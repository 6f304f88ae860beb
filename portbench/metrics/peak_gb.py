"""torch.cuda.max_memory_allocated() over the window, in GB (1e9 bytes)."""


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec.get("peak_bytes") else None
