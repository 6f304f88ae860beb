"""GB (1e9 bytes) of the tensors the capture returned in an edit; 0 when the edit captures nothing."""


def read(rec):
    if rec.get("unit_name") != "edit" or "payload_bytes" not in rec.get("counters", {}):
        return None
    return rec["counters"]["payload_bytes"] / 1e9
