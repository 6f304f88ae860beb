"""The share of the profiled updates that replayed a CUDA graph of the update, in %: the program's
`trainer.graphed` counter over the calls of `fz.trainer.step`; nothing where the program has no such
counter."""
from fatezero_tpu_torch.common import profiling


def read(rec):
    recorded = getattr(profiling, "recorded", None)  # absent before the program had spans
    if rec.get("unit_name") != "update" or recorded is None:
        return None
    seen = recorded()
    updates = seen["spans"].get("fz.trainer.step", {}).get("calls")
    if not updates or "trainer.graphed" not in seen["counters"]:
        return None
    return 100.0 * seen["counters"]["trainer.graphed"] / updates
