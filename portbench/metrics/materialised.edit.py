"""Controlled attention sites that materialised their probabilities in one edit: the program's
`ptp.materialised` counter over the profiled edits, per `edit_fast` call; 0 where every site ran
in value space."""
from fatezero_tpu_torch.common import profiling


def read(rec):
    recorded = getattr(profiling, "recorded", None)  # absent before the program had spans
    if rec.get("unit_name") != "edit" or recorded is None:
        return None
    seen = recorded()
    edits = seen["spans"].get("fz.pipeline.edit_fast", {}).get("calls")
    if not edits:
        return None
    return seen["counters"].get("ptp.materialised", 0) / edits
