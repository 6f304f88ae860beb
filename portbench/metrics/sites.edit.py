"""Controlled attention sites visited in one edit, the attention control's load: calls of the
program's `fz.ptp.site` span over the profiled edits, per `edit_fast` call."""
from fatezero_tpu_torch.common import profiling


def read(rec):
    recorded = getattr(profiling, "recorded", None)  # absent before the program had spans
    if rec.get("unit_name") != "edit" or recorded is None:
        return None
    spans = recorded()["spans"]
    edits = spans.get("fz.pipeline.edit_fast", {}).get("calls")
    if not edits or "fz.ptp.site" not in spans:
        return None
    return spans["fz.ptp.site"]["calls"] / edits
