"""Host seconds of the capture planner in one edit: the program's `fz.pipeline.plan_capture` span
(its meta-UNet build and meta forward included) over the profiled edits, per `edit_fast` call.
Taken under the profiler, which about doubles a host-bound unit's host time."""
from fatezero_tpu_torch.common import profiling


def read(rec):
    recorded = getattr(profiling, "recorded", None)  # absent before the program had spans
    if rec.get("unit_name") != "edit" or recorded is None:
        return None
    spans = recorded()["spans"]
    edits = spans.get("fz.pipeline.edit_fast", {}).get("calls")
    if not edits or "fz.pipeline.plan_capture" not in spans:
        return None
    return spans["fz.pipeline.plan_capture"]["total_s"] / edits
