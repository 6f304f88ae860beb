"""Host seconds of an update's optimizer phase: the program's `fz.trainer.optimizer` span (the
gradients gathered and clipped, AdamW's step on the fp32 masters, their write-back) over the
profiled updates, per `fz.trainer.step` call. Taken under the profiler, which about doubles a
host-bound unit's host time."""
from fatezero_tpu_torch.common import profiling


def read(rec):
    recorded = getattr(profiling, "recorded", None)  # absent before the program had spans
    if rec.get("unit_name") != "update" or recorded is None:
        return None
    spans = recorded()["spans"]
    updates = spans.get("fz.trainer.step", {}).get("calls")
    if not updates or "fz.trainer.optimizer" not in spans:
        return None
    return spans["fz.trainer.optimizer"]["total_s"] / updates
