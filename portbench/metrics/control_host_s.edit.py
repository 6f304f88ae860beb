"""Host seconds of attention control in one edit: the self time of the program's `fz.ptp.` spans
(the controller's per-step work, and each controlled site's fusion or capture) over the profiled
edits, per `edit_fast` call. Taken under the profiler, which about doubles a host-bound unit's
host time."""
from fatezero_tpu_torch.common import profiling


def read(rec):
    recorded = getattr(profiling, "recorded", None)  # absent before the program had spans
    if rec.get("unit_name") != "edit" or recorded is None:
        return None
    spans = recorded()["spans"]
    edits = spans.get("fz.pipeline.edit_fast", {}).get("calls")
    if not edits:
        return None
    return sum(s["self_s"] for name, s in spans.items() if name.startswith("fz.ptp.")) / edits
