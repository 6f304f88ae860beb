"""Host seconds of an update's forward and backward: the program's `fz.trainer.forward` (VAE
encodes, UNet forward, losses) and `fz.trainer.backward` spans over the profiled updates, per
`fz.trainer.step` call. Taken under the profiler, which about doubles a host-bound unit's host
time."""
from fatezero_tpu_torch.common import profiling


def read(rec):
    recorded = getattr(profiling, "recorded", None)  # absent before the program had spans
    if rec.get("unit_name") != "update" or recorded is None:
        return None
    spans = recorded()["spans"]
    updates = spans.get("fz.trainer.step", {}).get("calls")
    if not updates:
        return None
    return sum(spans.get(name, {}).get("total_s", 0.0)
               for name in ("fz.trainer.forward", "fz.trainer.backward")) / updates
