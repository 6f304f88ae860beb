"""Host seconds of the model's modules in one edit: the self time of the program's `fz.unet.` spans
(the UNet's forward, its resnets, group norms, attention, temporal attention and feed-forwards;
the VAE's group norms too) over the profiled edits, per `edit_fast` call. Taken under the
profiler, which about doubles a host-bound unit's host time."""
from fatezero_tpu_torch.common import profiling


def read(rec):
    recorded = getattr(profiling, "recorded", None)  # absent before the program had spans
    if rec.get("unit_name") != "edit" or recorded is None:
        return None
    spans = recorded()["spans"]
    edits = spans.get("fz.pipeline.edit_fast", {}).get("calls")
    if not edits:
        return None
    return sum(s["self_s"] for name, s in spans.items() if name.startswith("fz.unet.")) / edits
