"""Host seconds of the UNet's transformer stacks in one edit: the total of the program's
`fz.unet.transformer` spans (one SpatioTemporalTransformerModel call each: its norm, proj_in, every
block and proj_out) over the profiled edits, per `edit_fast` call; nothing where the program has no
such span. Taken under the profiler, which about doubles a host-bound unit's host time."""
from fatezero_tpu_torch.common import profiling


def read(rec):
    recorded = getattr(profiling, "recorded", None)  # absent before the program had spans
    if rec.get("unit_name") != "edit" or recorded is None:
        return None
    spans = recorded()["spans"]
    edits = spans.get("fz.pipeline.edit_fast", {}).get("calls")
    if not edits or "fz.unet.transformer" not in spans:
        return None
    return spans["fz.unet.transformer"]["total_s"] / edits
