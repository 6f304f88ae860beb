"""The share of the profiled edits' UNet forwards that replayed the forward's piecewise CUDA graphs,
in %: the program's `unet.graphed` counter over the calls of `fz.unet.forward`; nothing where the
program has no such counter."""
from fatezero_tpu_torch.common import profiling


def read(rec):
    recorded = getattr(profiling, "recorded", None)  # absent before the program had spans
    if rec.get("unit_name") != "edit" or recorded is None:
        return None
    seen = recorded()
    forwards = seen["spans"].get("fz.unet.forward", {}).get("calls")
    if not forwards or "unet.graphed" not in seen["counters"]:
        return None
    return 100.0 * seen["counters"]["unet.graphed"] / forwards
