"""Model operations of the edits the traced run timed without the profiler over their wall time,
as a share of the bf16 peak, in %."""
from portbench import roofline


def read(rec):
    if rec.get("unit_name") != "edit" or not rec.get("unprofiled_units"):
        return None
    return roofline.mfu_pct(rec["flops_per_unit"] * rec["unprofiled_units"], rec["unprofiled_wall_s"])
