"""The attention modules' least time (portbench/work.py's count of their products for one inversion
row and two edit rows a step, each bounded by the peaks) over the device time of the kernels the
attention modules launched in the profiled edit, in %."""
from portbench import roofline


def read(rec):
    t = rec.get("trace")
    if rec.get("unit_name") != "edit" or t is None or t.attn_device_s <= 0:
        return None
    return roofline.share_pct(rec["attn_bound_s"], t.attn_device_s)
