"""The share of the profiled edit's span in which no kernel, copy or set ran on the device, in %."""


def read(rec):
    t = rec.get("trace")
    return t.idle_pct if t is not None and rec.get("unit_name") == "edit" else None
