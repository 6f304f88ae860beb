"""The window's wall time over the updates it completed: a tuning run's length over its updates."""


def read(rec):
    if rec.get("unit_name") != "update" or not rec.get("units"):
        return None
    return rec["window_s"] / rec["units"]
