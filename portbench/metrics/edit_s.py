"""The window's wall time over the edits it completed: what a user waits for, per edit."""


def read(rec):
    if rec.get("unit_name") != "edit" or not rec.get("units"):
        return None
    return rec["window_s"] / rec["units"]
