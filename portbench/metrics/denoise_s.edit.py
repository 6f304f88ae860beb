"""Median seconds of `edit_fast` in the traced run's unprofiled edits (synchronised at both ends)."""
import statistics


def read(rec):
    v = rec.get("spans", {}).get("edit_fast")
    return statistics.median(v) if v and rec.get("unit_name") == "edit" else None
