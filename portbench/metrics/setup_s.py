"""Seconds from the process's start to the start of the measured window."""


def read(rec):
    return rec.get("setup_s")
