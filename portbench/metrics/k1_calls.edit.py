"""K1 launches in one edit: the program's `flash_forward.launches` over the profiled edit."""


def read(rec):
    if rec.get("unit_name") != "edit" or "k1_per_unit" not in rec.get("counters", {}):
        return None
    return rec["counters"]["k1_per_unit"]
