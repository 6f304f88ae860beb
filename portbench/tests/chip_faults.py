"""Reads the check's numbers on the card at the cell's own size, several seeds
in one process: with a fault planted in the program (the readings that set a
limit's upper end), with none, or with the float8 control beside the program:

    python3 -m portbench.tests.chip_faults <cell> <fault|none|fp8> <seed> [<seed> ...]

<fault> names a function of test_portbench_faults (e.g. _half_the_batch)."""
import json
import sys

import pytest

from portbench import run as R
from portbench.reference.numerics import FP8
from portbench.tests import test_portbench_faults as F


def main(cell, fault, *seeds):
    for seed in seeds:
        with pytest.MonkeyPatch.context() as mp:
            if fault not in ("none", "fp8"):
                getattr(F, fault)(mp)
            r = R.run(cell, int(seed), 1.0, False, limits={}, control=FP8() if fault == "fp8" else None)
        line = {"cell": cell, "fault": fault, "seed": int(seed),
                "readings": {k: c["value"] for k, c in r["compared"].items()}}
        if "control" in r:
            line["control"] = {k: c["value"] for k, c in r["control"]["compared"].items()}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
