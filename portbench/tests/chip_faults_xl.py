"""chip_faults.py for sdxl-replay10: the check's numbers on the card at the
cell's own size, with one of test_portbench_sdxl's faults planted, with none,
or with the float8 control beside the program:

    python3 -m portbench.tests.chip_faults_xl <fault|none|fp8> <seed> [<seed> ...]"""
import sys

from portbench.tests import chip_faults as CF
from portbench.tests import test_portbench_sdxl as F


def main(fault, *seeds):
    CF.F = F
    CF.main("sdxl-replay10", fault, *seeds)


if __name__ == "__main__":
    main(*sys.argv[1:])
