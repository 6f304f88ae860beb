import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def tiny(tmp_path):
    from portbench.tests import tiny as T

    return T.write_bench(str(tmp_path))
