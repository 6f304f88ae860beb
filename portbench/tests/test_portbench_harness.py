"""The harness end to end at the tiny size on the CPU: a contract-shaped result."""
import json

import pytest

from portbench import run as R
from portbench.tests import tiny as T

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("cell", sorted(T.CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_run_prints_a_contract_line(tiny, cell, trace):
    result = R.run(cell, T.SEED, 0.2, trace, device="cpu", limits=T.limits(cell), **tiny)
    line = json.loads(json.dumps(result))
    assert all(k in line for k in KEYS)
    assert list(line)[-1] == "compared"
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    bench = T.load(tiny["bench_path"])
    wanted = {m["name"] for m in R.metrics_of(bench, cell, per_layer=trace)}
    assert set(line["metrics"]) <= wanted
    if not trace:  # the end-to-end metrics a CPU run can read (peak_gb needs the card)
        assert {"setup_s", "tune_step_s" if cell == "jeep-tune" else "edit_s"} <= set(line["metrics"])
    for m in line["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    for c in line["compared"].values():
        assert c["limit"] is not None and c["value"] <= c["limit"]
