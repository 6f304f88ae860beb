"""A configuration, a mix, a per-layer metric and a cell join by added files and entries only."""
import json
import os
import shutil
import subprocess
import sys

from portbench.tests import tiny as T

SCRIPT = """
import json, sys
from portbench import run as R
r = R.run("added-cell", 12345, 0.1, bool(int(sys.argv[1])), device="cpu", limits={})
print(json.dumps(r["metrics"]))
"""


def test_added_files_are_found_by_name(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(T.PORTBENCH, copy / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    pb = copy / "portbench"
    cfg = T.load(os.path.join(T.HERE, "tiny.json"))
    cfg["model_config"] = {"lora": 16, "SparseCausalAttention_index": [-1, "first"]}
    (pb / "configs" / "added-config.json").write_text(json.dumps(cfg))
    mix = T.load(os.path.join(T.PORTBENCH, "mixes", "replay-edit.json"))
    mix.update(frames=3, resolution=64, steps=2, check={"invert_steps": 1, "edit_steps": 1})
    (pb / "mixes" / "added-mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "added_metric.edit.py").write_text(
        '"""A metric a later change adds."""\n\n\ndef read(rec):\n    return float(rec["unprofiled_units"])\n')
    bench = T.load(os.path.join(T.ROOT, "BENCHMARK.json"))
    bench["configs"].append({"name": "added-config", "source": "https://example.org/added",
                             "file": "portbench/configs/added-config.json", "reduced": [], "why": "added"})
    bench["workloads"].append({"name": "added-cell", "config": "added-config", "traffic": "added-mix",
                               "chips": 1, "why": "added"})
    for m in bench["end_to_end"]:
        if m["name"] == "edit_s":
            m["workloads"].append("added-cell")
    bench["per_layer"].append({"name": "added_metric.edit", "unit": "units", "better": "higher",
                               "source": "host_clock", "layer": "pipeline", "moves": "edit_s",
                               "workloads": ["added-cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {**os.environ, "PYTHONPATH": f"{copy}{os.pathsep}{T.ROOT}", "PYTHONHASHSEED": "0"}
    for trace, wanted in (("0", "edit_s"), ("1", "added_metric.edit")):
        out = subprocess.run([sys.executable, "-c", SCRIPT, trace], cwd=copy, env=env,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        assert wanted in json.loads(out.stdout.strip().splitlines()[-1])
