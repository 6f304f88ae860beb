"""A tiny copy of the benchmark for the CPU tests: the port's random:tiny
widths, 2 frames at 64^2, 3 DDIM steps, BENCHMARK.json's cells, metrics and
mixes otherwise."""
from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)
SEED = 2 ** 31 + 11  # past 32 signed bits, as the driver's seeds are


def load(path):
    with open(path) as f:
        return json.load(f)


BENCH = load(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = {w["name"]: w["traffic"] for w in BENCH["workloads"]}


def write_bench(tmp: str) -> dict:
    """A BENCHMARK.json, configurations and mixes for the tiny copy under `tmp`:
    the paths to hand run.run. Each configuration is tiny.json; a training one
    keeps its own inflation and training settings."""
    tiny = load(os.path.join(HERE, "tiny.json"))
    bench = dict(BENCH, configs=[])
    for c in BENCH["configs"]:
        real = load(os.path.join(ROOT, c["file"]))
        cfg = dict(tiny, model_config=real["model_config"], train=real["train"]) if "train" in real else tiny
        path = os.path.join(tmp, f"{c['name']}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": c["name"], "file": path})
    mixes = os.path.join(tmp, "mixes")
    os.makedirs(mixes, exist_ok=True)
    for m in CELLS.values():
        mix = load(os.path.join(PORTBENCH, "mixes", f"{m}.json"))
        mix.update(frames=2, resolution=64, profiled_units=1)
        if "steps" in mix:
            mix.update(steps=3, check={"invert_steps": 3, "edit_steps": 3})
        with open(os.path.join(mixes, f"{m}.json"), "w") as f:
            json.dump(mix, f)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return {"bench_path": path, "mixes_dir": mixes}


def limits(cell: str) -> dict:
    """The cell's own limits, as a run on the chip holds the numbers to them."""
    return load(os.path.join(PORTBENCH, "limits", f"{cell}.json"))
