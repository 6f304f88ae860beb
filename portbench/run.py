"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration (`portbench/configs/<config>.json`) and its traffic mix
(`portbench/mixes/<traffic>.json`); the mix names its driver
(`portbench/drivers/<driver>.py`), the checked numbers' limits are
`portbench/limits/<workload>.json`, and every metric is read by
`portbench/metrics/<metric>.py`. Adding a cell, a configuration, a mix or a
metric adds files and entries; this file stays as it is.

A run sets up (weights made on the card from the seed, kernels built or
found in the checkout's build directory, one warm unit of work), then runs
units back to back for `--seconds`, starting none that the mean so far says
would end past the deadline (at least one). `--trace 1` profiles the first
`profiled_units` units of the window and times the rest without the
profiler. After the window the program is dropped and the plain reference
checks what the window produced. The last line of standard output is one
JSON object; the numbers compared, each beside its limit, close standard
error and the JSON line. `--control fp8` also reads, at the same inputs,
the reference computed in float8 in the program's place and judges it by
the same comparison (the check's control; not part of a run).
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time

ROOT = os.getcwd()
HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = {"jax", "jaxlib", "flax", "fatezero_tpu"}
PROFILER_COST = 2.0  # a profiled unit takes about twice an unprofiled one (host-bound launches)


def process_age_s() -> float:
    """Seconds since this process started (the interpreter's start included)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py, found by name (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, workload: str, mixes_dir: str = None):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(ROOT, cfg_entry["file"]))
    mix = load_json(os.path.join(mixes_dir or os.path.join(HERE, "mixes"), f"{cell['traffic']}.json"))
    return cell, cfg, mix


def metrics_of(bench: dict, workload: str, per_layer: bool):
    entries = bench["per_layer"] if per_layer else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def window(driver, seconds: float, start_index: int = 0, timed_spans: bool = False):
    """Units back to back for `seconds`: (units done, wall seconds to the last one's end)."""
    t0 = time.perf_counter()
    n, wall = 0, 0.0
    while True:
        now = time.perf_counter() - t0
        mean = now / n if n else driver.warm_s
        if n and now + mean > seconds:
            break
        driver.unit(start_index + n, timed_spans=timed_spans)
        n += 1
        wall = time.perf_counter() - t0
    return n, wall


def judge(readings: dict, limits: dict):
    """(the numbers compared, each beside its limit; those read but not
    compared; whether every compared number is within its limit). A limit of
    null names a number read but deliberately not compared; a number the
    limits do not name at all fails the run."""
    compared = {k: {"value": v, "limit": limits.get(k)} for k, v in readings.items()
                if k not in limits or limits[k] is not None}
    uncompared = {k: v for k, v in readings.items() if k in limits and limits[k] is None}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"] for c in compared.values())
    return compared, uncompared, correct


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", control=None,
        bench_path: str = None, limits: dict = None, mixes_dir: str = None) -> dict:
    """One run of a cell: the result object. `bench_path`, `mixes_dir` and
    `limits` stand in for the checkout's own in the tests."""
    import torch

    from portbench import roofline
    from portbench import trace as T

    bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    _, cfg, mix = cell_spec(bench, workload, mixes_dir)
    driver_mod = load_module("drivers", mix["driver"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    card = roofline.card() if cuda else {}
    driver = driver_mod.Driver(cfg, mix, seed, device)
    driver.setup()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    gc.collect()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rec = {"unit_name": driver.unit_name, "setup_s": process_age_s()}
    if not trace:
        rec["units"], rec["window_s"] = window(driver, seconds)
    else:
        # the unprofiled units first: a process that has run the profiler launches slower after
        profiled_units = int(mix["profiled_units"])
        budget = max(seconds - PROFILER_COST * driver.warm_s * profiled_units, 0.0)
        rec["unprofiled_units"], rec["unprofiled_wall_s"] = window(driver, budget, timed_spans=True)
        rec["spans"] = driver.spans
        hooks = driver.attention_hooks()
        k1 = driver.k1_launches()
        start = rec["unprofiled_units"]

        def profiled_part():
            with T.span("unit"):
                for i in range(profiled_units):
                    driver.unit(start + i)
                sync()

        rec["trace"] = T.profiled(profiled_part)
        if hooks is not None:
            hooks.remove()
        rec["counters"] = {"k1_per_unit": (driver.k1_launches() - k1) / profiled_units, **driver.counters}
        rec.update(driver.trace_data())
    sync()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec["peak_bytes"] = peak
    attempted = rec["units"] if not trace else profiled_units + rec["unprofiled_units"]

    metrics = {}
    for m in metrics_of(bench, workload, per_layer=trace):
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    closed = process_age_s()
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = driver.check(control)
    print(f"portbench: setup {rec['setup_s']:.1f} s, window {closed - rec['setup_s']:.1f} s, "
          f"check {process_age_s() - closed:.1f} s", file=sys.stderr)
    if limits is None:
        path = os.path.join(HERE, "limits", f"{workload}.json")
        limits = load_json(path) if os.path.exists(path) else {}
    compared, uncompared, correct = judge(readings["program"], limits)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak), **card}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        t = rec["trace"]
        dev["busy_s"] = t.busy_s if t else 0.0
        dev["window_s"] = t.span_s if t else 0.0
        if t:
            result["breakdown"] = {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps}
    if uncompared:
        result["uncompared"] = uncompared
    if control is not None:
        # the control in the program's place, judged by the same comparison
        c_compared, _, c_correct = judge(readings["control"], limits)
        result["control"] = {"correct": c_correct, "compared": c_compared}
    result["compared"] = compared
    return result


def _reexec_with_fixed_hash_seed() -> None:
    """The stub tokenizer's ids follow Python's hash seed: fix it for the process."""
    if os.environ.get("PYTHONHASHSEED") != "0":
        env = {**os.environ, "PYTHONHASHSEED": "0"}
        os.execve(sys.executable, [sys.executable, "-m", "portbench.run", *sys.argv[1:]], env)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("fp8",), default=None)
    args = p.parse_args()
    _reexec_with_fixed_hash_seed()
    if importlib.util.find_spec("fatezero_tpu_torch") is None:
        print("portbench: the program (fatezero_tpu_torch) is not in this directory", file=sys.stderr)
        return 2
    import torch

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    chips = int(cell["chips"]) if cell else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    control = None
    if args.control:
        from portbench.reference.numerics import policy

        control = policy(args.control)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), control=control)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}, which the benchmark of the port must not load", file=sys.stderr)
        return 3
    if "control" in result:
        for name, c in result["control"]["compared"].items():
            print(f"control {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        print(f"control correct {result['control']['correct']}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
