"""Phase timing and torch.profiler tracing.

Counterpart of fatezero_tpu/common/profiling.py: every pipeline phase can be
timed with `phase(name)` (the same report and `phase_timings.json`), and a
whole run wrapped in a `torch.profiler` trace written as a Chrome trace
(viewable in Perfetto or chrome://tracing).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulates wall-clock per named phase; on a CUDA device each timed
    phase is synchronised at its start and end, so it holds its own device work."""

    def __init__(self, device=None):
        self.device = device
        self.phases: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        if sync:
            _sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _sync(self.device)
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"seconds": round(t, 3), "calls": self.counts[name]}
            for name, t in self.phases.items()
        }

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)

    def __str__(self) -> str:
        rows = [f"  {n:<28s} {v['seconds']:>9.2f}s x{v['calls']}" for n, v in self.report().items()]
        return "phase timings:\n" + "\n".join(rows)


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """torch.profiler over the block (host, and the card where there is one),
    written to `logdir/trace.json`; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
