"""Phase timing, program spans and counters, and torch.profiler tracing.

Counterpart of fatezero_tpu/common/profiling.py: every pipeline phase can be
timed with `phase(name)` (the same report and `phase_timings.json`), and a
whole run wrapped in a `torch.profiler` trace written as a Chrome trace
(viewable in Perfetto or chrome://tracing).

Program spans and counters mark the port's layers from the inside:
`span(name)` around a block, `spanned(name)` around a whole function, and
`count(name, n)` at the place where the work happens. They collect only
while a torch profiler collects (`torch.autograd._profiler_enabled()`):
then a span is also a profiler annotation (a record function), so it
sits in the same trace as the device kernels it launches, and a
process-wide recorder keeps, per span name, its calls, total seconds and
self seconds (the span's duration less what its child spans on the same
thread cover), and each counter's sum; `recorded()` reads them and
`reset()` clears them. Otherwise a span costs one flag test and a counter
nothing more. No span synchronises the device: its times are the host's.
Each thread keeps its own stack of open spans (the autograd engine runs a
checkpointed recomputation on its own thread on the card).
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Dict, Optional

import torch

_collecting = torch.autograd._profiler_enabled
# the profiler's annotation without record_function's Python object, which alone
# costs ~14 µs a span under the profiler on an H100's host (a whole span ~6 µs)
_Annotation = torch._C._profiler._RecordFunctionFast


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Recorder:
    """Per span name [calls, total ns, self ns] and per counter its sum,
    updated under a lock (spans close on more than one thread); each thread's
    stack of open spans, innermost last."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.spans: Dict[str, list] = {}
        self.counters: Dict[str, float] = {}

    def stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def add_span(self, name: str, total_ns: int, self_ns: int) -> None:
        with self._lock:
            rec = self.spans.get(name)
            if rec is None:
                self.spans[name] = [1, total_ns, self_ns]
            else:
                rec[0] += 1
                rec[1] += total_ns
                rec[2] += self_ns

    def add_count(self, name: str, n) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def read(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                "spans": {n: {"calls": c, "total_s": t * 1e-9, "self_s": s * 1e-9}
                          for n, (c, t, s) in self.spans.items()},
                "counters": dict(self.counters),
            }

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
            self.counters.clear()

    @contextlib.contextmanager
    def discarded(self):
        """Whatever closes inside the block is dropped: the recorder is left as it was."""
        with self._lock:
            spans, counters = {n: list(r) for n, r in self.spans.items()}, dict(self.counters)
        try:
            yield
        finally:
            with self._lock:
                self.spans, self.counters = spans, counters


_RECORDER = _Recorder()


class _Span:
    """A collecting span: a profiler annotation and a recorder entry."""

    __slots__ = ("name", "rf", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = _Annotation(self.name)
        self.rf.__enter__()
        self.child_ns = 0
        _RECORDER.stack().append(self)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        stack = _RECORDER.stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += dur
        _RECORDER.add_span(self.name, dur, dur - self.child_ns)
        self.rf.__exit__(*exc)


_OFF = contextlib.nullcontext()  # the one span of a process whose profiler is not collecting


def span(name: str):
    """A context manager marking one call of a layer; name a constant."""
    return _Span(name) if _collecting() else _OFF


def spanned(name: str):
    """Decorator: every call of the function inside `span(name)`."""

    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _collecting():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return wrapped

    return wrap


def count(name: str, n=1) -> None:
    """Add n to the counter `name` (while the profiler collects)."""
    if _collecting():
        _RECORDER.add_count(name, n)


def recorded() -> Dict[str, Dict]:
    """{"spans": {name: {"calls", "total_s", "self_s"}}, "counters": {name: sum}}
    of what collected since the last `reset()`."""
    return _RECORDER.read()


def reset() -> None:
    """Clear the recorded spans and counters."""
    _RECORDER.reset()


def discarded():
    """A context manager whose spans and counts are not recorded: host code
    whose work runs later, as a CUDA graph's capture (its replays do the work)."""
    return _RECORDER.discarded()


class PhaseTimer:
    """Accumulates wall-clock per named phase; on a CUDA device each timed
    phase is synchronised at its start and end, so it holds its own device
    work. Each phase is also the span `fz.cli.<name>`, inside that interval."""

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
            with span("fz.cli." + name):
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
    written to `logdir/trace.json`, with the program's spans and counters over
    the block (`recorded()`) in `logdir/spans.json`; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    reset()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(recorded(), f, indent=2)
