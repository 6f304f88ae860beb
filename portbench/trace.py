"""Spans of the harness's own, and what the profiler saw on the device.

The harness marks its calls into the program with `torch.profiler`
annotations (`span`), and the attention modules with forward hooks
(`AttentionSpans`); the program itself is not edited. `profiled(fn)` runs
fn under `torch.profiler` (CPU and CUDA activities, no shapes, no stacks),
keeps the events in memory and reduces them at once to a `DeviceTrace`:

* busy: the union of the device's operations (kernels, copies, sets) inside
  the span of the annotation `portbench.unit`, overlaps counted once;
* the device time of the kernels launched while an annotation whose name
  starts with `portbench.attn` was open on the host (a launch joins its
  kernel through the profiler's correlation id);
* the ten device operations with the most time, and the idle time between
  device operations grouped by the harness span and the CUDA runtime call
  open on the host at the start of each gap ("host" where none was: the
  host was running Python and the operators' host code).
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

UNIT = "portbench.unit"
ATTN = "portbench.attn"


def span(name: str):
    """A host annotation the trace reads (a no-op cost when no profiler runs)."""
    return torch.profiler.record_function(f"portbench.{name}")


class AttentionSpans:
    """Forward hooks on every module of the given classes: each call runs inside
    a `portbench.attn` annotation."""

    def __init__(self, model: torch.nn.Module, classes: Tuple[type, ...]):
        self.handles = []
        self._open: List = []
        for m in model.modules():
            if isinstance(m, classes):
                self.handles.append(m.register_forward_pre_hook(self._enter))
                self.handles.append(m.register_forward_hook(self._exit))

    def _enter(self, module, args):
        rf = torch.profiler.record_function(ATTN)
        rf.__enter__()
        self._open.append(rf)

    def _exit(self, module, args, out):
        self._open.pop().__exit__(None, None, None)

    def remove(self):
        for h in self.handles:
            h.remove()


def union_length(intervals: List[Tuple[int, int]]) -> int:
    """Total length covered by [start, end) intervals, overlaps counted once."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle stretches of [lo, hi) that no interval covers."""
    out, cursor = [], lo
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(s, e) for s, e in out if e > s]


@dataclasses.dataclass
class DeviceTrace:
    span_s: float
    busy_s: float
    attn_device_s: float
    device_ops: List[List]
    idle_gaps: List[List]

    @property
    def idle_pct(self) -> Optional[float]:
        return None if self.span_s <= 0 else 100.0 * (1.0 - self.busy_s / self.span_s)


def _annotation(e) -> bool:
    try:
        return bool(e.is_user_annotation())
    except (AttributeError, RuntimeError):
        return False


def reduce_events(events) -> Optional[DeviceTrace]:
    """The DeviceTrace of kineto events, or None when no device operation ran."""
    unit = None
    attn: List[Tuple[int, int]] = []
    spans: List[Tuple[int, int, str]] = []
    host_ops: List[Tuple[int, int, str]] = []
    launch_ns: Dict[int, int] = {}
    device: List[Tuple[int, int, str, int]] = []
    cpu = torch.autograd.DeviceType.CPU
    for e in events:
        name = e.name()
        on_host = e.device_type() == cpu
        if name.startswith("portbench."):
            if on_host:
                start = e.start_ns()
                end = start + e.duration_ns()
                if name == UNIT:
                    unit = (start, end)
                elif name == ATTN:
                    attn.append((start, end))
                else:
                    spans.append((start, end, name[len("portbench."):]))
        elif on_host:
            # of the host's events only the CUDA runtime and driver calls count:
            # they launch the kernels and wait for them
            if name.startswith("cu"):
                start = e.start_ns()
                launch_ns[e.correlation_id()] = start
                host_ops.append((start, start + e.duration_ns(), name))
        elif not _annotation(e):
            start = e.start_ns()
            device.append((start, start + e.duration_ns(), name, e.correlation_id()))
    if unit is None or not device:
        return None
    lo, hi = unit
    inside = [(max(s, lo), min(e, hi), n, c) for s, e, n, c in device if e > lo and s < hi]
    busy = union_length([(s, e) for s, e, _, _ in inside])
    attn.sort()
    starts = [s for s, _ in attn]
    attn_ns = 0
    by_name: Dict[str, int] = defaultdict(int)
    for s, e, n, c in inside:
        by_name[n] += e - s
        t = launch_ns.get(c)
        if t is not None:
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t < attn[k][1]:
                attn_ns += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps([(s, e) for s, e, _, _ in inside], lo, hi), key=lambda g: g[0] - g[1])[:500]
    spans.sort()
    host_ops.sort()
    label_ns: Dict[str, int] = defaultdict(int)
    for s, e in idle:
        label_ns[f"{_open_at(spans, s) or 'harness'}: {_open_at(host_ops, s) or 'host'}"] += e - s
    gaps_top = sorted(label_ns.items(), key=lambda kv: -kv[1])[:10]
    return DeviceTrace(
        span_s=(hi - lo) * 1e-9,
        busy_s=busy * 1e-9,
        attn_device_s=attn_ns * 1e-9,
        device_ops=[[n, ns * 1e-9] for n, ns in top],
        idle_gaps=[[n, ns * 1e-9] for n, ns in gaps_top],
    )


def _open_at(intervals: List[Tuple[int, int, str]], t: int) -> Optional[str]:
    """The innermost (latest started) interval open at time t, looking back
    over at most 2,000 intervals."""
    k = bisect.bisect_right(intervals, (t, float("inf"), "")) - 1
    for j in range(k, max(k - 2000, -1), -1):
        if intervals[j][1] > t:
            return intervals[j][2]
    return None


def profiled(fn: Callable[[], None]) -> Optional[DeviceTrace]:
    """Run fn (which opens `span("unit")` itself) under the profiler; reduce the
    events in memory."""
    import sys
    import time

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False) as prof:
        fn()
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    t3 = time.perf_counter()
    out = reduce_events(events)
    print(f"portbench: profiled {t1 - t0:.1f} s, profiler stop {t2 - t1:.1f} s, {len(events)} events "
          f"{t3 - t2:.1f} s, reduce {time.perf_counter() - t3:.1f} s", file=sys.stderr)
    return out
