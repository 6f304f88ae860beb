"""The port's one CUDA-graph layer (torch; the JAX package jits its update
and forward whole). Its users: the tuning update's graph
(trainer/ddpm_trainer.py) and the UNet forward's pieces between its eager
attention calls (models/unet_graph.py). Each adds its own conditions to the
rule `engages` and its own extras to `static_key`. A `GraphCache` holds an
`Entry` per key, at most `max_keys`, and the pool their graphs share. An
entry runs `WARMUP` times eagerly, is captured on a side stream on `static`
copies of its inputs (`GraphCache.capture`), then replays after `copy_in`.

A capture launches nothing, but the hand-written kernels' wrappers still
count what they record, and spans and counters still close: `Entry` leaves
the recorder as it was (`profiling.discarded`), sets each launch counter
back, and `replayed` adds the graph's launches once a replay.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import torch
from torch.nn.modules import module as _module

from fatezero_tpu_torch.common import profiling
from fatezero_tpu_torch.ops import flash_attention as FA
from fatezero_tpu_torch.ops.fused_norm import layer_norm_kernel
from fatezero_tpu_torch.parallel.sharding import current_seq_mesh

# the hand-written kernels' launch counters
LAUNCH_COUNTED = (FA.flash_forward, FA.flash_dq, FA.flash_dkv, layer_norm_kernel)
WARMUP = 1  # eager runs of a new static key before its capture


def hooked(modules: Iterable[torch.nn.Module]) -> bool:
    """Whether any of `modules` has a forward, pre-forward or backward hook."""
    return any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks or m._backward_pre_hooks
               for m in modules)


def engages(device: torch.device, modules: Callable[[], Iterable[torch.nn.Module]]) -> bool:
    """Whether work on `device` may run as CUDA graphs. It needs a CUDA
    device and no mesh in scope, since a mesh's collectives stay eager. The
    stream must not be capturing already. It needs no hook that a replay
    would skip: no global module hook, and no hook on the modules whose
    calls a replay skips. `modules()` gives those, and is called last."""
    return (device.type == "cuda" and current_seq_mesh() is None and not torch.cuda.is_current_stream_capturing()
            and not (_module._global_forward_hooks or _module._global_forward_pre_hooks
                     or _module._global_backward_hooks or _module._global_backward_pre_hooks)
            and not hooked(modules()))


def _form(x):
    if isinstance(x, dict):
        return tuple((n, _form(v)) for n, v in sorted(x.items()))
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    return None if x is None else type(x)


def static_key(inputs, *extras) -> tuple:
    """The static key of a graph: the shape and dtype of each tensor of
    `inputs`, the type of a number and None for an absent input (`inputs`
    may be a dict of them), followed by the caller's `extras`."""
    return (_form(inputs), *extras)


def static(x, device: torch.device):
    """A static copy of `x` (a tensor, a number as a 0-d tensor, None, or a
    dict of them) on `device`, made outside inference mode, so that any
    later run may write it."""
    if isinstance(x, dict):
        return {n: static(v, device) for n, v in x.items()}
    if x is None:
        return None
    with torch.inference_mode(False):
        return torch.as_tensor(x).to(device, copy=True)


def copy_in(target, x) -> None:
    """Copy the values of `x` into `target`, its static copy (`static`). A
    number goes in by `fill_`, with no copy from the host."""
    if isinstance(x, dict):
        for n, v in x.items():
            copy_in(target[n], v)
    elif isinstance(x, torch.Tensor):
        target.copy_(x)
    elif x is not None:
        target.fill_(x)


def replayed(launched: List[int]) -> None:
    """Count one replay of a graph that launched `launched` (`Entry.close`)."""
    for fn, n in zip(LAUNCH_COUNTED, launched):
        fn.launches += n


@contextlib.contextmanager
def side_stream() -> Iterator[None]:
    """Run the block on a new side stream. The side stream starts after the
    current stream's work, and the current stream then waits for it."""
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        yield
    main.wait_stream(side)


class Entry:
    """One static key's graphs. `warm` counts its eager runs. The capture
    (`GraphCache.capture`) sets `inputs`, the static copies the graphs read,
    and fills `schedule`: `begin` and `end` bracket a graph, which `end`
    replays at once, so that the work after it reads real values; between
    two, the caller runs eager work and appends a callable that `replay`
    calls with its `ctx`. `launched`: each counted kernel's launches in the
    graphs; `outputs` (set by the caller): the static tensors they write."""

    def __init__(self):
        self.warm = 0
        self.schedule: Optional[list] = None
        self.graph = None

    def warming(self) -> bool:
        """Whether this run of the key is one of its `WARMUP` eager runs
        before the capture; the run is counted."""
        if self.schedule is not None or self.warm >= WARMUP:
            return False
        self.warm += 1
        return True

    def begin(self) -> None:
        self._before = [fn.launches for fn in LAUNCH_COUNTED]
        self._discarded = profiling.discarded()
        self._discarded.__enter__()
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool)

    def end(self) -> None:
        graph = self.graph
        launched = self.close()
        self.launched = [a + b for a, b in zip(self.launched, launched)]
        graph.replay()
        replayed(launched)
        self.schedule.append(graph)

    def close(self) -> List[int]:
        """End the capture under way, the recorder and the launch counters
        left as before it; returns each counted kernel's launches in it."""
        graph, self.graph = self.graph, None
        try:
            graph.capture_end()
        finally:
            self._discarded.__exit__(None, None, None)
            launched = [fn.launches - n for fn, n in zip(LAUNCH_COUNTED, self._before)]
            for fn, n in zip(LAUNCH_COUNTED, self._before):
                fn.launches = n
        return launched

    def replay(self, inputs, ctx) -> None:
        """Copy `inputs` into the static ones and run the schedule: replay
        each graph, and call each eager item with `ctx`."""
        copy_in(self.inputs, inputs)
        for item in self.schedule:
            if isinstance(item, torch.cuda.CUDAGraph):
                item.replay()
            else:
                item(ctx)
        replayed(self.launched)


class GraphCache:
    """Entries by static key, at most `max_keys` of them, and the memory
    pool that their graphs share; a new key past the bound first releases
    the others."""

    def __init__(self, max_keys: int):
        self.max_keys = max_keys
        self.entries: Dict[tuple, Entry] = {}
        self.pool = None

    def entry(self, key: tuple) -> Entry:
        """The entry of `key`, new if the cache does not hold it."""
        if key not in self.entries and len(self.entries) >= self.max_keys:
            self.release()
        return self.entries.setdefault(key, Entry())

    def release(self) -> None:
        """Drop every entry, its graphs and the pool, and return their
        memory to the card. While a stream captures, do nothing: a capture
        may free no memory."""
        held = self.pool is not None
        if held and torch.cuda.is_current_stream_capturing():
            return
        self.entries.clear()
        self.pool = None
        if held:
            torch.cuda.empty_cache()

    @contextlib.contextmanager
    def capture(self, entry: Entry, inputs, device: torch.device) -> Iterator[None]:
        """Capture `entry`'s graphs into the cache's pool: `entry.inputs`
        becomes a static copy of `inputs` on `device`, and the block runs its
        work on them on a side stream, its first graph begun; leaving the
        block ends the last one."""
        entry.inputs = static(inputs, device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        entry.pool, entry.schedule, entry.launched = self.pool, [], [0] * len(LAUNCH_COUNTED)
        with side_stream():
            entry.begin()
            try:
                yield
            except BaseException:
                if entry.graph is not None:
                    entry.close()
                entry.schedule = None
                raise
            entry.end()
        # cuBLAS keeps a workspace per stream, and the side stream got one (the capture's stays in the pool, as
        # torch's own graph trees leave it); the blocks that the side stream cached serve no later work either
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
