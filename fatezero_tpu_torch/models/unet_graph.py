"""Piecewise CUDA graphs of the UNet's forward (torch; the JAX package jits
its forward whole and has nothing of this).

An eager forward of the SD UNet is thousands of small launches, and in the
edit the host, not the card, sets their pace. Here the forward is cut at
every call of an `EagerModule` (models/attention.py's `Attention` and
`TemporalAttention`, called through `run_eager`): a piece is everything
between two such calls (the time embedding and `conv_in`; the resnets,
GroupNorms, resamplers and skip concatenations; a transformer's norm,
projections and residuals; the blocks' LayerNorms, residual adds and
feed-forwards; `conv_out`), and each piece is replayed as a CUDA graph.
The attention modules run eagerly between the pieces, through
`module(...)`: their hooks fire, the attention controller's host work (ptp/:
the payload row, the contexts' counters, capture, the materialised path) runs
as in an eager forward, and the flash kernel counts its launches.

Where `graph_engages` holds (a CUDA device, no mesh, grad off, a stream not
already capturing, no temporal downsampling, and no forward or pre-forward
hook, global or on a module a piece runs: hooks on the UNet itself and on an
`EagerModule` are fine), the first forward of a static key
(`graph_key`) runs eagerly, the second captures: it runs the forward's own
code on a side stream, each piece between the begin and the end of its
capture, and replays each piece at once, so that the module after it reads
real values; the schedule of pieces and eager calls is kept. Later forwards
of the key copy their inputs into the key's static tensors (the timestep by
`fill_`: no host-to-device copy) and walk the schedule: replay piece k, call
module k, copy its output where piece k + 1 reads it, replay piece k + 1, and
so on; the output is cloned, so the caller owns it. The attention modules get
the forward's own controller. Another parameter or buffer object or storage,
or another submodule, drops every graph (`load_state_dict` copies in place:
the graphs read the new values).

Memory: the pieces of every key capture into one pool. Each forward is
self-contained (inputs copied in, the output cloned out) and nothing but an
eager module runs between two pieces, which allocates outside the pool, so a
later capture may reuse what an earlier one freed. What a module reads and
returns crosses the pieces in a staging buffer: the first input, and after
the module has returned its output, at offset 0, other inputs past it. So
the buffer holds one call's values, not one per call; its size is taken from
the warm-up forward, and a key keeps the buffer it was captured with. Inputs
that are views of the static inputs (the context) are passed as they are. The
pool stays reserved while the graphs live (about one forward's activations at
the largest key), beside the allocator's cache. `PiecewiseGraphs.release`
drops every graph, the pool and the staging buffers and empties the cache: a
forward with grad on (training) and each `DDPMTrainer.step` call it, and a
key past the `MAX_KEYS`-th drops the others first (an edit drives 2 to 4).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.nn.modules import module as _module

from fatezero_tpu_torch.common import profiling
from fatezero_tpu_torch.ops.graph_capture import LAUNCH_COUNTED, CountedCapture, release_workspaces, replayed
from fatezero_tpu_torch.parallel.sharding import current_seq_mesh

WARMUP_FORWARDS = 1  # eager forwards of a new static key before its capture
MAX_KEYS = 8  # static keys held at once; a new one past them drops the others
_ALIGN = 256  # bytes: the start of every staging region

_scope = threading.local()  # `.current`: the warm-up or capture under way on this thread


class EagerModule(nn.Module):
    """A module that runs eagerly between the pieces of a graphed forward
    (models/attention.py's `Attention` and `TemporalAttention`). Its callers
    call it through `run_eager`; its hooks fire on every forward, so a hook
    on it leaves the graphs on."""


def run_eager(module: EagerModule, *args, **kwargs):
    """`module(*args, **kwargs)`, an `EagerModule`, which runs eagerly
    between the pieces of a graphed forward. While a forward is captured the
    call ends the piece before it and starts the next one; the tensor it
    returns then holds until the next such call (the forward adds it to the
    residual at once)."""
    if not isinstance(module, EagerModule):
        raise TypeError(f"run_eager takes an EagerModule, got {type(module).__name__}: a piece would hold it")
    current = getattr(_scope, "current", None)
    if current is None:
        return module(*args, **kwargs)
    return current.call(module, args, kwargs)


def graph_engages(unet: torch.nn.Module, device: torch.device) -> bool:
    """Whether `unet`'s forward on `device` runs as piecewise CUDA graphs: on
    a CUDA device, with no mesh (its collectives stay eager), grad off
    (tuning stays eager, and the trainer's own graph captures it), the
    stream not capturing already, no temporal downsampling (its upsample
    copies indices to the device) and no hook a replay would skip."""
    return (device.type == "cuda" and current_seq_mesh() is None and not torch.is_grad_enabled()
            and unet.cfg.temporal_downsample_time == 0 and not torch.cuda.is_current_stream_capturing()
            and not (_module._global_forward_hooks or _module._global_forward_pre_hooks)
            and not unet._graphs.piece_hooked(unet))


def graph_key(sample, timesteps, context, added_cond, drop: int) -> tuple:
    """The static key of a graphed forward: the shape and dtype of each input
    (of a timestep given as a number, its type), the replay rows dropped (0
    without a controller; all of them in a capture-only forward) and whether
    LayerNorms take the kernel K4 (models/layers.py::FusedLayerNorm)."""
    added = () if added_cond is None else tuple((n, _form(x)) for n, x in sorted(added_cond.items()))
    return (_form(sample), _form(timesteps), _form(context), added, drop, bool(os.environ.get("FZ_PALLAS_LN")))


def _form(x):
    return (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else type(x)


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Layout:
    """A UNet's modules and tensors as its graphs were captured: every
    module's children, parameters and buffers by name (`holds` checks them
    and the tensors' storage), and the modules the pieces run (all but the
    UNet and the `EagerModule`s with everything inside them)."""

    def __init__(self, unet: torch.nn.Module):
        self.slots: List[tuple] = []
        self.storages: List[tuple] = []
        self.piece_modules: List[torch.nn.Module] = []

        def walk(m, in_piece):
            if in_piece:
                self.piece_modules.append(m)
            for d in (m._modules, m._parameters, m._buffers):
                for name, v in d.items():
                    self.slots.append((d, name, v))
                    if isinstance(v, torch.Tensor):
                        self.storages.append((v, v.data_ptr()))
            for child in m._modules.values():
                if child is not None:
                    walk(child, (in_piece or m is unet) and not isinstance(child, EagerModule))

        walk(unet, False)

    def holds(self) -> bool:
        return (all(d.get(name) is v for d, name, v in self.slots)
                and all(t.data_ptr() == ptr for t, ptr in self.storages))


class _Call:
    """An eager module's call between two pieces: its arguments (static or
    staging tensors; the controller is the forward's own) and the staging
    view its output is copied into."""

    def __init__(self, module, args, kwargs, out: torch.Tensor):
        self.module, self.args, self.out = module, args, out
        self.kwargs = {n: None if n == "attn_ctx" else v for n, v in kwargs.items()}

    def run(self, attn_ctx) -> None:
        kwargs = {**self.kwargs, "attn_ctx": attn_ctx} if "attn_ctx" in self.kwargs else self.kwargs
        self.out.copy_(self.module(*self.args, **kwargs))


class _Key:
    """One static key's graphs: `warm` eager forwards so far and `staging`
    the bytes their calls staged at most; after the capture `inputs` (the
    static tensors the pieces read), `schedule` (CUDA graphs and `_Call`s in
    order), `out` (the tensor the last piece writes; None for a capture-only
    forward) and `launched` (each counted kernel's launches in the pieces)."""

    def __init__(self):
        self.warm, self.staging = 0, 0
        self.schedule: Optional[list] = None


class _Warmup:
    """An eager forward that measures what its module calls would stage."""

    def __init__(self, key: _Key):
        self.key = key

    def call(self, module, args, kwargs):
        staged = sum(_aligned(_nbytes(t)) for t in (*args, *kwargs.values()) if isinstance(t, torch.Tensor))
        out = module(*args, **kwargs)
        self.key.staging = max(self.key.staging, staged, _nbytes(out))
        return out


class _Capture:
    """A key's capture under way: `begin` and `end` bracket a piece (`end`
    replays it at once), `call` ends one at an eager module's call."""

    def __init__(self, pool, staging: torch.Tensor, stable: set):
        self.pool, self.staging, self.stable = pool, staging, stable
        self.schedule: list = []
        self.launched = [0] * len(LAUNCH_COUNTED)
        self.graph = None

    def begin(self) -> None:
        self.counted = CountedCapture().__enter__()
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool)

    def end(self) -> None:
        graph, self.graph = self.graph, None
        try:
            graph.capture_end()
        finally:
            self.counted.__exit__(None, None, None)
        self.launched = [a + b for a, b in zip(self.launched, self.counted.launched)]
        graph.replay()
        replayed(self.counted.launched)
        self.schedule.append(graph)

    def abort(self) -> None:
        if self.graph is not None:
            graph, self.graph = self.graph, None
            try:
                graph.capture_end()
            finally:
                self.counted.__exit__(None, None, None)

    def _view(self, offset: int, like: torch.Tensor) -> torch.Tensor:
        return self.staging[offset : offset + _nbytes(like)].view(like.dtype).view(like.shape)

    def call(self, module, args, kwargs):
        offset = 0

        def stage(t):
            nonlocal offset
            if not isinstance(t, torch.Tensor) or t.untyped_storage().data_ptr() in self.stable:
                return t
            view = self._view(offset, t)
            view.copy_(t)  # the piece's last work
            offset += _aligned(_nbytes(t))
            return view

        args = tuple(stage(a) for a in args)
        kwargs = {n: stage(v) for n, v in kwargs.items()}
        self.end()
        out = module(*args, **kwargs)
        view = self._view(0, out)
        view.copy_(out)
        self.schedule.append(_Call(module, args, kwargs, view))
        self.begin()
        return view


class PiecewiseGraphs:
    """A UNet's piecewise CUDA graphs: a `_Key` per static key, the pool and
    the staging buffer they share, and the UNet's `_Layout` they were
    captured on. The UNet keeps one (`unet._graphs`)."""

    def __init__(self):
        self.keys: Dict[tuple, _Key] = {}
        self.layout: Optional[_Layout] = None
        self.pool = None
        self.staging: Optional[torch.Tensor] = None

    def piece_hooked(self, unet) -> bool:
        """Whether a module a piece runs has a forward or pre-forward hook. A
        UNet whose modules or tensors changed first drops every graph."""
        if self.layout is None or not self.layout.holds():
            self.release()
            self.layout = _Layout(unet)
        return any(m._forward_hooks or m._forward_pre_hooks for m in self.layout.piece_modules)

    def release(self) -> None:
        """Drop every key, its graphs and staging buffer, and the pool, and
        return their memory to the card; while a stream captures, nothing
        (a capture may free no memory)."""
        held = self.pool is not None
        if held and torch.cuda.is_current_stream_capturing():
            return
        self.keys.clear()
        self.pool = self.staging = None
        if held:
            torch.cuda.empty_cache()

    def forward(self, unet, sample, timesteps, context, attn_ctx, drop_replay_rows: int, added_cond):
        """`unet`'s forward as piecewise graphs (the first of a key eager)."""
        drop = drop_replay_rows if attn_ctx is not None else 0
        static = graph_key(sample, timesteps, context, added_cond, drop)
        if static not in self.keys and len(self.keys) >= MAX_KEYS:
            self.release()
        key = self.keys.setdefault(static, _Key())
        if key.schedule is None and key.warm < WARMUP_FORWARDS:
            key.warm += 1
            _scope.current = _Warmup(key)
            try:
                return unet._forward(sample, torch.as_tensor(timesteps, device=sample.device), context, attn_ctx,
                                     drop, added_cond)
            finally:
                _scope.current = None
        if key.schedule is None:
            self._capture(key, unet, sample, timesteps, context, attn_ctx, drop, added_cond)
        else:
            _copy_in(key.inputs, sample, timesteps, context, added_cond)
            for item in key.schedule:
                if isinstance(item, _Call):
                    item.run(attn_ctx)
                else:
                    item.replay()
            replayed(key.launched)
        profiling.count("unet.graphed")
        return None if key.out is None else key.out.clone()

    def _capture(self, key: _Key, unet, sample, timesteps, context, attn_ctx, drop: int, added_cond) -> None:
        """Capture the key's pieces in a forward whose values are real (each
        piece replayed once captured) on a side stream."""
        with torch.inference_mode(False):  # static tensors any later forward may write, in or out of inference mode
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            if self.staging is None or self.staging.numel() < key.staging:
                self.staging = torch.empty(key.staging, dtype=torch.uint8, device=sample.device)

            def static(x):
                return torch.empty(x.shape, dtype=x.dtype, device=sample.device)

            t = timesteps if isinstance(timesteps, torch.Tensor) else torch.as_tensor(timesteps)
            key.inputs = {"sample": static(sample), "t": static(t), "context": static(context),
                          "added": None if added_cond is None else {n: static(x) for n, x in added_cond.items()}}
        _copy_in(key.inputs, sample, timesteps, context, added_cond)
        s = key.inputs
        statics = (s["sample"], s["t"], s["context"], *(s["added"] or {}).values())
        stable = {x.untyped_storage().data_ptr() for x in statics}
        capture = _Capture(self.pool, self.staging, stable)
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            _scope.current = capture
            try:
                capture.begin()
                out = unet._forward(s["sample"], s["t"], s["context"], attn_ctx, drop, s["added"])
                capture.end()
            except BaseException:
                capture.abort()
                raise
            finally:
                _scope.current = None
        main.wait_stream(side)
        release_workspaces()
        torch.cuda.empty_cache()  # the blocks the eager calls cached on the side stream serve no later work
        key.schedule, key.out, key.launched = capture.schedule, out, capture.launched


def _copy_in(inputs: Dict, sample, timesteps, context, added_cond) -> None:
    inputs["sample"].copy_(sample)
    if isinstance(timesteps, torch.Tensor):
        inputs["t"].copy_(timesteps)
    else:
        inputs["t"].fill_(timesteps)
    inputs["context"].copy_(context)
    for n, x in (added_cond or {}).items():
        inputs["added"][n].copy_(x)
