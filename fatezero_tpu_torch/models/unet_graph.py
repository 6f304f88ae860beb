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

Where `graph_engages` holds, each static key goes through the lifecycle of
the port's one CUDA-graph layer (ops/graph_capture.py). Its first forward
runs eagerly; the second captures the forward's own code on a side stream,
each piece between the begin and the end of its capture and replayed at
once, so that the module after it reads real values. Later forwards copy
their inputs into the key's static tensors and walk the schedule: replay
piece k, call module k, copy its output where piece k + 1 reads it, and so
on; the output is cloned, so the caller owns it. The attention modules get
the forward's own controller. Another parameter or buffer object or
storage, or another submodule, drops every graph (`load_state_dict` copies
in place: the graphs read the new values).

Memory: the pieces of every key capture into one pool. Each forward is
self-contained (inputs copied in, the output cloned out) and nothing but an
eager module runs between two pieces, which allocates outside the pool, so a
later capture may reuse what an earlier one freed. What a module reads and
returns crosses the pieces in a staging buffer: the first input, and after
the module has returned its output, at offset 0, other inputs past it. So
the buffer holds one call's values, not one per call; its size is the most
that the warm-up forwards since the last release staged, and a key keeps the
buffer it was captured with. Inputs that are views of the static inputs (the
context) are passed as they are. The pool stays reserved while the graphs
live (about one forward's activations at the largest key), beside the
allocator's cache. `PiecewiseGraphs.release` drops every graph, the pool and
the staging buffers and empties the cache: a forward with grad on (training)
and each `DDPMTrainer.step` call it, and a key past the `MAX_KEYS`-th drops
the others first (an edit drives 2 to 4).
"""
from __future__ import annotations

import threading
from typing import List, Optional

import torch
from torch import nn

from fatezero_tpu_torch.common import profiling
from fatezero_tpu_torch.models.layers import layer_norm_takes_k4
from fatezero_tpu_torch.ops.graph_capture import Entry, GraphCache, engages, static_key

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
    """Whether `unet`'s forward on `device` runs as piecewise CUDA graphs:
    where the layer's rule holds (ops/graph_capture.py::engages) over the
    modules that the pieces run, with grad off (tuning stays eager, and the
    trainer's own graph captures it) and no temporal downsampling (its
    upsample copies indices to the device)."""
    return (not torch.is_grad_enabled() and unet.cfg.temporal_downsample_time == 0
            and engages(device, lambda: unet._graphs.piece_modules(unet)))


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

    def __call__(self, attn_ctx) -> None:
        kwargs = {**self.kwargs, "attn_ctx": attn_ctx} if "attn_ctx" in self.kwargs else self.kwargs
        self.out.copy_(self.module(*self.args, **kwargs))


class _Warmup:
    """An eager forward that measures what its module calls would stage."""

    def __init__(self, graphs: "PiecewiseGraphs"):
        self.graphs = graphs

    def call(self, module, args, kwargs):
        staged = sum(_aligned(_nbytes(t)) for t in (*args, *kwargs.values()) if isinstance(t, torch.Tensor))
        out = module(*args, **kwargs)
        self.graphs.staged = max(self.graphs.staged, staged, _nbytes(out))
        return out


class _Staging:
    """A forward's capture under way (`entry`): each eager module's call
    ends a piece and begins the next, its tensors crossing in `staging`."""

    def __init__(self, entry: Entry, staging: torch.Tensor, stable: set):
        self.entry, self.staging, self.stable = entry, staging, stable

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
        self.entry.end()
        out = module(*args, **kwargs)
        view = self._view(0, out)
        view.copy_(out)
        self.entry.schedule.append(_Call(module, args, kwargs, view))
        self.entry.begin()
        return view


class PiecewiseGraphs(GraphCache):
    """A UNet's piecewise CUDA graphs: the layer's cache of `MAX_KEYS` keys
    and their pool, the staging buffer the keys share, and the UNet's
    `_Layout` they were captured on. The UNet keeps one (`unet._graphs`)."""

    def __init__(self):
        super().__init__(MAX_KEYS)
        self.layout: Optional[_Layout] = None
        self.staging: Optional[torch.Tensor] = None
        self.staged = 0  # bytes the warm-up forwards staged at most

    def piece_modules(self, unet) -> List[torch.nn.Module]:
        """The modules the pieces run. A UNet whose modules or tensors
        changed first drops every graph."""
        if self.layout is None or not self.layout.holds():
            self.release()
            self.layout = _Layout(unet)
        return self.layout.piece_modules

    def release(self) -> None:
        """The layer's release (`GraphCache.release`), with the staging buffer."""
        super().release()
        if self.pool is None:
            self.staging, self.staged = None, 0

    def forward(self, unet, sample, timesteps, context, attn_ctx, drop_replay_rows: int, added_cond):
        """`unet`'s forward as piecewise graphs (the first of a key eager)."""
        drop = drop_replay_rows if attn_ctx is not None else 0
        inputs = dict(sample=sample, t=timesteps, context=context, added=added_cond)
        entry = self.entry(static_key(inputs, drop, layer_norm_takes_k4()))
        if entry.warming():
            _scope.current = _Warmup(self)
            try:
                return unet._forward(sample, torch.as_tensor(timesteps, device=sample.device), context, attn_ctx,
                                     drop, added_cond)
            finally:
                _scope.current = None
        if entry.schedule is None:  # capture the key's pieces in a forward whose values are real
            device = sample.device
            if self.staging is None or self.staging.numel() < self.staged:
                with torch.inference_mode(False):  # later forwards write it, in or out of inference mode
                    self.staging = torch.empty(self.staged, dtype=torch.uint8, device=device)
            with self.capture(entry, inputs, device):
                s = entry.inputs
                statics = (s["sample"], s["t"], s["context"], *(s["added"] or {}).values())
                _scope.current = _Staging(entry, self.staging, {x.untyped_storage().data_ptr() for x in statics})
                try:
                    entry.outputs = unet._forward(s["sample"], s["t"], s["context"], attn_ctx, drop, s["added"])
                finally:
                    _scope.current = None
        else:
            entry.replay(inputs, attn_ctx)
        profiling.count("unet.graphed")
        return None if entry.outputs is None else entry.outputs.clone()
