"""The (data, seq, tensor) device mesh over torch.distributed, and its collectives.

Counterpart of fatezero_tpu/parallel/sharding.py. The JAX package annotates
shardings and lets XLA's partitioner insert the collectives; the port is SPMD
with explicit collectives instead. One process runs per device (torchrun
launches them), and each holds

  data   — a replica: the edit shards no batch axis (the CFG rows stay
           together, as in the JAX package's inference paths);
  seq    — its contiguous block of the clip's frames;
  tensor — its block of attention heads and feed-forward columns (megatron:
           q/k/v and the GEGLU input split by columns, the output
           projections by rows and summed over the axis).

Collectives run only where frames or heads meet: the sparse-causal KV's halo
and anchor frame, the temporal conv's halo, the temporal attention's gather
of every frame, the GroupNorm statistics over frames, and the sum after each
row-split projection and over heads in the blend maps. Every one is an
`all_reduce` (sum) or a `broadcast`, the two collectives PyTorch's gloo
backend also takes on CUDA tensors; a gather is a sum over zero-padded slots,
which is exact. A collective on a meta tensor returns it unchanged: a meta
trace needs only the shapes.

Tuning differentiates through them (autograd Functions; where autograd
records nothing, as in the edit under inference mode, each is its forward
alone):

  * a sum over 'seq' (`_SeqSum`: the frame gathers, the halo, the anchor
    frame and the GroupNorm statistics) sums the gradient over 'seq' too:
    each seq rank's loss is its own frames' share of the total, so the sum
    returns every frame's gradient to the rank that owns it;
  * megatron's pair over 'tensor': f (`copy_to_tensor`, at the input of
    every column-split linear) is the identity forward and sums the gradient
    over the axis backward; g (the sum after a row-split linear) sums forward
    and passes the gradient through. The loss is the same on every tensor
    rank and counted once.

`tensor_gather`, `tensor_layout` and `unshard_state` assemble whole tensors
from the tensor-split weights (the trainer's optimizer and checkpoints).
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

AXES = ("data", "seq", "tensor")


class Mesh:
    """This process's place on a (data, seq, tensor) mesh: the axes' sizes, its
    coordinate on each, one process group per axis, and the collectives the
    models use. A mesh of one process has no groups and communicates nothing."""

    def __init__(self, shape: Sequence[int], device, device_mesh=None):
        self.shape = tuple(int(s) for s in shape)
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        if device_mesh is None:
            self.coords = {a: 0 for a in AXES}
            self.groups = {a: None for a in AXES}
        else:
            self.coords = {a: device_mesh.get_local_rank(a) for a in AXES}
            self.groups = {a: device_mesh.get_group(a) for a in AXES}

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(AXES, self.shape))}, rank {self.rank}, {self.device})"

    def size(self, axis: str) -> int:
        return self.shape[AXES.index(axis)]

    @property
    def seq(self) -> int:
        return self.size("seq")

    @property
    def tensor(self) -> int:
        return self.size("tensor")

    @property
    def seq_rank(self) -> int:
        return self.coords["seq"]

    @property
    def tensor_rank(self) -> int:
        return self.coords["tensor"]

    @property
    def rank(self) -> int:
        return dist.get_rank() if self.device_mesh is not None else 0

    @property
    def _host_values(self) -> torch.device:
        """Where small host values travel: NCCL moves only CUDA tensors."""
        return self.device if dist.get_backend() == "nccl" else torch.device("cpu")

    # ------------------------------------------------------------ collectives
    def _sum(self, buf: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
        """Sum `buf`, a tensor the caller owns, over `axis` (None: every rank) in place."""
        if buf.is_meta or self.device_mesh is None or (axis is not None and self.size(axis) == 1):
            return buf
        if not dist.is_initialized():  # a collective on a torn-down group would return buf unsummed
            raise RuntimeError("the mesh's process group has been destroyed")
        dist.all_reduce(buf, group=None if axis is None else self.groups[axis])
        return buf

    def tensor_sum(self, x: torch.Tensor) -> torch.Tensor:
        """`x` (a fresh tensor: summed in place) summed over the 'tensor' axis
        (megatron's g: the gradient passes through unsummed)."""
        return _TensorReduce.apply(x, self)

    def seq_sum(self, x: torch.Tensor) -> torch.Tensor:
        """`x` (a fresh tensor: summed in place) summed over the 'seq' axis;
        its gradient is summed over the axis alike."""
        return _SeqSum.apply(x, self)

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """`x` (a fresh tensor, not differentiated) summed over the 'data' axis in place."""
        return self._sum(x, "data")

    def without_seq(self) -> "Mesh":
        """This mesh with its frame split off: 'seq' reads as one device, so
        no halo or frame collective runs, and the 'tensor' split stays (the
        prior-preservation term's single-frame videos)."""
        view = copy.copy(self)
        view.shape = (self.shape[0], 1, self.shape[2])
        view.coords = dict(self.coords, seq=0)
        return view

    def local_frames(self, x, axis: int = 1):
        """This rank's block of `x`'s frames (tensor or numpy array); raises
        when the frame count does not split evenly over 'seq'."""
        n, s = x.shape[axis], self.seq
        if n % s:
            raise ValueError(f"{n} frames do not split over seq = {s} devices")
        fl = n // s
        index = [slice(None)] * x.ndim
        index[axis] = slice(self.seq_rank * fl, (self.seq_rank + 1) * fl)
        return x[tuple(index)]

    def all_frames(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """Every rank's frames of a frame-sharded `x`, in order, on every rank."""
        if self.seq == 1:
            return x
        fl = x.shape[axis]
        shape = list(x.shape)
        shape[axis] = fl * self.seq
        buf = x.new_zeros(shape)
        buf.narrow(axis, self.seq_rank * fl, fl).copy_(x)
        return self.seq_sum(buf)

    def frame_at(self, x: torch.Tensor, frame: int) -> torch.Tensor:
        """Global frame `frame` of a frame-sharded x [B, f, ...] as [B, 1, ...]
        on every rank: its owner contributes it and the others zeros (the
        masked sum of the JAX package's psum)."""
        fl = x.shape[1]
        owner, loc = divmod(int(frame), fl)
        mine = x[:, loc : loc + 1]
        # `where`, not a branch: every rank records the same operations, so
        # autograd runs the backward's collectives in one order on every rank
        buf = torch.where(x.new_full((), self.seq_rank == owner, dtype=torch.bool), mine, torch.zeros_like(mine))
        return self.seq_sum(buf)

    def neighbour_frames(self, x: torch.Tensor, left: int, right: int, ends=(None, None)):
        """The halo of a frame-sharded x [B, f, ...]: (the `left` frames just
        before this rank's block, the `right` frames just after it). Where the
        block ends the clip, `ends` stand there instead ([B, left, ...] and
        [B, right, ...]; zeros where None). One sum over slots: rank p fills
        slot p with its last `left` and first `right` frames. The clip's
        ends are chosen with `where`, so that every rank records the same
        operations and autograd runs the backward's collectives in one order
        on every rank."""
        s, p, fl = self.seq, self.seq_rank, x.shape[1]
        if max(left, right) > fl:
            raise ValueError(f"a halo of {max(left, right)} frames exceeds the {fl} frames a rank holds")
        lo_end, hi_end = (e if e is not None else x.new_zeros((x.shape[0], n, *x.shape[2:]))
                          for e, n in zip(ends, (left, right)))
        if s == 1:
            return lo_end, hi_end
        buf = x.new_zeros((s, x.shape[0], left + right, *x.shape[2:]))
        buf[p, :, :left] = x[:, fl - left :]
        buf[p, :, left:] = x[:, :right]
        buf = self.seq_sum(buf)
        first, last = (x.new_full((), edge, dtype=torch.bool) for edge in (p == 0, p == s - 1))
        lo = torch.where(first, lo_end, buf[max(p - 1, 0), :, :left])
        hi = torch.where(last, hi_end, buf[min(p + 1, s - 1), :, left:])
        return lo, hi

    def max_over_ranks(self, value: int) -> int:
        """The largest of every rank's `value` (an int), on every rank."""
        if self.device_mesh is None:
            return int(value)
        buf = torch.zeros(math.prod(self.shape), dtype=torch.int64, device=self._host_values)
        buf[self.rank] = int(value)
        return int(self._sum(buf, None).max())

    def broadcast_object(self, obj):
        """Rank 0's `obj` (picklable) on every rank."""
        if self.device_mesh is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, device=self._host_values)
        return box[0]


class _SeqSum(torch.autograd.Function):
    """Sum over 'seq' forward; the gradient summed over 'seq' backward."""

    @staticmethod
    def forward(ctx, buf, mesh):
        ctx.mesh = mesh
        ctx.mark_dirty(buf)
        return mesh._sum(buf, "seq")

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._sum(g.clone(memory_format=torch.contiguous_format), "seq"), None


class _TensorReduce(torch.autograd.Function):
    """Megatron's g: sum over 'tensor' forward, the identity backward."""

    @staticmethod
    def forward(ctx, buf, mesh):
        ctx.mark_dirty(buf)
        return mesh._sum(buf, "tensor")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToTensor(torch.autograd.Function):
    """Megatron's f: the identity forward, the gradient summed over 'tensor' backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._sum(g.clone(memory_format=torch.contiguous_format), "tensor"), None


# The mesh the models run under, set by FateZeroPipeline around its methods
# (the JAX package's ambient seq mesh, read there at trace time). The video
# ops, norms and attention read it at call time: None runs the one-device
# forms.
_SEQ_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar("fatezero_torch_mesh", default=None)


@contextlib.contextmanager
def seq_mesh_scope(mesh: Optional[Mesh]):
    token = _SEQ_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _SEQ_MESH.reset(token)


def current_seq_mesh() -> Optional[Mesh]:
    return _SEQ_MESH.get()


def global_frames(f: int) -> int:
    """The clip's frame count, from the `f` frames this rank holds."""
    mesh = current_seq_mesh()
    return f if mesh is None else f * mesh.seq


def tensor_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` (a fresh tensor) summed over the ambient mesh's 'tensor' axis."""
    mesh = current_seq_mesh()
    return x if mesh is None else mesh.tensor_sum(x)


def tensor_size() -> int:
    mesh = current_seq_mesh()
    return 1 if mesh is None else mesh.tensor


def row_parallel_linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`lin(x)` for a Linear whose input features are split over 'tensor'
    (shard_unet_): the partial products summed over the axis (g), the bias
    added once after the sum."""
    mesh = current_seq_mesh()
    if mesh is None or mesh.tensor == 1:
        return lin(x)
    y = mesh.tensor_sum(F.linear(x, lin.weight))
    return y if lin.bias is None else y + lin.bias


def copy_to_tensor(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f on the input of a column-split linear: x itself, whose
    gradient is summed over the ambient mesh's 'tensor' axis."""
    mesh = current_seq_mesh()
    if mesh is None or mesh.tensor == 1:
        return x
    return _CopyToTensor.apply(x, mesh)


# ------------------------------------------------------------------ set-up
def local_device(device="cuda") -> torch.device:
    """`cuda:LOCAL_RANK` under a launcher that sets LOCAL_RANK (torchrun) for a
    bare "cuda"; any other device as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def maybe_initialize_distributed(device="cuda", backend: Optional[str] = None, force: bool = False,
                                 init_method: Optional[str] = None) -> bool:
    """Join the launcher's process group: torchrun's RANK, WORLD_SIZE and
    (through the default env:// rendezvous) MASTER_ADDR and MASTER_PORT take
    the place of the JAX package's coordinator variables. The backend follows
    the device: NCCL for cuda, gloo for the CPU; `backend` overrides it (the
    dry run shares one card between gloo ranks). Returns False, doing
    nothing, in a plain single-process run unless `force`."""
    if dist.is_initialized():
        return True
    have_env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if not (force or have_env):
        return False
    if not have_env:
        raise RuntimeError("a distributed run needs RANK and WORLD_SIZE in the environment (torchrun sets them)")
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=init_method or "env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
    )
    return True


def make_mesh(shape: Optional[Sequence[int]] = None, device="cuda") -> Mesh:
    """The mesh over every process of the group; by default (1, n // t, t) with
    t = 2 when the n processes are even, as in the JAX package. A mesh of more
    than one process needs the process group (maybe_initialize_distributed)."""
    device = torch.device(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        tensor = 2 if n % 2 == 0 and n >= 2 else 1
        shape = (1, n // tensor, tensor)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError(f"mesh shape must be (data, seq, tensor), got {shape}")
    if math.prod(shape) > 1 and not dist.is_initialized():
        raise RuntimeError(f"a mesh of {math.prod(shape)} devices needs a process group; launch with torchrun")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not hold the {n} processes of the group")
    if not dist.is_initialized():
        return Mesh(shape, device)
    from torch.distributed.device_mesh import init_device_mesh

    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(shape, device, init_device_mesh(device.type, shape, mesh_dim_names=AXES))


def mesh_from_config(cfg, device="cuda") -> Mesh:
    """A mesh from a `sharding:` config block or a `--mesh` value.

    Accepted forms, as in the JAX package:
      * dict: `{mesh: [data, seq, tensor] | "auto", distributed: bool}`
      * str:  `"1,4,2"` (shape) or `"auto"` (the default split of every process)
    """
    if isinstance(cfg, str):
        cfg = {"mesh": cfg}
    cfg = dict(cfg or {})
    maybe_initialize_distributed(device, force=bool(cfg.get("distributed")))
    shape = cfg.get("mesh", "auto")
    if isinstance(shape, str):
        shape = None if shape.strip().lower() == "auto" else [int(x) for x in shape.replace("x", ",").split(",")]
    return make_mesh(shape, local_device(device))


# ------------------------------------------------------------ tensor split
def _keep_rows(lin: nn.Linear, blocks) -> None:
    """Keep the output features `blocks` (slices) of a Linear, in order."""
    w = torch.cat([lin.weight.detach()[b] for b in blocks])
    lin.weight = nn.Parameter(w.clone(), requires_grad=lin.weight.requires_grad)
    if lin.bias is not None:
        b = torch.cat([lin.bias.detach()[b] for b in blocks])
        lin.bias = nn.Parameter(b.clone(), requires_grad=lin.bias.requires_grad)
    lin.out_features = w.shape[0]


def _keep_cols(lin: nn.Linear, block: slice) -> None:
    """Keep the input features `block` of a Linear (its bias stays whole)."""
    w = lin.weight.detach()[:, block]
    lin.weight = nn.Parameter(w.clone(), requires_grad=lin.weight.requires_grad)
    lin.in_features = w.shape[1]


def _block(n: int, parts: int, rank: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{n} {what} do not split over tensor = {parts} devices")
    m = n // parts
    return slice(rank * m, (rank + 1) * m)


def shard_unet_(unet: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's part of the UNet's tensor-parallel weights, in place
    (the counterpart of unet_param_specs + shard_params): each attention's
    to_q/to_k/to_v keep its head block's columns and to_out the matching
    rows; each GEGLU projection keeps its column block of both halves, h and
    gate (chunk(2) then splits the local output the same way), and net.2 the
    matching rows. Convs, norms and embeddings stay whole. The state dict
    loaded before (convert/from_flax.py) is the global one. Raises when a head
    count or the feed-forward width does not split over 'tensor'."""
    from fatezero_tpu_torch.models.attention import Attention, TemporalAttention
    from fatezero_tpu_torch.models.layers import FeedForward

    if getattr(unet, "tensor_shards", 1) != 1:
        raise ValueError("the UNet is already sharded")
    t, r = mesh.tensor, mesh.tensor_rank
    if t > 1:
        for m in unet.modules():
            if isinstance(m, (Attention, TemporalAttention)):
                heads = _block(m.heads, t, r, "attention heads")
                cols = slice(heads.start * m.dim_head, heads.stop * m.dim_head)
                for lin in (m.to_q, m.to_k, m.to_v):
                    _keep_rows(lin, [cols])
                _keep_cols(m.to_out[0], cols)
                m.heads //= t
            elif isinstance(m, FeedForward):
                proj = m.net[0].proj
                inner = proj.out_features // 2
                cols = _block(inner, t, r, "feed-forward columns")
                _keep_rows(proj, [cols, slice(inner + cols.start, inner + cols.stop)])
                _keep_cols(m.net[2], cols)
    unet.tensor_shards = t
    return unet


# ------------------------------------------------------- whole tensors
def tensor_layout(unet: nn.Module) -> Dict[str, Tuple[int, int]]:
    """{parameter name: (dim, chunks)} of every parameter shard_unet_ splits
    over 'tensor': the dim split, and the number of equal chunks that split
    alike (2 for a GEGLU projection's h and gate halves, else 1). Parameters
    not named stay whole on every rank."""
    from fatezero_tpu_torch.models.attention import Attention, TemporalAttention
    from fatezero_tpu_torch.models.layers import FeedForward

    out = {}
    for prefix, m in unet.named_modules():
        pre = f"{prefix}." if prefix else ""
        if isinstance(m, (Attention, TemporalAttention)):
            for lin in ("to_q", "to_k", "to_v"):
                out[f"{pre}{lin}.weight"] = (0, 1)
            out[f"{pre}to_out.0.weight"] = (1, 1)
        elif isinstance(m, FeedForward):
            out[f"{pre}net.0.proj.weight"] = (0, 2)
            out[f"{pre}net.0.proj.bias"] = (0, 2)
            out[f"{pre}net.2.weight"] = (1, 1)
    return out


def tensor_gather(x: torch.Tensor, dim: int, chunks: int = 1, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The whole tensor of which `x` is this rank's block along `dim` (in
    `chunks` equal chunks, each split alike), on every rank: a sum over
    zero-padded slots, exact. Not differentiated."""
    mesh = mesh if mesh is not None else current_seq_mesh()
    if mesh is None or mesh.tensor == 1:
        return x
    t, r = mesh.tensor, mesh.tensor_rank
    parts = []
    for part in x.chunk(chunks, dim):
        n = part.shape[dim]
        shape = list(part.shape)
        shape[dim] = n * t
        buf = part.new_zeros(shape)
        buf.narrow(dim, r * n, n).copy_(part)
        parts.append(mesh._sum(buf, "tensor"))
    return torch.cat(parts, dim) if chunks > 1 else parts[0]


def tensor_block(x: torch.Tensor, dim: int, chunks: int = 1, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's block of a whole tensor: the inverse of tensor_gather."""
    mesh = mesh if mesh is not None else current_seq_mesh()
    if mesh is None or mesh.tensor == 1:
        return x
    parts = []
    for part in x.chunk(chunks, dim):
        block = _block(part.shape[dim], mesh.tensor, mesh.tensor_rank, "features")
        parts.append(part.narrow(dim, block.start, block.stop - block.start))
    return torch.cat(parts, dim) if chunks > 1 else parts[0]


def unshard_state(unet: nn.Module, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The UNet's whole state dict on every rank: the inverse of shard_unet_,
    the split linears gathered over 'tensor' (a collective: every rank calls
    it). Checkpoints are written from it."""
    state = {k: v.detach() for k, v in unet.state_dict().items()}
    if mesh is None or getattr(unet, "tensor_shards", 1) == 1:
        return state
    for name, (dim, chunks) in tensor_layout(unet).items():
        state[name] = tensor_gather(state[name], dim, chunks, mesh)
    return state
