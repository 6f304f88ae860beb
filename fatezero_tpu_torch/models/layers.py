"""Shared layers: timestep embeddings, the GEGLU feed-forward and the norms.

Counterpart of fatezero_tpu/models/layers.py, with diffusers parameter names.
Linear layers hold their weights in the model dtype; norm gains and biases
stay fp32 and the norms compute fp32 statistics (ops/fused_norm.py).
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from fatezero_tpu_torch.common.profiling import spanned
from fatezero_tpu_torch.ops.fused_norm import _ln_math, group_norm, layer_norm
from fatezero_tpu_torch.parallel.sharding import copy_to_tensor, current_seq_mesh, row_parallel_linear


def get_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers `Timesteps`), fp32 [B, dim]."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP over the sinusoidal embedding."""

    def __init__(self, in_channels: int, time_embed_dim: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.linear_1 = nn.Linear(in_channels, time_embed_dim, **kw)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim, **kw)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class GEGLU(nn.Module):
    """proj -> [h | gate] -> h * gelu(gate). Under tensor parallelism each rank
    holds the same column block of both halves (parallel/sharding.py)."""

    def __init__(self, dim_in: int, dim_out: int, dtype=torch.float32, device=None):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward, mult=4; `net.1` is diffusers' (parameter-free) dropout.
    Under tensor parallelism `net.0.proj` is column-split, its input marked
    with megatron's f, and `net.2` row-split: its partial products are
    summed over the 'tensor' axis (g) and its bias added once."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32, device=None):
        super().__init__()
        self.net = nn.ModuleList(
            [
                GEGLU(dim, dim * mult, dtype=dtype, device=device),
                nn.Identity(),
                nn.Linear(dim * mult, dim, dtype=dtype, device=device),
            ]
        )

    @spanned("fz.unet.feed_forward")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_parallel_linear(self.net[2], self.net[0](copy_to_tensor(x)))


def layer_norm_takes_k4() -> bool:
    """Whether LayerNorms take the LayerNorm kernel K4
    (ops/fused_norm.py::layer_norm). As in the JAX package, FZ_PALLAS_LN=1
    (read at each call) routes them through it; the default is the plain
    math."""
    return bool(os.environ.get("FZ_PALLAS_LN"))


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 E[x^2]-E[x]^2 statistics
    (eps 1e-5, torch nn.LayerNorm's default); output in the model dtype,
    through K4 where `layer_norm_takes_k4`."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if layer_norm_takes_k4():
            return layer_norm(x, self.weight, self.bias, self.eps).to(self.dtype)
        return _ln_math(x, self.weight, self.bias, self.eps).to(self.dtype)


class FusedGroupNorm(nn.Module):
    """GroupNorm over [..., C] inputs; statistics per sample over everything
    past the first `batch_dims` axes (batch_dims=1 is torch's GroupNorm on a
    [B, F, H, W, C] video: statistics over frames x space; batch_dims=2 keeps
    per-(batch, frame) statistics). A video's statistics over frames are
    summed over a seq mesh's frame blocks (their gradient alike, in tuning);
    the VAE's 4-D images and the per-frame form stay local."""

    def __init__(
        self,
        num_groups: int,
        num_channels: int,
        eps: float = 1e-5,
        batch_dims: int = 1,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.batch_dims = batch_dims
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    @spanned("fz.unet.group_norm")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        folded = x.reshape(*x.shape[: self.batch_dims], -1, c)
        mesh = current_seq_mesh()
        over_frames = self.batch_dims == 1 and x.dim() == 5 and mesh is not None and mesh.seq > 1
        out = group_norm(folded, self.weight, self.bias, self.num_groups, self.eps,
                         stats_sum=mesh.seq_sum if over_frames else None)
        return out.reshape(x.shape).to(self.dtype)
