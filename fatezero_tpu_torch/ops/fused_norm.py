"""LayerNorm / GroupNorm math with fp32 statistics (torch).

Counterpart of the plain parts of fatezero_tpu/ops/fused_norm.py: `_ln_math`
and `group_norm`. Both take fp32 statistics with the variance written as
E[x^2] - E[x]^2, as the JAX package does; torch's own `layer_norm` and
`group_norm` compute the variance another way, so the formula is written
out here. The Pallas LayerNorm kernel (K4, opt-in behind FZ_PALLAS_LN in the
JAX package) is not ported yet.
"""
from __future__ import annotations

import torch


def _ln_math(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis; fp32 statistics, output in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True) - mean.square()
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def group_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int = 32, eps: float = 1e-5
) -> torch.Tensor:
    """GroupNorm; x [..., S, C] (S = folded spatial; leading dims = samples),
    scale/bias [C]. fp32 statistics per sample and group over S x C/groups."""
    *lead, s, c = x.shape
    xf = x.float()
    cg = c // groups
    n = s * cg
    gsum = xf.sum(dim=-2).reshape(*lead, groups, cg).sum(-1)  # [..., G]
    gsumsq = xf.square().sum(dim=-2).reshape(*lead, groups, cg).sum(-1)
    gmean = gsum / n
    grstd = torch.rsqrt(gsumsq / n - gmean.square() + eps)
    cmean = gmean.repeat_interleave(cg, dim=-1).unsqueeze(-2)  # [..., 1, C]
    crstd = grstd.repeat_interleave(cg, dim=-1).unsqueeze(-2)
    y = (xf - cmean) * crstd
    return (y * scale.float() + bias.float()).to(x.dtype)
