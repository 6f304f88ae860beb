"""LayerNorm / GroupNorm with fp32 statistics (torch), and the LayerNorm kernel K4.

Counterpart of fatezero_tpu/ops/fused_norm.py. All take fp32 statistics with
the variance written as E[x^2] - E[x]^2, as the JAX package does; torch's own
`layer_norm` and `group_norm` compute the variance another way, so the
formula is written out here.

* `_ln_math` and `group_norm` are the plain math the models run by default.
* `layer_norm` is the JAX package's custom-VJP LayerNorm: its forward
  launches K4 (csrc/layer_norm.cu) on a CUDA tensor, or raises, and runs
  `_ln_math` on a CPU tensor; its backward is autograd of `_ln_math`, as in
  the JAX package. The models take it behind FZ_PALLAS_LN=1
  (models/layers.py::FusedLayerNorm). `layer_norm_kernel` counts K4's
  launches in `.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from fatezero_tpu_torch import csrc

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 2048


def _ln_math(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis; fp32 statistics, output in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True) - mean.square()
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


@functools.cache
def _kernel_fn():
    fn = csrc.load("layer_norm.cu").fz_layer_norm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def layer_norm_kernel(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """K4 forward: `_ln_math` over the last axis of x in one pass. A CUDA tensor
    launches the kernel or raises; a CPU tensor takes `_ln_math`."""
    if not x.is_cuda:
        return _ln_math(x, scale, bias, eps)
    c = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm takes fp32 or bf16 x, got {x.dtype}")
    if not 1 <= c <= MAX_CHANNELS or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"layer_norm takes c <= {MAX_CHANNELS} with [c] scale/bias; got x {tuple(x.shape)}")
    if not all(t.is_cuda and t.device == x.device for t in (scale, bias)):
        raise ValueError("layer_norm: x, scale and bias must lie on one CUDA device")
    x2 = x.contiguous().reshape(-1, c)
    w = scale.float().contiguous()
    b = bias.float().contiguous()
    y = torch.empty_like(x2)
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), x2.shape[0], c, float(eps),
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"layer_norm launch failed with CUDA error {err}")
    layer_norm_kernel.launches += 1
    return y.reshape(x.shape)


layer_norm_kernel.launches = 0


class LayerNorm(torch.autograd.Function):
    """K4 forward; backward = autograd of `_ln_math` (JAX `_ln_vjp_bwd`)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return layer_norm_kernel(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            xs, ss, bs = (t.detach().requires_grad_() for t in (x, scale, bias))
            y = _ln_math(xs, ss, bs, ctx.eps)
            return (*torch.autograd.grad(y, (xs, ss, bs), g), None)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; x any rank, scale/bias [C]; output in x's dtype."""
    return LayerNorm.apply(x, scale, bias, eps)


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
