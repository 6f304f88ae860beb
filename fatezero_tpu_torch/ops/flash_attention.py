"""Flash-attention forward (K1) for the large, never-edited attention maps.

Counterpart of fatezero_tpu/ops/flash_attention.py. Every attention site with
at least 256 query tokens that is not materialised runs here: the 64x64
self- and cross-attention sites, and the value-space self swap and cross edit
at the 32x32 and 16x16 sites (including their double-wide V).

* ``flash_attention`` launches the hand-written CUDA kernel
  (csrc/flash_fwd.cu) on a CUDA tensor; on a CPU tensor it computes the same
  function with its plain version, ``xla_attention``.
* ``fused_attention`` is the dispatch rule of the JAX package: 256 queries or
  more go to ``flash_attention``; fewer go to the plain math on any device.

Only the forward is ported; the backward kernels (K2/K3) wait for tuning.
"""
from __future__ import annotations

import ctypes

import torch

from fatezero_tpu_torch import csrc

FLASH_MIN_QUERIES = 256
MAX_HEAD_DIM = 160
MAX_VALUE_DIM = 320
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain attention with an fp32 softmax; the reference K1 is held against.

    Leading dims broadcast (e.g. 5-D [b, f, h, s, d] queries against a
    frame-broadcast [b, 1, h, kv, d] cross context). Output has q's dtype.
    """
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = csrc.load("flash_fwd.cu")
    fn = lib.fz_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attention takes [B, S, D] tensors, got {q.shape}, {k.shape}, {v.shape}")
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes fp32 or bf16 q/k/v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k and v")
    b, _, d = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[2] != d or v.shape[1] != k.shape[1]:
        raise ValueError(f"flash_attention shape mismatch: q {q.shape}, k {k.shape}, v {v.shape}")
    if d > MAX_HEAD_DIM or v.shape[2] > MAX_VALUE_DIM:
        raise ValueError(f"flash_attention supports d <= {MAX_HEAD_DIM}, dv <= {MAX_VALUE_DIM}")
    if not 1 <= b <= 65535:
        raise ValueError(f"flash_attention supports 1..65535 folded rows, got {b}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v without materialising scores.

    q: [B, Sq, d]; k: [B, Skv, d]; v: [B, Skv, dv] (B folds batch*frames*heads).
    On a CUDA tensor this launches K1 or raises; a CPU tensor takes the plain
    version. Returns [B, Sq, dv] in q's dtype.
    """
    if not q.is_cuda:
        return xla_attention(q, k, v, scale)
    _check(q, k, v)
    fn = _library().fz_flash_fwd
    b, sq, d = q.shape
    skv, dv = k.shape[1], v.shape[2]
    out = torch.empty((b, sq, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, skv, d, dv, float(scale), _DTYPES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _fold_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Fold leading dims to kernel rows and run the flash kernel.

    A frame-broadcast K/V (e.g. [b, 1, h, 77, d] cross context) is expanded
    to q's leading dims first, which copies it.
    """
    lead = q.shape[:-2]
    if k.shape[:-2] != lead:
        k = k.expand(*lead, *k.shape[-2:])
        v = v.expand(*lead, *v.shape[-2:])
    out = flash_attention(
        q.reshape(-1, *q.shape[-2:]).contiguous(),
        k.reshape(-1, *k.shape[-2:]).contiguous(),
        v.reshape(-1, *v.shape[-2:]).contiguous(),
        scale,
    )
    return out.reshape(*lead, *out.shape[-2:])


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Dispatch: K1 for 256 queries or more, plain math below.

    q: [..., S, D]; k/v: [..., KV, D|Dv] with leading dims broadcastable
    against q's. With 256 queries or more, a CUDA tensor runs K1 and a CPU
    tensor its plain version; fewer queries take the plain math on either
    device, as in the JAX package.
    """
    if q.shape[-2] >= FLASH_MIN_QUERIES:
        return _fold_flash(q, k, v, scale)
    return xla_attention(q, k, v, scale)
