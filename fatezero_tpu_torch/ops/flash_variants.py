"""The two flash-forward variants of the TPU probe scripts: K1b and K1c.

Neither runs on the edit or tuning paths; each runs on the probe that defines
it (``fatezero_tpu_torch/scripts``), as in the JAX package.

* ``flash_bf16`` (K1b, csrc/flash_fwd_bf16.cu) is K1 with bf16 operands into
  both products, the counterpart of scripts/bench_flash_variants.py's
  ``flash_bf16``: P is rounded to one bf16 term relative to the running max of
  its KV tile, so the result depends on the tile. Its plain version
  ``flash_bf16_reference`` takes the tile as ``block_kv``; the kernel's tile is
  ``K1B_BLOCK_KV``.
* ``flash_merged`` (K1c, csrc/flash_fwd_merged.cu) is K1's function on
  merged-head operands [R, S, H*D], the counterpart of
  scripts/bench_kernel_boundary.py's ``_fwd_call_merged``. Its plain version
  is ``merged_attention_reference``.

On a CUDA tensor each wrapper launches its kernel or raises, and counts its
launches in ``.launches``; a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from fatezero_tpu_torch import csrc
from fatezero_tpu_torch.ops.flash_attention import (
    _DTYPES, MAX_HEAD_DIM, _check_scale, _positive_scale, _stream, library_plan, xla_attention,
)

K1B_BLOCK_KV = 64  # csrc/flash_fwd.cuh MMA_BK: the KV tile K1b rounds P in
NEG_INF = -1e30  # the kernels' mask value


def flash_bf16_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, block_kv: int) -> torch.Tensor:
    """Plain version of K1b: the online softmax over KV tiles of `block_kv` keys.

    q is rounded to bf16 after scaling, k and v are rounded to bf16; S
    accumulates in fp32; p = exp(S - m_new) in fp32 with m_new the running
    max, l sums the unrounded p, and acc = acc * alpha + bf16(p) v in fp32.
    The output, acc / l, has q's dtype. A ragged last tile is shorter, which
    is what masking its missing keys to -1e30 gives.
    """
    bf16 = torch.bfloat16
    qb = (q.float() * scale).to(bf16).float()
    kb, vb = k.float().to(bf16).float(), v.float().to(bf16).float()
    acc = torch.zeros(*q.shape[:-1], v.shape[-1], dtype=torch.float32, device=q.device)
    m = torch.full((*q.shape[:-1], 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    for k0 in range(0, k.shape[-2], block_kv):
        s = torch.matmul(qb, kb[..., k0:k0 + block_kv, :].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(bf16).float(), vb[..., k0:k0 + block_kv, :])
        m = m_new
    return (acc / l).to(q.dtype)


def merged_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """Plain version of K1c: `xla_attention` per head on column slices.

    q [R, Sq, H*D], k/v [R, Skv, H*D] -> [R, Sq, H*D] in q's dtype.
    """
    def split(t):
        return t.unflatten(-1, (heads, -1)).transpose(-2, -3)  # [R, H, S, D]

    out = xla_attention(split(q), split(k), split(v), scale)
    return out.transpose(-2, -3).flatten(-2)


@functools.cache
def _fn(source: str, name: str):
    fn = getattr(csrc.load(source), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name} takes [B, S, D] tensors, got {q.shape}, {k.shape}, {v.shape}")
    if not all(t.is_cuda and t.device == q.device for t in (k, v)):
        raise ValueError(f"{name}: every operand must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes fp32 or bf16 operands of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name} takes contiguous operands")
    if k.shape[0] != q.shape[0] or v.shape[:2] != k.shape[:2] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{name} shape mismatch: q {q.shape}, k {k.shape}, v {v.shape}")


def flash_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """K1b: [B, Sq, dv] in q's dtype from q [B, Sq, d], k [B, Skv, d], v [B, Skv, dv].

    fp32 or bf16 inputs, d <= 160 and dv <= 160. A CUDA tensor launches K1b or
    raises; a CPU tensor takes `flash_bf16_reference` with K1B_BLOCK_KV.
    """
    if not q.is_cuda:
        return flash_bf16_reference(q, k, v, scale, K1B_BLOCK_KV)
    _check("flash_bf16", q, k, v)
    b, sq, d = q.shape
    skv, dv = k.shape[1], v.shape[2]
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM or not 1 <= b <= 65535:
        raise ValueError(f"flash_bf16 supports d, dv <= {MAX_HEAD_DIM} and 1..65535 rows, got {q.shape}, {v.shape}")
    out = torch.empty((b, sq, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _fn("flash_fwd_bf16.cu", "fz_flash_fwd_bf16")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, skv, d, dv, float(scale), _DTYPES[q.dtype], _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd_bf16 launch failed with CUDA error {err}")
    flash_bf16.launches += 1
    return out


def flash_merged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """K1c: softmax per head over merged-head operands, [R, Sq, H*D] in q's dtype.

    q [R, Sq, H*D], k/v [R, Skv, H*D]; head h is columns h*D..(h+1)*D-1. fp32
    or bf16, D <= 160, any scale but NaN. A CUDA tensor launches K1c or
    raises; a CPU tensor takes `merged_attention_reference`.
    """
    _check_scale(scale)
    if not q.is_cuda:
        return merged_attention_reference(q, k, v, scale, heads)
    _check("flash_merged", q, k, v)
    q, scale = _positive_scale(q, scale)
    r, sq, hd = q.shape
    d = hd // heads if heads > 0 else 0
    if d < 1 or d * heads != hd or v.shape[2] != hd or d > MAX_HEAD_DIM or r * heads > 65535:
        raise ValueError(f"flash_merged takes H*D columns with D <= {MAX_HEAD_DIM} and R*H <= 65535, "
                         f"got {q.shape}, {v.shape} with {heads} heads")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fn("flash_fwd_merged.cu", "fz_flash_fwd_merged")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            r, heads, sq, k.shape[1], d, float(scale), _DTYPES[q.dtype], _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd_merged launch failed with CUDA error {err}")
    flash_merged.launches += 1
    return out


def flash_bf16_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    """What `flash_bf16` launches for these CUDA operands (`kernel_plan`'s keys)."""
    _check("flash_bf16", q, k, v)
    return library_plan("flash_fwd_bf16.cu", "fz_flash_fwd_bf16_plan", q, k, v, q.shape[2], v.shape[2])


def flash_merged_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> dict:
    """What `flash_merged` launches for these CUDA operands (`kernel_plan`'s keys)."""
    _check("flash_merged", q, k, v)
    d = q.shape[2] // heads
    return library_plan("flash_fwd_merged.cu", "fz_flash_fwd_merged_plan", q, k, v, d, d)


flash_bf16.launches = 0
flash_merged.launches = 0
