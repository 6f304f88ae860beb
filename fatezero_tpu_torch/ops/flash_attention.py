"""Flash attention (K1 forward, K2/K3 backward) for the large, never-edited maps.

Counterpart of fatezero_tpu/ops/flash_attention.py. Every attention site with
at least 256 query tokens that is not materialised runs here: the 64x64
self- and cross-attention sites, and the value-space self swap and cross edit
at the 32x32 and 16x16 sites (including their double-wide V); under tuning,
the same sites carry gradients.

* ``flash_attention`` is differentiable: the JAX package's ``custom_vjp``
  becomes ``FlashAttention``, a ``torch.autograd.Function`` whose forward
  also keeps the fp32 log-sum-exp and whose backward recomputes the
  probabilities from it. Without gradients it runs the forward alone.
* On a CUDA tensor each step launches a hand-written kernel or raises:
  ``flash_forward`` K1 (csrc/flash_fwd.cu), ``flash_dq`` K2 and
  ``flash_dkv`` K3 (csrc/flash_bwd.cu). Each counts its launches in
  ``.launches``. On a CPU tensor they compute the same function with the
  plain versions, ``attention_with_lse`` and ``flash_bwd_reference``.
* ``kernel_plan`` mirrors, in plain Python, which forward kernel the C entry
  points choose for a call (CUDA cores or tensor cores, which tile loader,
  tile sizes, ring stages, shared bytes); ``flash_forward_plan`` asks the
  built library the same question, so a run can show the two agree.
  ``bwd_kernel_plan`` and ``flash_bwd_plan`` do the same for K2 and K3.
* ``fused_attention`` is the dispatch rule of the JAX package: 256 queries or
  more go to ``flash_attention``; fewer go to the plain math on any device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from fatezero_tpu_torch import csrc

FLASH_MIN_QUERIES = 256
MAX_HEAD_DIM = 160
MAX_VALUE_DIM = 320
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# csrc/flash_fwd.cuh's constants, by their names there (tests/test_torch_flash_plan.py
# parses the header and holds these to it)
MMA_BK = 64
MMA_PAD = 8
MMA_SMALL_DK = 5
MMA_SMALL_DVN = 10
MMA_WARPS_SMALL = 8
MMA_WARPS_LARGE = 4
MMA_STAGES_SMALL = 3
MMA_STAGES_LARGE = 2
WG_WARPS = 8
WG_STAGES = 3
WG_BAR_BYTES = 128
SMEM_LIMIT = 232448
BQ = 32
BK = 64
# csrc/flash_bwd.cu's constants (the same test holds these to that file)
BWD_SMALL_DK = 5
BWD_NARROW_DK = 3
BWD_STAGES_SMALL = 3
BWD_STAGES_LARGE = 2
DKV_STAGES = 3
DQ_WARPS = 8
DQ_BK = 64
DKV_WARPS_NARROW = 8
DKV_WARPS = 4
DKV_BQ_NARROW = 64
DKV_BQ_SMALL = 32
DKV_BQ_LARGE = 16
F_ROWS = 32
F_TILE = 64
# what the C entry points report in plan[0] and plan[1] (fz_flash_fwd_plan, fz_flash_bwd_plan)
PATHS = ("fma", "mma.sync", "wgmma")
LOADERS = ("element", "staged", "async")


def kernel_plan(d: int, dv: int, dtype: torch.dtype, aligned: bool = True, merged: bool = False,
                bf16_p: bool = False) -> dict:
    """Which forward kernel a call takes: the C dispatch of csrc/flash_fwd*.cu in Python.

    `merged` is K1c's layout, `bf16_p` K1b's numerics, neither is K1; `aligned`
    says that q, k, v and o all start on 16-byte boundaries. Returns path
    ("fma": fp32 on CUDA cores; "wgmma": bf16 tensor cores by warpgroup
    products, for aligned bf16 operands at the small head dims; "mma.sync":
    bf16 tensor cores otherwise), loader
    ("async": 16-byte cp.async into the ring; "staged": 16-byte loads of fp32
    rounded through registers; "element": one element at a time, for operands
    that are misaligned or whose widths are no multiples of 8), queries per
    block, keys per KV tile, ring stages and dynamic shared bytes.
    """
    if dtype not in _DTYPES:
        raise TypeError(f"the flash kernels take fp32 or bf16, got {dtype}")
    bf16 = dtype == torch.bfloat16
    if merged:
        dv = d
    if d < 1 or d > MAX_HEAD_DIM or dv < 1 or dv > (MAX_HEAD_DIM if merged or bf16_p else MAX_VALUE_DIM):
        raise ValueError(f"no flash kernel takes d {d}, dv {dv}")
    if not (bf16_p or (bf16 and dv <= 160)):
        smem = 4 * (BQ * (d + 1) + BK * (d + 1) + BK * dv + BQ * BK)
        return dict(path="fma", loader="element", block_q=BQ, block_kv=BK, stages=1, smem_bytes=smem)
    dk = 3 if d <= 48 else 5 if d <= 80 else 10  # 16-wide k-steps of the head dim
    dvn = 5 if dv <= 40 else 10 if dv <= 80 else 20  # 8-wide n-tiles of V
    small = dk <= MMA_SMALL_DK and dvn <= MMA_SMALL_DVN
    warps = MMA_WARPS_SMALL if small else MMA_WARPS_LARGE
    stages = MMA_STAGES_SMALL if small else MMA_STAGES_LARGE
    qs = 16 * dk + MMA_PAD
    vs = 8 * dvn + (0 if dvn % 2 else MMA_PAD)
    chunked = aligned and d % 8 == 0 and dv % 8 == 0
    loader = "element" if not chunked else "async" if bf16 else "staged"
    wgmma = chunked and bf16 and small
    if wgmma:  # its own block shape; unpadded core-matrix K and V tiles behind the ring's barriers
        warps, stages = WG_WARPS, WG_STAGES
        smem = WG_BAR_BYTES + 2 * (16 * warps * qs + stages * MMA_BK * (16 * dk + 8 * dvn))
    else:
        smem = 2 * (16 * warps * qs + stages * MMA_BK * (qs + vs))
    return dict(path="wgmma" if wgmma else "mma.sync", loader=loader, block_q=16 * warps, block_kv=MMA_BK, stages=stages, smem_bytes=smem)


def bwd_kernel_plan(kernel: str, d: int, dtype: torch.dtype, aligned: bool = True) -> dict:
    """Which backward kernel a call takes: the C dispatch of csrc/flash_bwd.cu in Python.

    `kernel` is "dq" (K2) or "dkv" (K3); `aligned` says that q, k, v, o and dO
    all start on 16-byte boundaries. Returns `kernel_plan`'s keys: path ("fma"
    for fp32, else "mma.sync"), loader ("async": 16-byte cp.async; "element":
    misaligned operands or a d that is no multiple of 8), block_q and block_kv
    (K2 owns block_q queries and streams tiles of block_kv keys, K3 owns
    block_kv keys and streams tiles of block_q queries), ring stages and
    dynamic shared bytes.
    """
    if kernel not in ("dq", "dkv"):
        raise ValueError(f"the backward kernels are dq and dkv, got {kernel}")
    if dtype not in _DTYPES:
        raise TypeError(f"the flash kernels take fp32 or bf16, got {dtype}")
    if d < 1 or d > MAX_HEAD_DIM:
        raise ValueError(f"no flash backward kernel takes d {d}")
    if dtype == torch.float32:
        if kernel == "dq":
            smem = 4 * (2 * F_ROWS * (d + 1) + 2 * F_TILE * (d + 1) + F_ROWS * F_TILE)
            return dict(path="fma", loader="element", block_q=F_ROWS, block_kv=F_TILE, stages=1, smem_bytes=smem)
        smem = 4 * (2 * F_ROWS * (d + 1) + 2 * F_TILE * (d + 1) + 2 * F_ROWS * F_TILE + 2 * F_TILE)
        return dict(path="fma", loader="element", block_q=F_TILE, block_kv=F_ROWS, stages=1, smem_bytes=smem)
    dk = 3 if d <= 40 else 5 if d <= 80 else 10  # 16-wide k-steps of the head dim
    small, narrow = dk <= BWD_SMALL_DK, dk <= BWD_NARROW_DK
    qs = 16 * dk + MMA_PAD
    loader = "async" if aligned and d % 8 == 0 else "element"
    if kernel == "dq":
        stages = BWD_STAGES_SMALL if small else BWD_STAGES_LARGE
        bq, bk = 16 * DQ_WARPS, DQ_BK
        smem = 2 * (2 * bq * qs + stages * 2 * bk * qs) + 4 * bq
    else:  # each ring slot holds Q, dO and O
        stages = DKV_STAGES
        bq = DKV_BQ_NARROW if narrow else DKV_BQ_SMALL if small else DKV_BQ_LARGE
        bk = 16 * (DKV_WARPS_NARROW if narrow else DKV_WARPS)
        smem = 2 * (2 * bk * qs + stages * (3 * bq * qs + 4 * bq))
    return dict(path="mma.sync", loader=loader, block_q=bq, block_kv=bk, stages=stages, smem_bytes=smem)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain attention with an fp32 softmax; the reference K1 is held against.

    Leading dims broadcast (e.g. 5-D [b, f, h, s, d] queries against a
    frame-broadcast [b, 1, h, kv, d] cross context). Output has q's dtype.
    """
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 under differentiation: (o in q's dtype, fp32 lse [B, Sq])."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v.float())
    return o.to(q.dtype), lse


def flash_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2 and K3: the `_dq_kernel`/`_dkv_kernel` formulas in fp32.

    P = exp(scale q k^T - lse); delta = rowsum(dO o O); dS = P o (dO v^T - delta);
    dq = scale dS k, dk = scale dS^T q, dv = P^T dO. Each gradient has its
    input's dtype.
    """
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _fwd_fn():
    fn = csrc.load("flash_fwd.cu").fz_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn(name: str):
    fn = getattr(csrc.load("flash_bwd.cu"), name)
    pointers = 7 if name == "fz_flash_bwd_dq" else 8
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more: torch.Tensor) -> None:
    """Raise on what the kernels do not take. `more` are further [B, Sq, d]-like
    tensors (o, dO) that must share q's device, dtype and contiguity."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attention takes [B, S, D] tensors, got {q.shape}, {k.shape}, {v.shape}")
    ts = (q, k, v, *more)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("flash_attention: every operand must lie on one CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"flash_attention takes fp32 or bf16 operands of one dtype, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention takes contiguous operands")
    b, _, d = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[2] != d or v.shape[1] != k.shape[1]:
        raise ValueError(f"flash_attention shape mismatch: q {q.shape}, k {k.shape}, v {v.shape}")
    if d > MAX_HEAD_DIM or v.shape[2] > MAX_VALUE_DIM:
        raise ValueError(f"flash_attention supports d <= {MAX_HEAD_DIM}, dv <= {MAX_VALUE_DIM}")
    if not 1 <= b <= 65535:
        raise ValueError(f"flash_attention supports 1..65535 folded rows, got {b}")


def library_plan(source: str, name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d: int, dv: int) -> dict:
    """Ask csrc/<source>'s entry point `name` (an fz_*_plan) what it would launch
    for these CUDA operands; the answer has `kernel_plan`'s keys. o is allocated
    by the wrappers, always on a 16-byte boundary, and is passed as null."""
    fn = getattr(csrc.load(source), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, d, dv, _DTYPES[q.dtype], out)
    if err != 0:
        raise RuntimeError(f"{name} refused d {d}, dv {dv}, {q.dtype} with CUDA error {err}")
    return dict(path=PATHS[out[0]], loader=LOADERS[out[1]], block_q=out[2], block_kv=out[3], stages=out[4],
                smem_bytes=out[5])


def flash_forward_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    """What `flash_forward` launches for these CUDA operands, from the built library."""
    _check(q, k, v)
    return library_plan("flash_fwd.cu", "fz_flash_fwd_plan", q, k, v, q.shape[2], v.shape[2])


def flash_bwd_plan(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   do: torch.Tensor) -> dict:
    """What `flash_dq` ("dq") or `flash_dkv` ("dkv") launches for these CUDA
    operands, from the built library (`bwd_kernel_plan`'s keys)."""
    _check(q, k, v, o, do)
    fn = csrc.load("flash_bwd.cu").fz_flash_bwd_plan
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    d = q.shape[2]
    err = fn(1 if kernel == "dkv" else 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), d,
             _DTYPES[q.dtype], out)
    if err != 0:
        raise RuntimeError(f"fz_flash_bwd_plan refused {kernel}, d {d}, {q.dtype} with CUDA error {err}")
    return dict(path=PATHS[out[0]], loader=LOADERS[out[1]], block_q=out[2], block_kv=out[3], stages=out[4],
                smem_bytes=out[5])


def _check_scale(scale: float) -> None:
    """K1 and K1c take any scale but NaN, on either device, as the JAX kernels do."""
    if scale != scale:
        raise ValueError(f"K1 and K1c take a scale that is a number, got {scale}")


def _positive_scale(q: torch.Tensor, scale: float) -> Tuple[torch.Tensor, float]:
    """(q, scale) with the same product q k^T * scale and a positive scale.

    K1 and K1c take the running max of the unscaled scores, which is the max
    of the scaled ones only for a positive scale, and their C entry points
    refuse any other. q k^T * scale = (-q) k^T * (-scale), and negation is
    exact in bf16 and fp32, so a negative scale launches with -q and -scale
    and gives the same output and log-sum-exp. At scale 0 every weight is 1
    (a uniform softmax over the keys); the kernels would also weigh the ragged
    KV tail's masked keys there, so q becomes zeros and the scale 1, whose
    scores are all 0 as well."""
    if scale > 0:
        return q, scale
    if scale < 0:
        return -q, -scale
    return torch.zeros_like(q), 1.0


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, with_lse: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1: (o [B, Sq, dv] in q's dtype, fp32 lse [B, Sq] or None).

    On a CUDA tensor this launches K1 or raises; a CPU tensor takes the plain
    version. The log-sum-exp is written only when asked for (differentiation).
    Any scale but NaN.
    """
    _check_scale(scale)
    if not q.is_cuda:
        if with_lse:
            return attention_with_lse(q, k, v, scale)
        return xla_attention(q, k, v, scale), None
    _check(q, k, v)
    q, scale = _positive_scale(q, scale)
    fn = _fwd_fn()
    b, sq, d = q.shape
    skv, dv = k.shape[1], v.shape[2]
    out = torch.empty((b, sq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, sq, skv, d, dv, float(scale), _DTYPES[q.dtype], _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {err}")
    flash_forward.launches += 1
    return out, lse


def _no_wide_v(q: torch.Tensor, v: torch.Tensor) -> None:
    if v.shape[-1] != q.shape[-1]:
        raise NotImplementedError(
            "flash_attention backward requires matching q/v head dims; the "
            "wide-V forward (value-space edit) is an inference-only path"
        )


def _check_bwd(q, k, v, o, lse, do) -> None:
    _check(q, k, v, o, do)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash backward: o {o.shape} and dO {do.shape} must match q {q.shape}")
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash backward takes a contiguous fp32 lse {tuple(q.shape[:2])} on q's device")


def flash_dq(q, k, v, o, lse, do, scale: float) -> torch.Tensor:
    """K2: dq [B, Sq, d] in q's dtype. A CUDA tensor launches K2 or raises."""
    _no_wide_v(q, v)
    if not q.is_cuda:
        return flash_bwd_reference(q, k, v, o, lse, do, scale)[0]
    _check_bwd(q, k, v, o, lse, do)
    b, sq, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _bwd_fn("fz_flash_bwd_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), b, sq, k.shape[1], d, float(scale), _DTYPES[q.dtype], _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"flash_bwd dq launch failed with CUDA error {err}")
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, o, lse, do, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dk, dv) [B, Skv, d] in k's dtype. A CUDA tensor launches K3 or raises."""
    _no_wide_v(q, v)
    if not q.is_cuda:
        return flash_bwd_reference(q, k, v, o, lse, do, scale)[1:]
    _check_bwd(q, k, v, o, lse, do)
    b, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _bwd_fn("fz_flash_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1], d, float(scale), _DTYPES[q.dtype],
            _stream(q),
        )
    if err != 0:
        raise RuntimeError(f"flash_bwd dkv launch failed with CUDA error {err}")
    flash_dkv.launches += 1
    return dk, dv


flash_forward.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """softmax(q k^T * scale) v with the flash backward (JAX `_flash` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq = flash_dq(q, k, v, o, lse, do, ctx.scale)
        dk, dv = flash_dkv(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v without materialising scores; differentiable.

    q: [B, Sq, d]; k: [B, Skv, d]; v: [B, Skv, dv] (B folds batch*frames*heads).
    Returns [B, Sq, dv] in q's dtype. Under autograd the result carries the
    flash backward (K2/K3 on the card); otherwise the forward runs alone.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale)
    return flash_forward(q, k, v, scale)[0]


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
    against q's. With 256 queries or more, a CUDA tensor runs K1 (and K2/K3
    under autograd) and a CPU tensor their plain versions; fewer queries take
    the plain math on either device, as in the JAX package.
    """
    if q.shape[-2] >= FLASH_MIN_QUERIES:
        return _fold_flash(q, k, v, scale)
    return xla_attention(q, k, v, scale)
