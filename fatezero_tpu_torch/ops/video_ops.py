"""Primitives for pseudo-3D video networks on channels-last [B, F, H, W, C] tensors.

Counterpart of fatezero_tpu/ops/video_ops.py (single-device forms; the
halo-exchange gather for frame-sharded meshes is not ported yet). The
temporal Conv1d over frames is a sum of k frame-shifted matmuls; the
sparse-causal frame gathers are static index lists.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F


def _pad_frames(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the frame axis (dim 1) of a 5-D tensor by `pad` on both sides."""
    return F.pad(x, (0, 0, 0, 0, 0, 0, pad, pad))


def temporal_conv(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, stride: int = 1
) -> torch.Tensor:
    """Channel-mixing conv over the frame axis as shifted matmuls.

    x: [B, F, H, W, C_in]; w: [k, C_in, C_out] ('same' zero padding, as
    nn.Conv1d(padding=k//2)); b: [C_out] or None.
    Returns [B, F_out, H, W, C_out] with F_out = (F + 2*(k//2) - k)//stride + 1.
    """
    k = w.shape[0]
    pad = k // 2
    xp = _pad_frames(x, pad)
    f_out = (x.shape[1] + 2 * pad - k) // stride + 1
    out = None
    for j in range(k):
        xs = xp[:, j : j + stride * (f_out - 1) + 1 : stride]
        y = torch.matmul(xs, w[j].to(xs.dtype))
        out = y if out is None else out + y
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def temporal_avgpool(x: torch.Tensor, kernel: int = 3, stride: int = 2) -> torch.Tensor:
    """AvgPool1d over frames, count_include_pad=True."""
    pad = kernel // 2
    xp = _pad_frames(x, pad)
    f_out = (x.shape[1] + 2 * pad - kernel) // stride + 1
    out = None
    for j in range(kernel):
        xs = xp[:, j : j + stride * (f_out - 1) + 1 : stride]
        out = xs if out is None else out + xs
    return out / float(kernel)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample on [B, F, H, W, C]."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def temporal_linear_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Linear 2x upsample along frames (F.interpolate mode='linear',
    align_corners=False)."""
    f = x.shape[1]
    pos = (np.arange(2 * f) + 0.5) / 2.0 - 0.5
    lo = np.clip(np.floor(pos).astype(np.int64), 0, f - 1)
    hi = np.clip(lo + 1, 0, f - 1)
    wgt = np.clip(pos - lo, 0.0, 1.0).astype(np.float32)
    wgt = torch.as_tensor(wgt, device=x.device).to(x.dtype)[None, :, None, None, None]
    lo_t = torch.as_tensor(lo, device=x.device)
    hi_t = torch.as_tensor(hi, device=x.device)
    return x[:, lo_t] * (1.0 - wgt) + x[:, hi_t] * wgt


def avgpool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 spatial average pool, stride 2, on [B, F, H, W, C]."""
    b, f, h, w, c = x.shape
    return x.reshape(b, f, h // 2, 2, w // 2, 2, c).mean(dim=(3, 5))


def sparse_frame_indices(
    num_frames: int, index_spec: Sequence[Union[int, str]]
) -> List[np.ndarray]:
    """Static per-frame KV source indices for SparseCausalAttention.

    Ints are relative offsets clipped to [0, F-1]; 'first'/'last'/'mid' are
    anchors. Returns one int array of shape [F] per entry.
    """
    out = []
    for index in index_spec:
        if isinstance(index, str):
            if index == "first":
                fi = np.zeros(num_frames, np.int64)
            elif index == "last":
                fi = np.full(num_frames, num_frames - 1, np.int64)
            elif index in ("mid", "middle"):
                fi = np.full(num_frames, (num_frames - 1) // 2, np.int64)
            else:
                raise ValueError(f"unknown frame anchor {index!r}")
        else:
            fi = np.clip(np.arange(num_frames) + int(index), 0, num_frames - 1)
        out.append(fi)
    return out


def gather_sparse_kv(kv: torch.Tensor, index_spec, num_frames: int) -> torch.Tensor:
    """kv [B, F, S, C] -> [B, F, len(index_spec)*S, C]: the tokens of each
    selected source frame, concatenated along the token axis."""
    idx_list = sparse_frame_indices(num_frames, index_spec)
    return torch.cat([kv[:, torch.as_tensor(idx, device=kv.device)] for idx in idx_list], dim=2)


def referenced_frames(num_frames: int, index_spec) -> List[int]:
    """Sorted unique source frames any query frame gathers from (static)."""
    idx_list = sparse_frame_indices(num_frames, index_spec)
    return sorted({int(i) for arr in idx_list for i in arr})


def regather_headsplit_kv(
    kv_sel: torch.Tensor, index_spec, num_frames: int, heads: int
) -> torch.Tensor:
    """Rebuild the post-gather head-split KV from its referenced-frame subset.

    kv_sel: [b, n_ref, heads, S, d], the head-split per-frame KV of the frames
    `referenced_frames` returns, in that order. Returns [b, F, heads, k*S, d],
    identical to head-splitting gather_sparse_kv's output.
    """
    refs = referenced_frames(num_frames, index_spec)
    pos = {fi: p for p, fi in enumerate(refs)}
    idx_list = sparse_frame_indices(num_frames, index_spec)
    per_frame = []
    for fi in range(num_frames):
        parts = [kv_sel[:, pos[int(arr[fi])]] for arr in idx_list]  # [b, h, s, d]
        per_frame.append(torch.cat(parts, dim=-2))  # [b, h, k*s, d]
    return torch.stack(per_frame, dim=1)  # [b, F, h, k*s, d]
