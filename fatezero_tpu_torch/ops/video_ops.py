"""Primitives for pseudo-3D video networks on channels-last [B, F, H, W, C] tensors.

Counterpart of fatezero_tpu/ops/video_ops.py. The temporal Conv1d over
frames is a sum of k frame-shifted matmuls; the sparse-causal frame gathers
are static index lists.

Under a mesh whose 'seq' axis splits the frames (parallel/sharding.py's
ambient mesh) each rank holds a block of frames, and the ops that read
across frames exchange them: the temporal conv and the sparse-causal gather's
int offsets take their neighbours' boundary frames (the halo; zeros, or the
clamped end frame, at the clip's ends only), an anchor frame comes from the
rank that owns it, and whatever the halo cannot serve (a hop past the
neighbour, a stride-2 temporal resample) gathers every frame and keeps this
rank's block of the result.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from fatezero_tpu_torch.parallel.sharding import current_seq_mesh, seq_mesh_scope


def _pad_frames(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the frame axis (dim 1) of a 5-D tensor by `pad` on both sides."""
    return F.pad(x, (0, 0, 0, 0, 0, 0, pad, pad))


def _seq_mesh():
    """The ambient mesh when its 'seq' axis splits the frames, else None."""
    mesh = current_seq_mesh()
    return mesh if mesh is not None and mesh.seq > 1 else None


def _whole_clip(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """fn over every frame of the clip, then this rank's block of its output:
    the form, under a seq mesh, of the ops whose output frames do not follow
    the blocks (a stride-2 temporal resample)."""
    mesh = _seq_mesh()
    full = mesh.all_frames(x)
    with seq_mesh_scope(None):
        out = fn(full, *args)
    return mesh.local_frames(out)


def _padded(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x with `pad` frames on each side: zeros beyond the clip's ends, and
    under a seq mesh the neighbouring ranks' frames between blocks."""
    mesh = _seq_mesh()
    if mesh is None or pad == 0:
        return _pad_frames(x, pad)
    lo, hi = mesh.neighbour_frames(x, pad, pad)
    return torch.cat([lo, x, hi], dim=1)


def temporal_conv(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, stride: int = 1
) -> torch.Tensor:
    """Channel-mixing conv over the frame axis as shifted matmuls.

    x: [B, F, H, W, C_in]; w: [k, C_in, C_out] ('same' zero padding, as
    nn.Conv1d(padding=k//2)); b: [C_out] or None.
    Returns [B, F_out, H, W, C_out] with F_out = (F + 2*(k//2) - k)//stride + 1.
    """
    if stride != 1 and _seq_mesh() is not None:
        return _whole_clip(temporal_conv, x, w, b, stride)
    k = w.shape[0]
    pad = k // 2
    xp = _padded(x, pad)
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
    if _seq_mesh() is not None:
        return _whole_clip(temporal_avgpool, x, kernel, stride)
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
    if _seq_mesh() is not None:
        return _whole_clip(temporal_linear_upsample_2x, x)
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
    selected source frame, concatenated along the token axis. `num_frames` is
    the clip's; under a seq mesh kv holds this rank's block of its frames."""
    return torch.cat(_sparse_sources(kv, index_spec, num_frames), dim=2)


def _frames_at(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """x[:, idx] for a static index array, made of views of x: each run of one
    frame repeated an expanded slice, each run of consecutive frames a slice.
    No index reaches the device, so a CUDA graph can capture it."""
    parts, i, n = [], 0, len(idx)
    while i < n:
        j = i + 1
        if j < n and idx[j] == idx[i]:
            while j < n and idx[j] == idx[i]:
                j += 1
            parts.append(x[:, idx[i] : idx[i] + 1].expand(x.shape[0], j - i, *x.shape[2:]))
        else:
            while j < n and idx[j] == idx[j - 1] + 1:
                j += 1
            parts.append(x[:, idx[i] : idx[i] + j - i])
        i = j
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _sparse_sources(x: torch.Tensor, index_spec, num_frames: int) -> List[torch.Tensor]:
    """Per index-spec entry, the source frame of each of this rank's query
    frames: [B, f, ...] each, for x [B, f, ...] (f = num_frames without a seq
    mesh). Under one, an int offset reads its neighbour's boundary frames
    (clamped at the clip's ends) and an anchor the rank that owns it; an
    offset past the neighbour gathers every frame."""
    mesh = _seq_mesh()
    if mesh is None:
        return [_frames_at(x, idx) for idx in sparse_frame_indices(num_frames, index_spec)]
    fl = x.shape[1]
    if fl * mesh.seq != num_frames:
        raise ValueError(f"{fl} frames a rank on a seq = {mesh.seq} mesh do not make a clip of {num_frames}")
    p = mesh.seq_rank
    parts = []
    for index, idx in zip(index_spec, sparse_frame_indices(num_frames, index_spec)):
        if isinstance(index, str):
            parts.append(mesh.frame_at(x, int(idx[0])).expand(x.shape[0], fl, *x.shape[2:]))
        elif abs(int(index)) > fl:  # a hop past the neighbour: every frame
            local = torch.as_tensor(idx[p * fl : (p + 1) * fl], device=x.device)
            parts.append(mesh.all_frames(x)[:, local])
        elif int(index) == 0:
            parts.append(x)
        elif int(index) < 0:
            m = -int(index)
            clamp = x[:, :1].expand(x.shape[0], m, *x.shape[2:])  # frame 0, before the clip
            head, _ = mesh.neighbour_frames(x, m, 0, ends=(clamp, None))
            parts.append(torch.cat([head, x[:, : fl - m]], dim=1))
        else:
            m = int(index)
            clamp = x[:, -1:].expand(x.shape[0], m, *x.shape[2:])  # the last frame, after the clip
            _, tail = mesh.neighbour_frames(x, 0, m, ends=(None, clamp))
            parts.append(torch.cat([x[:, m:], tail], dim=1))
    return parts


def referenced_frames(num_frames: int, index_spec) -> List[int]:
    """Sorted unique source frames any query frame gathers from (static)."""
    idx_list = sparse_frame_indices(num_frames, index_spec)
    return sorted({int(i) for arr in idx_list for i in arr})


def local_referenced_frames(num_frames: int, index_spec) -> List[int]:
    """The referenced frames this rank holds, as positions in its block: what
    the sparse-causal K dedup stores here. Under a seq mesh each referenced
    frame is stored once, by its owner (['mid'] leaves the other ranks none)."""
    mesh = _seq_mesh()
    refs = referenced_frames(num_frames, index_spec)
    if mesh is None:
        return refs
    fl = num_frames // mesh.seq
    lo = mesh.seq_rank * fl
    return [g - lo for g in refs if lo <= g < lo + fl]


def regather_headsplit_kv(
    kv_sel: torch.Tensor, index_spec, num_frames: int, heads: int
) -> torch.Tensor:
    """Rebuild the post-gather head-split KV from its referenced-frame subset.

    kv_sel: [b, n_ref, heads, S, d], the head-split per-frame KV of the frames
    `local_referenced_frames` returns, in that order. Returns
    [b, f, heads, k*S, d], identical to head-splitting gather_sparse_kv's
    output: the stored frames are put in place in a zero K of this rank's
    frames, and the gather (under a seq mesh, the halo) reads only them.
    """
    mesh = _seq_mesh()
    f = num_frames if mesh is None else num_frames // mesh.seq
    full = kv_sel.new_zeros((kv_sel.shape[0], f, *kv_sel.shape[2:]))
    full[:, local_referenced_frames(num_frames, index_spec)] = kv_sel
    return torch.cat(_sparse_sources(full, index_spec, num_frames), dim=-2)
