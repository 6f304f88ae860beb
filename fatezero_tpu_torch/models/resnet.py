"""Pseudo-3D convolution / resnet stack on channels-last video tensors.

Counterpart of fatezero_tpu/models/resnet.py, with diffusers/FateZero
parameter names: a PseudoConv3d holds its spatial Conv2d weight as
`weight`/`bias` and its temporal part as `conv_temporal` (a Conv1d, or the
LoRA pair `conv_temporal.down`/`conv_temporal.up`). All tensors are
[B, F, H, W, C]; the spatial conv runs on a channels-last NCHW view, so no
layout copy is made around it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fatezero_tpu_torch.common.profiling import spanned
from fatezero_tpu_torch.models.layers import FusedGroupNorm
from fatezero_tpu_torch.ops.video_ops import (
    temporal_avgpool,
    temporal_conv,
    temporal_linear_upsample_2x,
    upsample_nearest_2x,
)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias, stride: int, padding: int) -> torch.Tensor:
    """Conv2d on [N, H, W, C] via a channels-last view; returns [N, H', W', C_out]."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


class TemporalLoRA(nn.Module):
    """Rank-r temporal LoRA pair: Conv1d down [r, C, 3] and up [C, r, 3]."""

    def __init__(self, channels: int, rank: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.down = nn.Conv1d(channels, rank, 3, padding=1, bias=False, **kw)
        self.up = nn.Conv1d(rank, channels, 3, padding=1, bias=False, **kw)
        nn.init.zeros_(self.up.weight)


class PseudoConv3d(nn.Conv2d):
    """Spatial Conv2d per frame + temporal conv over frames (identity init).

    kernel_size == 1 convs carry no temporal part. ``lora_rank`` switches the
    temporal part to the rank-r LoRA pair (rank clamped to C//2 when it
    exceeds C) with a zero up projection.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        temporal_downsample: bool = False,
        lora_rank: Optional[int] = None,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__(
            in_channels, out_channels, kernel_size, stride=stride,
            padding=kernel_size // 2, dtype=dtype, device=device,
        )
        self.temporal_stride = 2 if temporal_downsample else 1
        self.lora = False
        if kernel_size <= 1:
            self.conv_temporal = None
        elif lora_rank is not None:
            rank = lora_rank if lora_rank <= out_channels else out_channels // 2
            self.lora = True
            self.conv_temporal = TemporalLoRA(out_channels, rank, dtype=dtype, device=device)
        else:
            self.conv_temporal = nn.Conv1d(
                out_channels, out_channels, 3, padding=1, dtype=dtype, device=device
            )
            nn.init.dirac_(self.conv_temporal.weight)
            nn.init.zeros_(self.conv_temporal.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, h, w, c = x.shape
        y = conv2d_nhwc(x.reshape(b * f, h, w, c), self.weight, self.bias, self.stride, self.padding)
        y = y.reshape(b, f, *y.shape[1:])
        if self.conv_temporal is None:
            return y
        s = self.temporal_stride
        if self.lora:
            # Conv1d [out, in, k] -> temporal_conv's [k, in, out]
            down = self.conv_temporal.down.weight.permute(2, 1, 0)
            up = self.conv_temporal.up.weight.permute(2, 1, 0)
            delta = temporal_conv(temporal_conv(y, down, None, stride=s), up, None)
            skip = temporal_avgpool(y) if s == 2 else y
            return skip + delta
        wt = self.conv_temporal.weight.permute(2, 1, 0)
        return temporal_conv(y, wt, self.conv_temporal.bias, stride=s)


class UpsamplePseudo3D(nn.Module):
    """Nearest 2x spatial upsample (+ linear 2x temporal when restoring a
    temporal downsample), then a pseudo-3D conv."""

    def __init__(self, channels: int, temporal_upsample: bool = False, lora_rank=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.temporal_upsample = temporal_upsample
        self.conv = PseudoConv3d(channels, channels, 3, lora_rank=lora_rank, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_nearest_2x(x)
        if self.temporal_upsample:
            x = temporal_linear_upsample_2x(x)
        return self.conv(x)


class DownsamplePseudo3D(nn.Module):
    """Stride-2 pseudo-3D conv (optionally stride-2 temporal)."""

    def __init__(self, channels: int, temporal_downsample: bool = False, lora_rank=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.conv = PseudoConv3d(
            channels, channels, 3, stride=2, temporal_downsample=temporal_downsample,
            lora_rank=lora_rank, dtype=dtype, device=device,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ResnetBlockPseudo3D(nn.Module):
    """GN/SiLU/conv x2 with the timestep-embedding add after conv1, and skip."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: int = 1280,
        groups: int = 32,
        eps: float = 1e-5,
        lora_rank: Optional[int] = None,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = FusedGroupNorm(groups, in_channels, eps, **kw)
        self.conv1 = PseudoConv3d(in_channels, out_channels, 3, lora_rank=lora_rank, **kw)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels, **kw)
        self.norm2 = FusedGroupNorm(groups, out_channels, eps, **kw)
        self.conv2 = PseudoConv3d(out_channels, out_channels, 3, lora_rank=lora_rank, **kw)
        self.conv_shortcut = (
            PseudoConv3d(in_channels, out_channels, 1, **kw) if in_channels != out_channels else None
        )

    @spanned("fz.unet.resnet")
    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h
