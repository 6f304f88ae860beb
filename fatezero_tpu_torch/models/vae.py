"""AutoencoderKL (the Stable-Diffusion VAE) for per-frame encode/decode (torch).

Counterpart of fatezero_tpu/models/vae.py, with diffusers parameter names
(encoder.down_blocks.0.resnets.0.conv1.weight, ...; the mid-block attention
uses the older group_norm/query/key/value/proj_attn names). Images are
[N, H, W, 3] in [-1, 1] (N folds batch*frames); latents are [N, H/8, W/8, 4],
unscaled (callers apply the 0.18215 factor). The mid-block attention is plain
torch math in fp32, as the reference's is plain einsum math.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fatezero_tpu_torch.models.layers import FusedGroupNorm
from fatezero_tpu_torch.models.resnet import conv2d_nhwc

VAE_SCALE = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = VAE_SCALE


class Conv2dNHWC(nn.Conv2d):
    """Conv2d taking and returning channels-last [N, H, W, C] tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.weight, self.bias, self.stride, self.padding)


class VAEResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = FusedGroupNorm(groups, cin, 1e-6, **kw)
        self.conv1 = Conv2dNHWC(cin, cout, 3, padding=1, **kw)
        self.norm2 = FusedGroupNorm(groups, cout, 1e-6, **kw)
        self.conv2 = Conv2dNHWC(cout, cout, 3, padding=1, **kw)
        self.conv_shortcut = Conv2dNHWC(cin, cout, 1, **kw) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head full self-attention over spatial tokens, fp32 softmax."""

    def __init__(self, channels: int, groups: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.group_norm = FusedGroupNorm(groups, channels, 1e-6, **kw)
        self.query = nn.Linear(channels, channels, **kw)
        self.key = nn.Linear(channels, channels, **kw)
        self.value = nn.Linear(channels, channels, **kw)
        self.proj_attn = nn.Linear(channels, channels, **kw)

    def forward(self, x):
        b, h, w, c = x.shape
        t = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = self.query(t).float(), self.key(t).float(), self.value(t).float()
        attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)) * c**-0.5, dim=-1)
        out = self.proj_attn(torch.matmul(attn, v).to(self.dtype))
        return x + out.reshape(b, h, w, c)


class _Block(nn.Module):
    def __init__(self, resnets, sampler=None, sampler_name=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class _Sampler(nn.Module):
    """Holds the resampling conv as `.conv` (diffusers naming)."""

    def __init__(self, conv):
        super().__init__()
        self.conv = conv


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.resnets = nn.ModuleList([VAEResnetBlock(ch, ch, groups, **kw), VAEResnetBlock(ch, ch, groups, **kw)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups, **kw)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        g = cfg.norm_num_groups
        chs = cfg.block_out_channels
        self.conv_in = Conv2dNHWC(cfg.in_channels, chs[0], 3, padding=1, **kw)
        self.down_blocks = nn.ModuleList()
        cin = chs[0]
        for i, ch in enumerate(chs):
            resnets = [VAEResnetBlock(cin if j == 0 else ch, ch, g, **kw) for j in range(cfg.layers_per_block)]
            sampler = None
            if i < len(chs) - 1:
                # stride-2 conv after an asymmetric (0, 1) pad
                sampler = _Sampler(Conv2dNHWC(ch, ch, 3, stride=2, **kw))
            self.down_blocks.append(_Block(resnets, sampler, "downsamplers"))
            cin = ch
        self.mid_block = _MidBlock(chs[-1], g, dtype, device)
        self.conv_norm_out = FusedGroupNorm(g, chs[-1], 1e-6, **kw)
        self.conv_out = Conv2dNHWC(chs[-1], 2 * cfg.latent_channels, 3, padding=1, **kw)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            for r in block.resnets:
                x = r(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0].conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        g = cfg.norm_num_groups
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = Conv2dNHWC(cfg.latent_channels, rev[0], 3, padding=1, **kw)
        self.mid_block = _MidBlock(rev[0], g, dtype, device)
        self.up_blocks = nn.ModuleList()
        cin = rev[0]
        for i, ch in enumerate(rev):
            resnets = [VAEResnetBlock(cin if j == 0 else ch, ch, g, **kw) for j in range(cfg.layers_per_block + 1)]
            sampler = _Sampler(Conv2dNHWC(ch, ch, 3, padding=1, **kw)) if i < len(rev) - 1 else None
            self.up_blocks.append(_Block(resnets, sampler, "upsamplers"))
            cin = ch
        self.conv_norm_out = FusedGroupNorm(g, rev[-1], 1e-6, **kw)
        self.conv_out = Conv2dNHWC(rev[-1], cfg.out_channels, 3, padding=1, **kw)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            for r in block.resnets:
                x = r(x)
            if hasattr(block, "upsamplers"):
                x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                x = block.upsamplers[0].conv(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """encode(images) -> (mean, logvar); decode(latents) -> images."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.dtype = dtype
        self.encoder = Encoder(cfg, **kw)
        self.decoder = Decoder(cfg, **kw)
        self.quant_conv = Conv2dNHWC(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, **kw)
        self.post_quant_conv = Conv2dNHWC(cfg.latent_channels, cfg.latent_channels, 1, **kw)

    def encode(self, images: torch.Tensor):
        moments = self.quant_conv(self.encoder(images.to(self.dtype)))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(latents.to(self.dtype)))
