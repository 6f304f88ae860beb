"""Pseudo-3D conditional UNet (torch): the model the edit runs every step.

Counterpart of fatezero_tpu/models/unet3d.py: a 2-D Stable-Diffusion UNet
inflated with identity-initialised temporal convs and zero-initialised
temporal attention, with SparseCausalAttention in place of spatial
self-attention. Parameter names follow diffusers/FateZero
(down_blocks.0.resnets.0.conv1.weight, ...). The attention controller is
passed to ``forward`` and visits the controlled sites in the same order as
the JAX model (down, mid, up), so capture positions line up. With
``gradient_checkpointing`` (tuning) each down, mid and up block runs under
``torch.utils.checkpoint`` (non-reentrant), as the JAX model wraps them in
``nn.remat``: their activations are recomputed in the backward pass instead
of kept. As there, only when no attention controller is attached.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fatezero_tpu_torch.models.attention import SpatioTemporalTransformerModel
from fatezero_tpu_torch.models.layers import FusedGroupNorm, TimestepEmbedding, get_timestep_embedding
from fatezero_tpu_torch.models.resnet import (
    DownsamplePseudo3D,
    PseudoConv3d,
    ResnetBlockPseudo3D,
    UpsamplePseudo3D,
)
from fatezero_tpu_torch.ptp.context import MAX_CONTROLLED_TOKENS, AttnContext


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    """Static architecture config (diffusers unet config + FateZero model_config:
    lora / SparseCausalAttention_index / least_sc_channel / temporal_downsample_time)."""

    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlockPseudo3D",
        "CrossAttnDownBlockPseudo3D",
        "CrossAttnDownBlockPseudo3D",
        "DownBlockPseudo3D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlockPseudo3D",
        "CrossAttnUpBlockPseudo3D",
        "CrossAttnUpBlockPseudo3D",
        "CrossAttnUpBlockPseudo3D",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: int = 8  # diffusers legacy: number of heads
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    sparse_causal_indices: Tuple[Union[int, str], ...] = (-1, "first")
    least_sc_channel: int = 0
    temporal_downsample_time: int = 0
    lora: Optional[int] = None
    temporal_attention: bool = True
    # tuning-time recomputation of each down/mid/up block (reference
    # unet_3d_blocks.py:308-326); off while a controller records maps
    gradient_checkpointing: bool = False

    def block_sparse_indices(self, dim: int):
        """Frame-local self-attention (no gather) below least_sc_channel."""
        if self.least_sc_channel and dim < self.least_sc_channel:
            return ()
        return self.sparse_causal_indices


class _Blocks(nn.Module):
    """A down/mid/up block: resnets, optional transformers, optional resampler."""

    def __init__(self, resnets, attentions, sampler=None, sampler_name=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class UNetPseudo3DConditionModel(nn.Module):
    """forward(sample [B,F,H,W,C], timesteps [B] or scalar, encoder_hidden_states
    [B,77,C_cross], attn_ctx) -> fp32 eps prediction [B,F,H,W,C]."""

    def __init__(self, cfg: UNet3DConfig = UNet3DConfig(), dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        ch0 = cfg.block_out_channels[0]
        temb_ch = ch0 * 4
        heads = cfg.attention_head_dim

        def resnet(cin, cout):
            return ResnetBlockPseudo3D(
                cin, cout, temb_ch, cfg.norm_num_groups, cfg.norm_eps, cfg.lora, **kw
            )

        def transformer(ch):
            return SpatioTemporalTransformerModel(
                ch, heads, ch // heads, 1, cfg.cross_attention_dim, cfg.norm_num_groups,
                cfg.block_sparse_indices(ch), True, cfg.temporal_attention, **kw,
            )

        self.conv_in = PseudoConv3d(cfg.in_channels, ch0, 3, lora_rank=cfg.lora, **kw)
        self.time_embedding = TimestepEmbedding(ch0, temb_ch, **kw)

        n = len(cfg.down_block_types)
        skips = [ch0]  # channel count of each residual pushed on the skip stack
        cin = ch0
        self.down_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.down_block_types):
            is_final = i == n - 1
            t_down = (i >= n - cfg.temporal_downsample_time) and not is_final
            cout = cfg.block_out_channels[i]
            cross = block_type.startswith("CrossAttn")
            resnets, attns = [], []
            for j in range(cfg.layers_per_block):
                resnets.append(resnet(cin if j == 0 else cout, cout))
                if cross:
                    attns.append(transformer(cout))
                skips.append(cout)
            sampler = None
            if not is_final:
                sampler = DownsamplePseudo3D(cout, t_down, cfg.lora, **kw)
                skips.append(cout)
            self.down_blocks.append(_Blocks(resnets, attns, sampler, "downsamplers"))
            cin = cout

        cmid = cfg.block_out_channels[-1]
        self.mid_block = _Blocks([resnet(cmid, cmid), resnet(cmid, cmid)], [transformer(cmid)])

        rev = list(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        cin = cmid
        for i, block_type in enumerate(cfg.up_block_types):
            is_final = i == n - 1
            t_up = i < (cfg.temporal_downsample_time - 1)
            cout = rev[i]
            cross = block_type.startswith("CrossAttn")
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                resnets.append(resnet((cin if j == 0 else cout) + skips.pop(), cout))
                if cross:
                    attns.append(transformer(cout))
            sampler = None if is_final else UpsamplePseudo3D(cout, t_up, cfg.lora, **kw)
            self.up_blocks.append(_Blocks(resnets, attns, sampler, "upsamplers"))
            cin = cout

        self.conv_norm_out = FusedGroupNorm(cfg.norm_num_groups, ch0, cfg.norm_eps, **kw)
        self.conv_out = PseudoConv3d(ch0, cfg.out_channels, 3, lora_rank=cfg.lora, **kw)

    def forward(
        self,
        sample: torch.Tensor,
        timesteps,
        encoder_hidden_states: torch.Tensor,
        attn_ctx: Optional[AttnContext] = None,
        drop_replay_rows: int = 0,
    ) -> Optional[torch.Tensor]:
        """drop_replay_rows: the first N batch rows exist only to feed the
        controller's stored or edited maps (the inversion replay of the edit).
        No site above MAX_CONTROLLED_TOKENS queries is stored or edited, and
        the up blocks' resolution only grows, so from the first up block past
        that size those rows are sliced off. If every row is a replay row (a
        capture-only forward) the rest is skipped and None is returned: the
        caller reads ``attn_ctx.captured``. Where even the last up block is
        controlled, nothing is dropped."""
        cfg = self.cfg
        b = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(b)
        t_emb = get_timestep_embedding(
            timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift
        ).to(self.dtype)
        temb = self.time_embedding(t_emb)
        context = encoder_hidden_states.to(self.dtype)

        x = self.conv_in(sample.to(self.dtype))
        remat = cfg.gradient_checkpointing and attn_ctx is None and torch.is_grad_enabled()

        def run(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

        res_stack = [x]
        for block in self.down_blocks:
            x, res = run(self._down, block, x, temb, context, attn_ctx)
            res_stack.extend(res)
        x = run(self._mid, x, temb, context, attn_ctx)
        drop = drop_replay_rows if attn_ctx is not None else 0
        for block in self.up_blocks:
            if drop and x.shape[2] * x.shape[3] > MAX_CONTROLLED_TOKENS:
                if drop >= b:
                    return None  # capture-only: every controlled map is captured
                x, temb, context = x[drop:], temb[drop:], context[drop:]
                res_stack = [r[drop:] for r in res_stack]
                drop = 0
            n = len(block.resnets)
            skips = res_stack[-n:][::-1]
            del res_stack[-n:]
            x = run(self._up, block, x, skips, temb, context, attn_ctx)

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.float()

    @staticmethod
    def _down(block, x, temb, context, attn_ctx):
        """One down block; returns its output and the residuals it pushes."""
        res = []
        for j, resnet in enumerate(block.resnets):
            x = resnet(x, temb)
            if block.attentions is not None:
                x = block.attentions[j](x, context, attn_ctx=attn_ctx, place="down")
            res.append(x)
        if hasattr(block, "downsamplers"):
            x = block.downsamplers[0](x)
            res.append(x)
        return x, res

    def _mid(self, x, temb, context, attn_ctx):
        mid = self.mid_block
        x = mid.resnets[0](x, temb)
        x = mid.attentions[0](x, context, attn_ctx=attn_ctx, place="mid")
        return mid.resnets[1](x, temb)

    @staticmethod
    def _up(block, x, skips, temb, context, attn_ctx):
        """One up block; `skips` are the residuals it pops, in pop order."""
        for j, resnet in enumerate(block.resnets):
            x = resnet(torch.cat([x, skips[j]], dim=-1), temb)
            if block.attentions is not None:
                x = block.attentions[j](x, context, attn_ctx=attn_ctx, place="up")
        if hasattr(block, "upsamplers"):
            x = block.upsamplers[0](x)
        return x
