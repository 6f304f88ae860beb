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
of kept. As there, only when no attention controller is attached. On a mesh
the recomputation runs under the mesh of the forward (the backward may run on
another thread, which does not see the ambient mesh) and issues the block's
collectives again, in the forward's order on every rank.

Besides SD-1.x the config takes SDXL's keys: a head count (diffusers'
legacy `attention_head_dim`) and a transformer depth for each level
(`transformer_layers_per_block`; the mid block takes the last), the
text-time added embedding (`use_linear_projection` changes nothing here:
channels-last `proj_in`/`proj_out` are linears either way, and the loader
takes SD-1's 1x1 convs and SDXL's linears alike): `forward(added_cond=...)` adds
`add_embedding(cat(text_embeds, sinusoid(time_ids)))` to the time embedding.

On a device mesh (parallel/sharding.py) the forward runs on this rank's block
of frames with the weights `shard_unet_` kept; the layers exchange what
crosses blocks. `tensor_shards` records the 'tensor' size the weights were
split for, and the forward refuses any other mesh.
"""
from __future__ import annotations

import dataclasses
import contextlib
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fatezero_tpu_torch.common.profiling import span, spanned
from fatezero_tpu_torch.models.attention import SpatioTemporalTransformerModel
from fatezero_tpu_torch.models.layers import FusedGroupNorm, TimestepEmbedding, get_timestep_embedding
from fatezero_tpu_torch.models.resnet import (
    DownsamplePseudo3D,
    PseudoConv3d,
    ResnetBlockPseudo3D,
    UpsamplePseudo3D,
)
from fatezero_tpu_torch.models.unet_graph import PiecewiseGraphs, graph_engages
from fatezero_tpu_torch.parallel.sharding import current_seq_mesh, seq_mesh_scope, tensor_size
from fatezero_tpu_torch.ptp.context import MAX_CONTROLLED_TOKENS, AttnContext


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    """Static architecture config (diffusers unet config + FateZero model_config:
    lora / SparseCausalAttention_index / least_sc_channel / temporal_downsample_time)."""

    sample_size: int = 64  # latent side of the checkpoint's training resolution
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
    # diffusers legacy: the number of heads, one for every level or one per level
    attention_head_dim: Union[int, Tuple[int, ...]] = 8
    # transformer blocks in each attention site, one for every level or one per level
    transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1
    cross_attention_dim: int = 768
    addition_embed_type: Optional[str] = None  # None or "text_time" (SDXL)
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 0
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

    @classmethod
    def from_reference(cls, config: dict) -> "UNet3DConfig":
        """Build from a diffusers unet config.json dict with the FateZero
        model_config keys laid over it, as the JAX package's from_reference:
        2D block types become their Pseudo3D counterparts, keys that change
        nothing the UNet computes drop. A key that changes the computation in
        a way this UNet does not build (`REFUSED`) raises."""
        known = {f.name for f in dataclasses.fields(cls)}
        mapped = {}
        for key, value in config.items():
            if key in REFUSED and not REFUSED[key](value):
                raise ValueError(f"the UNet does not build the diffusers key {key}={value!r}")
            if key == "SparseCausalAttention_index":
                mapped["sparse_causal_indices"] = tuple(value)
            elif key == "temporal_downsample" and value:
                mapped["temporal_downsample_time"] = 3
            elif key in ("down_block_types", "up_block_types"):
                mapped[key] = tuple(v.replace("2D", "Pseudo3D") for v in value)
            elif key in known:
                mapped[key] = tuple(value) if isinstance(value, list) else value
        return cls(**mapped)

    def level_heads(self, level: int) -> int:
        h = self.attention_head_dim
        return h[level] if isinstance(h, tuple) else h

    def level_depth(self, level: int) -> int:
        d = self.transformer_layers_per_block
        return d[level] if isinstance(d, tuple) else d

    def block_sparse_indices(self, dim: int):
        """Frame-local self-attention (no gather) below least_sc_channel."""
        if self.least_sc_channel and dim < self.least_sc_channel:
            return ()
        return self.sparse_causal_indices


def _off(*allowed):
    return lambda value: value in allowed


# diffusers keys that change the computation, and the values this UNet builds
REFUSED = {
    "class_embed_type": _off(None),
    "num_class_embeds": _off(None),
    "upcast_attention": _off(None, False),
    "only_cross_attention": lambda v: not (any(v) if isinstance(v, (list, tuple)) else v),
    "dual_cross_attention": _off(None, False),
    "resnet_time_scale_shift": _off("default"),
    "num_attention_heads": _off(None),
    "addition_embed_type": _off(None, "text_time"),
    "encoder_hid_dim": _off(None),
    "time_cond_proj_dim": _off(None),
    "time_embedding_type": _off("positional"),
    "mid_block_type": _off("UNetMidBlock2DCrossAttn"),
    "center_input_sample": _off(False),
    "conv_in_kernel": _off(3),
    "conv_out_kernel": _off(3),
    "reverse_transformer_layers_per_block": _off(None),
    "encoder_hid_dim_type": _off(None),
    "cross_attention_norm": _off(None),
    "time_embedding_act_fn": _off(None),
    "time_embedding_dim": _off(None),
    "timestep_post_act": _off(None),
    "resnet_skip_time_act": _off(False),
    "resnet_out_scale_factor": _off(1, 1.0),
    "mid_block_scale_factor": _off(1, 1.0),
    "act_fn": _off("silu"),
    "downsample_padding": _off(1),
}


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
        self.tensor_shards = 1
        kw = dict(dtype=dtype, device=device)
        ch0 = cfg.block_out_channels[0]
        temb_ch = ch0 * 4

        def resnet(cin, cout):
            return ResnetBlockPseudo3D(
                cin, cout, temb_ch, cfg.norm_num_groups, cfg.norm_eps, cfg.lora, **kw
            )

        def transformer(ch, level):
            heads = cfg.level_heads(level)
            return SpatioTemporalTransformerModel(
                ch, heads, ch // heads, cfg.level_depth(level), cfg.cross_attention_dim, cfg.norm_num_groups,
                cfg.block_sparse_indices(ch), True, cfg.temporal_attention, **kw,
            )

        self.conv_in = PseudoConv3d(cfg.in_channels, ch0, 3, lora_rank=cfg.lora, **kw)
        self.time_embedding = TimestepEmbedding(ch0, temb_ch, **kw)
        self.add_embedding = None
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb_ch, **kw)

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
                    attns.append(transformer(cout, i))
                skips.append(cout)
            sampler = None
            if not is_final:
                sampler = DownsamplePseudo3D(cout, t_down, cfg.lora, **kw)
                skips.append(cout)
            self.down_blocks.append(_Blocks(resnets, attns, sampler, "downsamplers"))
            cin = cout

        cmid = cfg.block_out_channels[-1]
        self.mid_block = _Blocks([resnet(cmid, cmid), resnet(cmid, cmid)], [transformer(cmid, n - 1)])

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
                    attns.append(transformer(cout, n - 1 - i))
            sampler = None if is_final else UpsamplePseudo3D(cout, t_up, cfg.lora, **kw)
            self.up_blocks.append(_Blocks(resnets, attns, sampler, "upsamplers"))
            cin = cout

        self.conv_norm_out = FusedGroupNorm(cfg.norm_num_groups, ch0, cfg.norm_eps, **kw)
        self.conv_out = PseudoConv3d(ch0, cfg.out_channels, 3, lora_rank=cfg.lora, **kw)
        self._graphs = PiecewiseGraphs()  # models/unet_graph.py

    @spanned("fz.unet.forward")
    def forward(
        self,
        sample: torch.Tensor,
        timesteps,
        encoder_hidden_states: torch.Tensor,
        attn_ctx: Optional[AttnContext] = None,
        drop_replay_rows: int = 0,
        added_cond: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Optional[torch.Tensor]:
        """added_cond: with the text-time embedding (SDXL), `text_embeds`
        [B, P] and `time_ids` [B, 6], one row per batch row; a UNet without
        it takes none.

        drop_replay_rows: the first N batch rows exist only to feed the
        controller's stored or edited maps (the inversion replay of the edit).
        No site above MAX_CONTROLLED_TOKENS queries is stored or edited, and
        the up blocks' resolution only grows, so from the first up block past
        that size those rows are sliced off. If every row is a replay row (a
        capture-only forward) the rest is skipped and None is returned: the
        caller reads ``attn_ctx.captured``. Where even the last up block is
        controlled, nothing is dropped.

        Where `models/unet_graph.py::graph_engages` holds (a CUDA device,
        grad off, no mesh, no hook a replay would skip), the forward runs as
        piecewise CUDA graphs: the same operations, replayed between eager
        calls of the attention modules; the returned tensor is the caller's.
        A forward with grad on (training) releases them."""
        if tensor_size() != self.tensor_shards:
            raise RuntimeError(
                f"the UNet's weights are split for tensor = {self.tensor_shards}, the mesh in scope has "
                f"tensor = {tensor_size()} (shard_unet_ and seq_mesh_scope must name one mesh)"
            )
        if (added_cond is None) != (self.add_embedding is None):
            raise ValueError("the text-time UNet needs added_cond (text_embeds, time_ids); another UNet takes none")
        if graph_engages(self, sample.device):
            return self._graphs.forward(self, sample, timesteps, encoder_hidden_states, attn_ctx, drop_replay_rows,
                                        added_cond)
        if torch.is_grad_enabled():
            self.release_graphs()
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        return self._forward(sample, timesteps, encoder_hidden_states, attn_ctx, drop_replay_rows, added_cond)

    def release_graphs(self) -> None:
        """Drop the forward's piecewise CUDA graphs and return their memory
        to the card (models/unet_graph.py::PiecewiseGraphs.release)."""
        self._graphs.release()

    def _forward(self, sample, timesteps: torch.Tensor, encoder_hidden_states, attn_ctx, drop_replay_rows: int,
                 added_cond) -> Optional[torch.Tensor]:
        """The forward's operations, with the timesteps on the device; the
        attention modules called through `run_eager` (models/attention.py)."""
        cfg = self.cfg
        b = sample.shape[0]
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(b)
        t_emb = get_timestep_embedding(
            timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift
        ).to(self.dtype)
        temb = self.time_embedding(t_emb)
        if added_cond is not None:
            with span("fz.unet.add_embedding"):
                time_ids = added_cond["time_ids"]
                t_ids = get_timestep_embedding(
                    time_ids.reshape(-1), cfg.addition_time_embed_dim, cfg.flip_sin_to_cos, cfg.freq_shift
                ).reshape(time_ids.shape[0], -1)
                add = torch.cat([added_cond["text_embeds"].float(), t_ids], dim=-1).to(self.dtype)
                temb = temb + self.add_embedding(add)
        context = encoder_hidden_states.to(self.dtype)

        x = self.conv_in(sample.to(self.dtype))
        remat = cfg.gradient_checkpointing and attn_ctx is None and torch.is_grad_enabled()
        mesh = current_seq_mesh()

        def scopes():  # (the forward's, the recomputation's)
            return contextlib.nullcontext(), seq_mesh_scope(mesh)

        def run(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False, context_fn=scopes) if remat else fn(*args)

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
