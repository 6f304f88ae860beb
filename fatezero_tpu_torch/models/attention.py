"""Spatio-temporal transformer with SparseCausalAttention (torch).

Counterpart of fatezero_tpu/models/attention.py, with diffusers parameter
names (to_q/to_k/to_v/to_out.0, proj_in/proj_out, ff.net.0.proj, ...).
Attention sites run one of three paths:

* value space: a controller computes the (edited) output from q/k/v without
  materialising probabilities (ptp/context.py);
* materialised: explicit probabilities handed to the controller's
  ``process`` (logits in the model dtype, fp32 softmax, probabilities cast
  back to the model dtype before the store, the edit and @V);
* fused: ``fused_attention`` (K1 for 256 queries or more on the GPU).

Activations keep the reference layouts: [b, f, s, c] through the transformer
and [b, f, heads, s, d] through attention.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from fatezero_tpu_torch.models.layers import FeedForward, FusedGroupNorm, FusedLayerNorm
from fatezero_tpu_torch.ops.flash_attention import fused_attention
from fatezero_tpu_torch.ops.video_ops import gather_sparse_kv, referenced_frames
from fatezero_tpu_torch.ptp.context import MAX_CONTROLLED_TOKENS, AttnContext


def _split_heads5(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[..., S, H*D] -> [..., H, S, D]."""
    *lead, s, hd = x.shape
    return x.reshape(*lead, s, heads, hd // heads).transpose(-2, -3)


def _merge_heads5(x: torch.Tensor) -> torch.Tensor:
    """[..., H, S, D] -> [..., S, H*D]."""
    x = x.transpose(-2, -3)
    *lead, s, h, d = x.shape
    return x.reshape(*lead, s, h * d)


class Attention(nn.Module):
    """Multi-head attention with an optional controller.

    Self-attention input is [b, f, s, c]; the cross-attention context is
    [b, kv, c_cross], its K/V computed once per batch row and broadcast over
    frames.
    """

    def __init__(
        self,
        query_dim: int,
        heads: int,
        dim_head: int,
        cross_attention_dim: Optional[int] = None,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        inner = heads * dim_head
        kv_dim = cross_attention_dim if cross_attention_dim is not None else query_dim
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.dim_head = dim_head
        self.dtype = dtype
        self.to_q = nn.Linear(query_dim, inner, bias=False, **kw)
        self.to_k = nn.Linear(kv_dim, inner, bias=False, **kw)
        self.to_v = nn.Linear(kv_dim, inner, bias=False, **kw)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, **kw)])

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        *,
        attn_ctx: Optional[AttnContext] = None,
        place: Optional[str] = None,
        sparse_indices: Optional[Sequence[Union[int, str]]] = None,
    ) -> torch.Tensor:
        scale = self.dim_head**-0.5
        is_cross = context is not None
        b, f = x.shape[0], x.shape[1]

        q = self.to_q(x)
        kv_src = context if is_cross else x
        k = self.to_k(kv_src)
        v = self.to_v(kv_src)
        if is_cross:
            k = k[:, None]  # [B, 1, KV, inner], frame-broadcast
            v = v[:, None]

        k_store = sparse_meta = None
        if sparse_indices is not None and not is_cross and len(sparse_indices) > 0 and f > 1:
            if attn_ctx is not None:
                # store only the referenced source frames' K (['mid'] -> 1 frame);
                # consumers re-gather with regather_headsplit_kv
                refs = referenced_frames(f, sparse_indices)
                k_sel = k if refs == list(range(f)) else k[:, refs]
                k_store = _split_heads5(k_sel, self.heads)
                sparse_meta = (tuple(sparse_indices), f, self.heads)
            k = gather_sparse_kv(k, sparse_indices, f)
            v = gather_sparse_kv(v, sparse_indices, f)

        qh = _split_heads5(q, self.heads)  # [B, F, H, S, D]
        kh = _split_heads5(k, self.heads)  # [B, F|1, H, KV, D]
        vh = _split_heads5(v, self.heads)

        controlled = (
            attn_ctx is not None and place is not None and qh.shape[-2] <= MAX_CONTROLLED_TOKENS
        )
        fast = None
        if controlled:
            fast = attn_ctx.value_space_attention(
                qh, kh, vh, scale, place, is_cross, (b, f),
                k_store=k_store, sparse_meta=sparse_meta,
            )
        if fast is not None:
            out = fast.to(self.dtype)
        elif controlled:
            kb = kh.expand(b, f, *kh.shape[2:])
            vb = vh.expand(b, f, *vh.shape[2:])
            logits = torch.matmul(qh.to(self.dtype), kb.to(self.dtype).transpose(-1, -2)).float() * scale
            probs5 = torch.softmax(logits, dim=-1).to(self.dtype)
            probs5 = attn_ctx.process(probs5, place, is_cross)
            out = torch.matmul(probs5.to(self.dtype), vb.to(self.dtype))
        else:
            out = fused_attention(qh, kh, vh, scale)

        return self.to_out[0](_merge_heads5(out))  # [B, F, S, inner] -> proj


class TemporalAttention(nn.Module):
    """Per-pixel self-attention over frames with a zero-initialised output
    projection (identity residual at init). Input/output [b, f, d, c]; fp32
    softmax."""

    def __init__(self, dim: int, heads: int, dim_head: int, dtype=torch.float32, device=None):
        super().__init__()
        inner = heads * dim_head
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.dim_head = dim_head
        self.dtype = dtype
        self.to_q = nn.Linear(dim, inner, bias=False, **kw)
        self.to_k = nn.Linear(dim, inner, bias=False, **kw)
        self.to_v = nn.Linear(dim, inner, bias=False, **kw)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim, **kw)])
        nn.init.zeros_(self.to_out[0].weight)
        nn.init.zeros_(self.to_out[0].bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, d, c = x.shape
        scale = self.dim_head**-0.5

        def heads5(t):  # [b, f, d, h*e] -> [b, f, d, h, e] fp32
            return t.reshape(b, f, d, self.heads, self.dim_head).float()

        q5, k5, v5 = heads5(self.to_q(x)), heads5(self.to_k(x)), heads5(self.to_v(x))
        s = torch.einsum("bfdhe,bgdhe->bdhfg", q5, k5) * scale
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bdhfg,bgdhe->bfdhe", p, v5).to(self.dtype)
        return self.to_out[0](out.reshape(b, f, d, self.heads * self.dim_head))


class SpatioTemporalTransformerBlock(nn.Module):
    """attn1 (sparse-causal self) -> attn2 (text cross) -> FF -> temporal attn,
    each pre-LayerNormed with a residual add, on [b, f, s, c]."""

    def __init__(
        self,
        dim: int,
        heads: int,
        dim_head: int,
        cross_attention_dim: int = 768,
        sparse_indices: Tuple[Union[int, str], ...] = (-1, "first"),
        use_sparse_causal: bool = True,
        temporal_attention: bool = True,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.sparse_indices = tuple(sparse_indices) if use_sparse_causal else None
        self.temporal_attention = temporal_attention
        self.norm1 = FusedLayerNorm(dim, **kw)
        self.attn1 = Attention(dim, heads, dim_head, **kw)
        self.norm2 = FusedLayerNorm(dim, **kw)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim, **kw)
        self.norm3 = FusedLayerNorm(dim, **kw)
        self.ff = FeedForward(dim, **kw)
        if temporal_attention:
            self.norm_temporal = FusedLayerNorm(dim, **kw)
            self.attn_temporal = TemporalAttention(dim, heads, dim_head, **kw)

    def forward(self, x, context, video_shape, attn_ctx=None, place=None):
        b, f = video_shape
        x = x + self.attn1(
            self.norm1(x), attn_ctx=attn_ctx, place=place, sparse_indices=self.sparse_indices
        )
        x = x + self.attn2(self.norm2(x), context, attn_ctx=attn_ctx, place=place)
        x = x + self.ff(self.norm3(x))
        if self.temporal_attention and f > 1:
            x = x + self.attn_temporal(self.norm_temporal(x))
        return x


class SpatioTemporalTransformerModel(nn.Module):
    """GN (per batch row and frame) -> proj_in -> blocks -> proj_out + residual,
    on [B, F, H, W, C] video."""

    def __init__(
        self,
        in_channels: int,
        heads: int,
        dim_head: int,
        num_layers: int = 1,
        cross_attention_dim: int = 768,
        norm_num_groups: int = 32,
        sparse_indices: Tuple[Union[int, str], ...] = (-1, "first"),
        use_sparse_causal: bool = True,
        temporal_attention: bool = True,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        inner = heads * dim_head
        kw = dict(dtype=dtype, device=device)
        self.norm = FusedGroupNorm(norm_num_groups, in_channels, eps=1e-6, batch_dims=2, **kw)
        self.proj_in = nn.Linear(in_channels, inner, **kw)
        self.transformer_blocks = nn.ModuleList(
            [
                SpatioTemporalTransformerBlock(
                    inner, heads, dim_head, cross_attention_dim, sparse_indices,
                    use_sparse_causal, temporal_attention, **kw,
                )
                for _ in range(num_layers)
            ]
        )
        self.proj_out = nn.Linear(inner, in_channels, **kw)

    def forward(self, x, context, attn_ctx=None, place=None):
        b, f, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x))
        h = h.reshape(b, f, hh * ww, h.shape[-1])
        for block in self.transformer_blocks:
            h = block(h, context, (b, f), attn_ctx=attn_ctx, place=place)
        h = h.reshape(b, f, hh, ww, h.shape[-1])
        return self.proj_out(h) + x
