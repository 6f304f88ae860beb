"""Attention-controller contexts: what each controlled attention site calls.

Counterpart of fatezero_tpu/ptp/context.py. A context is a plain object
handed to the UNet's forward. Every controlled
site (at most 32x32 query tokens) calls either
``ctx.value_space_attention(...)`` (the probability-free fast path) or, when
that returns None, ``ctx.process(probs, place, is_cross)`` on its
materialised probabilities. Sites are visited in the UNet's static order, so
position counters line up with the capture.

* ``StoreContext`` captures cross probabilities and, with ``self_qk``, the
  self sites' (q, k) (the inversion's capture).
* ``EditContext`` consumes one step of that capture and rewrites the
  conditional row: prompt-to-prompt cross replace/refine/reweight in value
  space, and the gated, optionally masked self swap from the stored (q, k).
* ``InlineEditContext`` serves the single-forward edit: batch row 0 is the
  inversion replay, and the cond row is edited against row 0's attention at
  each site.

Maps are [b, f, heads, s, kv]; b = 1 at inversion, 2 (uncond, cond) under
CFG and 3 (replay, uncond, cond) inline; only the cond row is stored or
edited.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

STORE_KEYS = ("down_cross", "mid_cross", "up_cross", "down_self", "mid_self", "up_self")

# Maps with more query tokens than this are never stored or edited.
MAX_CONTROLLED_TOKENS = 32 * 32


def store_key(place: str, is_cross: bool) -> str:
    return f"{place}_{'cross' if is_cross else 'self'}"


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., H, S, D] -> [..., S, H*D]: the layout the (q, k) payload is stored in."""
    x = x.transpose(-2, -3)
    *lead, s, h, d = x.shape
    return x.reshape(*lead, s, h * d)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[..., S, H*D] -> [..., H, S, D] (inverse of merge_heads)."""
    *lead, s, hd = x.shape
    return x.reshape(*lead, s, heads, hd // heads).transpose(-2, -3)


class AttnContext:
    """Interface each controlled attention site calls. Base = no-op."""

    def process(self, probs: torch.Tensor, place: str, is_cross: bool) -> torch.Tensor:
        """probs: [b, f, heads, s, kv] in the model dtype. Returns edited probs."""
        return probs

    def value_space_attention(
        self, qh, kh, vh, scale, place, is_cross, video_shape, **site_info
    ) -> Optional[torch.Tensor]:
        """Optional fast path: the site's (edited) output straight from q/k/v.

        qh: [b, f, h, s, d]; kh/vh: [b, f, h, kv, d] (self) or [b, 1, h, kv, d]
        (cross, frame-broadcast). Returns [b, f, h, s, d], or None to ask for
        the materialised path. site_info: `k_store` (the referenced-frame
        deduplicated K of a sparse-causal site) and `sparse_meta`
        ((index_spec, f, heads) to re-gather it)."""
        return None


NoopContext = AttnContext


class StoreContext(AttnContext):
    """Capture controlled maps in visit order.

    ``captured[key][pos]`` holds the cond row's cross (or self) probabilities
    in ``store_dtype``. With ``self_qk=True`` the self sites store merged-head
    (q, k) in ``captured_qk`` instead and compute their own output with
    fused_attention, so no self probabilities are materialised.
    """

    def __init__(
        self,
        save_self_attention: bool = True,
        store_dtype=torch.bfloat16,
        self_qk: bool = False,
    ):
        self.save_self_attention = save_self_attention and not self_qk
        self.self_qk = self_qk
        self.store_dtype = store_dtype
        self.captured: Dict[str, List[torch.Tensor]] = {k: [] for k in STORE_KEYS}
        self.captured_qk: Dict[str, List] = {k: [] for k in STORE_KEYS if k.endswith("self")}

    def value_space_attention(self, qh, kh, vh, scale, place, is_cross, video_shape, **site_info):
        if is_cross or not self.self_qk:
            return None
        from fatezero_tpu_torch.ops.flash_attention import fused_attention

        k_keep = site_info.get("k_store")
        if k_keep is None:
            k_keep = kh
        self.captured_qk[store_key(place, False)].append(
            (
                merge_heads(qh).to(self.store_dtype),
                merge_heads(k_keep).to(self.store_dtype),
            )
        )
        return fused_attention(qh, kh, vh, scale)

    def _maybe_store(self, probs: torch.Tensor, place: str, is_cross: bool) -> None:
        if probs.shape[-2] <= MAX_CONTROLLED_TOKENS and (is_cross or self.save_self_attention):
            cond = probs[-1:] if probs.shape[0] > 1 else probs
            self.captured[store_key(place, is_cross)].append(cond.to(self.store_dtype))

    def process(self, probs, place, is_cross):
        self._maybe_store(probs, place, is_cross)
        return probs


@dataclasses.dataclass
class EditParams:
    """Per-step parameters of the prompt-to-prompt edit (tensors on the device)."""

    cross_edit_kind: str  # 'replace' | 'refine'
    mapper: Optional[torch.Tensor] = None  # replace: [1, 77, 77]
    refine_mapper: Optional[torch.Tensor] = None  # refine: int [1, 77]
    refine_alphas: Optional[torch.Tensor] = None  # refine: [1, 77]
    equalizer: Optional[torch.Tensor] = None  # reweight: [1, 77]
    self_replace_active: bool = True
    # per-step gate in {0, 1} (0-d tensor); when set it replaces
    # self_replace_active and the swap is computed every step and mixed by it
    self_gate: Optional[torch.Tensor] = None
    # {s_tokens: [f, 1, s, 1]} blend masks for the self swap (1 = keep the live map)
    self_masks: Optional[Dict[int, torch.Tensor]] = None
    save_self_attention: bool = True


def replace_cross(
    attn_base: torch.Tensor, attn_replace: torch.Tensor, params: EditParams
) -> torch.Tensor:
    """Prompt-to-prompt cross-attention rewrite.

    attn_base: [f, h, s, 77] inversion map; attn_replace: [b=1, f, h, s, 77].
    """
    dt = attn_base.dtype
    if params.cross_edit_kind == "replace":
        new = torch.einsum("fhsw,bwn->bfhsn", attn_base, params.mapper.to(dt))
    elif params.cross_edit_kind == "refine":
        gathered = attn_base[..., params.refine_mapper[0]]  # [f, h, s, 77]
        alphas = params.refine_alphas[0].to(dt)
        new = (gathered * alphas + attn_replace[0] * (1.0 - alphas))[None]
    else:
        raise ValueError(params.cross_edit_kind)
    if params.equalizer is not None:
        new = new * params.equalizer.to(dt)[:, None, None, None, :]
    return new


def replace_self(
    attn_base: torch.Tensor, attn_replace: torch.Tensor, mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """Self-attention swap, optionally gated by a spatial blend mask.

    attn_base: [f, h, s, kv]; attn_replace: [b=1, f, h, s, kv];
    mask: [f, 1, s, 1], 1 = keep the live map, 0 = use the inverted one.
    """
    base = attn_base[None]
    if mask is None:
        return base.expand(attn_replace.shape)
    m = mask[None].to(attn_replace.dtype)
    return m * attn_replace + (1.0 - m) * base


def _cross_weights(p: EditParams, alpha_words: torch.Tensor, kv: int, dev):
    """The value-space cross edit's [kv, kv] matrix m1 and per-token weight w2:

        edited(P_cond) @ V = P_base @ (m1 @ V) + P_cond @ (w2 * V)

    Refine: new = (P_base[:, mapper] * alpha + P_cond * (1-alpha)) * eq and
    cond = new * aw + (1-aw) * P_cond, so m1 = E @ diag(alpha*eq*aw) with
    E[i, n] = [mapper[n] == i] and w2 = (1-alpha)*eq*aw + (1-aw). Replace:
    m1 = mapper * eq*aw and w2 = 1-aw."""
    aw = alpha_words.float().reshape(-1).expand(kv)
    eq = p.equalizer[0].float() if p.equalizer is not None else torch.ones(kv, device=dev)
    if p.cross_edit_kind == "refine":
        al = p.refine_alphas[0].float()
        w1 = al * eq * aw
        w2 = (1.0 - al) * eq * aw + (1.0 - aw)
        E = (torch.arange(kv, device=dev)[:, None] == p.refine_mapper[0][None, :]).float()
        return E * w1[None, :], w2
    return p.mapper[0].float() * (eq * aw)[None, :], 1.0 - aw


class InlineEditContext(StoreContext):
    """Single-forward prompt-to-prompt: batch row 0 is the inversion replay.

    The UNet runs once on [replay (source cond), edit uncond, edit cond]; at
    every controlled site the cond row is edited against row 0's attention
    of the same site. Not usable with self masks from the same step's cross
    maps (the attention blend), which are complete only after the forward.
    With `capture_for_blend` the cross sites materialise and store row 0's
    maps in ``captured_inv`` and the cond row's in ``captured`` for the latent
    blend; with `viz_size` the cross sites of that many queries do, for the
    attention visualisation.
    """

    def __init__(
        self,
        params: EditParams,
        alpha_words: torch.Tensor,
        store_dtype=torch.bfloat16,
        capture_for_blend: bool = False,
        viz_size: Optional[int] = None,
    ):
        super().__init__(save_self_attention=False, store_dtype=store_dtype)
        self.params = params
        self.alpha_words = alpha_words
        self.capture_for_blend = capture_for_blend
        self.viz_size = viz_size
        self.captured_inv: Dict[str, List[torch.Tensor]] = {k: [] for k in STORE_KEYS}

    def _capture_cross(self, s: int) -> bool:
        return self.capture_for_blend or (self.viz_size is not None and s == self.viz_size)

    def value_space_attention(self, qh, kh, vh, scale, place, is_cross, video_shape, **site_info):
        """The inline edit without materialised probabilities: every edit op is
        linear in the probabilities along kv, so with row 0's P_rep

            cross: out_cond = P_rep @ (m1 @ V_cond) + P_cond @ (w2 * V_cond)
            self:  out_cond = g * (P_rep @ V_cond) + (1-g) * (P_cond @ V_cond)

        Row 0's own output and the P_rep term come from one attention with
        the values concatenated along d (a wide V). Returns None (materialise)
        for cross sites whose maps are captured and for masked self swaps.
        """
        from fatezero_tpu_torch.ops.flash_attention import fused_attention

        b, f = video_shape
        if b != 3 or qh.shape[0] != 3:
            return None
        p = self.params
        if is_cross and self._capture_cross(qh.shape[-2]):
            return None
        if not is_cross and p.self_masks is not None:
            return None
        d = qh.shape[-1]
        if is_cross:
            m1, w2 = _cross_weights(p, self.alpha_words, kh.shape[-2], qh.device)
            v_c = vh[2]  # [1, h, kv, d] frame-broadcast cross values
            v1 = torch.einsum("wn,xhnd->xhwd", m1.to(v_c.dtype), v_c)
            rep2 = fused_attention(qh[0], kh[0], torch.cat([vh[0], v1], dim=-1), scale)
            out_rep, term1 = rep2[..., :d], rep2[..., d:]
            v2 = v_c * w2[None, None, :, None].to(v_c.dtype)
            uc = fused_attention(qh[1:3], kh[1:3], torch.cat([vh[1:2], v2[None]], dim=0), scale)
            out_unc, out_cond = uc[0], term1 + uc[1]
        else:
            if p.self_gate is not None:
                g = p.self_gate
            elif p.self_replace_active:
                g = torch.tensor(1.0, device=qh.device)
            else:  # no swap: three independent attentions
                return fused_attention(qh, kh, vh, scale)
            rep2 = fused_attention(qh[0], kh[0], torch.cat([vh[0], vh[2]], dim=-1), scale)
            out_rep, swapped = rep2[..., :d], rep2[..., d:]
            uc = fused_attention(qh[1:3], kh[1:3], vh[1:3], scale)
            out_unc, out_live = uc[0], uc[1]
            g = g.float().to(out_live.dtype)
            out_cond = g * swapped + (1.0 - g) * out_live
        return torch.stack([out_rep, out_unc, out_cond], dim=0)

    def process(self, probs, place, is_cross):
        if probs.shape[-2] > MAX_CONTROLLED_TOKENS or probs.shape[0] < 3:
            return probs
        base = probs[0]  # [f, h, s, kv]: the replay row's probabilities
        if is_cross and self._capture_cross(probs.shape[-2]):
            key = store_key(place, True)
            self.captured_inv[key].append(probs[:1].to(self.store_dtype))
            self.captured[key].append(probs[-1:].to(self.store_dtype))
        rep, uncond, cond = probs[:1], probs[1:2], probs[2:]
        if is_cross:
            new = replace_cross(base, cond, self.params)
            aw = self.alpha_words.to(cond.dtype)
            cond = new * aw + (1.0 - aw) * cond
        elif self.params.self_gate is not None or self.params.self_replace_active:
            mask = None
            if self.params.self_masks is not None:
                mask = self.params.self_masks.get(probs.shape[-2])
            swapped = replace_self(base, cond, mask)
            if self.params.self_gate is not None:
                g = self.params.self_gate.to(cond.dtype)
                swapped = g * swapped + (1.0 - g) * cond
            cond = swapped
        return torch.cat([rep, uncond, cond], dim=0)


class EditContext(StoreContext):
    """Consume one inversion step's capture and rewrite the cond row.

    ``injected[key][pos]`` are the inversion's cross maps ([1, f, h, s, kv]);
    ``injected_qk[key][pos]`` its self (q, k) pairs. Position counters follow
    the visit order of the UNet. Cross sites run in value space, except
    those with `materialize_cross_size` queries: the latent blend and the
    attention visualisation read their live maps, so they materialise through
    ``process``, which stores the cond row in ``captured``. Self sites run in
    value space from ``injected_qk`` and otherwise materialise.
    """

    def __init__(
        self,
        injected: Dict[str, List[torch.Tensor]],
        params: EditParams,
        alpha_words: torch.Tensor,
        store_dtype=torch.bfloat16,
        injected_qk: Optional[Dict[str, List]] = None,
        materialize_cross_size: Optional[int] = None,
    ):
        super().__init__(save_self_attention=params.save_self_attention, store_dtype=store_dtype)
        self.injected = injected
        self.injected_qk = injected_qk
        self.params = params
        self.alpha_words = alpha_words
        self.materialize_cross_size = materialize_cross_size
        self._pos = {k: 0 for k in STORE_KEYS}
        self._pos_qk = {k: 0 for k in STORE_KEYS}

    def _cross_value_space(self, qh, kh, vh, scale, place, video_shape):
        """Probability-free cross edit against the injected base probabilities.

        The live cond probabilities enter the edit only through linear ops
        along kv (replace/refine mix, reweight, alpha-time-word mix), which
        commute with @V (_cross_weights):

            out_cond = base @ (m1 @ V_cond) + attention(q_c, k_c, V_cond * w2)
        """
        from fatezero_tpu_torch.ops.flash_attention import fused_attention

        key = store_key(place, True)
        pos = self._pos[key]
        self._pos[key] = pos + 1
        base = self.injected[key][pos][0]  # [f, h, s, kv]
        m1, w2 = _cross_weights(self.params, self.alpha_words, kh.shape[-2], qh.device)
        v_c = vh[-1]  # cond row's frame-broadcast values, [1, h, kv, d]
        v1 = torch.einsum("wn,xhnd->xhwd", m1.to(v_c.dtype), v_c)  # [1, h, kv, d]
        term1 = torch.einsum("fhsw,xhwd->fhsd", base.to(v_c.dtype), v1)  # [f, h, s, d]
        v2 = v_c * w2[None, None, :, None].to(v_c.dtype)
        out = fused_attention(qh, kh, torch.cat([vh[:-1], v2[None]], dim=0), scale)
        out_rest, term2 = out[:-1], out[-1]
        cond = (term1 + term2)[None]
        if out_rest.shape[0] == 0:
            return cond
        return torch.cat([out_rest, cond], dim=0)

    def value_space_attention(self, qh, kh, vh, scale, place, is_cross, video_shape, **site_info):
        """Self swap without materialised probabilities, from the stored (q, k).

        The swap and its mask are linear in the probabilities, so

            out = (g*m + 1-g) * (P_cond @ V) + g*(1-m) * (P_base @ V)

        where P_base @ V is one attention of the injected q/k against the
        live cond values. Cross sites go through _cross_value_space.
        """
        if is_cross:
            if self.materialize_cross_size is not None and qh.shape[-2] == self.materialize_cross_size:
                return None  # the blend and viz read these live maps
            return self._cross_value_space(qh, kh, vh, scale, place, video_shape)
        if self.injected_qk is None or self.save_self_attention:
            return None
        from fatezero_tpu_torch.ops.flash_attention import fused_attention
        from fatezero_tpu_torch.ops.video_ops import regather_headsplit_kv

        p = self.params
        key = store_key(place, False)
        pos = self._pos_qk[key]
        self._pos_qk[key] = pos + 1

        live = fused_attention(qh, kh, vh, scale)
        if p.self_gate is None and not p.self_replace_active:
            return live
        v_cond = vh[-1:]  # [1, f, h, kv, d]
        q_inj, k_inj = self.injected_qk[key][pos]
        heads = qh.shape[-3]
        q_inj = split_heads(q_inj, heads)
        k_inj = split_heads(k_inj, heads)
        if site_info.get("sparse_meta") is not None:
            # the stored K is the referenced-frame subset: re-gather it
            index_spec, f_meta, heads = site_info["sparse_meta"]
            k_inj = regather_headsplit_kv(k_inj, index_spec, f_meta, heads)
        base_out = fused_attention(q_inj.to(vh.dtype), k_inj.to(vh.dtype), v_cond, scale)
        g = p.self_gate if p.self_gate is not None else torch.tensor(1.0, device=qh.device)
        g = g.float().to(live.dtype)
        live_u, live_c = live[:-1], live[-1:]
        mask = p.self_masks.get(qh.shape[-2]) if p.self_masks is not None else None
        if mask is None:
            cond = g * base_out + (1.0 - g) * live_c
        else:
            m = mask[None].to(live.dtype)
            cond = (g * m + (1.0 - g)) * live_c + g * (1.0 - m) * base_out
        if live_u.shape[0] == 0:
            return cond
        return torch.cat([live_u, cond], dim=0)

    def process(self, probs, place, is_cross):
        # pre-edit capture of the cond row
        self._maybe_store(probs, place, is_cross)
        if probs.shape[-2] > MAX_CONTROLLED_TOKENS:
            return probs
        key = store_key(place, is_cross)
        pos = self._pos[key]
        self._pos[key] = pos + 1

        def base():
            return self.injected[key][pos][0].to(probs.dtype)

        uncond, cond = probs[:-1], probs[-1:]
        if is_cross:
            new = replace_cross(base(), cond, self.params)
            aw = self.alpha_words.to(cond.dtype)
            cond = new * aw + (1.0 - aw) * cond
        elif self.params.self_gate is not None or self.params.self_replace_active:
            mask = None
            if self.params.self_masks is not None:
                mask = self.params.self_masks.get(probs.shape[-2])
            swapped = replace_self(base(), cond, mask)
            if self.params.self_gate is not None:
                g = self.params.self_gate.to(cond.dtype)
                swapped = g * swapped + (1.0 - g) * cond
            cond = swapped
        if uncond.shape[0] == 0:
            return cond
        return torch.cat([uncond, cond], dim=0)
