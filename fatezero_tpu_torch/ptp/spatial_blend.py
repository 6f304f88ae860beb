"""Spatial blending: masks from the mid-resolution cross-attention maps.

Counterpart of fatezero_tpu/ptp/spatial_blend.py. Plain tensor functions on
the device of the maps they are given, called per step by the pipeline:

* the attention blend ('source' prompt): a mask from the inversion step's
  maps, resized to each controlled self-attention resolution, gates the self
  swap (EditParams.self_masks);
* the latent blend ('both'): masks from the inversion step's maps and the
  running sum of the edit's own live maps, applied to the latent after the
  scheduler step inside the blend window.

Maps are [p, f, heads, s, 77] with s = (latent / 4)^2; the pipeline selects
the five maps at that resolution (fatezero_pipeline._blend_maps_16). Under a
device mesh f and heads are this rank's: the mean over heads sums over the
'tensor' axis, and everything after it is per frame, so it stays local.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fatezero_tpu_torch.parallel.sharding import tensor_size, tensor_sum
from fatezero_tpu_torch.ptp.seq_aligner import get_word_inds

MAX_WORDS = 77


def word_alpha_layers(prompts: Sequence[str], words, tokenizer) -> np.ndarray:
    """[n_prompts, 77] indicator of the blend words."""
    alpha = np.zeros((len(prompts), MAX_WORDS), np.float32)
    for i, (prompt, words_) in enumerate(zip(prompts, words)):
        if isinstance(words_, str):
            words_ = [words_]
        for word in words_:
            inds = get_word_inds(prompt, word, tokenizer)
            alpha[i, inds] = 1.0
    return alpha


def _aggregate(maps: Sequence[torch.Tensor], alpha: torch.Tensor) -> torch.Tensor:
    """maps: list of [p, f, heads, s, 77] -> word-weighted head mean [p, f, r, r].
    Under a mesh that splits the heads the mean is the sum over every rank's
    heads (a sum over 'tensor') divided by their count."""
    items = []
    for m in maps:
        p, f, h, s, w = m.shape
        r = int(np.sqrt(s))
        items.append(m.reshape(p, f, h, r, r, w))
    stacked = torch.cat(items, dim=2).float()  # [p, f, H*, r, r, 77]
    al = alpha.float()[:, None, None, None, None, :]
    weighted = (stacked * al).sum(-1)
    if tensor_size() == 1:
        return weighted.mean(2)
    return tensor_sum(weighted.sum(2)) / (weighted.shape[2] * tensor_size())


def _maxpool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 max pool with padding 1 over the last two axes (the padding
    takes no part in the max, as -inf padding would)."""
    return F.max_pool2d(x, kernel_size=3, stride=1, padding=1)


def _resize_nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize on [p, f, h, w]: source row i * src_h // h, in integers
    (a float scale, as in F.interpolate, can pick another row)."""
    h, w = hw
    src_h, src_w = x.shape[-2:]
    rows = torch.arange(h, device=x.device) * src_h // h
    cols = torch.arange(w, device=x.device) * src_w // w
    return x[..., rows, :][..., :, cols]


def blend_map(
    maps: Sequence[torch.Tensor],
    alpha: torch.Tensor,
    target_hw: Tuple[int, int],
    use_pool: bool = True,
) -> torch.Tensor:
    """The map `blend_mask` thresholds: aggregated, pooled, resized and divided
    by its per-(prompt, frame) maximum, [p, f, h, w] in fp32."""
    m = _aggregate(maps, alpha)
    if use_pool:
        m = _maxpool3(m)
    m = _resize_nearest(m, target_hw)
    denom = m.amax(dim=(-2, -1), keepdim=True)
    return m / torch.clamp(denom, min=1e-12)


def blend_mask(
    maps: Sequence[torch.Tensor],
    alpha: torch.Tensor,
    target_hw: Tuple[int, int],
    th: float,
    use_pool: bool = True,
) -> torch.Tensor:
    """Binary mask [p, f, h, w]: 1 = keep the target (generated), 0 = use the source."""
    return (blend_map(maps, alpha, target_hw, use_pool) > th).float()


@dataclasses.dataclass
class SpatialBlender:
    """Config of one blender, and the masks it recorded (``record``).

    prompt_choose='source' gives the self-attention mask from the source row
    only; 'both' the union of the source and target masks, for the latent blend.
    """

    alpha_layers: np.ndarray  # [n_prompts, 77]
    start_blend: int
    end_blend: int
    th: Tuple[float, float] = (0.3, 0.3)
    prompt_choose: str = "source"
    save_path: Optional[str] = None
    # indicator of words whose own (unpooled, th[1]-thresholded) mask is
    # carved out of the main mask
    substruct_layers: Optional[np.ndarray] = None

    counter: int = 0
    mask_list: List[np.ndarray] = dataclasses.field(default_factory=list)

    @classmethod
    def create(
        cls,
        prompts,
        words,
        tokenizer,
        num_steps: int,
        start_blend: float = 0.2,
        end_blend: float = 0.8,
        th=(0.3, 0.3),
        prompt_choose: str = "source",
        save_path: Optional[str] = None,
        substruct_words=None,
    ) -> "SpatialBlender":
        assert prompt_choose in ("source", "both")
        return cls(
            alpha_layers=word_alpha_layers(prompts, words, tokenizer),
            start_blend=int(start_blend * num_steps),
            end_blend=int(end_blend * num_steps),
            th=tuple(th) if not isinstance(th, (int, float)) else (th, th),
            prompt_choose=prompt_choose,
            save_path=save_path,
            substruct_layers=None
            if substruct_words is None
            else word_alpha_layers(prompts, substruct_words, tokenizer),
        )

    def _alpha(self, layers: np.ndarray, device) -> torch.Tensor:
        rows = layers[:1] if self.prompt_choose == "source" else layers
        return torch.as_tensor(rows, dtype=torch.float32, device=device)

    def mask_for(self, maps: Sequence[torch.Tensor], target_hw) -> torch.Tensor:
        """[p_effective, f, h, w]: p = 1 for 'source'; for 'both' every row is
        united with the source row."""
        dev = maps[0].device
        mask = blend_mask(maps, self._alpha(self.alpha_layers, dev), target_hw, self.th[0], use_pool=True)
        if self.prompt_choose == "both":
            mask = torch.maximum(mask[:1], mask)
        if self.substruct_layers is not None:
            sub = blend_mask(maps, self._alpha(self.substruct_layers, dev), target_hw, self.th[1], use_pool=False)
            if self.prompt_choose == "both":
                sub = torch.maximum(sub[:1], sub)
            mask = mask * (1.0 - sub)
        return mask

    def record(self, mask: np.ndarray, save_tag: str = "") -> None:
        """Keep one step's mask and, with a save_path, write its last row as
        one PNG per frame, `mask_{save_tag}_{counter:03d}_{frame:02d}.png`
        holding uint8(mask * 255), as the JAX package writes them."""
        self.mask_list.append(np.asarray(mask))
        if self.save_path is None:
            return
        from PIL import Image

        os.makedirs(self.save_path, exist_ok=True)
        m = np.asarray(mask)
        m = m[-1] if m.ndim == 4 else m  # [f, h, w]
        for fi, frame in enumerate(m):
            img = Image.fromarray((np.asarray(frame) * 255).astype(np.uint8))
            img.save(os.path.join(self.save_path, f"mask_{save_tag}_{self.counter:03d}_{fi:02d}.png"))

    def latent_blend_active(self, step: int) -> bool:
        """The blend window: edit step `step` is the reference's 1-based counter step + 1."""
        return self.start_blend < (step + 1) < self.end_blend


def apply_latent_blend(x_t: torch.Tensor, inverted: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x_t, inverted: [1, f, h, w, c]; mask: [p, f, h, w] (row -1 = union).
    Outside the mask the inverted latent wins."""
    m = mask[-1][None, ..., None]
    return inverted + m * (x_t - inverted)
