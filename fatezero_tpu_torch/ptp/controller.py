"""Edit-controller assembly: `make_controller` and `EditController`.

Counterpart of fatezero_tpu/ptp/controller.py. Builds, from the prompts and
the prompt-to-prompt config, what the edit needs per step: the cross
mapper (replace or refine), the optional reweight equalizer, the time/word
alpha schedule, the self-replace step window and the two spatial blenders
(ptp/spatial_blend.py). Arrays stay numpy; the pipeline moves them to its
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from fatezero_tpu_torch.ptp.schedules import get_equalizer, get_time_words_attention_alpha
from fatezero_tpu_torch.ptp.seq_aligner import get_refinement_mapper, get_replacement_mapper
from fatezero_tpu_torch.ptp.spatial_blend import SpatialBlender


@dataclasses.dataclass
class EditController:
    num_steps: int
    cross_edit_kind: str  # 'replace' | 'refine'
    mapper: Optional[np.ndarray]  # [1, 77, 77] for replace
    refine_mapper: Optional[np.ndarray]  # [1, 77] for refine
    refine_alphas: Optional[np.ndarray]  # [1, 77]
    equalizer: Optional[np.ndarray]  # [1, 77]
    alpha_time_words: np.ndarray  # [steps+1, 1, 1, 1, 77]
    self_replace_window: Tuple[int, int]
    latent_blend: Optional[SpatialBlender] = None
    attention_blend: Optional[SpatialBlender] = None
    use_inversion_attention: bool = True
    save_self_attention: bool = True

    def self_replace_active(self, step: int) -> bool:
        lo, hi = self.self_replace_window
        return lo <= step < hi

    def step_in_store(self, step: int, num_stored: int) -> int:
        """The store row an edit step reads: an inversion store runs clean ->
        noisy and the edit noisy -> clean, so it is read backwards."""
        if self.use_inversion_attention:
            return num_stored - step - 1
        return step

    def edit_window(self, n_used: int) -> int:
        """Number of leading edit steps that consume inversion-pass attention;
        steps from here on are identity edits (zero alphas, no self swap).
        The blends read the inversion maps at every step, so with a blend the
        window is all n_used steps."""
        if self.latent_blend is not None or self.attention_blend is not None:
            return n_used
        w = min(self.self_replace_window[1], n_used)
        alphas = np.asarray(self.alpha_time_words[:n_used, 0]).reshape(n_used, -1)
        nz = np.nonzero(alphas.any(axis=1))[0]
        if nz.size:
            w = max(w, int(nz[-1]) + 1)
        return int(max(0, min(w, n_used)))


def make_controller(
    tokenizer,
    prompts: List[str],
    num_steps: int,
    is_replace_controller: bool = True,
    cross_replace_steps=0.8,
    self_replace_steps: float = 0.0,
    blend_words=None,
    eq_params: Optional[Dict] = None,
    blend_th=(0.3, 0.3),
    blend_latents: bool = False,
    blend_self_attention: bool = False,
    use_inversion_attention: bool = True,
    save_self_attention: bool = True,
    save_path: Optional[str] = None,
) -> EditController:
    """prompts = [source, target]. `blend_words` builds a blender only under
    `blend_latents` (latent blend, steps 20-80 %, source-target union) or
    `blend_self_attention` (mask on the self swap, every step, source only).
    With `save_path` the blenders write their masks' PNGs under
    `<save_path>/latent_blend_mask` and `<save_path>/attention_blend_mask`
    (SpatialBlender.record)."""
    source, target = prompts[0], prompts[1]
    equal_length = len(source.split(" ")) == len(target.split(" "))
    use_replace = bool(is_replace_controller) and equal_length

    mapper = refine_mapper = refine_alphas = None
    if use_replace:
        mapper = get_replacement_mapper(prompts, tokenizer)
    else:
        refine_mapper, refine_alphas = get_refinement_mapper(prompts, tokenizer)

    equalizer = None
    if eq_params is not None:
        equalizer = get_equalizer(target, eq_params["words"], eq_params["values"], tokenizer)

    alpha_time_words = get_time_words_attention_alpha(
        prompts, num_steps, cross_replace_steps, tokenizer
    )
    if isinstance(self_replace_steps, (int, float)):
        self_replace_steps = (0.0, float(self_replace_steps))
    window = (
        int(num_steps * self_replace_steps[0]),
        int(num_steps * self_replace_steps[1]),
    )

    latent_blend = attention_blend = None
    if blend_words is not None and blend_words != "None":
        if blend_latents:
            latent_blend = SpatialBlender.create(
                prompts, blend_words, tokenizer, num_steps, start_blend=0.2, end_blend=0.8,
                th=blend_th, prompt_choose="both",
                save_path=None if save_path is None else f"{save_path}/latent_blend_mask",
            )
        if blend_self_attention:
            attention_blend = SpatialBlender.create(
                prompts, blend_words, tokenizer, num_steps, start_blend=0.0, end_blend=2.0,
                th=blend_th, prompt_choose="source",
                save_path=None if save_path is None else f"{save_path}/attention_blend_mask",
            )
    return EditController(
        num_steps=num_steps,
        cross_edit_kind="replace" if use_replace else "refine",
        mapper=mapper,
        refine_mapper=refine_mapper,
        refine_alphas=refine_alphas,
        equalizer=equalizer,
        alpha_time_words=alpha_time_words,
        self_replace_window=window,
        latent_blend=latent_blend,
        attention_blend=attention_blend,
        use_inversion_attention=use_inversion_attention,
        save_self_attention=save_self_attention,
    )
