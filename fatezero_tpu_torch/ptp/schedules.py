"""Time/word attention-replace schedules and equalizers (pure numpy).

Ports of the reference's ptp_utils.get_time_words_attention_alpha /
update_alpha_time_word (ptp_utils.py:165-199) and get_equalizer
(attention_util.py:307-316). The resulting [steps+1, 1, 1, 1, 77] alpha tensor
is sliced per step and fed to EditContext as a traced array (no retrace across
steps).
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Union

import numpy as np

from fatezero_tpu_torch.ptp.seq_aligner import get_word_inds

MAX_WORDS = 77


def update_alpha_time_word(
    alpha: np.ndarray,
    bounds: Union[float, Tuple[float, float]],
    prompt_ind: int,
    word_inds: np.ndarray | None = None,
) -> np.ndarray:
    if isinstance(bounds, (int, float)):
        bounds = (0.0, float(bounds))
    start, end = int(bounds[0] * alpha.shape[0]), int(bounds[1] * alpha.shape[0])
    if word_inds is None:
        word_inds = np.arange(alpha.shape[2])
    alpha[:start, prompt_ind, word_inds] = 0
    alpha[start:end, prompt_ind, word_inds] = 1
    alpha[end:, prompt_ind, word_inds] = 0
    return alpha


def get_time_words_attention_alpha(
    prompts: List[str],
    num_steps: int,
    cross_replace_steps: Union[float, Dict[str, Union[float, Tuple[float, float]]]],
    tokenizer,
    max_num_words: int = MAX_WORDS,
) -> np.ndarray:
    """[steps+1, n_prompts-1, 1, 1, 77] word-level replace gate per step."""
    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {"default_": cross_replace_steps}
    else:
        cross_replace_steps = dict(cross_replace_steps)
    if "default_" not in cross_replace_steps:
        cross_replace_steps["default_"] = (0.0, 1.0)
    alpha = np.zeros((num_steps + 1, len(prompts) - 1, max_num_words), np.float32)
    for i in range(len(prompts) - 1):
        update_alpha_time_word(alpha, cross_replace_steps["default_"], i)
    for key, bounds in cross_replace_steps.items():
        if key == "default_":
            continue
        for i, prompt in enumerate(prompts[1:]):
            inds = get_word_inds(prompt, key, tokenizer)
            if len(inds) > 0:
                update_alpha_time_word(alpha, bounds, i, inds)
    return alpha.reshape(num_steps + 1, len(prompts) - 1, 1, 1, max_num_words)


def get_equalizer(
    text: str,
    word_select: Union[str, int, Tuple],
    values: List[float],
    tokenizer,
    max_num_words: int = MAX_WORDS,
) -> np.ndarray:
    """[1, 77] per-token scale for the reweight controller."""
    if isinstance(word_select, (int, str)):
        word_select = (word_select,)
    eq = np.ones((1, max_num_words), np.float32)
    for word, val in zip(word_select, values):
        inds = get_word_inds(text, word, tokenizer)
        eq[:, inds] = val
    return eq
