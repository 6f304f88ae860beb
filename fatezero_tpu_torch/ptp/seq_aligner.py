"""Prompt alignment: token mappers for cross-attention replace / refine.

Device-free numpy port of the prompt-to-prompt alignment logic the reference
uses (video_diffusion/prompt_attention/seq_aligner.py): Needleman-Wunsch
global alignment between source/target token sequences -> refinement mapper
(+ per-token alphas), and the word-level soft permutation matrix for the
replace controller. All outputs are numpy; callers lift to jnp.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

GAP, MATCH, MISMATCH = 0, 1, -1


def global_align(x: List[int], y: List[int]) -> np.ndarray:
    """Needleman-Wunsch traceback matrix (seq_aligner.py:61-76 semantics)."""
    n, m = len(x), len(y)
    score = np.zeros((n + 1, m + 1), np.int32)
    trace = np.zeros((n + 1, m + 1), np.int32)
    score[0, 1:] = (np.arange(m) + 1) * GAP
    score[1:, 0] = (np.arange(n) + 1) * GAP
    trace[0, 1:] = 1
    trace[1:, 0] = 2
    trace[0, 0] = 4
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            left = score[i, j - 1] + GAP
            up = score[i - 1, j] + GAP
            diag = score[i - 1, j - 1] + (MATCH if x[i - 1] == y[j - 1] else MISMATCH)
            best = max(left, up, diag)
            score[i, j] = best
            trace[i, j] = 1 if best == left else (2 if best == up else 3)
    return trace


def aligned_mapper(x: List[int], y: List[int]) -> np.ndarray:
    """[(y_pos, x_pos or -1)] pairs for every target token (seq_aligner.py:79-104)."""
    trace = global_align(x, y)
    i, j = len(x), len(y)
    pairs = []
    while i > 0 or j > 0:
        t = trace[i, j]
        if t == 3:
            i -= 1
            j -= 1
            pairs.append((j, i))
        elif t == 1:
            j -= 1
            pairs.append((j, -1))
        elif t == 2:
            i -= 1
        else:
            break
    pairs.reverse()
    return np.asarray(pairs, np.int64) if pairs else np.zeros((0, 2), np.int64)


def get_mapper(x: str, y: str, tokenizer, max_len: int = 77) -> Tuple[np.ndarray, np.ndarray]:
    """Refinement mapper + alphas for one target prompt (seq_aligner.py:107-118).

    mapper[j] = source token position feeding target token j (or a
    past-the-end identity index for padding); alphas[j] = 1 where the target
    token has a source counterpart (those positions take the inverted map).
    """
    x_ids = tokenizer.encode(x)
    y_ids = tokenizer.encode(y)
    base = aligned_mapper(x_ids, y_ids)
    alphas = np.ones(max_len, np.float32)
    alphas[: base.shape[0]] = (base[:, 1] != -1).astype(np.float32)
    mapper = np.zeros(max_len, np.int64)
    mapper[: base.shape[0]] = base[:, 1]
    mapper[base.shape[0] :] = len(y_ids) + np.arange(max_len - len(y_ids))
    return mapper, alphas


def get_refinement_mapper(prompts: List[str], tokenizer, max_len: int = 77):
    """Stacked mappers/alphas for prompts[1:] against prompts[0]."""
    mappers, alphas = [], []
    for target in prompts[1:]:
        m, a = get_mapper(prompts[0], target, tokenizer, max_len)
        mappers.append(m)
        alphas.append(a)
    return np.stack(mappers), np.stack(alphas)


def get_word_inds(text: str, word_place, tokenizer) -> np.ndarray:
    """Token indices (in the bos-prefixed encoding) covering a prompt word
    (seq_aligner.py:131-149 / ptp_utils.py:144-162)."""
    split_text = text.split(" ")
    if isinstance(word_place, str):
        word_place = [i for i, w in enumerate(split_text) if word_place == w]
    elif isinstance(word_place, int):
        word_place = [word_place]
    out = []
    if len(word_place) > 0:
        words_encode = [tokenizer.decode([i]).strip("#") for i in tokenizer.encode(text)][1:-1]
        cur_len, ptr = 0, 0
        for i in range(len(words_encode)):
            cur_len += len(words_encode[i])
            if ptr in word_place:
                out.append(i + 1)
            if cur_len >= len(split_text[ptr]):
                ptr += 1
                cur_len = 0
    return np.asarray(out, np.int64)


def get_replacement_mapper_(x: str, y: str, tokenizer, max_len: int = 77) -> np.ndarray:
    """77x77 soft permutation for word-level replacement (seq_aligner.py:152-185).

    Requires equal word counts; differing token spans are spread with 1/n
    weights.
    """
    # Algorithm semantics (word-span mapping with 1/n weight spreading) are
    # pinned value-for-value to Google's Apache-2.0 prompt-to-prompt
    # seq_aligner (vendored by the reference) via tests/test_reference_golden.py.
    words_x = x.split(" ")
    words_y = y.split(" ")
    if len(words_x) != len(words_y):
        raise ValueError(
            f"replacement mapping needs equal word counts, got {len(words_x)} "
            f"vs {len(words_y)}; use the refine controller "
            "(is_replace_controller: false) for prompts of different lengths."
        )
    inds_replace = [i for i in range(len(words_y)) if words_y[i] != words_x[i]]
    inds_source = [get_word_inds(x, i, tokenizer) for i in inds_replace]
    inds_target = [get_word_inds(y, i, tokenizer) for i in inds_replace]
    mapper = np.zeros((max_len, max_len), np.float32)
    i = j = 0
    cur = 0
    while i < max_len and j < max_len:
        if cur < len(inds_source) and len(inds_source[cur]) > 0 and inds_source[cur][0] == i:
            s, t = inds_source[cur], inds_target[cur]
            if len(s) == len(t):
                mapper[s, t] = 1.0
            else:
                ratio = 1.0 / len(t)
                for tt in t:
                    mapper[s, tt] = ratio
            cur += 1
            i += len(s)
            j += len(t)
        elif cur < len(inds_source):
            mapper[i, j] = 1.0
            i += 1
            j += 1
        else:
            mapper[j, j] = 1.0
            i += 1
            j += 1
    return mapper


def get_replacement_mapper(prompts: List[str], tokenizer, max_len: int = 77) -> np.ndarray:
    return np.stack(
        [get_replacement_mapper_(prompts[0], p, tokenizer, max_len) for p in prompts[1:]]
    )
