"""DDIM and prompt-to-prompt, plainly.

* The Stable Diffusion 1.x noise schedule (scaled-linear betas 0.00085 to
  0.012 over 1,000 steps, offset 1, `set_alpha_to_one` false, epsilon
  prediction), the deterministic DDIM step (eta 0), its exact inversion and
  classifier-free guidance.
* Prompt-to-prompt's edit parameters worked out from the token ids: the
  refinement mapper (Needleman-Wunsch alignment of the two prompts' tokens)
  or the word replacement matrix, the reweighting equalizer, the per-step
  word gate of `cross_replace_steps` and the window of `self_replace_steps`;
  and `fuse`, the edit of one controlled site's attention probabilities
  against the source row's, as prompt-to-prompt and FateZero define it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

TRAIN_STEPS = 1000


class Schedule:
    def __init__(self, device, beta_start=0.00085, beta_end=0.012):
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, TRAIN_STEPS, dtype=np.float64) ** 2
        ac = np.cumprod(1.0 - betas)
        self.ac = torch.as_tensor(ac.astype(np.float32), device=device)
        self.final = float(np.float32(ac[0]))

    def alpha(self, t) -> torch.Tensor:
        t = torch.as_tensor(t, device=self.ac.device)
        return torch.where(t >= 0, self.ac[t.clamp(0, TRAIN_STEPS - 1).long()],
                           torch.tensor(self.final, device=self.ac.device))

    @staticmethod
    def timesteps(steps: int) -> List[int]:
        """The descending DDIM grid: leading spacing plus offset 1."""
        ratio = TRAIN_STEPS // steps
        return [min(i * ratio + 1, TRAIN_STEPS - 1) for i in range(steps)][::-1]

    def transfer(self, eps, t_from, t_to, x):
        a_from, a_to = self.alpha(t_from), self.alpha(t_to)
        x0 = (x - (1 - a_from).sqrt() * eps) / a_from.sqrt()
        return a_to.sqrt() * x0 + (1 - a_to).sqrt() * eps

    def eps_coef(self, t_from, t_to) -> float:
        """c in transfer(eps, t_from, t_to, x) = a x + c eps: how much of the
        step is the model's epsilon."""
        a_from, a_to = self.alpha(t_from), self.alpha(t_to)
        return float((1 - a_to).sqrt() - (a_to / a_from).sqrt() * (1 - a_from).sqrt())

    def invert_step(self, eps, t: int, x, steps: int):
        """The latent at t - 1000/steps -> the latent at t."""
        return self.transfer(eps, t - TRAIN_STEPS // steps, t, x)

    def denoise_step(self, eps, t: int, x, steps: int):
        return self.transfer(eps, t, t - TRAIN_STEPS // steps, x)

    def add_noise(self, x0, noise, t, dtype=None):
        """q(x_t | x_0). With `dtype`, the latents' dtype in the configuration,
        alpha-bar is first rounded to it, as diffusers' `add_noise` casts it to
        the sample's dtype (in bfloat16 alpha-bar at t = 1 is 1.0: no noise)."""
        a = self.alpha(t)
        if dtype is not None:
            a = a.to(dtype).float()
        a = a.reshape(-1, *([1] * (x0.dim() - 1)))
        return a.sqrt() * x0 + (1 - a).sqrt() * noise


def guidance(eps_uncond, eps_cond, scale: float):
    return eps_uncond + scale * (eps_cond - eps_uncond)


# --------------------------------------------------------- prompt-to-prompt
def _align(x: Sequence[int], y: Sequence[int]) -> List[tuple]:
    """(target position, source position or -1) for every target token:
    Needleman-Wunsch with gap 0, match 1, mismatch -1 (prompt-to-prompt's
    seq_aligner)."""
    n, m = len(x), len(y)
    score = np.zeros((n + 1, m + 1), np.int64)
    trace = np.zeros((n + 1, m + 1), np.int64)
    trace[0, 1:], trace[1:, 0], trace[0, 0] = 1, 2, 4
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            left, up = score[i, j - 1], score[i - 1, j]
            diag = score[i - 1, j - 1] + (1 if x[i - 1] == y[j - 1] else -1)
            best = max(left, up, diag)
            score[i, j] = best
            trace[i, j] = 1 if best == left else (2 if best == up else 3)
    i, j, pairs = n, m, []
    while i > 0 or j > 0:
        t = trace[i, j]
        if t == 3:
            i, j = i - 1, j - 1
            pairs.append((j, i))
        elif t == 1:
            j -= 1
            pairs.append((j, -1))
        elif t == 2:
            i -= 1
        else:
            break
    return pairs[::-1]


class P2P:
    """A [source, target] edit's parameters, on `device`.

    `tok` holds, per prompt, its ids with bos and eos (`ids`) and the token
    positions of each whitespace word (`spans`). `p2p` holds the mix's
    prompt-to-prompt settings: is_replace_controller, cross_replace_steps,
    self_replace_steps and eq_params, as FateZero's configs name them."""

    def __init__(self, prompts: List[str], tok: Dict, p2p: Dict, steps: int, device, max_len: int = 77):
        src, tgt = prompts
        words_src, words_tgt = src.split(" "), tgt.split(" ")
        self.replace = bool(p2p.get("is_replace_controller", True)) and len(words_src) == len(words_tgt)
        ids_src, ids_tgt = tok["ids"]
        spans_src, spans_tgt = tok["spans"]
        if self.replace:
            mapper = np.zeros((max_len, max_len), np.float32)
            diff = [k for k in range(len(words_tgt)) if words_tgt[k] != words_src[k]]
            s_inds = [spans_src[k] for k in diff]
            t_inds = [spans_tgt[k] for k in diff]
            i = j = cur = 0
            while i < max_len and j < max_len:
                if cur < len(s_inds) and len(s_inds[cur]) > 0 and s_inds[cur][0] == i:
                    s, t = s_inds[cur], t_inds[cur]
                    if len(s) == len(t):
                        mapper[s, t] = 1.0
                    else:
                        for tt in t:
                            mapper[s, tt] = 1.0 / len(t)
                    cur, i, j = cur + 1, i + len(s), j + len(t)
                elif cur < len(s_inds):
                    mapper[i, j] = 1.0
                    i, j = i + 1, j + 1
                else:
                    mapper[j, j] = 1.0
                    i, j = i + 1, j + 1
            self.mapper = torch.as_tensor(mapper, device=device)
        else:
            pairs = np.asarray(_align(ids_src, ids_tgt), np.int64).reshape(-1, 2)
            alphas = np.ones(max_len, np.float32)
            alphas[: len(pairs)] = pairs[:, 1] != -1
            mapper = np.zeros(max_len, np.int64)
            mapper[: len(pairs)] = pairs[:, 1]
            mapper[len(pairs):] = len(ids_tgt) + np.arange(max_len - len(ids_tgt))
            self.refine_mapper = torch.as_tensor(mapper, device=device)
            self.refine_alphas = torch.as_tensor(alphas, device=device)
        eq = np.ones(max_len, np.float32)
        eqp = p2p.get("eq_params")
        if eqp:
            for word, value in zip(eqp["words"], eqp["values"]):
                for k, w in enumerate(words_tgt):
                    if w == word:
                        eq[spans_tgt[k]] = value
        self.eq = torch.as_tensor(eq, device=device)
        # the word gate of each step: 1 while the step lies in cross_replace_steps
        crs = p2p.get("cross_replace_steps", 0.8)
        crs = dict(crs) if isinstance(crs, dict) else {"default_": crs}
        crs.setdefault("default_", (0.0, 1.0))
        gate = np.zeros((steps + 1, max_len), np.float32)

        def span(bounds, cols):
            lo, hi = (0.0, float(bounds)) if isinstance(bounds, (int, float)) else bounds
            a, b = int(lo * (steps + 1)), int(hi * (steps + 1))
            gate[:a, cols] = 0
            gate[a:b, cols] = 1
            gate[b:, cols] = 0

        span(crs["default_"], np.arange(max_len))
        for word, bounds in crs.items():
            if word != "default_":
                cols = [c for k, w in enumerate(words_tgt) if w == word for c in spans_tgt[k]]
                if cols:
                    span(bounds, np.asarray(cols))
        self.alpha_words = torch.as_tensor(gate, device=device)
        srs = p2p.get("self_replace_steps", 0.0)
        lo, hi = (0.0, float(srs)) if isinstance(srs, (int, float)) else srs
        self.self_window = (int(steps * lo), int(steps * hi))

    def self_gate(self, i: int) -> float:
        return 1.0 if self.self_window[0] <= i < self.self_window[1] else 0.0

    def fuse(self, probs: torch.Tensor, is_cross: bool, i: int) -> torch.Tensor:
        """probs [3, f, h, s, kv] of rows (source, target uncond, target cond):
        the target cond row edited against the source row at edit step i."""
        base, cond = probs[0], probs[2]
        if is_cross:
            if self.replace:
                new = torch.einsum("fhsw,wn->fhsn", base, self.mapper)
            else:
                a = self.refine_alphas
                new = base[..., self.refine_mapper] * a + cond * (1 - a)
            new = new * self.eq
            aw = self.alpha_words[i]
            cond = new * aw + (1 - aw) * cond
        else:
            g = self.self_gate(i)
            cond = g * base + (1 - g) * cond
        return torch.stack([probs[0], probs[1], cond])
