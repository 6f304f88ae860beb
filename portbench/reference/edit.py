"""The FateZero edit, plainly: text, VAE, one DDIM inversion step and one
prompt-to-prompt edit step, each from a state it is given.

The edit step runs the source row (the inversion's latent at the step's
noise level, under the source prompt) in one forward beside the target's
unconditional and conditional rows, and edits the conditional row's
attention probabilities against the source row's at every controlled site
(diffusion.P2P.fuse): this is prompt-to-prompt's replay of the inversion,
which FateZero's stored attention computes ahead of time.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference.diffusion import P2P, Schedule, guidance
from portbench.reference.sd import VAE_SCALE, VAE, TextEncoder, UNet


class EditReference:
    def __init__(self, W: Dict[str, Dict[str, torch.Tensor]], cfg: dict, P, mix: dict, tok: Dict, device):
        self.cfg, self.P, self.mix = cfg, P, mix
        self.steps = int(mix["steps"])
        self.unet = UNet(W["unet"], P, cfg)
        self.vae = VAE(W["vae"], P, cfg)
        self.text = TextEncoder(W["text_encoder"], P, cfg)
        self.sched = Schedule(device)
        self.ts = Schedule.timesteps(self.steps)
        self.p2p = P2P([mix["source"], mix["target"]], tok, mix["p2p"], self.steps, device)
        self.device = device

    @torch.no_grad()
    def encode_prompt(self, ids: np.ndarray) -> torch.Tensor:
        """ids [2, 77] (empty prompt, prompt) -> embeddings [2, 77, C]."""
        return self.text.forward(torch.as_tensor(ids, device=self.device))

    @torch.no_grad()
    def encode_video(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [f, H, W, 3] in [-1, 1] -> scaled posterior means [1, f, H/8, W/8, 4]."""
        return torch.stack([self.vae.encode(frames[i:i + 1])[0][0] for i in range(frames.shape[0])])[None] * VAE_SCALE

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """[1, f, h, w, 4] -> frames [f, 8h, 8w, 3] in [0, 1]."""
        z = latents[0] / VAE_SCALE
        out = torch.cat([self.vae.decode(z[i:i + 1]) for i in range(z.shape[0])])
        return (out / 2 + 0.5).clamp(0, 1)

    @torch.no_grad()
    def invert_step(self, x: torch.Tensor, i: int, emb_src: torch.Tensor):
        """Inversion step i (clean -> noisy) from the latent at step i: (the
        latent at step i + 1, the epsilon, the epsilon's coefficient in the step)."""
        t = self.ts[self.steps - 1 - i]
        eps = self.unet.forward(x, t, emb_src[-1:])
        dt = 1000 // self.steps
        return self.sched.invert_step(eps, t, x, self.steps), eps, self.sched.eps_coef(t - dt, t)

    @torch.no_grad()
    def edit_step(self, x: torch.Tensor, i: int, source: torch.Tensor, emb_src, emb_tgt):
        """Edit step i (noisy -> clean) from latent x, against `source`, the
        inversion's latent at the same noise level: (the next latent, the
        guided epsilon, its coefficient in the step)."""
        t = self.ts[i]
        self.unet.ctl = lambda probs, place, is_cross: self.p2p.fuse(probs, is_cross, i)
        try:
            eps = self.unet.forward(torch.cat([source, x, x]), t, torch.cat([emb_src[-1:], emb_tgt]))
        finally:
            self.unet.ctl = None
        eps = guidance(eps[1:2], eps[2:3], float(self.mix["guidance_scale"]))
        dt = 1000 // self.steps
        return self.sched.denoise_step(eps, t, x, self.steps), eps, self.sched.eps_coef(t, t - dt)


    @torch.no_grad()
    def site(self, name: str, x: torch.Tensor, context, i: int) -> torch.Tensor:
        """One controlled attention site of edit step i from its inputs: x
        [3, f, s, c] the rows (source, target uncond, target cond), context
        [3, 77, C] (None for self-attention) -> the site's output [3, f, s, c],
        the target cond row's attention edited against the source row's."""
        u = self.unet
        sparse = () if (u.least_sc and x.shape[-1] < u.least_sc) else u.sparse
        u.ctl = lambda probs, place, is_cross: self.p2p.fuse(probs, is_cross, i)
        try:
            return u.attention(name, x, context, name.split("_")[0], sparse)
        finally:
            u.ctl = None


class PooledEpsGap:
    """The gap of the epsilon a side's steps imply, pooled over the sampled
    steps: sqrt(sum ||x_next - ref_next||^2 / c^2 / sum ||eps_ref||^2). A DDIM
    step is a x + c eps, so (x_next - ref_next) / c is the gap of the side's
    epsilon to the reference's, which no cancellation between the latent and
    epsilon terms of a step can inflate."""

    def __init__(self):
        self.num = 0.0
        self.den = 0.0
        self.steps = []

    def add(self, x_next: torch.Tensor, ref_next: torch.Tensor, eps_ref: torch.Tensor, c: float) -> None:
        gap = float((x_next.double() - ref_next.double()).norm()) / abs(c)
        norm = float(eps_ref.double().norm())
        self.num += gap * gap
        self.den += norm * norm
        self.steps.append(gap / norm)

    def value(self) -> float:
        return (self.num / self.den) ** 0.5


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def sample_steps(rng: np.random.Generator, units: int, steps: int, count: int) -> List[tuple]:
    """`count` distinct (unit, step) pairs drawn from `rng`."""
    pool = units * steps
    picks = rng.choice(pool, size=min(count, pool), replace=False)
    return sorted((int(p) // steps, int(p) % steps) for p in picks)
