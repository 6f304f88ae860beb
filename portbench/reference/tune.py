"""One-shot Tune-A-Video updates, plainly.

An update draws its randoms from a host `torch.Generator` (the timestep, the
latent noise and the VAE posterior's sample, then the class image's three
when a class image is given), encodes the clip with the VAE's posterior
sample, noises it to the timestep (alpha-bar taken in the latents' dtype,
as the configuration serves them), and takes the mean squared error of the
UNet's epsilon against the noise (plus the weighted class term with prior
preservation). The trained parameters are those whose names contain
`attn_temporal` or `to_q` (and `conv_temporal` with `train_temporal_conv`);
their gradients are clipped to a global norm and AdamW (torch's decoupled
weight decay) updates them, written out below. Every other weight stays.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from portbench.reference.diffusion import TRAIN_STEPS, Schedule
from portbench.reference.sd import VAE_SCALE, VAE, UNet

TRAINABLE = ("attn_temporal", "to_q")
TEMPORAL_CONV = "conv_temporal"
BETAS = (0.9, 0.999)
EPS = 1e-8


def trainable(names, train_temporal_conv: bool) -> List[str]:
    pats = TRAINABLE + ((TEMPORAL_CONV,) if train_temporal_conv else ())
    return [n for n in names if any(p in n for p in pats)]


def draw(gen: torch.Generator, frames: int, h: int, w: int, classes: int = 0) -> Dict[str, torch.Tensor]:
    """One update's randoms, in the order they are drawn."""
    lat = (frames, h // 8, w // 8, 4)
    d = {"t": torch.randint(0, TRAIN_STEPS, (1,), generator=gen),
         "noise": torch.randn((1, *lat), generator=gen),
         "vae_noise": torch.randn(lat, generator=gen)}
    if classes:
        clat = (classes, h // 8, w // 8, 4)
        d["class_t"] = torch.randint(0, TRAIN_STEPS, (classes,), generator=gen)
        d["class_noise"] = torch.randn((classes, 1, *clat[1:]), generator=gen)
        d["class_vae_noise"] = torch.randn(clat, generator=gen)
    return d


class TuneReference:
    """Float32 updates from the generated weights; `P` the precision policy,
    `latent_dtype` the dtype the configuration trains the latents in."""

    def __init__(self, W: Dict[str, Dict[str, torch.Tensor]], cfg: dict, P, device,
                 latent_dtype: torch.dtype = torch.float32):
        self.cfg, self.P, self.device = cfg, P, device
        self.latent_dtype = latent_dtype
        tr = cfg["train"]
        self.lr = float(tr["learning_rate"])
        self.max_norm = float(tr["max_grad_norm"])
        self.wd = float(tr["weight_decay"])
        self.prior = tr.get("prior_preservation")
        self.params = {n: t.detach().float().clone() for n, t in W["unet"].items()}
        self.names = trainable(self.params, bool(tr["train_temporal_conv"]))
        for n in self.names:
            self.params[n].requires_grad_(True)
        self.unet = UNet(self.params, P, cfg)
        self.unet.checkpoint = True
        self.vae = VAE(W["vae"], P, cfg)
        self.sched = Schedule(device)
        self.m = {n: torch.zeros_like(self.params[n]) for n in self.names}
        self.v = {n: torch.zeros_like(self.params[n]) for n in self.names}
        self.step_count = 0

    @torch.no_grad()
    def _encode(self, images: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        zs = []
        for i in range(images.shape[0]):
            mean, logvar = self.vae.encode(images[i:i + 1])
            zs.append(mean[0] + torch.exp(0.5 * logvar[0]) * noise[i].to(self.device))
        return torch.stack(zs) * VAE_SCALE

    def _loss(self, latents, emb, noise, t):
        noise = noise.to(self.device)
        t = t.to(self.device)
        noisy = self.sched.add_noise(latents, noise, t, self.latent_dtype)
        pred = self.unet.forward(noisy, t, emb)
        return ((pred - noise) ** 2).mean()

    def update(self, images, emb, d, class_images=None, class_emb=None, moments=None):
        """One update; returns (loss, {name: the clipped gradient}). With
        `moments`, the clip's posterior is the one given, not the VAE's own."""
        if moments is None:
            latents = self._encode(images, d["vae_noise"])[None]
        else:
            mean, logvar = moments.float().chunk(2, dim=-1)
            noise = d["vae_noise"].to(self.device)
            latents = ((mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise) * VAE_SCALE)[None]
        with torch.enable_grad():
            loss = self._loss(latents, emb, d["noise"], d["t"])
            total = loss
            if self.prior is not None and class_images is not None:
                lat2 = self._encode(class_images, d["class_vae_noise"])[:, None]
                prior = self.prior * self._loss(lat2, class_emb.expand(lat2.shape[0], -1, -1),
                                                d["class_noise"], d["class_t"])
                total = total + prior
                loss = loss + prior
            grads = torch.autograd.grad(total, [self.params[n] for n in self.names], allow_unused=True)
        grads = {n: (torch.zeros_like(self.params[n]) if g is None else g.detach())
                 for n, g in zip(self.names, grads)}
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        if norm >= self.max_norm:
            grads = {n: g / norm * self.max_norm for n, g in grads.items()}
        self.step_count += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.step_count, 1 - b2 ** self.step_count
        with torch.no_grad():
            for n, g in grads.items():
                p = self.params[n]
                p.mul_(1 - self.lr * self.wd)
                self.m[n].mul_(b1).add_(g, alpha=1 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[n].sqrt() / math.sqrt(c2)).add_(EPS)
                p.addcdiv_(self.m[n], denom, value=-self.lr / c1)
        return float(loss.detach()), grads


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between two sets of norms, each against the
    reference's norm of that leaf or of the median leaf, whichever is larger."""
    names = list(ref) if names is None else names
    med = sorted(ref[n] for n in ref)[len(ref) // 2]
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)
