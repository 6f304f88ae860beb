"""One-shot Tune-A-Video fine-tuning (torch), the reference trainer's semantics.

Counterpart of fatezero_tpu/trainer/ddpm_trainer.py:

  * only parameters whose name contains "attn_temporal" or "to_q" (plus the
    temporal convs and their LoRA pairs, `conv_temporal`, with
    `train_temporal_conv`) are trained; every other parameter gets
    `requires_grad=False` and is never handed to the optimizer, so it stays
    bit-identical (the JAX package's multi_transform + set_to_zero);
  * loss = MSE between the UNet prediction and epsilon (or velocity) on
    VAE-encoded, noised video latents; optional prior preservation on class
    images;
  * gradients clipped to a global norm, then AdamW (torch's, whose decoupled
    decay equals optax.adamw's) or the int8-state AdamW (trainer/adam8bit.py),
    with the diffusers learning-rate schedule family (`make_lr_schedule`);
  * `gradient_checkpointing` in the UNet config recomputes every down, mid
    and up block in the backward pass (models/unet3d.py).

Precision: the JAX package keeps fp32 parameters and computes in the model
dtype. Here the UNet computes with weights in the model dtype (bf16 on the
card), and the trainer keeps an fp32 master copy of each trainable parameter
for the optimizer: the bf16 gradient is widened to fp32 (as the cotangent of
JAX's cast is), AdamW updates the master, and the master is rounded into the
bf16 weight, which is what JAX's bf16 compute does with its fp32 parameter at
the next use. Frozen weights need no fp32 copy. In fp32 the master is the
parameter itself.

Randoms: JAX draws t, the noise and the VAE posterior sample from split keys.
Here `draw` takes them from a host `torch.Generator` in a fixed order, so a
seed gives the same draws on the card and the CPU, and `_update` takes
explicit draws (a test can hand it JAX's).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from fatezero_tpu_torch.models.vae import VAE_SCALE
from fatezero_tpu_torch.ops import schedule as S

TRAINABLE = ("attn_temporal", "to_q")
TEMPORAL_CONV = ("conv_temporal",)  # holds the flax conv_temporal_* and lora_temporal_* leaves
STATE_FILE = "training_state.pt"


def trainable_mask(module: torch.nn.Module, patterns=TRAINABLE, train_temporal_conv: bool = False) -> Dict[str, bool]:
    """{parameter name: trainable} by substring match on the parameter names."""
    pats = list(patterns) + (list(TEMPORAL_CONV) if train_temporal_conv else [])
    return {name: any(p in name for p in pats) for name, _ in module.named_parameters()}


# ------------------------------------------------------------------ schedules
# optax's schedules as plain functions of the step (optax counts from 0)


def _polynomial(init: float, end: float, power: float, steps: int) -> Callable[[int], float]:
    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac**power + end

    return schedule


def _cosine_decay(init: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    def schedule(count: int) -> float:
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _join(schedules, boundaries) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = fn(step - boundary)
        return out

    return schedule


def make_lr_schedule(
    name: str,
    learning_rate: float,
    train_steps: int,
    warmup_steps: int = 0,
    num_cycles: float = 0.5,
    power: float = 1.0,
) -> Callable[[int], float]:
    """The diffusers get_scheduler family, as the JAX package builds it from optax."""
    warmup = _polynomial(0.0, learning_rate, 1.0, max(warmup_steps, 1))
    rest = max(train_steps - warmup_steps, 1)
    if name in ("constant", "constant_with_warmup"):
        main = lambda count: learning_rate  # noqa: E731
    elif name == "linear":
        main = _polynomial(learning_rate, 0.0, 1.0, rest)
    elif name == "cosine":
        main = _cosine_decay(learning_rate, rest)
    elif name == "cosine_with_restarts":
        n = max(int(num_cycles), 1)
        per = max(rest // n, 1)
        main = _join([_cosine_decay(learning_rate, per) for _ in range(n)], [per * (i + 1) for i in range(n - 1)])
    elif name == "polynomial":
        main = _polynomial(learning_rate, 0.0, power, rest)
    else:
        raise ValueError(f"unknown lr scheduler {name!r}")
    if warmup_steps > 0:
        return _join([warmup, main], [warmup_steps])
    return main


# ---------------------------------------------------------------------- draws


@dataclasses.dataclass
class Draws:
    """The randoms of one update: timestep [1], latent noise [1, f, h, w, c] and
    the VAE posterior sample [f, h, w, c]; the class_* ones for prior
    preservation ([b], [b, 1, h, w, c], [b, h, w, c])."""

    t: torch.Tensor
    noise: torch.Tensor
    vae_noise: torch.Tensor
    class_t: Optional[torch.Tensor] = None
    class_noise: Optional[torch.Tensor] = None
    class_vae_noise: Optional[torch.Tensor] = None

    def to(self, device) -> "Draws":
        return Draws(**{k: None if v is None else v.to(device) for k, v in dataclasses.asdict(self).items()})


# ----------------------------------------------------------------- persistence


def save_training_state(path: str, state: Dict) -> None:
    """Persist the optimizer state, the fp32 masters and the step for exact resume."""
    os.makedirs(path, exist_ok=True)
    torch.save(
        {"step": state["step"], "optimizer": state["optimizer"].state_dict(),
         "master": {n: m.detach() for n, m in state["master"].items()}},
        os.path.join(path, STATE_FILE),
    )


def load_training_state(path: str, trainer: "DDPMTrainer", state: Dict) -> Dict:
    """Restore what `save_training_state` wrote into a freshly initialised state
    of the same model and optimizer config."""
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    if set(saved["master"]) != set(state["master"]):
        raise ValueError(
            f"training state at {path} holds {len(saved['master'])} trainable tensors but the "
            f"current trainer trains {len(state['master'])}: resume with the same settings "
            "(train_temporal_conv, lora, ...) as the run that saved it"
        )
    with torch.no_grad():
        for name, master in state["master"].items():
            master.copy_(saved["master"][name])
            param = trainer.trainable[name]
            if param is not master:
                param.copy_(master)
    state["optimizer"].load_state_dict(saved["optimizer"])
    state["step"] = int(saved["step"])
    return state


# --------------------------------------------------------------------- trainer


class DDPMTrainer:
    """Holds the models and the update rule; `step(state, images, text_emb, gen)` is one update."""

    def __init__(
        self,
        unet,
        vae,
        schedule: Optional[S.DiffusionSchedule] = None,
        learning_rate: float = 3e-5,
        lr_scheduler: str = "constant",
        lr_warmup_steps: int = 0,
        train_steps: int = 300,
        max_grad_norm: float = 1.0,
        train_temporal_conv: bool = False,
        use_8bit_adam: bool = False,
        optimizer: Optional[str] = None,  # "adamw" | "adamw8bit" | "adafactor"
        prediction_type: str = "epsilon",
        prior_preservation: Optional[float] = None,
        weight_decay: float = 1e-2,
    ):
        self.unet = unet
        self.vae = vae
        device = next(unet.parameters()).device
        self.schedule = schedule if schedule is not None else S.make_schedule(
            prediction_type=prediction_type, device=device
        )
        self.prior_preservation = prior_preservation
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay
        self.lr = make_lr_schedule(lr_scheduler, learning_rate, train_steps, lr_warmup_steps)
        self.optimizer = optimizer or ("adamw8bit" if use_8bit_adam else "adamw")
        if self.optimizer == "adafactor":
            raise NotImplementedError("the adafactor optimizer is not ported yet: use adamw or adamw8bit")
        if self.optimizer not in ("adamw", "adamw8bit"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        mask = trainable_mask(unet, train_temporal_conv=train_temporal_conv)
        for name, p in unet.named_parameters():
            p.requires_grad_(mask[name])
        for p in vae.parameters():
            p.requires_grad_(False)
        self.trainable = {name: p for name, p in unet.named_parameters() if mask[name]}
        cfg = vae.cfg
        self._vae_factor = 2 ** (len(cfg.block_out_channels) - 1)
        self._latent_channels = cfg.latent_channels

    def init_state(self) -> Dict:
        """{"step", "optimizer", "master"}: master holds an fp32 copy of each
        trainable parameter (the parameter itself where it is fp32)."""
        master = {
            n: p if p.dtype == torch.float32 else p.detach().float().clone()
            for n, p in self.trainable.items()
        }
        params = list(master.values())
        if self.optimizer == "adamw8bit":
            from fatezero_tpu_torch.trainer.adam8bit import AdamW8bit

            opt = AdamW8bit(params, lr=self.lr(0), weight_decay=self.weight_decay)
        else:
            opt = torch.optim.AdamW(params, lr=self.lr(0), betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=self.weight_decay)
        return {"step": 0, "optimizer": opt, "master": master}

    # ------------------------------------------------------------------ draws
    def draw(self, generator: torch.Generator, image_shape, class_shape=None) -> Draws:
        """Randoms of one update from a host generator (same draws on any device)."""
        def normal(shape):
            return torch.randn(shape, generator=generator)

        def randint(n):
            return torch.randint(0, self.schedule.num_train_timesteps, (n,), generator=generator)

        def latent(shape):
            f, h, w, _ = shape
            return (f, h // self._vae_factor, w // self._vae_factor, self._latent_channels)

        lat = latent(image_shape)
        d = Draws(t=randint(1), noise=normal((1, *lat)), vae_noise=normal(lat))
        if class_shape is not None:
            clat = latent(class_shape)
            d.class_t = randint(clat[0])
            d.class_noise = normal((clat[0], 1, *clat[1:]))
            d.class_vae_noise = normal(clat)
        return d

    # ------------------------------------------------------------------- loss
    @torch.no_grad()
    def _encode(self, images: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """VAE posterior sample of [n, h, w, 3] images, scaled: [n, h/8, w/8, 4]."""
        mean, logvar = self.vae.encode(images)
        z = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
        return z * VAE_SCALE

    def _loss(self, latents, text_emb, noise, t):
        noise = noise.to(latents.dtype)
        noisy = S.add_noise(self.schedule, latents, noise, t)
        pred = self.unet(noisy, t, text_emb)
        if self.schedule.prediction_type == "epsilon":
            target = noise
        elif self.schedule.prediction_type == "v_prediction":
            target = S.get_velocity(self.schedule, latents, noise, t)
        else:
            raise ValueError(self.schedule.prediction_type)
        return torch.mean((pred.float() - target.float()) ** 2)

    def _update(self, state, images, text_emb, draws: Draws, class_images=None, class_text_emb=None):
        """One parameter update with explicit draws; returns the loss (on the device).
        The clipped fp32 gradients stay in each master's `.grad` until the next update."""
        for p in self.trainable.values():
            p.grad = None
        latents = self._encode(images, draws.vae_noise)[None]  # [1, f, h, w, 4]
        loss = self._loss(latents, text_emb, draws.noise, draws.t)
        if self.prior_preservation is not None and class_images is not None:
            lat2 = self._encode(class_images, draws.class_vae_noise)[:, None]  # [b, 1, h, w, 4]
            loss = loss + self.prior_preservation * self._loss(lat2, class_text_emb, draws.class_noise, draws.class_t)
        loss.backward()

        # optax.clip_by_global_norm: g unchanged if |g| < max_norm, else g / |g| * max_norm;
        # a parameter the forward did not reach has a zero gradient (still decayed), as in JAX
        grads = {
            n: p.grad.float() if p.grad is not None else torch.zeros_like(state["master"][n])
            for n, p in self.trainable.items()
        }
        g_norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        keep = g_norm < self.max_grad_norm
        for n, g in grads.items():
            state["master"][n].grad = torch.where(keep, g, g / g_norm * self.max_grad_norm)

        opt = state["optimizer"]
        for group in opt.param_groups:
            group["lr"] = self.lr(state["step"])
        opt.step()
        with torch.no_grad():
            for n, master in state["master"].items():
                param = self.trainable[n]
                if param is not master:
                    param.copy_(master)
        state["step"] += 1
        return loss.detach()

    def step(self, state, images, text_emb, generator: torch.Generator, class_images=None, class_text_emb=None):
        """One update on images [f, h, w, 3] in [-1, 1] with text_emb [1, 77, C] (cond);
        the randoms come from `generator` (a host generator). Returns (state, loss)."""
        device = images.device
        draws = self.draw(generator, images.shape, None if class_images is None else class_images.shape)
        loss = self._update(state, images, text_emb, draws.to(device), class_images, class_text_emb)
        return state, loss

    def run_steps(
        self,
        state,
        frames,
        text_emb,
        generator: torch.Generator,
        num_steps: int,
        crop: Optional[Tuple[int, int]] = None,
        class_images=None,
        class_text_emb=None,
    ):
        """`num_steps` updates on one clip; frames [f, H, W, 3] stay on the device and
        each step takes an independent uniform random crop to `crop` (h, w) when
        given. Returns (state, per-step losses [num_steps])."""
        losses = []
        for _ in range(num_steps):
            images = frames
            if crop is not None:
                ch, cw = crop
                _, h, w, _ = frames.shape
                top = int(torch.randint(0, h - ch + 1, (), generator=generator))
                left = int(torch.randint(0, w - cw + 1, (), generator=generator))
                images = frames[:, top : top + ch, left : left + cw]
            state, loss = self.step(state, images, text_emb, generator, class_images, class_text_emb)
            losses.append(loss)
        return state, torch.stack(losses)
