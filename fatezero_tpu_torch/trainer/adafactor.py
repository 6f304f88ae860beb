"""Adafactor: a torch optimizer with the update rule of optax.adafactor.

Counterpart of the JAX package's `optimizer: "adafactor"`, which chains
`optax.clip_by_global_norm(max_grad_norm)` (done by the trainer) with
`optax.adafactor(learning_rate=lr)` at its defaults:

  * second moments factored into a row and a column mean of g^2 + EPS for
    tensors whose two largest dims are both >= MIN_DIM (128), a full second
    moment otherwise (1-D tensors, small matrices);
  * decay 1 - (t + 1)^-DECAY_RATE (0.8) at update t (counted from 0);
  * the update clipped to an RMS of at most CLIP (1.0);
  * scaled by the learning rate and by max(RMS(parameter), MIN_SCALE)
    (`multiply_by_parameter_scale`, MIN_SCALE 1e-3);
  * no momentum and no weight decay.

The state holds `step` and the fp32 accumulators `v_row`, `v_col` (factored)
or `v`. Plain elementwise torch: the JAX version has no Pallas kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

DECAY_RATE = 0.8
EPS = 1e-30
CLIP = 1.0
MIN_DIM = 128
MIN_SCALE = 1e-3


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """(d1, d0): the second-largest and the largest dim of `shape` when both
    are at least MIN_DIM, else None (optax's _factored_dims, with numpy's
    argsort for the same choice among equal dims)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("Adafactor.step takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                st = self.state[p]
                dims = factored_dims(tuple(p.shape))
                if not st:
                    st["step"] = 0
                    if dims is not None:
                        d1, d0 = dims
                        st["v_row"] = torch.zeros(np.delete(p.shape, d0).tolist(), device=p.device)
                        st["v_col"] = torch.zeros(np.delete(p.shape, d1).tolist(), device=p.device)
                    else:
                        st["v"] = torch.zeros(p.shape, device=p.device)
                # fp32 scalars, as optax computes them
                t = torch.tensor(st["step"] + 1, dtype=torch.float32, device=p.device)
                decay = 1.0 - t ** (-DECAY_RATE)
                g2 = g * g + EPS
                if dims is not None:
                    d1, d0 = dims
                    st["v_row"] = decay * st["v_row"] + (1.0 - decay) * g2.mean(dim=d0)
                    st["v_col"] = decay * st["v_col"] + (1.0 - decay) * g2.mean(dim=d1)
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_mean = st["v_row"].mean(dim=reduced_d1, keepdim=True)
                    row_factor = (st["v_row"] / row_mean) ** -0.5
                    col_factor = st["v_col"] ** -0.5
                    u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                else:
                    st["v"] = decay * st["v"] + (1.0 - decay) * g2
                    u = g * st["v"] ** -0.5
                u = u / torch.clamp(torch.sqrt((u * u).mean()) / CLIP, min=1.0)
                u = u * group["lr"]
                p32 = p.float()
                rms = torch.sqrt((p32 * p32).mean())
                u = u * torch.where(rms <= MIN_SCALE, torch.full_like(rms, MIN_SCALE), rms)
                p.copy_(p32 - u)
                st["step"] += 1
        return None
