"""8-bit-state AdamW: a torch optimizer holding int8 moments on the device.

Counterpart of fatezero_tpu/trainer/adam8bit.py (the reference's
`use_8bit_adam`, bitsandbytes' AdamW8bit): AdamW with the same first and
second moments, bias correction and decoupled weight decay, but both moment
tensors stored as int8 with one fp32 absmax scale per block of 256 values
(~2 bytes per parameter of state instead of 8). The code is blockwise absmax
plus mu-law companding (near-constant relative precision over ~3 decades),
and the second moment is stored as sqrt(v). The update follows the JAX
package's optax chain: scale by 8-bit Adam, add decayed weights, scale by the
learning rate, add to the parameter.

Plain elementwise torch: the JAX version has no Pallas kernel (XLA fuses the
dequantise -> Adam -> requantise chain there), so nothing here is a kernel.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_MU = 255.0
_LOG1P_MU = float(np.log1p(_MU))


def _quantize(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise absmax + mu-law int8 code of a tensor: (int8 [padded n], fp32 [blocks])."""
    flat = x.reshape(-1).float()
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    absmax = blocks.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    y = blocks.abs() / scale[:, None]
    c = torch.round(127.0 * torch.log1p(_MU * y) / _LOG1P_MU)
    return (torch.sign(blocks) * c).to(torch.int8).reshape(-1), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape, block: int) -> torch.Tensor:
    qf = q.reshape(-1, block).float()
    y = torch.expm1(qf.abs() * (_LOG1P_MU / 127.0)) / _MU
    blocks = torch.sign(qf) * y * scale[:, None]
    n = int(np.prod(shape))
    return blocks.reshape(-1)[:n].reshape(shape)


class AdamW8bit(torch.optim.Optimizer):
    """AdamW with int8 blockwise moments. State per parameter: `step`, the
    codes and scales of m (`m_q`, `m_scale`) and of sqrt(v) (`v_q`, `v_scale`)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, block_size: int = 256):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      block_size=block_size))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("AdamW8bit.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            block, eps, lr, wd = group["block_size"], group["eps"], group["lr"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    blocks = -(-p.numel() // block)
                    st["step"] = 0
                    for key in ("m", "v"):
                        st[f"{key}_q"] = torch.zeros(blocks * block, dtype=torch.int8, device=p.device)
                        st[f"{key}_scale"] = torch.ones(blocks, dtype=torch.float32, device=p.device)
                st["step"] += 1
                count = st["step"]
                one = torch.ones((), dtype=torch.float32, device=p.device)
                bc1 = 1.0 - (one * b1) ** count
                bc2 = 1.0 - (one * b2) ** count
                g = p.grad.float()
                m = b1 * _dequantize(st["m_q"], st["m_scale"], g.shape, block) + (1.0 - b1) * g
                v_sqrt = _dequantize(st["v_q"], st["v_scale"], g.shape, block)
                v = b2 * v_sqrt * v_sqrt + (1.0 - b2) * g * g
                upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                st["m_q"], st["m_scale"] = _quantize(m, block)
                st["v_q"], st["v_scale"] = _quantize(torch.sqrt(v), block)
                upd = upd + wd * p.float()
                p.copy_(p.float() + upd * (-lr))
        return None
