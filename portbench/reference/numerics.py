"""The precision the reference computes in.

`FP32` is the reference itself: plain float32 products with TF32 switched off
(`strict_fp32`). `FP8` is the correctness control: the same reference with
every operand of every product (weights, activations, attention
probabilities) rounded to float8 e4m3 under a per-tensor scale, the step
below the bfloat16 that the configurations state. Under autograd the
rounding passes the gradient straight through, so the control's backward
runs on the rounded operands the forward saved.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def strict_fp32() -> None:
    """Float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class FP32:
    name = "fp32"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))

    def lin(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        return F.linear(self.q(x), self.q(w), b)

    def conv(self, x: torch.Tensor, w: torch.Tensor, b, stride: int = 1, padding: int = 0) -> torch.Tensor:
        """Conv2d on channels-last [N, H, W, C]."""
        y = F.conv2d(self.q(x).permute(0, 3, 1, 2), self.q(w), b, stride=stride, padding=padding)
        return y.permute(0, 2, 3, 1)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.q(a), self.q(b))


class FP8(FP32):
    name = "fp8"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        amax = t.detach().abs().amax().float().clamp_min(1e-30)
        scale = amax / E4M3_MAX
        r = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
        return t + (r - t).detach() if t.requires_grad else r


def policy(name: str):
    return {"fp32": FP32, "fp8": FP8}[name]()
