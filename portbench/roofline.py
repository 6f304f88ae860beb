"""The chip's published peaks and the bound of an operation against them.

NVIDIA H100 SXM data sheet, dense rates: 989 TFLOP/s in bf16 and fp16 on the
tensor cores, 3.35 TB/s of HBM3 bandwidth. The rates assume the full 700 W
power limit; `card()` reports the limit the card was set to, which every
number measured against these peaks is printed beside.
"""
from __future__ import annotations

import subprocess
from typing import Iterable, Optional, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations over
    the peak rate and the bytes over the peak bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def total_bound_s(ops: Iterable[Tuple[float, float]]) -> float:
    """Sum of each (flops, bytes) operation's own bound."""
    return sum(bound_s(f, b) for f, b in ops)


def share_pct(bound: float, measured_s: float) -> Optional[float]:
    """The bound as a percentage of the measured time, or None without a time."""
    if not measured_s or measured_s <= 0:
        return None
    return 100.0 * bound / measured_s


def mfu_pct(flops: float, seconds: float) -> Optional[float]:
    """Useful operations per second as a percentage of the bf16 peak."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS


def card() -> dict:
    """The card's name and power limit as nvidia-smi reads them ({} where it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    name, limit = (s.strip() for s in out.splitlines()[0].split(","))
    try:
        return {"smi_name": name, "power_limit_w": float(limit)}
    except ValueError:
        return {"smi_name": name}
