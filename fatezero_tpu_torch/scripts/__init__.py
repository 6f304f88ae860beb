"""Probe scripts of the port: the paths that run the flash variants K1b and K1c.

Run each as a module on a machine with a CUDA card, e.g.
``python -m fatezero_tpu_torch.scripts.bench_flash_variants``.
"""
from __future__ import annotations

import subprocess


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
