#!/usr/bin/env python3
"""Where the device time goes in the PyTorch/CUDA port, on one card.

    python3 scripts/profile_torch_step.py

Builds SD-1.4 at full width with random weights and profiles with
torch.profiler, after warm-up:

* one tuning step of config/tune/jeep.yaml's settings (8 frames at 512x512,
  bf16, per-block gradient checkpointing, lora 160, temporal convs trained);
* the 10-step teaser edit (invert with capture, then edit), default
  LayerNorm and FZ_PALLAS_LN=1.

For each it prints the unprofiled wall time, the device time by kernel
group, the busy share (device time over unprofiled wall) and the top
kernels. The card's name and power limit come first. Needs a CUDA device.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402

GROUPS = [
    ("K1 flash forward", r"flash_fwd"),
    ("K2 flash dQ", r"flash_dq"),
    ("K3 flash dK/dV", r"flash_dkv"),
    ("K4 layer norm", r"layer_norm_kernel"),
    ("convolutions", r"conv|cudnn|implicit|winograd|fft|nchw|nhwc"),
    ("matmuls", r"gemm|cutlass|xmma|cublas|splitK"),
    ("optimizer", r"multi_tensor|adam"),
    ("reductions", r"reduce|Reduce|norm|softmax"),
    ("elementwise and copies", r"elementwise|vectorized|unrolled|copy|cat|index|fill|where|pow|mul|add"),
]


def group(name: str) -> str:
    for label, pattern in GROUPS:
        if re.search(pattern, name):
            return label
    return "other"


def profile(label, fn, wall_reps=2):
    for _ in range(wall_reps):  # warm-up and the unprofiled wall time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    by_group, by_kernel, counts = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_group[group(e.name)] += us
        by_kernel[e.name] += us
        counts[e.name] += 1
    total = sum(by_group.values()) / 1e3
    print(f"[{label}] unprofiled wall {wall:.3f} s; kernel time on the device {total:.1f} ms; "
          f"busy share {total / 1e3 / wall:.1%}", flush=True)
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[{label}]   {g:24s} {us / 1e3:9.1f} ms  {us / 1e3 / total:6.1%}")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[{label}]   top {us / 1e3:9.1f} ms  x{counts[name]:<6d} {name[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_step.py needs a CUDA device", file=sys.stderr)
        return 1
    from fatezero_tpu_torch import csrc
    from fatezero_tpu_torch.models.loader import load_models

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    csrc.build_all(C.KERNEL_SOURCES)
    device = torch.device("cuda")

    m, trainer, video, emb = C.tuning_setup(device, "random:sd", C.JEEP, torch.bfloat16, C.FRAMES, C.RES,
                                            C.TUNE_SEED, C.TUNE_LR)
    state = trainer.init_state()
    gen = torch.Generator().manual_seed(C.TUNE_SEED)
    profile("tuning step", lambda: trainer.step(state, video, emb, gen))
    del m, trainer, state
    torch.cuda.empty_cache()

    sd = load_models("random:sd", C.TEASER, dtype=torch.bfloat16, seed=0, device=device)

    def edit():
        C.run_slice(device, sd, "random:sd", torch.bfloat16, C.FRAMES, C.RES, C.STEPS)

    profile("edit, default LayerNorm", edit)
    os.environ["FZ_PALLAS_LN"] = "1"
    try:
        profile("edit, FZ_PALLAS_LN=1", edit)
    finally:
        del os.environ["FZ_PALLAS_LN"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
