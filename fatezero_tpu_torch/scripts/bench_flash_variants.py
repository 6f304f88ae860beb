"""Time the flash-forward variants K1 and K1b at the edit's dominant shapes.

    python -m fatezero_tpu_torch.scripts.bench_flash_variants

Counterpart of scripts/bench_flash_variants.py. At three attention shapes of
the edit, in bf16, with 192 folded rows (3 batch rows x 8 frames x 8 heads)
and head dim 40 (64^2 self, 32^2 self of the value-space site, 64^2 cross), it

* checks max|K1b - K1| (the JAX script's own check) and prints it beside
  max|K1b - plain|, the plain version run with K1b's KV tile;
* times K1 (`flash_attention`), K1b (`flash_bf16`) and, as the yardstick,
  `scaled_dot_product_attention` with CUDA events over a pool of inputs, and
  prints the useful TF/s of each (4 * rows * Sq * Skv * d FLOPs).

K1b's KV tile is fixed (K1B_BLOCK_KV), so there is no block sweep. The last
line is one JSON object with every shape's numbers and the card's name and
power limit. Needs a CUDA device.
"""
from __future__ import annotations

import json

import torch
import torch.nn.functional as F

from fatezero_tpu_torch.ops import flash_attention as FA
from fatezero_tpu_torch.ops import flash_variants as FV
from fatezero_tpu_torch.scripts import card

SHAPES = [
    ("self64", 192, 4096, 4096, 40),
    ("self32-vs", 192, 1024, 1024, 40),  # value-space controlled site
    ("cross64", 192, 4096, 77, 40),
]
POOL = 3
ITERS = 8
# each kernel's calls per shape: the check, the warm-up and ITERS timed calls
CALLS_PER_SHAPE = 2 + ITERS


def time_fn(fn, pool) -> float:
    """ms per call over ITERS calls cycling through `pool`, after a warm-up call."""
    fn(*pool[0])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(ITERS):
        fn(*pool[(i + 1) % len(pool)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main() -> list:
    """Check and time each shape on the CUDA device; one dict per shape."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_flash_variants needs a CUDA device")
    device = card()
    print(f"device: {device}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for name, rows, sq, skv, d in SHAPES:
        pool = [
            tuple(torch.randn(rows, n, d, device="cuda", generator=gen).to(torch.bfloat16) for n in (sq, skv, skv))
            for _ in range(POOL)
        ]
        scale = d**-0.5
        q, k, v = pool[0]
        o_k1 = FA.flash_attention(q, k, v, scale).float()
        o_k1b = FV.flash_bf16(q, k, v, scale).float()
        o_plain = FV.flash_bf16_reference(q, k, v, scale, FV.K1B_BLOCK_KV).float()
        err_k1 = (o_k1b - o_k1).abs().max().item()
        err_plain = (o_k1b - o_plain).abs().max().item()
        max_plain = o_plain.abs().max().item()
        del o_k1, o_k1b, o_plain
        print(f"[{name}] max|K1b - K1| = {err_k1:.3e}  max|K1b - plain| = {err_plain:.3e}", flush=True)
        ms = {
            "K1": time_fn(lambda q, k, v: FA.flash_attention(q, k, v, scale), pool),
            "K1b": time_fn(lambda q, k, v: FV.flash_bf16(q, k, v, scale), pool),
            # the library's attention, timed as a yardstick only
            "sdpa": time_fn(lambda q, k, v: F.scaled_dot_product_attention(q[None], k[None], v[None], scale=scale),
                            pool),
        }
        flops = 4 * rows * sq * skv * d
        for label, t in ms.items():
            print(f"[{name}] {label:5s} {t:8.3f} ms  useful {flops / t / 1e9:6.1f} TF/s", flush=True)
        results.append(dict(shape=name, rows=rows, sq=sq, skv=skv, d=d, max_abs_k1b_k1=err_k1,
                            max_abs_k1b_plain=err_plain, max_abs_plain=max_plain, **{f"{k}_ms": t for k, t in ms.items()},
                            **{f"{k}_tflops": flops / t / 1e9 for k, t in ms.items()}))
        del pool, q, k, v
        torch.cuda.empty_cache()
    print(json.dumps({"shapes": results, "device": device}), flush=True)
    return results


if __name__ == "__main__":
    main()
