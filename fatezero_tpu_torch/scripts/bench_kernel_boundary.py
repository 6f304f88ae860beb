"""Kernel-boundary probe: the head-split copies around a flash site, on the card.

    python -m fatezero_tpu_torch.scripts.bench_kernel_boundary

Counterpart of scripts/bench_kernel_boundary.py. The projections emit
[B, F, S, H*D] (heads minor), while K1 folds (B*F*H) into rows and therefore
takes [B, F, H, S, D]: every flash site pays a head-split transpose of q, k
and v before the kernel and a merge after it. Two versions of one attention
site of SD-1.4's 64^2 level (q [2, 8, 4096, 320] against a sparse-causal KV
of 8192 tokens, 8 heads of 40, bf16), each LayerNorm -> q/k/v projections
-> attention -> out projection + residual:

* ``site_ship``: the port's own path, `_split_heads5`, `fused_attention`
  (K1) and `_merge_heads5`, so the port's real boundary copies;
* ``site_merged``: K1c (`flash_merged`) on the projection output as it is.

Each is timed as the JAX script does: iterations chained through the output,
one synchronisation, CUDA events. Prints one JSON line: site, ship_ms,
merged_ms, speedup, max_abs_diff (and max_abs_out, the largest output, for
its scale), and the card's name and power limit.
Needs a CUDA device.
"""
from __future__ import annotations

import json

import torch

from fatezero_tpu_torch.models.attention import _merge_heads5, _split_heads5
from fatezero_tpu_torch.ops.flash_attention import fused_attention
from fatezero_tpu_torch.ops.flash_variants import flash_merged
from fatezero_tpu_torch.scripts import card

B, F, S, C = 2, 8, 4096, 320
H = 8  # heads of D = C // H = 40
KV = 2 * S  # sparse-causal gather of 2 frames
DTYPE = torch.bfloat16
ITERS = 10
# each site's calls in main: the output, the settle call and ITERS timed calls
CALLS_PER_SITE = 2 + ITERS


def _ln(x, g, b2):
    """The JAX script's two-pass LayerNorm: fp32 mean and variance."""
    xf = x.float()
    m = xf.mean(dim=-1, keepdim=True)
    var = (xf - m).square().mean(dim=-1, keepdim=True)
    return ((x - m) * torch.rsqrt(var + 1e-5) * g + b2).to(x.dtype)


def site_ship(x, kv_x, wq, wk, wv, wo, g, b2, heads: int = H):
    """The port's path: LN -> proj -> head split -> fused_attention (K1) -> merge -> proj."""
    h, hk = _ln(x, g, b2), _ln(kv_x, g, b2)
    d = wq.shape[1] // heads
    q = _split_heads5(h @ wq, heads)  # [B, F, H, S, D]
    k = _split_heads5(hk @ wk, heads)
    v = _split_heads5(hk @ wv, heads)
    out = fused_attention(q, k, v, d**-0.5)
    return x + _merge_heads5(out) @ wo


def site_merged(x, kv_x, wq, wk, wv, wo, g, b2, heads: int = H):
    """Boundary-free path: K1c consumes the projection output as it is."""
    h, hk = _ln(x, g, b2), _ln(kv_x, g, b2)
    b, f, s, _ = x.shape
    d = wq.shape[1] // heads
    q = (h @ wq).reshape(b * f, s, -1)
    k = (hk @ wk).reshape(b * f, kv_x.shape[2], -1)
    v = (hk @ wv).reshape(b * f, kv_x.shape[2], -1)
    out = flash_merged(q, k, v, d**-0.5, heads)
    return x + out.reshape(b, f, s, -1) @ wo


def make_inputs(b=B, f=F, s=S, c=C, kv=KV, dtype=DTYPE, seed=0, device="cuda"):
    """(x, kv_x, wq, wk, wv, wo, g, b2) drawn from `seed`: activations N(0, 1),
    projections N(0, 0.02^2), LayerNorm scale 1 and bias 0 in fp32."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, std=1.0):
        return (torch.randn(*shape, device=device, generator=gen) * std).to(dtype)

    x, kv_x = normal(b, f, s, c), normal(b, f, kv, c)
    wq, wk, wv, wo = (normal(c, c, std=0.02) for _ in range(4))
    g = torch.ones(c, device=device)
    b2 = torch.zeros(c, device=device)
    return x, kv_x, wq, wk, wv, wo, g, b2


def time_site(fn, args) -> float:
    """ms per call, ITERS iterations chained through the output (a real data
    dependency), after one settle call; one synchronisation at the end."""
    x, rest = args[0], args[1:]
    fn(x, *rest)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    xi = x
    for _ in range(ITERS):
        xi = fn(xi, *rest)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_kernel_boundary needs a CUDA device")
    args = make_inputs()
    ms, outs = {}, {}
    for name, fn in (("ship", site_ship), ("merged", site_merged)):
        outs[name] = fn(*args).float()
        ms[name] = time_site(fn, args)
    result = {
        "site": f"[{B},{F},{S},{C}] H{H} D{C // H} KV{KV} {str(DTYPE).replace('torch.', '')}",
        "ship_ms": ms["ship"],
        "merged_ms": ms["merged"],
        "speedup": ms["ship"] / ms["merged"],
        "max_abs_diff": (outs["ship"] - outs["merged"]).abs().max().item(),
        "max_abs_out": outs["ship"].abs().max().item(),
        "device": card(),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
