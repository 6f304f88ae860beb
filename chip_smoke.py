#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's zero-shot edit once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each synchronised and timed:

1. device: CUDA and compute capability 9.0 are required (there is no CPU path);
2. build: compile the hand-written kernels from fatezero_tpu_torch/csrc;
3. kernels: K1 (flash-attention forward) against its plain PyTorch version
   at every attention-site shape of the edit, in fp32 and bf16, plus a
   double-wide-V case; any shape outside its tolerance fails the run;
4. reference: the slice at a small size (random:tiny, fp32) on the card,
   through the kernels, against the same slice on the CPU (plain versions);
5. slice: the full-width teaser edit (random:sd weights from a seed, teaser
   model_config, 8 frames at 512x512, bf16 model, 10 DDIM steps): encode both
   prompts, VAE-encode a seeded synthetic clip, invert with a full capture,
   edit from the stored payload, decode. Outputs must have the right shapes
   and be finite, K1 must have launched, and no attention site with 256 or
   more queries may have taken the plain path.

The line before the last is a JSON object with each kernel's launch count on
the main path, its worst error against the plain version, and its time beside
the plain version's; the last line is the device contract
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits nonzero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

STEPS = 10  # config/low_resource_teaser/jeep_watercolor_ddim_10_steps.yaml
FRAMES, RES = 8, 512
TEASER = {"lora": 160, "SparseCausalAttention_index": ["mid"], "least_sc_channel": 640}
SOURCE = "a silver jeep driving down a curvy road in the countryside"
TARGET = "watercolor painting of a silver jeep driving down a curvy road in the countryside"

# (site, d, Sq, Skv, dv) of every K1 call in the edit at 64x64 latents; fold
# rows = 2 CFG rows x 8 frames x 8 heads (the inversion folds 64)
K1_ROWS = 2 * FRAMES * 8
K1_SITES = [
    ("64^2 self", 40, 4096, 4096, 40),
    ("64^2 cross", 40, 4096, 77, 40),
    ("32^2 self", 80, 1024, 1024, 80),
    ("32^2 cross", 80, 1024, 77, 80),
    ("16^2 self", 160, 256, 256, 160),
    ("16^2 cross", 160, 256, 77, 160),
]
K1_WIDE_V = ("32^2 wide V", 80, 1024, 1024, 160)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name, fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"[phase] {name}: {dt:.3f} s, max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return out, dt


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels():
    """K1 against xla_attention at every site shape; returns (max_err, ms, plain_ms)
    where the times sum one bf16 call of each main-path site shape."""
    import torch

    from fatezero_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, k1_ms, plain_ms = 0.0, 0.0, 0.0
    for site in K1_SITES + [K1_WIDE_V]:
        name, d, sq, skv, dv = site
        rows = K1_ROWS if site is not K1_WIDE_V else K1_ROWS // 2
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(rows, sq, d, device="cuda", generator=gen).to(dtype)
            k = torch.randn(rows, skv, d, device="cuda", generator=gen).to(dtype)
            v = torch.randn(rows, skv, dv, device="cuda", generator=gen).to(dtype)
            scale = d**-0.5
            out = FA.flash_attention(q, k, v, scale)
            ref = FA.xla_attention(q, k, v, scale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            # fp32: only the summation order differs; bf16: both round the
            # same fp32 value, so they may differ by one unit in the last place
            # (2^-7 relative) at the largest output
            tol = 1e-4 if dtype == torch.float32 else 2**-7 * ref.float().abs().max().item() + 1e-4
            reps = 5 if sq * skv >= 4096 * 4096 else 20
            t_k1 = cuda_ms(lambda: FA.flash_attention(q, k, v, scale), reps)
            t_plain = cuda_ms(lambda: FA.xla_attention(q, k, v, scale), reps)
            log(
                f"[K1] {name:12s} rows={rows} d={d} Sq={sq} Skv={skv} dv={dv} {str(dtype):14s} "
                f"max_abs_err={err:.3e} tol={tol:.3e} k1_ms={t_k1:.3f} plain_ms={t_plain:.3f}"
            )
            if not err <= tol:
                raise AssertionError(f"K1 disagrees with the plain version at {site} {dtype}: {err} > {tol}")
            worst = max(worst, err)
            if dtype == torch.bfloat16 and site is not K1_WIDE_V:
                k1_ms += t_k1
                plain_ms += t_plain
            del q, k, v, out, ref
    torch.cuda.empty_cache()
    return worst, k1_ms, plain_ms


def run_slice(device, tag, model_config, dtype, frames, res, steps, seed=0):
    """Encode prompts and a seeded clip, invert with capture, edit, decode;
    on the card each stage is a timed phase named after `tag`."""
    import torch

    from fatezero_tpu_torch.models.loader import load_models
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
    from fatezero_tpu_torch.ptp.controller import make_controller

    m = load_models(tag, model_config, dtype=dtype, seed=seed, device=device)
    pipe = FateZeroPipeline(
        m.unet, m.vae, m.text_encoder, m.tokenizer, m.schedule, store_dtype=dtype, device=device
    )
    # made on the host so the card and the CPU see the same clip
    gen = torch.Generator().manual_seed(seed)
    video = (torch.rand(frames, res, res, 3, generator=gen) * 2.0 - 1.0).to(device)
    controller = make_controller(
        m.tokenizer, [SOURCE, TARGET], num_steps=steps, is_replace_controller=False,
        cross_replace_steps=0.8, self_replace_steps=0.8,
        eq_params={"words": ["watercolor"], "values": [10]},
    )
    if device.type == "cuda":
        def run(name, fn):
            return phase(f"{tag} {name}", fn)
    else:
        def run(name, fn):
            return fn(), None
    (emb_src, emb_tgt), t_text = run("text", lambda: (pipe.encode_prompt(SOURCE), pipe.encode_prompt(TARGET)))
    latents, t_enc = run("vae_encode", lambda: pipe.encode_video(video))
    (traj, stored), t_inv = run("invert", lambda: pipe.invert_fast(latents, emb_src, steps, capture=True))
    (edited, _), t_edit = run(
        "edit", lambda: pipe.edit_fast(traj, emb_src, emb_tgt, controller, steps, stored=stored)
    )
    decoded, t_dec = run("vae_decode", lambda: pipe.decode_latents(edited))
    outs = dict(emb_src=emb_src, emb_tgt=emb_tgt, latents=latents, traj=traj, edited=edited, decoded=decoded)
    times = dict(text=t_text, vae_encode=t_enc, invert=t_inv, edit=t_edit, vae_decode=t_dec)
    return outs, times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"chip_smoke.py needs an sm_90 (Hopper) card, found capability {cap}")
    from fatezero_tpu_torch import csrc
    from fatezero_tpu_torch.ops import flash_attention as FA

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    _, t_build = phase("build K1", lambda: csrc.load("flash_fwd.cu"))
    (k1_err, k1_ms, k1_plain_ms), _ = phase("K1 vs plain", check_kernels)

    # the slice at a small size, through the kernels on the card, against the
    # plain versions on the CPU: same seed, same weights and inputs
    def reference():
        tiny = dict(model_config=TEASER, dtype=torch.float32, frames=2, res=128, steps=3)
        gpu, _ = run_slice(device, "random:tiny", **tiny)
        cpu, _ = run_slice(torch.device("cpu"), "random:tiny", **tiny)
        for key in ("traj", "edited"):
            a, b = gpu[key].float().cpu(), cpu[key].float()
            err = (a - b).abs().max().item()
            # fp32 on both devices; sums run in other orders (cuDNN vs CPU
            # convolutions, K1 vs matmul attention) over 3+3 UNet passes
            tol = 1e-3 * max(1.0, b.abs().max().item())
            log(f"[reference] tiny {key}: max_abs_err {err:.3e} (tol {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"tiny slice on the card disagrees with the CPU at {key}: {err} > {tol}")
        err = float(abs(gpu["decoded"] - cpu["decoded"]).max())
        log(f"[reference] tiny decoded video: max_abs_err {err:.3e} (tol 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"tiny decoded video disagrees: {err}")

    phase("reference (tiny, card vs CPU)", reference)

    # the main path at full width: count K1 launches and watch the plain path
    plain_queries = []
    plain = FA.xla_attention

    def watched_plain(q, k, v, scale):
        if q.is_cuda:
            plain_queries.append(q.shape[-2])
        return plain(q, k, v, scale)

    FA.xla_attention = watched_plain
    torch.cuda.reset_peak_memory_stats()
    FA.flash_attention.launches = 0
    try:
        outs, times = run_slice(device, "random:sd", TEASER, torch.bfloat16, FRAMES, RES, STEPS)
    finally:
        FA.xla_attention = plain
    launches = FA.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()

    lat = RES // 8
    expect = dict(
        emb_src=(2, 77, 768), emb_tgt=(2, 77, 768), latents=(1, FRAMES, lat, lat, 4),
        traj=(STEPS + 1, 1, FRAMES, lat, lat, 4), edited=(1, FRAMES, lat, lat, 4),
        decoded=(FRAMES, RES, RES, 3),
    )
    for key, shape in expect.items():
        val = outs[key]
        finite = bool(torch.isfinite(val).all()) if torch.is_tensor(val) else bool(np.isfinite(val).all())
        log(f"[slice] {key}: shape {tuple(val.shape)} finite {finite}")
        if tuple(val.shape) != shape or not finite:
            raise AssertionError(f"{key}: expected finite {shape}, got {tuple(val.shape)} finite={finite}")
    log(f"[slice] K1 launches {launches}; plain attention calls on the card: {len(plain_queries)}, "
        f"largest query count {max(plain_queries, default=0)}")
    if launches <= 0:
        raise AssertionError("the main path never launched K1")
    if any(s >= FA.FLASH_MIN_QUERIES for s in plain_queries):
        raise AssertionError("an attention site with >= 256 queries took the plain path")
    log(f"[slice] phase seconds {json.dumps(times)}; peak device memory {peak / 2**30:.2f} GiB; "
        f"K1 build {t_build:.1f} s")

    log(json.dumps({"kernels": [{
        "name": "K1 flash_attention forward",
        "route": "cuda",
        "source": "fatezero_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "fatezero_tpu/ops/flash_attention.py:93",
        "launches": launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
