#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's edit and one-shot tuning on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each synchronised and timed:

1. device: CUDA and compute capability 9.0 are required (there is no CPU path);
2. build: compile the hand-written kernels from fatezero_tpu_torch/csrc, one
   nvcc per source, all started together;
3. kernels, each against its plain PyTorch version on the same inputs:
   K1 (flash-attention forward) at every attention-site shape of the edit, in
   fp32 and bf16, plus a double-wide-V case; K1 with its log-sum-exp, K2 (dQ)
   and K3 (dK, dV) against plain autograd through `xla_attention` at every
   training-site shape, in fp32 and bf16; K4 (LayerNorm) against `_ln_math`
   at the edit's LayerNorm shapes; K1b (bf16-P flash forward) against its
   plain version with K1b's KV tile at the flash-variants probe's shapes, with
   max|K1b - K1| beside it; K1c (merged-head flash forward) against its plain
   version at the kernel-boundary probe's site and at ragged cross shapes, in
   fp32 and bf16; then the three forward kernels at tile-edge shapes (KV
   lengths around the 64-key tile, a ragged query tile, every head dim, fp32
   and bf16, with and without the log-sum-exp, one operand that starts
   off a 16-byte boundary, a negative scale and scale 0); K2 and K3 at their
   own tile-edge shapes (query counts and KV lengths around the 64-row tiles,
   every head dim, fp32 and bf16, a negative scale, each operand in turn off
   a 16-byte boundary) against their plain version and plain autograd. Each
   [K1], [K1b], [K1c] and [K1-K3] line also gives the
   useful TFLOP/s, the share of the bound and the path the library's dispatch
   took (CUDA cores or tensor cores, which tile loader), which must be the
   one `kernel_plan` predicts; K1c's lines time K1 on the same work with its
   heads folded (k1_folded_ms). Any value outside its tolerance fails;
4. reference: the edit at a small size (random:tiny, fp32) on the card,
   through the kernels, against the same edit on the CPU (plain versions);
5. tuning reference: one tuning update at a small size (random:tiny, fp32,
   128x128 frames, so K1/K2/K3 run) on the card against the CPU, with the
   same host-drawn randoms;
   edit modes reference: the blenders' masks on seeded maps, then the blend
   config (below) at a small size (random:tiny, 2 frames of 16x16 seeded
   latents, seeded text embeddings, fp32) in every edit mode, card against
   CPU: stored with both blends, replay, inline, hybrid (2 of 4 rows, with and
   without inversion attention), strength 0.5 and viz; latents, every
   normalised blend map (with the threshold band shown empty) and every mask;
6. the main paths at full SD-1.4 width (random:sd weights from a seed), each
   driven with every launch count set to 0 just before it and read just
   after:
   a. edit: the teaser edit (teaser model_config, 8 frames at 512x512, bf16,
      10 DDIM steps): encode both prompts, VAE-encode a seeded synthetic
      clip, invert with a full capture, edit from the stored payload, decode;
      K1's launches are then listed by shape and by the kernel each took;
   b. the same edit with FZ_PALLAS_LN=1 (LayerNorm through K4), held to (a);
      then the blend config, config/teaser/jeep_posche_local_latent_blend.yaml
      (lora 160, default sparse-causal, replace cross 0.5 self 0.5,
      blend_words, both blends at th 0.3; 8 frames at 512x512, bf16, 10
      steps) in the modes, each timed once: stored with both blends, stored
      without blends, replay, a hybrid planned by plan_capture at 40 % of
      the payload, and inline (latent blend only, as inline allows);
      each prints invert and edit seconds, peak memory, the payload predicted
      and held, and K1's launches against the count from the sites' shapes;
      on the stored edit's trajectory, replay and hybrid must agree with
      stored to one bf16 unit;
   c. tuning: three updates of config/tune/jeep.yaml's settings (lora 160,
      gradient checkpointing, temporal convs trained, lr 1e-5 constant, seed
      74831) on 8 frames at 512x512 in bf16;
   d. the flash-variants probe (fatezero_tpu_torch.scripts.bench_flash_variants),
      the path of K1b: K1, K1b and the library's attention at three edit
      shapes (192 folded rows, d 40, bf16);
   e. the kernel-boundary probe (fatezero_tpu_torch.scripts.bench_kernel_boundary),
      the path of K1c: one 64^2 attention site with the port's head-split
      copies around K1, and with K1c on the projection output as it is.
   Outputs must be finite and of the right shapes, every kernel of a path
   must have launched, K1/K2/K3 must have launched once per counted site and
   K1b/K1c once per probe call, no attention site with 256 or more queries
   may take the plain path, frozen parameters must stay bit-identical and
   some trainable ones must move.

The line before the last two is a JSON object with each kernel's launches on
its main path, worst error against the plain version, time beside the plain
version's, the library call's and the bound; then the card's name and power
limit; the last line is the device contract
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits nonzero.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

STEPS = 10  # config/low_resource_teaser/jeep_watercolor_ddim_10_steps.yaml
FRAMES, RES = 8, 512
TEASER = {"lora": 160, "SparseCausalAttention_index": ["mid"], "least_sc_channel": 640}
SOURCE = "a silver jeep driving down a curvy road in the countryside"
TARGET = "watercolor painting of a silver jeep driving down a curvy road in the countryside"
# config/tune/jeep.yaml: model_config, gradient_checkpointing, seed, learning_rate,
# train_temporal_conv (lr_scheduler defaults to constant)
JEEP = {"lora": 160, "gradient_checkpointing": True}
JEEP_PROMPT = "a silver jeep driving down a curvy road in the countryside,"
TUNE_SEED, TUNE_LR, TUNE_STEPS = 74831, 1e-5, 3

# config/teaser/jeep_posche_local_latent_blend.yaml: model_config, prompts
# (the dataset prompt and the editing prompt) and p2p_config
POSCHE_MODEL = {"lora": 160}
POSCHE_SOURCE = "a silver jeep driving down a curvy road in the countryside,"
POSCHE_TARGET = "a Porsche car driving down a curvy road in the countryside,"
POSCHE_P2P = dict(
    is_replace_controller=True, cross_replace_steps={"default_": 0.5}, self_replace_steps=0.5,
    blend_words=[["silver", "jeep"], ["Porsche", "car"]], blend_th=[0.3, 0.3],
    blend_latents=True, blend_self_attention=True, use_inversion_attention=True,
)
HYBRID_BUDGET = 0.4  # the hybrid's payload budget, a share of the full payload
# the tiny modes, card against CPU in fp32 (sharp_cross_state's weights):
# the normalised blend maps of an edit that both devices run from one
# trajectory and payload (measured <= 5.0e-5 on the H100), and each captured
# payload leaf relative to max(1, max|leaf|): the payload carries the
# inversion's drift between the devices, which sharp softmaxes amplify
# (measured <= 1.26e-2 at trajectories that part by <= 2.1e-3)
MODES_MAP_TOL = 1e-4
MODES_PAYLOAD_TOL = 5e-2

KERNEL_SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "layer_norm.cu", "flash_fwd_bf16.cu", "flash_fwd_merged.cu")
# one H100 SXM (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12

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
# (site, d, Sq, Skv) of every flash call in tuning: rows = 1 x 8 frames x 8
# heads; sparse-causal [-1, 'first'] self-attention sees 2 frames of keys
TRAIN_ROWS = FRAMES * 8
TRAIN_SITES = [
    ("64^2 self", 40, 4096, 8192),
    ("64^2 cross", 40, 4096, 77),
    ("32^2 self", 80, 1024, 2048),
    ("32^2 cross", 80, 1024, 77),
    ("16^2 self", 160, 256, 512),
    ("16^2 cross", 160, 256, 77),
]
# [rows, C] of every LayerNorm in the edit (2 CFG rows x 8 frames x tokens),
# and CLIP's (2 prompts x 77 tokens)
LN_SHAPES = [(2 * FRAMES * 4096, 320), (2 * FRAMES * 1024, 640), (2 * FRAMES * 256, 1280),
             (2 * FRAMES * 64, 1280), (2 * 77, 768)]
# (site, rows, heads, Sq, Skv, D) of K1c: the kernel-boundary probe's site (2
# batch rows x 8 frames, sparse-causal KV of 2 frames), then ragged cross
# shapes at each head dim
K1C_SITES = [
    ("boundary self", 16, 8, 4096, 8192, 40),
    ("64^2 cross", 16, 8, 4096, 77, 40),
    ("32^2 cross", 16, 8, 1024, 77, 80),
    ("16^2 cross", 16, 8, 256, 77, 160),
]


# tile-edge shapes of the three forward kernels: KV lengths around the 64-key
# tile (and the 77 text tokens), a whole and a ragged query tile, every head dim
EDGE_SKV = (1, 63, 64, 65, 77, 128, 129, 200)
EDGE_SQ = (256, 300)
EDGE_D = (40, 80, 160)
# the backward's: query counts around its 64-row tiles, KV lengths around them
EDGE_BWD_SQ = (1, 63, 64, 65, 127, 129, 300)
EDGE_BWD_SKV = (1, 64, 77, 129, 200)


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


def device_ms(fn, reps: int) -> float:
    """Kernel time on the device per call of `fn` (torch.profiler), summed over
    every kernel it launches. For calls short enough that host overhead
    between launches would dominate CUDA-event timing."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps


class Totals:
    """Per-kernel sums over the main-path shapes (bf16) of the check phases."""

    def __init__(self):
        self.err = 0.0
        self.ms = self.plain_ms = self.bound_ops_ms = self.bound_bytes_ms = 0.0
        self.library_ms = 0.0

    def add(self, ms, plain_ms, library_ms, flops, nbytes):
        self.ms += ms
        self.plain_ms += plain_ms
        self.library_ms += library_ms
        self.bound_ops_ms += flops / PEAK_BF16_FLOPS * 1e3
        self.bound_bytes_ms += nbytes / PEAK_BYTES * 1e3

    def entry(self, name, source, replaces, launches):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": self.err, "ms": self.ms, "plain_ms": self.plain_ms,
            "bound_ms": max(self.bound_ops_ms, self.bound_bytes_ms),
            "bound_by": "operations" if self.bound_ops_ms >= self.bound_bytes_ms else "bytes",
            "library_ms": self.library_ms,
        }


def sdpa(q, k, v, scale):
    """The library call computing K1's function: [B, S, d] folded rows as heads."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q[None], k[None], v[None], scale=scale)[0]


def rate(flops, nbytes, ms) -> str:
    """Useful TFLOP/s and the share of the bound for one timed shape."""
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    return f"tflops={flops / ms / 1e9:.1f} of_bound={bound / ms:.1%}"


def took(plan: dict, expect: dict) -> str:
    """The path the built library chose, which must be kernel_plan's."""
    if plan != expect:
        raise AssertionError(f"the library's dispatch {plan} is not kernel_plan's {expect}")
    return f"path={plan['path']}/{plan['loader']}"


def check_edit_k1(k1: Totals):
    """K1 against xla_attention at every edit site shape; adds the bf16 main-path
    shapes to k1's sums."""
    import torch

    from fatezero_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(0)
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
            t_lib = cuda_ms(lambda: sdpa(q, k, v, scale), reps) if dv == d else float("nan")
            flops = 2 * rows * sq * skv * (d + dv)
            nbytes = q.element_size() * rows * (sq * d + skv * d + skv * dv + sq * dv)
            path = took(FA.flash_forward_plan(q, k, v), FA.kernel_plan(d, dv, dtype))
            log(
                f"[K1] {name:12s} rows={rows} d={d} Sq={sq} Skv={skv} dv={dv} {str(dtype):14s} "
                f"max_abs_err={err:.3e} tol={tol:.3e} k1_ms={t_k1:.3f} plain_ms={t_plain:.3f} sdpa_ms={t_lib:.3f} "
                f"{rate(flops, nbytes, t_k1)} {path}"
            )
            if not err <= tol:
                raise AssertionError(f"K1 disagrees with the plain version at {site} {dtype}: {err} > {tol}")
            k1.err = max(k1.err, err)
            if dtype == torch.bfloat16 and site is not K1_WIDE_V:
                k1.add(t_k1, t_plain, t_lib, flops, nbytes)
            del q, k, v, out, ref
    torch.cuda.empty_cache()


def check_training_kernels(k2: Totals, k3: Totals):
    """K1 with its LSE, K2 and K3 against plain autograd through xla_attention
    at every tuning site shape; adds the bf16 shapes to k2's and k3's sums."""
    import torch

    from fatezero_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = TRAIN_ROWS
    for name, d, sq, skv in TRAIN_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (
                torch.randn(rows, n, d, device="cuda", generator=gen).to(dtype) for n in (sq, skv, skv, sq)
            )
            scale = d**-0.5
            o, lse = FA.flash_forward(q, k, v, scale, with_lse=True)
            dq = FA.flash_dq(q, k, v, o, lse, do, scale)
            dk, dv = FA.flash_dkv(q, k, v, o, lse, do, scale)
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
            ref_o = FA.xla_attention(qr, kr, vr, scale)
            ref_grads = torch.autograd.grad(ref_o, (qr, kr, vr), do)
            ref_lse = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, -1)
            torch.cuda.synchronize()
            errs, bad = {}, []
            for key, got, ref in [("o", o, ref_o), ("lse", lse, ref_lse), ("dq", dq, ref_grads[0]),
                                  ("dk", dk, ref_grads[1]), ("dv", dv, ref_grads[2])]:
                ref = ref.detach().float()
                err = (got.float() - ref).abs().max().item()
                big = ref.abs().max().item()
                if key == "lse" or dtype == torch.float32:
                    # fp32 arithmetic on both sides, summed in other orders
                    tol = 1e-4 * max(1.0, big)
                elif key == "o":
                    tol = 2**-7 * big + 1e-4  # one bf16 unit at the largest output
                else:
                    # two bf16 units at the largest gradient: the rounding of
                    # the output, and delta read from the bf16 O
                    tol = 2**-6 * big + 1e-4
                errs[key] = err
                if not err <= tol:
                    bad.append(f"{key}: {err:.3e} > tol {tol:.3e}")
            del ref_o, ref_grads, qr, kr, vr, ref_lse
            if bad:
                log(f"[K1-K3] {name} {dtype} disagrees with plain autograd: {'; '.join(bad)}")
                raise AssertionError(f"K1/K2/K3 disagree with plain autograd at {name} {dtype}")
            reps = 3 if sq * skv >= 4096 * 4096 else 10
            t_k1 = cuda_ms(lambda: FA.flash_forward(q, k, v, scale, with_lse=True), reps)
            t_k2 = cuda_ms(lambda: FA.flash_dq(q, k, v, o, lse, do, scale), reps)
            t_k3 = cuda_ms(lambda: FA.flash_dkv(q, k, v, o, lse, do, scale), reps)
            t_plain_fwd = cuda_ms(lambda: FA.attention_with_lse(q, k, v, scale), reps)
            t_plain_bwd = cuda_ms(lambda: FA.flash_bwd_reference(q, k, v, o, lse, do, scale), reps)
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            with torch.enable_grad():
                lib_out = sdpa(qs, ks, vs, scale)
            t_lib = cuda_ms(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do, retain_graph=True), reps)
            del lib_out, qs, ks, vs
            tok = rows * d * q.element_size()  # bytes of one token's row of one operand
            work2 = (6 * rows * sq * skv * d, tok * (4 * sq + 2 * skv) + 4 * rows * sq)
            work3 = (8 * rows * sq * skv * d, tok * (3 * sq + 4 * skv) + 4 * rows * sq)
            path2, path3 = (took(FA.flash_bwd_plan(kind, q, k, v, o, do), FA.bwd_kernel_plan(kind, d, dtype))
                            for kind in ("dq", "dkv"))
            log(
                f"[K1-K3] {name:10s} rows={rows} d={d} Sq={sq} Skv={skv} {str(dtype):14s} "
                + " ".join(f"err_{key}={e:.3e}" for key, e in errs.items())
                + f" k1_lse_ms={t_k1:.3f} k2_ms={t_k2:.3f} k3_ms={t_k3:.3f} plain_fwd_ms={t_plain_fwd:.3f}"
                f" plain_bwd_ms={t_plain_bwd:.3f} sdpa_bwd_ms={t_lib:.3f}"
                f" | K2 {rate(*work2, t_k2)} {path2} | K3 {rate(*work3, t_k3)} {path3}"
            )
            k2.err = max(k2.err, errs["dq"])
            k3.err = max(k3.err, errs["dk"], errs["dv"])
            if dtype == torch.bfloat16:
                k2.add(t_k2, t_plain_bwd, t_lib, *work2)
                k3.add(t_k3, t_plain_bwd, t_lib, *work3)
            del q, k, v, do, o, lse, dq, dk, dv
            torch.cuda.empty_cache()


def check_layer_norm(k4: Totals):
    """K4 against _ln_math at the edit's LayerNorm shapes, fp32 and bf16."""
    import torch
    import torch.nn.functional as F

    from fatezero_tpu_torch.ops import fused_norm as FN

    gen = torch.Generator(device="cuda").manual_seed(2)
    for rows, c in LN_SHAPES:
        scale = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = (2.0 * torch.randn(rows, c, device="cuda", generator=gen) + 0.5).to(dtype)
            out = FN.layer_norm_kernel(x, scale, bias, 1e-5)
            ref = FN._ln_math(x, scale, bias, 1e-5).float()
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            big = ref.abs().max().item()
            # fp32: sums in another order; bf16: one unit in the last place of
            # the largest output
            tol = 1e-5 * max(1.0, big) if dtype == torch.float32 else 2**-7 * big + 1e-5
            # a K4 call is shorter than its host overhead: device time, not events
            t_k4 = device_ms(lambda: FN.layer_norm_kernel(x, scale, bias, 1e-5), 20)
            t_plain = device_ms(lambda: FN._ln_math(x, scale, bias, 1e-5), 20)
            ws, bs = scale.to(dtype), bias.to(dtype)
            t_lib = device_ms(lambda: F.layer_norm(x, (c,), ws, bs, 1e-5), 20)
            log(f"[K4] rows={rows} C={c} {str(dtype):14s} max_abs_err={err:.3e} tol={tol:.3e} "
                f"k4_ms={t_k4:.4f} plain_ms={t_plain:.4f} layer_norm_ms={t_lib:.4f}")
            if not err <= tol:
                raise AssertionError(f"K4 disagrees with _ln_math at {(rows, c)} {dtype}: {err} > {tol}")
            k4.err = max(k4.err, err)
            if dtype == torch.bfloat16 and c != 768:
                k4.add(t_k4, t_plain, t_lib, 8 * rows * c, 2 * 2 * rows * c + 8 * c)


def check_k1b(k1b: Totals):
    """K1b against its plain version, with K1b's KV tile, at the flash-variants
    probe's shapes (bf16), with max|K1b - K1| beside it for information."""
    import torch

    from fatezero_tpu_torch.ops import flash_attention as FA
    from fatezero_tpu_torch.ops import flash_variants as FV
    from fatezero_tpu_torch.scripts.bench_flash_variants import SHAPES

    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, rows, sq, skv, d in SHAPES:
        q, k, v = (torch.randn(rows, n, d, device="cuda", generator=gen).to(torch.bfloat16) for n in (sq, skv, skv))
        scale = d**-0.5
        # the plain version runs tile by tile (K1B_BLOCK_KV keys), so the
        # [rows, Sq, Skv] fp32 scores never exist whole
        plain = lambda: FV.flash_bf16_reference(q, k, v, scale, FV.K1B_BLOCK_KV)  # noqa: E731
        out = FV.flash_bf16(q, k, v, scale).float()
        ref = plain().float()
        err = (out - ref).abs().max().item()
        err_k1 = (out - FA.flash_forward(q, k, v, scale)[0].float()).abs().max().item()
        # both round the same values to bf16; where the two exps differ in the
        # last fp32 place a probability may round the other way, and the
        # output to bf16 may then differ by one unit at the largest output
        tol = 2**-7 * ref.abs().max().item() + 1e-4
        del out, ref
        reps = 5 if sq * skv >= 4096 * 4096 else 20
        t_k1b = cuda_ms(lambda: FV.flash_bf16(q, k, v, scale), reps)
        t_plain = cuda_ms(plain, 3)
        t_lib = cuda_ms(lambda: sdpa(q, k, v, scale), reps)
        flops, nbytes = 4 * rows * sq * skv * d, 2 * rows * d * (2 * sq + 2 * skv)
        path = took(FV.flash_bf16_plan(q, k, v), FA.kernel_plan(d, d, torch.bfloat16, bf16_p=True))
        log(f"[K1b] {name:10s} rows={rows} d={d} Sq={sq} Skv={skv} max_abs_err={err:.3e} tol={tol:.3e} "
            f"max|K1b-K1|={err_k1:.3e} k1b_ms={t_k1b:.3f} plain_ms={t_plain:.3f} sdpa_ms={t_lib:.3f} "
            f"{rate(flops, nbytes, t_k1b)} {path}")
        if not err <= tol:
            raise AssertionError(f"K1b disagrees with its plain version at {name}: {err} > {tol}")
        k1b.err = max(k1b.err, err)
        k1b.add(t_k1b, t_plain, t_lib, flops, nbytes)
        del q, k, v
        torch.cuda.empty_cache()


def check_k1c(k1c: Totals):
    """K1c against its plain version (chunked by rows) at K1C_SITES, fp32 and
    bf16; adds the bf16 boundary site, the probe's shape, to k1c's sums."""
    import torch
    import torch.nn.functional as F

    from fatezero_tpu_torch.ops import flash_attention as FA
    from fatezero_tpu_torch.ops import flash_variants as FV

    gen = torch.Generator(device="cuda").manual_seed(4)
    for site in K1C_SITES:
        name, rows, heads, sq, skv, d = site
        # rows per plain call: ~1 GiB of fp32 scores (the whole boundary site's are 17 GB)
        chunk = max(1, 2**30 // (heads * sq * skv * 4))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(rows, n, heads * d, device="cuda", generator=gen).to(dtype) for n in (sq, skv, skv))
            scale = d**-0.5

            def plain():
                return torch.cat([FV.merged_attention_reference(q[i:i + chunk], k[i:i + chunk], v[i:i + chunk],
                                                                scale, heads) for i in range(0, rows, chunk)])

            def split(t):
                return t.unflatten(-1, (heads, d)).transpose(1, 2)  # strided [R, H, S, D] view

            out = FV.flash_merged(q, k, v, scale, heads)
            ref = plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = 1e-4 if dtype == torch.float32 else 2**-7 * ref.float().abs().max().item() + 1e-4  # K1's
            del out, ref
            reps = 5 if sq * skv >= 4096 * 4096 else 20
            t_k1c = cuda_ms(lambda: FV.flash_merged(q, k, v, scale, heads), reps)
            t_plain = cuda_ms(plain, 3)
            t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(split(q), split(k), split(v), scale=scale), reps)
            # K1 on the same work, its heads folded into rows by a copy that is not timed
            qf, kf, vf = (split(x).reshape(rows * heads, -1, d).contiguous() for x in (q, k, v))
            t_k1 = cuda_ms(lambda: FA.flash_forward(qf, kf, vf, scale), reps)
            del qf, kf, vf
            flops = 4 * rows * heads * sq * skv * d
            nbytes = q.element_size() * rows * heads * d * (2 * sq + 2 * skv)
            path = took(FV.flash_merged_plan(q, k, v, heads), FA.kernel_plan(d, d, dtype, merged=True))
            log(f"[K1c] {name:13s} rows={rows} heads={heads} d={d} Sq={sq} Skv={skv} {str(dtype):14s} "
                f"max_abs_err={err:.3e} tol={tol:.3e} k1c_ms={t_k1c:.3f} plain_ms={t_plain:.3f} sdpa_ms={t_lib:.3f} "
                f"k1_folded_ms={t_k1:.3f} {rate(flops, nbytes, t_k1c)} {path}")
            if not err <= tol:
                raise AssertionError(f"K1c disagrees with its plain version at {name} {dtype}: {err} > {tol}")
            k1c.err = max(k1c.err, err)
            if dtype == torch.bfloat16 and site is K1C_SITES[0]:
                k1c.add(t_k1c, t_plain, t_lib, flops, nbytes)
            del q, k, v
            torch.cuda.empty_cache()


def shifted(t):
    """A copy of t in storage one element on: contiguous, but 2 bytes off a 16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 2
    return out


def check_forward_edges():
    """K1 (with and without its log-sum-exp), K1b and K1c against their plain
    versions where a ring of KV tiles can break: KV lengths around the tile,
    a ragged query tile, every head dim, fp32 and bf16; then bf16 operands
    that start 2 bytes off a 16-byte boundary, which must take the element
    loader; then a negative scale and scale 0. Tolerances are those of the
    path-shape checks."""
    import torch

    from fatezero_tpu_torch.ops import flash_attention as FA
    from fatezero_tpu_torch.ops import flash_variants as FV

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, heads = 2, 2
    worst = {}

    def hold(kernel, got, ref, tol, what):
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{kernel} disagrees with its plain version at {what}: {err} > {tol}")
        worst[kernel] = max(worst.get(kernel, 0.0), err)

    def three_kernels(q, k, v, qm, km, vm, scale, what):
        """q, k, v [rows, S, d]; qm, km, vm [rows, S, heads * d]"""
        dtype = q.dtype
        ref, ref_lse = FA.attention_with_lse(q, k, v, scale)
        big = ref.float().abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else 2**-7 * big + 1e-4
        hold("K1", FA.flash_forward(q, k, v, scale)[0], ref, tol, what)
        o, lse = FA.flash_forward(q, k, v, scale, with_lse=True)
        hold("K1", o, ref, tol, what + " with lse")
        hold("K1 lse", lse, ref_lse, 1e-4 * max(1.0, ref_lse.abs().max().item()), what)
        ref_b = FV.flash_bf16_reference(q, k, v, scale, FV.K1B_BLOCK_KV)
        hold("K1b", FV.flash_bf16(q, k, v, scale), ref_b, 2**-7 * ref_b.float().abs().max().item() + 1e-4, what)
        ref_m = FV.merged_attention_reference(qm, km, vm, scale, heads)
        tol_m = 1e-4 if dtype == torch.float32 else 2**-7 * ref_m.float().abs().max().item() + 1e-4
        hold("K1c", FV.flash_merged(qm, km, vm, scale, heads), ref_m, tol_m, what)

    n = 0
    for d in EDGE_D:
        scale = d**-0.5
        for sq in EDGE_SQ:
            for skv in EDGE_SKV:
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v = (torch.randn(rows, s, heads * d, device="cuda", generator=gen).to(dtype)
                               for s in (sq, skv, skv))
                    three_kernels(q[..., :d].contiguous(), k[..., :d].contiguous(), v[..., :d].contiguous(),
                                  q, k, v, scale, f"d={d} Sq={sq} Skv={skv} {dtype}")
                    n += 1

    paths = set()
    for d, sq, skv in [(40, 300, 77), (80, 256, 129), (160, 256, 200)]:
        scale = d**-0.5
        q, k, v = (torch.randn(rows, s, heads * d, device="cuda", generator=gen).to(torch.bfloat16)
                   for s in (sq, skv, skv))
        qf, kf, vf = (t[..., :d].contiguous() for t in (q, k, v))
        for which in range(3):  # q, then k, then v off the boundary
            folded = [shifted(t) if i == which else t for i, t in enumerate((qf, kf, vf))]
            merged = [shifted(t) if i == which else t for i, t in enumerate((q, k, v))]
            for plan, mirror in [
                (FA.flash_forward_plan(*folded), FA.kernel_plan(d, d, torch.bfloat16, aligned=False)),
                (FV.flash_bf16_plan(*folded), FA.kernel_plan(d, d, torch.bfloat16, aligned=False, bf16_p=True)),
                (FV.flash_merged_plan(*merged, heads), FA.kernel_plan(d, d, torch.bfloat16, aligned=False, merged=True)),
            ]:
                paths.add(took(plan, mirror))
                if plan["loader"] != "element":
                    raise AssertionError(f"a misaligned operand took the {plan['loader']} loader")
            three_kernels(*folded, *merged, scale, f"d={d} Sq={sq} Skv={skv} operand {which} off a 16-byte boundary")
            n += 1
    # a negative scale (K1 and K1c launch with -q and -scale) and scale 0 (a
    # uniform softmax over the keys, the ragged tail's masked ones excluded)
    for d in EDGE_D:
        for sq, skv in [(300, 77), (256, 129)]:
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.randn(rows, s, heads * d, device="cuda", generator=gen).to(dtype)
                           for s in (sq, skv, skv))
                for scale in (-(d**-0.5), 0.0):
                    three_kernels(q[..., :d].contiguous(), k[..., :d].contiguous(), v[..., :d].contiguous(),
                                  q, k, v, scale, f"d={d} Sq={sq} Skv={skv} {dtype} scale={scale}")
                    n += 1
    torch.cuda.synchronize()
    log(f"[edges] {n} shapes x (K1, K1+lse, K1b, K1c) within tolerance; worst errors "
        + " ".join(f"{key}={err:.3e}" for key, err in worst.items())
        + f"; misaligned operands took {sorted(paths)}")


def check_backward_edges():
    """K1 with its log-sum-exp, K2 and K3 against flash_bwd_reference and plain
    autograd through xla_attention where their blocks and rings can break:
    query counts around the 64-row tiles, KV lengths around them (and the 77
    text tokens), every head dim, fp32 and bf16; a negative scale; then bf16
    operands that start 2 bytes off a 16-byte boundary (each of q, k, v, o
    and dO in turn) or a head dim that is no multiple of 8, which must take
    the element loader. Tolerances are check_training_kernels'."""
    import torch

    from fatezero_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = 2
    worst = {}

    def hold(q, k, v, o, do, scale, what):
        dtype = q.dtype
        lse = FA.flash_forward(q, k, v, scale, with_lse=True)[1]
        dq = FA.flash_dq(q, k, v, o, lse, do, scale)
        dk, dv = FA.flash_dkv(q, k, v, o, lse, do, scale)
        refs = FA.flash_bwd_reference(q, k, v, o, lse, do, scale)
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        grads = torch.autograd.grad(FA.xla_attention(qr, kr, vr, scale), (qr, kr, vr), do)
        for key, got, ref, auto in zip(("dq", "dk", "dv"), (dq, dk, dv), refs, grads):
            for against, r in (("reference", ref), ("autograd", auto)):
                r = r.detach().float()
                big = r.abs().max().item()
                tol = 1e-4 * max(1.0, big) if dtype == torch.float32 else 2**-6 * big + 1e-4
                err = (got.float() - r).abs().max().item()
                if not err <= tol:
                    raise AssertionError(f"{key} disagrees with the {against} at {what}: {err} > {tol}")
                worst[key] = max(worst.get(key, 0.0), err)

    def operands(sq, skv, d, dtype):
        q, k, v, do = (torch.randn(rows, s, d, device="cuda", generator=gen).to(dtype) for s in (sq, skv, skv, sq))
        return q, k, v, do

    n = 0
    for d in EDGE_D:
        scale = d**-0.5
        for sq in EDGE_BWD_SQ:
            for skv in EDGE_BWD_SKV:
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v, do = operands(sq, skv, d, dtype)
                    o = FA.flash_forward(q, k, v, scale)[0]
                    hold(q, k, v, o, do, scale, f"d={d} Sq={sq} Skv={skv} {dtype}")
                    n += 1
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = operands(129, 77, d, dtype)
            o = FA.flash_forward(q, k, v, -scale)[0]
            hold(q, k, v, o, do, -scale, f"d={d} Sq=129 Skv=77 {dtype} scale={-scale}")
            n += 1

    paths = set()
    for d, sq, skv, which in [(40, 300, 77, w) for w in range(5)] + [(80, 129, 200, w) for w in range(5)] + \
            [(160, 65, 129, w) for w in range(5)] + [(36, 129, 77, None)]:
        scale = d**-0.5
        q, k, v, do = operands(sq, skv, d, torch.bfloat16)
        o = FA.flash_forward(q, k, v, scale)[0]
        ops = [shifted(t) if i == which else t for i, t in enumerate((q, k, v, o, do))]
        for kind in ("dq", "dkv"):
            plan = FA.flash_bwd_plan(kind, *ops)
            paths.add(took(plan, FA.bwd_kernel_plan(kind, d, torch.bfloat16, aligned=which is None)))
            if plan["loader"] != "element":
                raise AssertionError(f"{kind} with operand {which} off a 16-byte boundary, d={d}, took the "
                                     f"{plan['loader']} loader")
        hold(*ops, scale, f"d={d} Sq={sq} Skv={skv} operand {which} off a 16-byte boundary")
        n += 1
    torch.cuda.synchronize()
    log(f"[bwd edges] {n} shapes x (K2, K3) within tolerance of flash_bwd_reference and autograd; worst errors "
        + " ".join(f"{key}={err:.3e}" for key, err in worst.items())
        + f"; misaligned or odd-width operands took {sorted(paths)}")


def log_k1_paths(calls):
    """The edit's K1 launches by shape and by the kernel `kernel_plan` gives each
    (the operands are contiguous copies, on 16-byte boundaries): how many lie
    off the tensor cores (a double-wide V at d 160 would take the CUDA-core kernel)."""
    import collections

    from fatezero_tpu_torch.ops import flash_attention as FA

    by_path = collections.Counter()
    for (rows, sq, skv, d, dv, dtype), n in sorted(collections.Counter(calls).items(), key=lambda kv: -kv[1]):
        plan = FA.kernel_plan(d, dv, dtype)
        log(f"[edit] K1 x{n:<4d} rows={rows} Sq={sq} Skv={skv} d={d} dv={dv} {str(dtype):14s} "
            f"path={plan['path']}/{plan['loader']}")
        by_path[plan["path"]] += n
    log(f"[edit] K1 launches by path: {json.dumps(by_path)}")


def run_slice(device, m, tag, dtype, frames, res, steps, seed=0):
    """Encode prompts and a seeded clip, invert with capture, edit, decode with
    the models `m` (load_models' bundle); on the card each stage is a timed
    phase named after `tag`."""
    import torch

    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
    from fatezero_tpu_torch.ptp.controller import make_controller

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


def tuning_setup(device, tag, model_config, dtype, frames, res, seed, lr):
    """Models, trainer, a seeded synthetic clip and the prompt's embedding."""
    import torch

    from fatezero_tpu_torch.models.loader import load_models
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
    from fatezero_tpu_torch.trainer.ddpm_trainer import DDPMTrainer

    m = load_models(tag, model_config, dtype=dtype, seed=seed, device=device)
    pipe = FateZeroPipeline(m.unet, m.vae, m.text_encoder, m.tokenizer, m.schedule, device=device)
    gen = torch.Generator().manual_seed(seed)
    video = (torch.rand(frames, res, res, 3, generator=gen) * 2.0 - 1.0).to(device)
    emb = pipe.encode_prompt(JEEP_PROMPT)[-1:].clone()  # cond half only, as cli/train.py
    trainer = DDPMTrainer(m.unet, m.vae, schedule=m.schedule, learning_rate=lr, train_temporal_conv=True)
    return m, trainer, video, emb


def tiny_tuning_reference():
    """One tuning update at a small size, card against CPU, same host draws."""
    import torch

    lr = 1e-3
    runs = {}
    for device in (torch.device("cuda"), torch.device("cpu")):
        m, trainer, video, emb = tuning_setup(device, "random:tiny", JEEP, torch.float32, 2, 128, 0, lr)
        state = trainer.init_state()
        before = {n: p.detach().clone() for n, p in m.unet.named_parameters()}
        draws = trainer.draw(torch.Generator().manual_seed(1), video.shape)
        loss = trainer._update(state, video, emb, draws.to(device))
        grads = {n: p.grad.detach().float().cpu() for n, p in trainer.trainable.items()}
        after = {n: p.detach().cpu() for n, p in m.unet.named_parameters()}
        frozen_moved = [n for n, p in m.unet.named_parameters()
                        if n not in trainer.trainable and not torch.equal(p.detach(), before[n])]
        runs[device.type] = dict(loss=float(loss), grads=grads, before={n: p.cpu() for n, p in before.items()},
                                 after=after, frozen_moved=frozen_moved, trainable=set(trainer.trainable))
    gpu, cpu = runs["cuda"], runs["cpu"]
    if gpu["frozen_moved"] or cpu["frozen_moved"]:
        raise AssertionError(f"frozen params moved: {gpu['frozen_moved'][:3]} {cpu['frozen_moved'][:3]}")
    # fp32 on both devices; sums in other orders (cuDNN vs CPU convolutions,
    # K1/K2/K3 vs matmul attention) through the forward, the checkpointed
    # recompute and the backward
    loss_err = abs(gpu["loss"] - cpu["loss"])
    log(f"[tuning reference] loss card {gpu['loss']:.6f} cpu {cpu['loss']:.6f} abs_err {loss_err:.3e} "
        f"(tol {1e-4 * abs(cpu['loss']):.3e})")
    if not loss_err <= 1e-4 * abs(cpu["loss"]):
        raise AssertionError("tiny tuning loss disagrees card vs CPU")
    worst_g = worst_p = 0.0
    for n in cpu["trainable"]:
        g_ref = cpu["grads"][n]
        g_err = (gpu["grads"][n] - g_ref).abs().max().item() / max(g_ref.abs().max().item(), 1e-12)
        worst_g = max(worst_g, g_err)
        # AdamW's first step moves each coordinate by lr * g / (|g| + eps) plus
        # decay: where a gradient is at its rounding noise the sign may differ,
        # so a param is held to one full step's difference
        p_err = (gpu["after"][n] - cpu["after"][n]).abs().max().item()
        worst_p = max(worst_p, p_err)
    log(f"[tuning reference] {len(cpu['trainable'])} trainable tensors: worst grad error "
        f"{worst_g:.3e} of the tensor's max (tol 1e-3), worst param error {worst_p:.3e} (tol {2.1 * lr:.1e})")
    if not worst_g <= 1e-3 or not worst_p <= 2.1 * lr:
        raise AssertionError("tiny tuning update disagrees card vs CPU")


def count_sites(unet, min_queries, latent):
    """Attention sites per UNet forward at or above min_queries (self + cross)."""
    from fatezero_tpu_torch.models.attention import SpatioTemporalTransformerModel

    n = 0
    res = latent
    for block in unet.down_blocks:
        if block.attentions is not None and res * res >= min_queries:
            n += 2 * len(block.attentions)
        if hasattr(block, "downsamplers"):
            res //= 2
    if res * res >= min_queries:
        n += 2 * sum(isinstance(m, SpatioTemporalTransformerModel) for m in unet.mid_block.modules())
    for block in unet.up_blocks:
        if block.attentions is not None and res * res >= min_queries:
            n += 2 * len(block.attentions)
        if hasattr(block, "upsamplers"):
            res *= 2
    return n


def transformer_sizes(unet, latent):
    """(place, query tokens) of every spatio-temporal transformer, in visit order."""
    out, res = [], latent
    for block in unet.down_blocks:
        if block.attentions is not None:
            out += [("down", res * res)] * len(block.attentions)
        if hasattr(block, "downsamplers"):
            res //= 2
    out.append(("mid", res * res))
    for block in unet.up_blocks:
        if block.attentions is not None:
            out += [("up", res * res)] * len(block.attentions)
        if hasattr(block, "upsamplers"):
            res *= 2
    return out


def k1_per_forward(unet, latent, kind, materialized=None):
    """K1 launches of one UNet forward, from the sites' shapes: a site runs K1
    when it has 256 queries or more and takes a fused path.

    kind: 'plain' (no controller: both sites fused); 'capture' (the inversion's
    StoreContext: controlled self sites fused, controlled cross sites
    materialised); 'capture_only' (the same, up to the first up block past the
    controlled size, where drop_replay_rows ends the forward); 'edit' (the
    EditContext with a gated self swap: live + injected attention at each
    controlled self site, the value-space cross edit at each controlled cross
    site but those of `materialized` queries); 'inline' (the 3-row
    InlineEditContext under a latent blend: two attentions at each controlled
    self site, every controlled cross site materialised)."""
    from fatezero_tpu_torch.ops.flash_attention import FLASH_MIN_QUERIES
    from fatezero_tpu_torch.ptp.context import MAX_CONTROLLED_TOKENS

    n = 0
    for place, s in transformer_sizes(unet, latent):
        if s < FLASH_MIN_QUERIES:
            continue
        if kind == "plain" or s > MAX_CONTROLLED_TOKENS:
            if kind == "capture_only" and place == "up" and s > MAX_CONTROLLED_TOKENS:
                break
            n += 2
        elif kind in ("capture", "capture_only"):
            n += 1
        elif kind == "inline":
            n += 2
        else:
            n += 2 + (s != materialized)
    return n


class BlendRecorder:
    """Stands in for the pipeline's blend_mask and keeps every normalised map
    m / max(m) it thresholds, with the threshold, on the maps' device (no
    copy to the host inside the edit)."""

    def __init__(self):
        from fatezero_tpu_torch.ptp import spatial_blend

        self.blend_map = spatial_blend.blend_map
        self.calls = []

    def __call__(self, maps, alpha, target_hw, th, use_pool=True):
        norm = self.blend_map(maps, alpha, target_hw, use_pool)
        self.calls.append((norm, th))
        return (norm > th).float()


def recorded_edit(pipe, *args, **kwargs):
    """pipe.edit_fast with every blend threshold recorded: (latent, aux, calls),
    the calls' maps copied to the host after the edit."""
    from fatezero_tpu_torch.pipelines import fatezero_pipeline as FPM

    rec, blend_mask = BlendRecorder(), FPM.blend_mask
    FPM.blend_mask = rec
    try:
        out, aux = pipe.edit_fast(*args, **kwargs)
    finally:
        FPM.blend_mask = blend_mask
    return out, aux, [(norm.float().cpu(), th) for norm, th in rec.calls]


def sharp_cross_state(unet, seed):
    """Weights for `unet` drawn with numpy from `seed` as
    tests/test_torch_edit_modes.py draws them: N(0, 1 / fan-in) kernels with
    the cross-attention q and k 3x larger, norm scales 1 + N(0, 0.01),
    biases N(0, 0.01). The cross maps then vary over the image, so the blend
    masks are neither all 1 nor all 0 (random:tiny's N(0, 0.02) weights give
    near-uniform maps and masks that are all 1)."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in sorted(unet.state_dict().items()):
        shape = tuple(p.shape)
        if name.endswith("bias"):
            w = 0.1 * rng.standard_normal(shape)
        elif len(shape) == 1:
            w = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            gain = 3.0 if ".attn2.to_q." in name or ".attn2.to_k." in name else 1.0
            w = gain * rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        state[name] = w.astype(np.float32)
    return state


def check_blend_masks(map_tol):
    """The blenders' masks on the card against the CPU, on seeded maps that
    vary over the image (softmaxes of N(0, 36) logits): 'source', 'both' and
    'both' with substruct words, resized to 8x8, 16x16 and 64x64, and the
    latent blend. Masks are held exactly; no CPU pixel may lie within map_tol
    of its threshold, and the normalised maps agree within map_tol."""
    import torch

    from fatezero_tpu_torch.models.tokenizer import StubTokenizer
    from fatezero_tpu_torch.ptp import spatial_blend as SB

    rng = np.random.default_rng(12)
    maps = []
    for _ in range(5):
        x = rng.standard_normal((2, 8, 8, 256, 77)) * 6.0
        e = np.exp(x - x.max(-1, keepdims=True))
        maps.append((e / e.sum(-1, keepdims=True)).astype(np.float32))
    inv, x_t = (rng.standard_normal((1, 8, 64, 64, 4)).astype(np.float32) for _ in range(2))
    prompts, worst, n = [POSCHE_SOURCE, POSCHE_TARGET], 0.0, 0
    for choose, sub in (("source", None), ("both", None), ("both", [["road"], ["road"]])):
        blender = SB.SpatialBlender.create(prompts, POSCHE_P2P["blend_words"], StubTokenizer(), STEPS,
                                           th=(0.3, 0.3), prompt_choose=choose, substruct_words=sub)
        rows = slice(0, 1) if choose == "source" else slice(None)
        for hw in ((8, 8), (16, 16), (64, 64)):
            out = {}
            for dev in ("cuda", "cpu"):
                tm = [torch.from_numpy(m[rows]).to(dev) for m in maps]
                alpha = torch.from_numpy(blender.alpha_layers[rows]).to(dev)
                mask = blender.mask_for(tm, hw)
                blended = SB.apply_latent_blend(torch.from_numpy(x_t).to(dev), torch.from_numpy(inv).to(dev),
                                                mask) if hw == (64, 64) else None
                norms = [SB.blend_map(tm, alpha, hw)]
                if sub is not None:  # the substruct words' map, unpooled
                    norms.append(SB.blend_map(tm, torch.from_numpy(blender.substruct_layers[rows]).to(dev), hw, False))
                out[dev] = (torch.stack(norms).cpu(), mask.cpu(), blended)
            (na, ma, ba), (nb, mb, bb) = out["cuda"], out["cpu"]
            err, margin = (na - nb).abs().max().item(), (nb - 0.3).abs().min().item()
            if not (err <= map_tol and margin > map_tol and torch.equal(ma, mb)):
                raise AssertionError(f"blend masks ({choose}, substruct {sub is not None}, {hw}) differ card vs CPU: "
                                     f"map error {err:.3e}, closest pixel {margin:.3e} from 0.3")
            if bb is not None and not torch.equal(ba.cpu(), bb):
                raise AssertionError(f"apply_latent_blend ({choose}) differs card vs CPU")
            worst, n = max(worst, err), n + 1
            log(f"[blend masks] {choose} substruct={sub is not None} {hw}: map max_abs_err {err:.3e} "
                f"(tol {map_tol}), closest pixel {margin:.3e} from th, masks equal, mask mean {mb.mean().item():.4f}")
    return worst


def tiny_modes_reference():
    """Every edit mode at a small size, card against CPU, in fp32: the tiny
    UNet with the blend config's model_config and sharp_cross_state's weights
    (so that the masks vary and the masked self swap and the latent blend's
    inverted branch run), 2 frames of 16x16 seeded latents and seeded text
    embeddings, the blend config's controller. The two hybrids without blends
    have an edit window of 2 of their 4 steps, so their identity-gated tail
    (payload row 0 under zero gates) runs; with blends the window is every
    step. check_blend_masks first holds the blenders alone on seeded maps.

    Sharp cross attention amplifies the two devices' rounding from pass to
    pass, so the inversions and the edits are held apart: each inversion
    (trajectory and payload) card against CPU, then each edit on the card
    from the CPU's trajectory and payload against the CPU's edit. Held: the
    trajectories and edited latents within 1e-3 x max|x| (the tiny edit's
    tolerance) and the payload within MODES_PAYLOAD_TOL; every normalised blend
    map within MODES_MAP_TOL of the CPU's; the masks equal wherever the CPU's
    map is more than MODES_MAP_TOL from its threshold, and that band empty,
    so no mask can flip between the two; every aux mask equal."""
    import torch

    from fatezero_tpu_torch.models.loader import load_models, load_state
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline, _payload_leaves
    from fatezero_tpu_torch.ptp.controller import make_controller

    # the same maps on both devices differ only in the order of their sums
    # (~1e-7 at values up to 1); the edit's maps also carry the UNet's
    check_blend_masks(1e-6)
    map_tol = MODES_MAP_TOL
    rng = np.random.default_rng(11)
    lat = rng.standard_normal((1, 2, 16, 16, 4)).astype(np.float32)
    emb = [rng.standard_normal((2, 77, 32)).astype(np.float32) for _ in range(2)]
    no_blends = {"blend_words": None}
    modes = [  # name, steps, controller overrides, payload, edit_fast keywords
        ("stored, both blends", 3, {}, "full", {}),
        ("replay", 3, {}, None, {}),
        ("inline", 3, {"blend_self_attention": False}, None, {}),
        ("hybrid, inversion attention", 4, {}, "part", {}),
        ("hybrid, no inversion attention", 4, {"use_inversion_attention": False}, "part", {}),
        ("hybrid, no blends, inversion attention", 4, no_blends, "part", {}),
        ("hybrid, no blends, no inversion attention", 4, {**no_blends, "use_inversion_attention": False}, "part", {}),
        ("strength 0.5", 3, {}, "full", {"strength": 0.5}),
        ("viz", 3, {}, "full", {"viz": True}),
    ]

    def moved(payload, dev):
        if payload is None:
            return None
        return {"probs": {key: [t.to(dev) for t in lst] for key, lst in payload["probs"].items()},
                "qk": {key: [tuple(t.to(dev) for t in pair) for pair in lst] for key, lst in payload["qk"].items()}}

    runs, inversions, state, faults = {}, {}, None, []
    for dev in (torch.device("cpu"), torch.device("cuda")):
        m = load_models("random:tiny", POSCHE_MODEL, torch.float32, device=dev)
        state = state or sharp_cross_state(m.unet, seed=7)
        load_state(m.unet, state, dev)
        pipe = FateZeroPipeline(m.unet, None, None, m.tokenizer, m.schedule, store_dtype=torch.float32, device=dev)
        x, es, et = (torch.from_numpy(a).to(dev) for a in (lat, *emb))
        out = runs[dev.type] = {}
        for name, steps, over, payload, kw in modes:
            ctl = make_controller(m.tokenizer, [POSCHE_SOURCE, POSCHE_TARGET], steps, **{**POSCHE_P2P, **over})
            extra, stored, rows = {}, None, None
            if payload == "part":  # a budget of 2.5 steps: k = 2 rows
                rows = pipe.plan_capture(x, steps, ctl.edit_window(steps), 2.5 * pipe.capture_payload_bytes(x, 1),
                                         use_inversion_attention=ctl.use_inversion_attention)
                assert rows is not None and rows[1] == 2, rows
                extra["stored_row0"] = rows[0]
            if payload is None:
                traj = pipe.invert_fast(x, es, steps)
            else:
                traj, stored = pipe.invert_fast(x, es, steps, capture=True, capture_rows=rows)
            if dev.type == "cpu":
                inversions[name] = (traj, stored)
            else:  # the inversion, card against CPU; the edit then starts from the CPU's
                ref_traj, ref_stored = inversions[name]
                err = (traj.cpu() - ref_traj).abs().max().item()
                tol = 1e-3 * max(1.0, ref_traj.abs().max().item())
                p_err = max((((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1.0)).item() for a, b in
                             zip(_payload_leaves(stored), _payload_leaves(ref_stored))), default=0.0) \
                    if stored is not None else 0.0
                log(f"[modes reference] tiny {name}: inversion card vs CPU, trajectory max_abs_err {err:.3e} "
                    f"(tol {tol:.3e}), payload max_abs_err / max(1, max) {p_err:.3e} (tol {MODES_PAYLOAD_TOL})")
                if not (err <= tol and p_err <= MODES_PAYLOAD_TOL):
                    faults.append(f"{name}: inversion card vs CPU {err:.3e} (tol {tol:.3e}), payload {p_err:.3e}")
                traj, stored = ref_traj.to(dev), moved(ref_stored, dev)
            if stored is not None:
                extra["stored"] = stored
            out[name] = (*recorded_edit(pipe, traj, es, et, ctl, steps, **kw, **extra), ctl.edit_window(steps))
        del m, pipe
    worst = {}
    for name, *_ in modes:
        (a, aux_a, calls_a, window), (b, aux_b, calls_b, _) = runs["cuda"][name], runs["cpu"][name]
        a = a.float().cpu()
        err = (a - b).abs().max().item()
        tol = 1e-3 * max(1.0, b.abs().max().item())
        if not (torch.isfinite(a).all() and err <= tol):
            faults.append(f"{name}: card vs CPU latent error {err:.3e} > {tol:.3e}")
        if len(calls_a) != len(calls_b):
            faults.append(f"{name}: {len(calls_a)} blend masks on the card, {len(calls_b)} on the CPU")
        map_err = max((abs(na - nb).max().item() for (na, _), (nb, _) in zip(calls_a, calls_b)), default=0.0)
        margin = min(((nb - th).abs().min().item() for nb, th in calls_b), default=float("inf"))
        in_band = sum(int(((nb - th).abs() <= map_tol).sum()) for nb, th in calls_b)
        flipped = sum(int((((na > th) != (nb > th)) & ((nb - th).abs() > map_tol)).sum())
                      for (na, _), (nb, th) in zip(calls_a, calls_b))
        if not (map_err <= map_tol and in_band == 0 and flipped == 0):
            faults.append(f"{name}: blend maps card vs CPU {map_err:.3e} (tol {map_tol}); {in_band} CPU pixels "
                          f"within the tolerance of their threshold (must be 0); {flipped} mask pixels differ "
                          f"outside that band")
        for key in aux_b:
            if key != "cross_avg" and not torch.equal(aux_a[key].float().cpu(), aux_b[key]):
                faults.append(f"{name}: aux {key} differs card vs CPU")
        if "cross_avg" in aux_b:
            c_err = (aux_a["cross_avg"].float().cpu() - aux_b["cross_avg"]).abs().max().item()
            rows = aux_a["cross_avg"].sum(-1)
            if not (c_err <= map_tol and (rows - 1).abs().max().item() <= 1e-5):
                faults.append(f"{name}: cross_avg off by {c_err:.3e} or rows not summing to 1")
            log(f"[modes reference] tiny {name}: cross_avg max_abs_err {c_err:.3e} (tol {map_tol})")
        means = {k: round(float(v.float().mean()), 4) for k, v in aux_b.items() if k != "cross_avg"}
        log(f"[modes reference] tiny {name}: latent max_abs_err {err:.3e} (tol {tol:.3e}); edit window {window}; "
            f"{len(calls_b)} blend maps, max_abs_err {map_err:.3e} (tol {map_tol}), closest CPU pixel "
            f"{margin:.3e} from its threshold, {in_band} within the tolerance; mask means {json.dumps(means)}")
        worst[name] = err
    if faults:
        raise AssertionError("tiny edit modes, card vs CPU: " + "; ".join(faults))
    return worst


def fp32_trajectory_witness(device, latents, emb_src, emb_tgt):
    """Replay on its own trajectory against stored, the blend config at full
    width in fp32 (store dtype fp32) on the bf16 modes' latents and prompts.
    In bf16 the plain inversion (every cross site through K1, P kept in fp32)
    and the capturing one (the controlled sites materialise bf16
    probabilities) part through the trajectory. In fp32 both keep fp32
    probabilities, so a gap left there would be a fault of the plain inversion
    or the capture, not rounding: the two edits must agree within one bf16
    unit of the largest value, the tolerance the bf16 modes meet on one
    trajectory, and their masks must be equal. Untimed; no main path."""
    import torch

    from fatezero_tpu_torch.models.loader import load_models
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
    from fatezero_tpu_torch.ptp.controller import make_controller

    m = load_models("random:sd", POSCHE_MODEL, dtype=torch.float32, seed=0, device=device)
    pipe = FateZeroPipeline(m.unet, None, None, m.tokenizer, m.schedule, store_dtype=torch.float32, device=device)
    ctl = make_controller(m.tokenizer, [POSCHE_SOURCE, POSCHE_TARGET], STEPS, **POSCHE_P2P)
    t0 = time.perf_counter()
    traj_plain = pipe.invert_fast(latents, emb_src, STEPS)
    replay, replay_aux = pipe.edit_fast(traj_plain, emb_src, emb_tgt, ctl, STEPS)
    traj, stored = pipe.invert_fast(latents, emb_src, STEPS, capture=True)
    ref, ref_aux = pipe.edit_fast(traj, emb_src, emb_tgt, ctl, STEPS, stored=stored)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    drift = ((traj_plain[-1] - traj[-1]).norm() / traj[-1].norm()).item()
    err = (replay.float() - ref.float()).abs().max().item()
    tol = 2**-7 * ref.abs().max().item()
    same_masks = all(torch.equal(replay_aux[key], ref_aux[key]) for key in ref_aux)
    log(f"[modes] fp32 witness: plain vs capturing inversion rel_l2 at the noisiest latent {drift:.3e}; replay on "
        f"its own trajectory vs stored max_abs_err {err:.3e} of max {ref.abs().max().item():.3e} (tol {tol:.3e}), "
        f"masks equal {same_masks}, finite {bool(torch.isfinite(replay).all() and torch.isfinite(ref).all())}; "
        f"{seconds:.1f} s")
    if not (err <= tol and same_masks):
        raise AssertionError(f"fp32: replay on its own trajectory disagrees with stored ({err:.3e} > {tol:.3e} "
                             f"or masks differ)")
    del m, pipe, traj_plain, replay, traj, stored, ref


def full_width_modes(device, kernels, reset_counts, check_plain):
    """The blend config at full SD-1.4 width in bf16, 8 frames at 512^2, 10
    steps: stored with both blends, replay, and a hybrid whose budget holds
    HYBRID_BUDGET of the full payload. Each mode's phases are timed once; K1's
    launches are held to k1_per_forward's count."""
    import torch

    from fatezero_tpu_torch.models.loader import load_models
    from fatezero_tpu_torch.pipelines import fatezero_pipeline as FPM
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
    from fatezero_tpu_torch.ptp.controller import make_controller

    t_start = time.perf_counter()
    m = load_models("random:sd", POSCHE_MODEL, dtype=torch.bfloat16, seed=0, device=device)
    pipe = FateZeroPipeline(m.unet, m.vae, m.text_encoder, m.tokenizer, m.schedule,
                            store_dtype=torch.bfloat16, device=device)
    gen = torch.Generator().manual_seed(0)
    video = (torch.rand(FRAMES, RES, RES, 3, generator=gen) * 2.0 - 1.0).to(device)
    def controller(**over):
        return make_controller(m.tokenizer, [POSCHE_SOURCE, POSCHE_TARGET], STEPS, **{**POSCHE_P2P, **over})

    ctl = controller()
    emb_src, emb_tgt = pipe.encode_prompt(POSCHE_SOURCE), pipe.encode_prompt(POSCHE_TARGET)
    latents = pipe.encode_video(video)
    lat = RES // 8
    s16 = (lat // 4) ** 2
    full_bytes = pipe.capture_payload_bytes(latents, STEPS)
    plan = pipe.plan_capture(latents, STEPS, ctl.edit_window(STEPS), HYBRID_BUDGET * full_bytes)
    if plan is None or not 1 < plan[1] < STEPS:
        raise AssertionError(f"plan_capture at {HYBRID_BUDGET:.0%} of the payload gave {plan}, not a hybrid")
    per_fwd = {kind: k1_per_forward(m.unet, lat, kind, s16) for kind in ("plain", "capture", "capture_only", "edit")}
    per_fwd["edit, no blends"] = k1_per_forward(m.unet, lat, "edit")
    per_fwd["inline"] = k1_per_forward(m.unet, lat, "inline")
    k = plan[1]
    replay_step = per_fwd["plain"] + per_fwd["capture_only"] + per_fwd["edit"]
    modes = {  # name: (payload rows, K1 launches from the shapes, controller)
        "stored": (None, STEPS * (per_fwd["capture"] + per_fwd["edit"]), ctl),
        "stored, no blends": (None, STEPS * (per_fwd["capture"] + per_fwd["edit, no blends"]),
                              controller(blend_words=None)),
        "replay": ("replay", STEPS * replay_step, ctl),
        "hybrid": (plan, k * (per_fwd["capture"] + per_fwd["edit"]) + (STEPS - k) * replay_step, ctl),
        "inline, latent blend": ("replay", STEPS * (per_fwd["plain"] + per_fwd["inline"]),
                                 controller(blend_self_attention=False)),
    }
    log(f"[modes] K1 per forward {json.dumps(per_fwd)}; payload predicted {full_bytes} bytes for {STEPS} steps; "
        f"hybrid plan {plan} at a budget of {HYBRID_BUDGET * full_bytes:.0f} bytes")
    # one untimed step of the capturing inversion and of the blended stored
    # edit first, so that no timed mode carries the first call of a shape
    warm_traj, warm = pipe.invert_fast(latents, emb_src, 1, capture=True)
    pipe.edit_fast(warm_traj, emb_src, emb_tgt, controller(), 1, stored=warm)
    del warm_traj, warm
    results, outs = {}, {}
    for name, (rows, k1_expect, mode_ctl) in modes.items():
        n_rows = 0 if rows == "replay" else STEPS if rows is None else rows[1]
        predicted = pipe.capture_payload_bytes(latents, n_rows)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_counts()
        if rows == "replay":  # replay, or inline where the controller allows it
            traj, t_inv = phase(f"modes {name} invert", lambda: pipe.invert_fast(latents, emb_src, STEPS))
            stored, extra = None, {}
        else:
            (traj, stored), t_inv = phase(f"modes {name} invert", lambda: pipe.invert_fast(
                latents, emb_src, STEPS, capture=True, capture_rows=rows))
            extra = {"stored": stored, "stored_row0": 0 if rows is None else rows[0]}
        inv_peak = torch.cuda.max_memory_allocated() - before
        held = torch.cuda.memory_allocated() - before
        payload = 0 if stored is None else sum(t.numel() * t.element_size() for t in FPM._payload_leaves(stored))
        (edited, aux), t_edit = phase(f"modes {name} edit", lambda: pipe.edit_fast(
            traj, emb_src, emb_tgt, mode_ctl, STEPS, **extra))
        peak = torch.cuda.max_memory_allocated() - before
        k1 = kernels[0].launches
        launches = {fn.__name__: fn.launches for fn in kernels}
        finite = bool(torch.isfinite(edited).all())
        means = {key: round(float(v.float().mean()), 4) for key, v in aux.items()}
        log(f"[modes] {name}: invert {t_inv:.3f} s, edit {t_edit:.3f} s, peak {peak / 2**30:.2f} GiB above the "
            f"{before / 2**30:.2f} GiB held at the mode's start (weights, and the stored mode's trajectory and "
            f"payload once that has run); "
            f"payload predicted {predicted} bytes, actual {payload}, held after invert {held} bytes "
            f"(trajectory included), invert peak above start {inv_peak} bytes; K1 launches {k1} "
            f"(expected {k1_expect}); launches {json.dumps(launches)}; output {tuple(edited.shape)} finite {finite}; "
            f"mask means {json.dumps(means)}")
        check_plain(f"modes {name}")
        if not finite or tuple(edited.shape) != (1, FRAMES, lat, lat, 4):
            raise AssertionError(f"modes {name}: output {tuple(edited.shape)} finite={finite}")
        if k1 != k1_expect:
            raise AssertionError(f"modes {name}: K1 launched {k1} times, the sites' shapes give {k1_expect}")
        if stored is not None and predicted != payload:
            raise AssertionError(f"modes {name}: capture_payload_bytes predicted {predicted}, the payload holds {payload}")
        results[name] = dict(invert_s=t_inv, edit_s=t_edit, peak_above_start_gib=peak / 2**30, k1=k1,
                             payload=payload)
        if name in ("stored", "replay"):
            outs[name] = (traj, stored, edited.float(), aux)
        del traj, stored, extra, edited, aux
        torch.cuda.empty_cache()
    # A plain inversion runs every cross site through K1, the capturing one
    # materialises the controlled ones (bf16 probabilities), so in bf16 their
    # trajectories part, and random weights amplify that over 20 passes. On
    # the stored edit's own trajectory, replay and the hybrid (its payload the
    # stored one's rows [row0, row0 + k)) consume the same maps as the stored
    # edit (the capture-only forward is the inversion's forward cut short):
    # they must agree with it to one bf16 unit at the largest value, masks
    # exactly. These two edits are no main path and are not timed.
    traj, stored, ref, ref_aux = outs["stored"]
    traj_plain, _, own_replay, _ = outs.pop("replay")
    log(f"[modes] plain vs capturing inversion: rel_l2 at the noisiest latent "
        f"{((traj_plain[-1] - traj[-1]).norm() / traj[-1].norm()).item():.3e}; replay on its own trajectory vs "
        f"stored: max_abs_err {(own_replay - ref).abs().max().item():.3e} of max {ref.abs().max().item():.3e}")
    del traj_plain, own_replay
    part = {"probs": {key: [a[plan[0]:plan[0] + k] for a in lst] for key, lst in stored["probs"].items()},
            "qk": {key: [tuple(t[plan[0]:plan[0] + k] for t in pair) for pair in lst]
                   for key, lst in stored["qk"].items()}}
    for name, extra in (("replay", {}), ("hybrid", {"stored": part, "stored_row0": plan[0]})):
        got, aux, calls = recorded_edit(pipe, traj, emb_src, emb_tgt, ctl, STEPS, **extra)
        err = (got.float() - ref).abs().max().item()
        tol = 2**-7 * ref.abs().max().item()
        same_masks = all(torch.equal(aux[key], ref_aux[key]) for key in ref_aux)
        margin = min(((n - th).abs().min().item() for n, th in calls), default=float("inf"))
        log(f"[modes] {name} vs stored, on the stored edit's trajectory: max_abs_err {err:.3e} (tol {tol:.3e}), "
            f"masks equal {same_masks}; closest blend pixel {margin:.3e} from its threshold")
        if not (err <= tol and same_masks):
            raise AssertionError(f"modes {name} disagrees with the stored edit")
    check_plain("modes agreement")
    del m, pipe, outs, traj, stored, part
    torch.cuda.empty_cache()
    fp32_trajectory_witness(device, latents.float(), emb_src.float(), emb_tgt.float())
    check_plain("modes fp32 witness")
    del latents, emb_src, emb_tgt
    torch.cuda.empty_cache()
    total = time.perf_counter() - t_start
    log(f"[modes] summary {json.dumps(results)}")
    log(f"[modes] full-width modes took {total:.1f} s in all")
    return results, total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"chip_smoke.py needs an sm_90 (Hopper) card, found capability {cap}")
    from fatezero_tpu_torch import csrc
    from fatezero_tpu_torch.models.loader import load_models
    from fatezero_tpu_torch.ops import flash_attention as FA
    from fatezero_tpu_torch.ops import flash_variants as FV
    from fatezero_tpu_torch.ops import fused_norm as FN
    from fatezero_tpu_torch.scripts import bench_flash_variants as probe_variants
    from fatezero_tpu_torch.scripts import bench_kernel_boundary as probe_boundary
    from fatezero_tpu_torch.scripts import card

    smi = card()
    log(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    kernels = [FA.flash_forward, FA.flash_dq, FA.flash_dkv, FN.layer_norm_kernel, FV.flash_bf16, FV.flash_merged]

    def reset_counts():
        for fn in kernels:
            fn.launches = 0

    _, t_build = phase("build K1-K4, K1b, K1c", lambda: csrc.build_all(KERNEL_SOURCES))
    k1, k2, k3, k4, k1b, k1c = Totals(), Totals(), Totals(), Totals(), Totals(), Totals()
    phase("K1 vs plain (edit sites)", lambda: check_edit_k1(k1))
    phase("K1+LSE, K2, K3 vs plain autograd (tuning sites)", lambda: check_training_kernels(k2, k3))
    phase("K4 vs _ln_math", lambda: check_layer_norm(k4))
    phase("K1b vs plain (flash-variants shapes)", lambda: check_k1b(k1b))
    phase("K1c vs plain (kernel-boundary site, cross shapes)", lambda: check_k1c(k1c))
    phase("K1, K1b, K1c vs plain (tile-edge shapes, misaligned operands, scales)", check_forward_edges)
    phase("K2, K3 vs plain and autograd (tile-edge shapes, misaligned operands)", check_backward_edges)

    # the edit at a small size, through the kernels on the card, against the
    # plain versions on the CPU: same seed, same weights and inputs
    def reference():
        tiny = dict(dtype=torch.float32, frames=2, res=128, steps=3)
        cpu_dev = torch.device("cpu")
        gpu, _ = run_slice(device, load_models("random:tiny", TEASER, torch.float32, device=device), "random:tiny", **tiny)
        cpu, _ = run_slice(cpu_dev, load_models("random:tiny", TEASER, torch.float32, device=cpu_dev), "random:tiny", **tiny)
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

    phase("reference (tiny edit, card vs CPU)", reference)
    phase("reference (tiny tuning update, card vs CPU)", tiny_tuning_reference)
    phase("reference (tiny edit modes, card vs CPU)", tiny_modes_reference)

    # every plain attention call on the card, and every plain call of a
    # kernel's version on the card, is recorded: the main paths must make none
    # at 256 queries or more
    plain_queries = []
    watched = [(FA, "xla_attention"), (FA, "attention_with_lse"), (FA, "flash_bwd_reference"),
               (FV, "merged_attention_reference")]
    originals = {name: getattr(mod, name) for mod, name in watched}

    def watch(name):
        def watched(q, *args):
            if q.is_cuda:
                plain_queries.append((name, q.shape[-2]))
            return originals[name](q, *args)
        return watched

    for mod, name in watched:
        setattr(mod, name, watch(name))

    def check_plain(path):
        big = [c for c in plain_queries if c[0] != "xla_attention" or c[1] >= FA.FLASH_MIN_QUERIES]
        log(f"[{path}] plain attention calls on the card: {len(plain_queries)}, "
            f"largest query count {max((c[1] for c in plain_queries), default=0)}")
        if big:
            raise AssertionError(f"{path}: {len(big)} attention calls of >= 256 queries took a plain path")
        plain_queries.clear()

    # ---- main path a: the edit
    sd = load_models("random:sd", TEASER, dtype=torch.bfloat16, seed=0, device=device)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    k1_calls, flash_attention = [], FA.flash_attention

    def recorded(q, k, v, scale):  # the shapes fused_attention hands to K1
        k1_calls.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2], v.shape[2], q.dtype))
        return flash_attention(q, k, v, scale)

    FA.flash_attention = recorded
    outs, times = run_slice(device, sd, "random:sd", torch.bfloat16, FRAMES, RES, STEPS)
    FA.flash_attention = flash_attention
    edit_launches = {fn.__name__: fn.launches for fn in kernels}
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
        log(f"[edit] {key}: shape {tuple(val.shape)} finite {finite}")
        if tuple(val.shape) != shape or not finite:
            raise AssertionError(f"{key}: expected finite {shape}, got {tuple(val.shape)} finite={finite}")
    log(f"[edit] launches {json.dumps(edit_launches)}")
    log_k1_paths(k1_calls)
    if len(k1_calls) != edit_launches["flash_forward"]:
        raise AssertionError(f"{len(k1_calls)} K1 calls recorded, {edit_launches['flash_forward']} launched")
    teaser_k1 = STEPS * (k1_per_forward(sd.unet, lat, "capture") + k1_per_forward(sd.unet, lat, "edit"))
    log(f"[edit] K1 launches {edit_launches['flash_forward']}, expected from the sites' shapes {teaser_k1}")
    if edit_launches["flash_forward"] != teaser_k1:
        raise AssertionError(f"the edit launched K1 {edit_launches['flash_forward']} times, not {teaser_k1}")
    check_plain("edit")
    log(f"[edit] phase seconds {json.dumps(times)}; peak device memory {peak / 2**30:.2f} GiB; "
        f"kernel build {t_build:.1f} s")
    ref_edited, ref_traj = outs["edited"].float(), outs["traj"].float()
    emb_src = outs["emb_src"]
    del outs

    # ---- main path b: the same edit with LayerNorm through K4
    def rel_l2(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def with_k4(fn):
        os.environ["FZ_PALLAS_LN"] = "1"
        try:
            return fn()
        finally:
            del os.environ["FZ_PALLAS_LN"]

    x0, cond = ref_traj[0], emb_src[-1:]
    with torch.inference_mode():  # one UNet pass from the same input, both LayerNorms
        eps_plain = sd.unet(x0, 1, cond)
        eps_k4 = with_k4(lambda: sd.unet(x0, 1, cond))
    plain_queries.clear()  # those two passes are no main path
    reset_counts()
    ln_outs, ln_times = with_k4(lambda: run_slice(device, sd, "random:sd K4", torch.bfloat16, FRAMES, RES, STEPS))
    ln_launches = {fn.__name__: fn.launches for fn in kernels}
    log(f"[edit K4] launches {json.dumps(ln_launches)}")
    if ln_launches["layer_norm_kernel"] <= 0 or ln_launches["flash_forward"] <= 0:
        raise AssertionError("the FZ_PALLAS_LN=1 edit did not launch K4 and K1")
    check_plain("edit K4")
    # timing in turns (default, K4, K4, default): the two counted runs and
    # these two, so that warm-up favours neither
    _, ln_times2 = with_k4(lambda: run_slice(device, sd, "random:sd K4 again", torch.bfloat16, FRAMES, RES, STEPS))
    _, times2 = run_slice(device, sd, "random:sd again", torch.bfloat16, FRAMES, RES, STEPS)
    log(f"[edit K4] phase seconds in turns: default {json.dumps(times)}; K4 {json.dumps(ln_times)}; "
        f"K4 {json.dumps(ln_times2)}; default {json.dumps(times2)}")
    del sd
    torch.cuda.empty_cache()

    # The two bf16 LayerNorms differ only where K4's fp32 statistics, summed in
    # another order, round an output the other way (one bf16 unit); a UNet of
    # bf16 matmuls and residual adds carries such units on. The bf16 tolerance
    # is therefore the bf16 edit's own: the same models and inputs in fp32
    # (weights as drawn, before their bf16 rounding) are the reference, and
    # the K4 edit must come as close to it as the default bf16 edit: within 25%
    # for one UNet pass, within 2x after the 20 passes of invert and edit.
    # Random weights amplify those units from pass to pass, so the default
    # edit's own distance to fp32 spreads by up to 1.5x between runs of the
    # same code (the stub tokenizer's salted hash changes the prompts' tokens),
    # and two equally accurate edits can read that far apart in one run; a
    # wrong LayerNorm already shows in the single pass.
    sd32 = load_models("random:sd", TEASER, dtype=torch.float32, seed=0, device=device)
    with torch.inference_mode():
        eps32 = sd32.unet(x0.float(), 1, cond.float())
    ref32, _ = run_slice(device, sd32, "random:sd fp32", torch.float32, FRAMES, RES, STEPS)
    del sd32
    plain_queries.clear()  # the reference is no main path
    checks = [("one UNet pass eps", eps_k4, eps_plain, eps32, 1.25),
              ("inverted latent", ln_outs["traj"][-1], ref_traj[-1], ref32["traj"][-1], 2.0),
              ("edited latent", ln_outs["edited"], ref_edited, ref32["edited"], 2.0)]
    log("[edit K4] inversion trajectory, rel_l2 per step: K4 vs default "
        + " ".join(f"{rel_l2(ln_outs['traj'][i], ref_traj[i]):.2e}" for i in range(STEPS + 1))
        + "; default vs fp32 " + " ".join(f"{rel_l2(ref_traj[i], ref32['traj'][i]):.2e}" for i in range(STEPS + 1)))
    for name, got, plain, ref, factor in checks:
        e_k4, e_plain = rel_l2(got, ref), rel_l2(plain, ref)
        log(f"[edit K4] {name}: rel_l2 to fp32, K4 {e_k4:.3e} default {e_plain:.3e} (tol {factor * e_plain:.3e}); "
            f"K4 vs default {rel_l2(got, plain):.3e}")
        if not (torch.isfinite(got).all() and e_k4 <= factor * e_plain):
            raise AssertionError(f"the FZ_PALLAS_LN=1 edit is less accurate than the default edit at {name}")
    del ln_outs, ref_edited, ref_traj, ref32, eps_plain, eps_k4, eps32
    torch.cuda.empty_cache()

    # ---- main path b2: the blend config's edit modes at full width
    modes, t_modes = full_width_modes(device, kernels, reset_counts, check_plain)

    # ---- main path c: one-shot tuning at full width
    m, trainer, video, emb = tuning_setup(device, "random:sd", JEEP, torch.bfloat16, FRAMES, RES, TUNE_SEED, TUNE_LR)
    state = trainer.init_state()
    frozen = {n: p.detach().clone() for n, p in m.unet.named_parameters() if n not in trainer.trainable}
    start = {n: p.detach().clone() for n, p in trainer.trainable.items()}
    gen = torch.Generator().manual_seed(TUNE_SEED)
    sites = count_sites(m.unet, FA.FLASH_MIN_QUERIES, lat)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i in range(TUNE_STEPS):
        (state, loss), dt = phase(f"tuning step {i}", lambda: trainer.step(state, video, emb, gen))
        losses.append(float(loss))
        step_s.append(dt)
    tune_launches = {fn.__name__: fn.launches for fn in kernels}
    tune_peak = torch.cuda.max_memory_allocated()
    log(f"[tuning] losses {losses}; seconds per step {step_s}; peak device memory {tune_peak / 2**30:.2f} GiB")
    log(f"[tuning] launches {json.dumps(tune_launches)}; {sites} attention sites with >= 256 queries per forward")
    check_plain("tuning")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite tuning loss: {losses}")
    expected = dict(flash_forward=2 * sites * TUNE_STEPS, flash_dq=sites * TUNE_STEPS, flash_dkv=sites * TUNE_STEPS)
    for name, n in expected.items():
        if tune_launches[name] != n:
            raise AssertionError(f"tuning launched {name} {tune_launches[name]} times, expected {n}")
    moved_frozen = [n for n, p in m.unet.named_parameters() if n in frozen and not torch.equal(p.detach(), frozen[n])]
    moved = [n for n, p in trainer.trainable.items() if not torch.equal(p.detach(), start[n])]
    log(f"[tuning] trainable tensors moved {len(moved)} of {len(start)}; frozen tensors moved "
        f"{len(moved_frozen)} of {len(frozen)}")
    if moved_frozen or not moved:
        raise AssertionError("tuning moved a frozen param or no trainable one")
    del m, trainer, state, frozen, start
    torch.cuda.empty_cache()

    # ---- main path d: the flash-variants probe, K1b's path. Its own check
    # runs K1b's plain version, flash_bf16_reference, which is not watched.
    reset_counts()
    variants, _ = phase("probe bench_flash_variants", probe_variants.main)
    variants_launches = {fn.__name__: fn.launches for fn in kernels}
    log(f"[bench_flash_variants] launches {json.dumps(variants_launches)}")
    check_plain("bench_flash_variants")
    calls = len(probe_variants.SHAPES) * probe_variants.CALLS_PER_SHAPE
    if variants_launches["flash_bf16"] != calls or variants_launches["flash_forward"] != calls:
        raise AssertionError(f"bench_flash_variants launched K1b/K1 {variants_launches}, expected {calls} each")
    for r in variants:
        tol = 2**-7 * r["max_abs_plain"] + 1e-4
        if not (r["max_abs_k1b_plain"] <= tol and all(np.isfinite([r["K1_ms"], r["K1b_ms"], r["max_abs_k1b_k1"]]))):
            raise AssertionError(f"bench_flash_variants {r['shape']}: K1b off its plain version ({tol:.3e}) or not finite: {r}")

    # ---- main path e: the kernel-boundary probe, K1c's path
    reset_counts()
    boundary, _ = phase("probe bench_kernel_boundary", probe_boundary.main)
    boundary_launches = {fn.__name__: fn.launches for fn in kernels}
    log(f"[bench_kernel_boundary] launches {json.dumps(boundary_launches)}")
    check_plain("bench_kernel_boundary")
    calls = probe_boundary.CALLS_PER_SITE
    if boundary_launches["flash_merged"] != calls or boundary_launches["flash_forward"] != calls:
        raise AssertionError(f"bench_kernel_boundary launched K1c/K1 {boundary_launches}, expected {calls} each")
    # K1 and K1c run the same arithmetic on the same values; the bf16 sites may
    # differ by one unit at the largest output
    tol = 2**-7 * boundary["max_abs_out"] + 1e-4
    if not (boundary["max_abs_diff"] <= tol and np.isfinite(boundary["speedup"])):
        raise AssertionError(f"bench_kernel_boundary: ship and merged sites differ by more than {tol:.3e}: {boundary}")
    for mod, name in watched:
        setattr(mod, name, originals[name])

    log(json.dumps({"kernels": [
        k1.entry("K1 flash_attention forward", "fatezero_tpu_torch/csrc/flash_fwd.cu",
                 "fatezero_tpu/ops/flash_attention.py:93", edit_launches["flash_forward"]),
        k2.entry("K2 flash_attention backward dQ", "fatezero_tpu_torch/csrc/flash_bwd.cu",
                 "fatezero_tpu/ops/flash_attention.py:185", tune_launches["flash_dq"]),
        k3.entry("K3 flash_attention backward dK/dV", "fatezero_tpu_torch/csrc/flash_bwd.cu",
                 "fatezero_tpu/ops/flash_attention.py:220", tune_launches["flash_dkv"]),
        k4.entry("K4 layer_norm", "fatezero_tpu_torch/csrc/layer_norm.cu",
                 "fatezero_tpu/ops/fused_norm.py:47", ln_launches["layer_norm_kernel"]),
        k1b.entry("K1b flash_bf16 forward (bf16 P)", "fatezero_tpu_torch/csrc/flash_fwd_bf16.cu",
                  "scripts/bench_flash_variants.py:60", variants_launches["flash_bf16"]),
        k1c.entry("K1c flash_merged forward (merged heads)", "fatezero_tpu_torch/csrc/flash_fwd_merged.cu",
                  "scripts/bench_kernel_boundary.py:71", boundary_launches["flash_merged"]),
    ]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
