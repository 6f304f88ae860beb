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
   CLI reference: config/demo_tiny.yaml through the edit CLI on the card and
   on the CPU (fp32) from a diffusers-layout checkpoint of random:tiny's 2-D
   weights written to build/: the same artifact names, decoded videos within
   CLI_VIDEO_TOL, blend maps within MODES_MAP_TOL with the band empty, mask
   PNGs equal;
   tuning CLI reference: config/tune_demo_tiny.yaml through cli.train.train
   on the card and on the CPU (fp32, random:tiny, synthetic frames, 2
   updates, validation and a checkpoint at step 2): losses, validation
   videos, artifact names and the written checkpoint's tensors;
   streaming reference: invert(store=...) and sample at a small size (the
   modes' UNet and weights): refine + reweight, replace with both blends,
   strength 0.5 and the save/swap edit, each edit on the card from the
   CPU's store;
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
   b3. the edit CLI, `fatezero_tpu_torch.cli.edit.run`, on two shipped
      configs at full width as shipped (bf16) but for their frames (8
      synthetic 512x512 PNGs), logdir and depth (CLI_STEPS steps, cut from
      50); their ./ckpt/ paths are absent, so the loader builds random:sd:
      config/teaser/jeep_watercolor.yaml (two prompts; its payload fits the
      8 GB budget: a full capture) and
      config/teaser/jeep_posche_local_latent_blend.yaml (both blends; under
      CLI_BLEND_BUDGET_GB: a hybrid, as at 50 steps under 8 GB). Each
      `[cli]` line gives the CLI's own
      phase_timings.json, the wall time, the capture plan, the payload
      predicted and held, the peak memory, K1's launches against the count
      from the sites' shapes (viz on) and the artifacts; every expected
      artifact (gifs, frame folders, atten gifs, one mask PNG per step and
      frame) must exist;
   c. tuning: three updates of config/tune/jeep.yaml's settings (lora 160,
      gradient checkpointing, temporal convs trained, lr 1e-5 constant, seed
      74831) on 8 frames at 512x512 in bf16;
   c2. the tuning CLI, `fatezero_tpu_torch.cli.train.run`, on
      config/tune/jeep.yaml as shipped but for 8 synthetic 512x640 frames
      (the random crop runs), 3 synthetic class images (the per-step path),
      the logdir and 4 updates with validation at step 4 (its first of 3
      prompts, VALIDATION_STEPS DDIM steps at strength 0.99, cut from 50) and
      a checkpoint at 4; the edit CLI on its checkpoint_4 with
      config/teaser/jeep_posche.yaml at TUNED_EDIT_STEPS steps (the
      loaded UNet must equal the tuned one bit for bit); then
      config/tune/man_skate.yaml (no class data: the chunked run_steps path
      with the crop on the card), 4 updates, one checkpoint. Each
      `[train-cli]` line gives seconds per step, the validation's invert,
      sample, decode and artifact seconds, checkpoint bytes against the fp32
      parameter bytes, peak memory and K1/K2/K3 launches against the counts
      from the sites' shapes; frozen parameters stay bit-identical, some
      trainable ones move, every artifact exists;
   c3. the streaming store through the edit CLI:
      config/low_resource_teaser/jeep_watercolor_ddim_10_steps_disk_store.yaml
      as shipped but for DISK_STORE_STEPS steps (random:sd, synthetic 512x512
      frames) and config/teaser/jeep_watercolor.yaml with
      use_inversion_attention false at SAVE_SWAP_STEPS steps (the save/swap
      edit). Each `[stream]` line gives the store's
      bytes a step predicted from the sites' shapes and held (and pickled),
      the copy seconds, the CLI's phase seconds, peak memory and K1's
      launches against the count from the sites' shapes; for the disk store
      also the largest difference between the streaming edit and the fused
      path's edit on the same trajectory (bf16, informational); the fp32
      witness at full width (the streaming edit against the fused stored
      edit, within one bf16 unit of the largest value) runs on the mesh
      phase's world of one (c8);
   c4. the dataset x p2p-grid sweep, `fatezero_tpu_torch.cli.dataset_sweep.run`,
      on config/dataset_sweep.yaml as shipped (its grid of self_replace_steps
      0.5 and 0.9, its editing block: one replace edit, 3 steps) but for
      random:sd in bf16 and SWEEP_VIDEOS video of 8 seeded 512x512 PNGs at
      image_size 512 (the frame loader's exact case): an edit per grid point,
      each with a `[sweep]` line (wall, phase_timings.json, capture plan, peak
      memory, K1 against the sites' count, the frame loader that ran); the
      result folders must be distinct;
   c5. the CLIP evaluation of those folders, `fatezero_tpu_torch.cli.evaluate.run`
      with an `items:` bench and a seeded random ViT-B/32, on the card and on
      the CPU: features within EVAL_FEATURE_TOL, Tem-Con within
      EVAL_TEMCON_TOL, logit gaps within EVAL_GAP_BAND, Frame-Acc equal on
      every frame whose logit gap clears EVAL_GAP_BAND, with the stub tokens and with a BPE tokenizer of the
      prompts (with which some frames must); config/bench_clean_prompt.yaml on a
      synthetic results tree (n, missing, per_item); image_features' frames
      per second on the card (`[eval]` lines);
   c6. the C++ frame loader (`[native]`): bit-equal to PIL at native
      resolution where it builds; where it does not, why, and
      native_loader=True must raise;
   c7. the port's headline bench, fatezero_tpu_torch/scripts/bench.py, at
      full width (teaser model, FRAMES x RES^2, bf16; BENCH_RUNS): `main` in
      this process, fused at 10 steps with viz (a full capture under the 8
      GB budget), fused with BENCH_REPLAY=1 at 10 steps and stream at 3,
      each `[bench]` line its JSON object and launches: bench.py's keys with
      the card's, the plan, the bench's own K1 count of its timed passes
      against the sites' shapes, its probe's K2 and K3 once each, every
      launch of the run against its count; then `python3 -m
      fatezero_tpu_torch.scripts.bench` as a process at BENCH_MODULE_STEPS
      steps (it re-executes itself under PYTHONHASHSEED=0) with its last
      line parsed and held to the same checks;
   c8. the edit, tuning and the streaming store on a (1,2,2) device mesh
      (`mesh_phase`) at full width, FRAMES x RES^2, through
      fatezero_tpu_torch/scripts/dryrun_mesh.py: four gloo ranks sharing the
      card, spawned once for three jobs, against a world of one running the
      same jobs in this process. `[mesh]`: the teaser model and controller, MESH_STEPS steps,
      the trajectory and the stored edit in fp32 within MESH_FP32_TOL
      (rel_l2), then in bf16 finite; in each dtype each rank's K1 launches
      equal to the unsharded count from the sites' shapes (the counts reset
      and read in the rank around each part) and its payload bytes to their
      prediction. `[mesh-train]`:
      config/tune/jeep.yaml's model, one AdamW update in fp32 within
      MESH_TRAIN_TOL of the world of one's (loss, gradient norm, clipped
      gradients, the update), and per rank in fp32 and bf16 K1/K2/K3 equal
      to the unsharded count from the sites' shapes, frozen tensors
      untouched. `[mesh-stream]`: the disk-store config's model and
      controller, the streaming inversion and edit in fp32 within
      MESH_STREAM_TOL, each rank's store bytes a step as predicted, the four
      ranks' sum the world of one's, the bf16 store's prediction
      STORE_BYTES_BF16, one pickle per rank and step, K1 per rank the
      unsharded count; the world of one's fp32 streaming and fused edits
      are the stream phase's fp32 witness. Then the edit CLI (teaser, FRAMES
      frames, every prompt), its disk-store branch and the tuning CLI (jeep,
      2 updates, a checkpoint and a validation of its first prompt), these
      two on MESH_CLI_FRAMES frames, each under NCCL as a world of one (mesh
      1,1,1), bit-equal to the run without a mesh;
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

import gc
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

# the edit CLI (python3 -m fatezero_tpu_torch.cli.edit) on shipped configs;
# the tiny run's decoded videos card vs CPU in fp32 (values in [0, 1])
REPO = os.path.dirname(os.path.abspath(__file__))
CLI_TINY = os.path.join(REPO, "config", "demo_tiny.yaml")
CLI_TEASER = os.path.join(REPO, "config", "teaser", "jeep_watercolor.yaml")
CLI_BLEND = os.path.join(REPO, "config", "teaser", "jeep_posche_local_latent_blend.yaml")
CLI_VIDEO_TOL = 1e-3
# the shipped teaser configs run 50 steps; the CLI phase runs them at 10, and
# the blend config under a 1.6 GB budget (7 of its 10 rows: a hybrid, as the
# 8 GB default gives 37 of 50)
CLI_STEPS, CLI_BLEND_BUDGET_GB = 10, 1.6

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
    self site, every controlled cross site materialised); 'inline, no blend'
    (the same without a blend: two attentions at each controlled site, none
    at the cross sites of `materialized` queries); 'stream' (the
    streaming store's StoreContext and EditContext: every controlled site
    materialised, so only the sites past the controlled size run K1)."""
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
        elif kind == "stream":
            continue
        elif kind in ("capture", "capture_only"):
            n += 1
        elif kind == "inline":
            n += 2
        elif kind == "inline, no blend":
            n += 2 + 2 * (s != materialized)
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


# ---------------------------------------------------------------- the edit CLI
def write_tokenizer(path, text):
    """A CLIP BPE vocab: the 512 byte symbols, the special tokens, and the
    merges (with their tokens) that join each word of `text` letter by letter
    from the left (a word can still split where another word's merge comes
    first)."""
    from fatezero_tpu_torch.models.tokenizer import bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars]
    merges = []
    for word in sorted(set(text.lower().replace(",", " ").split())):
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            merges.append(f"{parts[0]} {parts[1]}")
            parts = [parts[0] + parts[1]] + parts[2:]
            if parts[0] not in vocab:
                vocab.append(parts[0])
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({tok: i for i, tok in enumerate(vocab)}, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(dict.fromkeys(merges)) + "\n")
    return len(vocab)


def write_frames(path, n, hw, seed):
    """n seeded RGB PNG frames of hw = (h, w) pixels."""
    from PIL import Image

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(os.path.join(path, f"{i:05d}.png"))
    return path


def write_tiny_diffusers(path, model_config, text):
    """random:tiny's 2-D weights as a diffusers-layout checkpoint (the UNet's
    proj_in/proj_out as 1x1 convs, as SD-1.4 ships them), its config.json
    files, a tokenizer for `text` and a scheduler config."""
    from fatezero_tpu_torch.common.checkpoint import write_safetensors
    from fatezero_tpu_torch.models import loader as L

    m = L.load_models("random:tiny", model_config, device="cpu")
    unet = {k: v.numpy() for k, v in m.unet.state_dict().items() if "temporal" not in k and "lora" not in k}
    for k in unet:
        if k.endswith((".proj_in.weight", ".proj_out.weight")):
            unet[k] = unet[k][:, :, None, None]
    down = ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"]
    up = ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3
    tiny = L.TINY_UNET
    configs = {
        "unet": {**tiny, "block_out_channels": list(tiny["block_out_channels"]), "sample_size": 8,
                 "down_block_types": down, "up_block_types": up, "layers_per_block": 2},
        "vae": {"block_out_channels": list(L.TINY_VAE.block_out_channels), "norm_num_groups": 8,
                "latent_channels": 4, "layers_per_block": 2},
        "text_encoder": {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
                         "num_attention_heads": 2, "vocab_size": L.TINY_TEXT.vocab_size},
    }
    states = {"unet": unet, "vae": {k: v.numpy() for k, v in m.vae.state_dict().items()},
              "text_encoder": {k: v.numpy() for k, v in m.text_encoder.state_dict().items()}}
    for comp, cfg in configs.items():
        os.makedirs(os.path.join(path, comp), exist_ok=True)
        with open(os.path.join(path, comp, "config.json"), "w") as f:
            json.dump(cfg, f)
        name = "model.safetensors" if comp == "text_encoder" else "diffusion_pytorch_model.safetensors"
        write_safetensors(os.path.join(path, comp, name), states[comp])
    n_vocab = write_tokenizer(os.path.join(path, "tokenizer"), text)
    if n_vocab > L.TINY_TEXT.vocab_size:
        raise AssertionError(f"the tiny tokenizer holds {n_vocab} tokens, the text tower {L.TINY_TEXT.vocab_size}")
    os.makedirs(os.path.join(path, "scheduler"), exist_ok=True)
    with open(os.path.join(path, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump({"num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012,
                   "beta_schedule": "scaled_linear", "set_alpha_to_one": False}, f)
    return path


def artifact_names(root):
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)


def recorded_blends(fn):
    """Run fn() with every blend mask the pipeline thresholds recorded:
    (fn's result, [(normalised map on the host, threshold)])."""
    from fatezero_tpu_torch.pipelines import fatezero_pipeline as FPM

    rec, blend_mask = BlendRecorder(), FPM.blend_mask
    FPM.blend_mask = rec
    try:
        out = fn()
    finally:
        FPM.blend_mask = blend_mask
    return out, [(norm.float().cpu(), th) for norm, th in rec.calls]


def tiny_cli_reference():
    """config/demo_tiny.yaml through cli.edit.test on the card and on the CPU,
    fp32 (mixed_precision "no"), from a diffusers-layout checkpoint of
    random:tiny's 2-D weights and 8 synthetic 80x96 frames (the config takes
    4 at stride 2, at 64x64): both runs must write the same artifact names,
    decode videos within CLI_VIDEO_TOL, and write equal mask PNGs, with every
    normalised blend map within MODES_MAP_TOL of the CPU's and the CPU's
    pixels more than that from their threshold (the band rule)."""
    import shutil

    import torch
    from PIL import Image

    from fatezero_tpu_torch.cli import edit as cli
    from fatezero_tpu_torch.common.config import load_config

    work = os.path.join(REPO, "build", "cli_smoke_tiny")
    shutil.rmtree(work, ignore_errors=True)
    cfg = load_config(CLI_TINY).to_dict()
    prompts = " ".join([cfg["dataset_config"]["prompt"], *cfg["editing_config"]["editing_prompts"]])
    ckpt = write_tiny_diffusers(os.path.join(work, "tiny_ckpt"), cfg["model_config"], prompts)
    cfg["dataset_config"]["path"] = write_frames(os.path.join(work, "tiny_frames"), 8, (80, 96), seed=5)
    cfg.update(config=CLI_TINY, pretrained_model_path=ckpt, mixed_precision="no")
    runs = {}
    for dev in ("cuda", "cpu"):
        (logdir, videos), maps = recorded_blends(
            lambda: cli.test(**cfg, logdir=os.path.join(work, f"tiny_{dev}"), device=dev))
        runs[dev] = (logdir, videos, maps, artifact_names(logdir))
    (gdir, gvid, gmaps, gnames), (cdir, cvid, cmaps, cnames) = runs["cuda"], runs["cpu"]
    if gnames != cnames:
        raise AssertionError(f"tiny CLI artifacts differ card vs CPU: {sorted(set(gnames) ^ set(cnames))[:10]}")
    vid_err = max(float(np.abs(a - b).max()) for a, b in zip(gvid, cvid))
    map_err = max(((a - b).abs().max().item() for (a, _), (b, _) in zip(gmaps, cmaps)), default=0.0)
    margin = min(((b - th).abs().min().item() for b, th in cmaps), default=float("inf"))
    masks = [n for n in cnames if n.endswith(".png") and "_blend_mask" in n]
    same = all(np.array_equal(np.asarray(Image.open(os.path.join(gdir, n))), np.asarray(Image.open(os.path.join(cdir, n))))
               for n in masks)
    log(f"[cli tiny] {len(cnames)} artifacts, names equal; decoded videos max_abs_err {vid_err:.3e} "
        f"(tol {CLI_VIDEO_TOL}); {len(cmaps)} blend maps max_abs_err {map_err:.3e} (tol {MODES_MAP_TOL}), closest "
        f"CPU pixel {margin:.3e} from its threshold; {len(masks)} mask PNGs equal {same}")
    if len(gmaps) != len(cmaps) or not masks:
        raise AssertionError(f"tiny CLI: {len(gmaps)} vs {len(cmaps)} blend maps, {len(masks)} mask PNGs")
    if not (vid_err <= CLI_VIDEO_TOL and map_err <= MODES_MAP_TOL and margin > MODES_MAP_TOL and same):
        raise AssertionError("the tiny CLI run on the card disagrees with the CPU's")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def cli_k1_expected(unet, latent, steps, n_prompts, plan, window, viz=True):
    """K1 launches of one CLI edit run from the sites' shapes: the inversion
    captures the plan's rows (a plain forward elsewhere); each prompt's edit
    (with viz, as the CLI runs it, the (latent/4)^2 cross sites materialise)
    runs stored where the payload serves it, replays (a capture-only forward,
    then the edit) up to the edit window, and runs the identity-gated tail
    stored."""
    s16 = (latent // 4) ** 2 if viz else None
    per = {kind: k1_per_forward(unet, latent, kind, s16) for kind in ("plain", "capture", "capture_only", "edit")}
    k = 0 if plan is None else plan[1]
    w_id = steps if k == steps else max(window, k)
    invert = k * per["capture"] + (steps - k) * per["plain"]
    replay = (w_id - k) if plan is not None else steps
    edit = (steps - replay) * per["edit"] + replay * (per["capture_only"] + per["edit"])
    return invert + n_prompts * edit, per


def apply_overrides(cfg, overrides):
    """Merge `overrides` into a config dict: a top-level key is set, a dict
    value updates that block."""
    for key, value in overrides.items():
        if isinstance(value, dict):
            cfg[key].update(value)
        else:
            cfg[key] = value


def cli_full_width(name, path, work, frames, kernels, reset_counts, check_plain, overrides=None):
    """A shipped config through cli.edit.run at full SD-1.4 width, as shipped
    but for its frames (8 synthetic 512^2 PNGs), its logdir and `overrides`
    (top-level keys; a dict value updates that block): where its
    pretrained_model_path (./ckpt/...) is absent, the loader warns and
    builds random:sd, as the JAX package does. Returns the run's numbers."""
    import torch

    from fatezero_tpu_torch.cli import edit as cli
    from fatezero_tpu_torch.common.config import load_config
    from fatezero_tpu_torch.models.loader import _unet_cfg_overrides
    from fatezero_tpu_torch.models.unet3d import UNet3DConfig, UNetPseudo3DConditionModel
    from fatezero_tpu_torch.pipelines import fatezero_pipeline as FPM

    cfg = load_config(path).to_dict()
    cfg["dataset_config"]["path"] = frames
    apply_overrides(cfg, overrides or {})
    logdir = os.path.join(work, name)
    cfg["logdir"] = logdir
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with Recorder() as rec:
        plans = rec.wrap(FPM.FateZeroPipeline, "plan_capture", keep=True)
        inversions = rec.wrap(FPM.FateZeroPipeline, "invert_fast", keep=True)
        edits = rec.wrap(FPM.FateZeroPipeline, "edit_fast")
        decodes = rec.wrap(FPM.FateZeroPipeline, "decode_latents")
        out_dir, videos = cli.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    check_plain(f"cli {name}")
    with open(os.path.join(out_dir, "phase_timings.json")) as f:
        timings = {k: v["seconds"] for k, v in json.load(f).items()}
    steps = int(cfg["editing_config"]["num_inference_steps"])
    prompts = list(cfg["editing_config"]["editing_prompts"])
    n_frames = int(cfg["dataset_config"]["n_sample_frame"])
    meta = UNetPseudo3DConditionModel(UNet3DConfig(**_unet_cfg_overrides(cfg["model_config"])),
                                      dtype=torch.bfloat16, device="meta")
    seen = {"edit_s": [t for t, _ in edits], "decode_s": [t for t, _ in decodes]}
    if plans:
        pipe, (latents, _), kw, plan = plans[0][1]
        seen.update(plan=plan, window=kw["window"], budget=kw["budget_bytes"],
                    predicted=0 if plan is None else pipe.capture_payload_bytes(latents, plan[1]))
    captured = [c[1][3][1] for c in inversions if c[1][2].get("capture")]
    if captured:
        seen["held"] = sum(t.numel() * t.element_size() for t in FPM._payload_leaves(captured[0]))
    del plans, inversions, captured  # the run's models and payload
    k1_expect, per = cli_k1_expected(meta, RES // 8, steps, len(prompts), seen.get("plan"), seen.get("window", 0))
    names = artifact_names(out_dir)
    expect = {"input.gif", "grid.gif", "step_0.gif", "step_0atten.gif", "config.yml", "log.log", "phase_timings.json"}
    for i in range(len(prompts)):
        expect |= {f"step_0_{i}_0.gif", f"step_0_{i}_0atten.gif"} | {f"step_0_{i}_0/{j:05d}.png" for j in range(n_frames)}
    masks = {}
    for i, block in (cfg["editing_config"].get("p2p_config") or {}).items():
        for flag, sub in (("blend_latents", "latent_blend_mask"), ("blend_self_attention", "attention_blend_mask")):
            if block.get("blend_words") and block.get(flag):
                want = {f"prompt_{i}/{sub}/mask_step{s:03d}_{s + 1:03d}_{j:02d}.png"
                        for s in range(steps) for j in range(n_frames)}
                masks[f"prompt_{i}/{sub}"] = len(want)
                expect |= want
    missing = sorted(expect - set(names))
    finite = all(np.isfinite(v).all() and v.shape == (n_frames, RES, RES, 3) for v in videos)
    result = dict(
        config=os.path.relpath(path, REPO), phase_seconds=timings, wall_s=wall,
        edit_fast_s=seen["edit_s"], decode_s=seen["decode_s"],
        artifact_s=timings["editing"] - sum(seen["edit_s"]) - sum(seen["decode_s"]), plan=seen.get("plan"),
        window=seen.get("window"), budget_bytes=seen.get("budget"), payload_predicted=seen.get("predicted"),
        payload_held=seen.get("held"), peak_gib=peak / 2**30, k1=launches["flash_forward"], k1_expected=k1_expect,
        k1_per_forward=per, launches=launches, artifacts=len(names), mask_pngs=masks, videos_finite=finite,
    )
    log(f"[cli] {name}: {json.dumps(result)}")
    log(f"[cli] {name} artifact names (frame folders and masks folded): "
        + json.dumps(sorted({n.split('/')[0] if '/' in n else n for n in names})))
    if missing or not finite or len(videos) != len(prompts):
        raise AssertionError(f"cli {name}: missing artifacts {missing[:10]}, videos finite {finite}, "
                             f"{len(videos)} videos for {len(prompts)} prompts")
    if launches["flash_forward"] != k1_expect:
        raise AssertionError(f"cli {name}: K1 launched {launches['flash_forward']} times, the sites' shapes give {k1_expect}")
    if seen.get("plan") is not None and seen.get("held") != seen.get("predicted"):
        raise AssertionError(f"cli {name}: payload predicted {seen.get('predicted')}, held {seen.get('held')}")
    return result


def cli_phase(kernels, reset_counts, check_plain):
    """The edit CLI at full width: the teaser and the blend config at
    CLI_STEPS steps each (cut from their 50); the blend config under a
    CLI_BLEND_BUDGET_GB payload budget, so that its capture is a hybrid, as
    the 8 GB default makes it at 50 steps."""
    import shutil

    import torch

    work = os.path.join(REPO, "build", "cli_smoke")
    shutil.rmtree(work, ignore_errors=True)
    frames = write_frames(os.path.join(work, "frames"), FRAMES, (RES, RES), seed=7)
    results = {}
    over = {"editing_config": {"num_inference_steps": CLI_STEPS}}
    try:
        for name, path, budget in (("teaser", CLI_TEASER, None), ("blend", CLI_BLEND, CLI_BLEND_BUDGET_GB)):
            if budget is not None:
                os.environ["FZ_PAYLOAD_BUDGET_GB"] = str(budget)
            try:
                results[name], _ = phase(f"cli {name}", lambda: cli_full_width(
                    name, path, work, frames, kernels, reset_counts, check_plain, overrides=over))
            finally:
                os.environ.pop("FZ_PAYLOAD_BUDGET_GB", None)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


# ---------------------------------------------------------------- tuning CLI
TUNE_TINY = os.path.join(REPO, "config", "tune_demo_tiny.yaml")
TUNE_JEEP = os.path.join(REPO, "config", "tune", "jeep.yaml")
TUNE_MAN = os.path.join(REPO, "config", "tune", "man_skate.yaml")
EDIT_POSCHE = os.path.join(REPO, "config", "teaser", "jeep_posche.yaml")
DISK_STORE = os.path.join(REPO, "config", "low_resource_teaser", "jeep_watercolor_ddim_10_steps_disk_store.yaml")
TUNE_CLI_STEPS = 4  # config/tune/*.yaml train 1,000 steps
TUNED_EDIT_STEPS = 3  # config/teaser/jeep_posche.yaml runs 50
VALIDATION_STEPS = 10  # config/tune/jeep.yaml validates at 50
# the tiny tuning run's update, card against CPU: two CPU runs that differ only
# in their thread count read 2.2e-4; an update never applied reads 1, one of
# the two steps missing about 0.5
TUNE_UPDATE_TOL = 0.02
SAVE_SWAP_STEPS = 3  # config/teaser/jeep_watercolor.yaml runs 50
DISK_STORE_STEPS = 3  # the disk-store config runs 10


class Recorder:
    """Wraps methods of classes for one run: each call's seconds (synchronised
    on the card) and, where asked, what `keep(obj, args, kwargs, result)`
    picks of it (True: all four); restores the methods on exit."""

    def __init__(self, sync=True):
        self.sync, self.calls, self.saved = sync, {}, []

    def wrap(self, cls, name, keep=None):
        import torch

        fn = getattr(cls, name)
        calls = self.calls.setdefault(f"{cls.__name__}.{name}", [])

        def wrapped(obj, *args, **kwargs):
            if self.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(obj, *args, **kwargs)
            if self.sync:
                torch.cuda.synchronize()
            call = (obj, args, kwargs, out)
            calls.append((time.perf_counter() - t0, (call if keep is True else keep(*call)) if keep else None))
            return out

        self.saved.append((cls, name, fn))
        setattr(cls, name, wrapped)
        return calls

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for cls, name, fn in reversed(self.saved):
            setattr(cls, name, fn)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def tiny_train_cli_reference():
    """config/tune_demo_tiny.yaml through cli.train.train on the card and on
    the CPU, fp32 (mixed_precision "no"), random:tiny, 8 synthetic 80x96
    frames (the config takes 4 at stride 2, random 64x64 crops on the
    device), 2 updates, validation and a checkpoint at step 2, 2-step
    validation sampling; every random is drawn on the host, so both runs
    draw the same. Held: the losses within 1e-4 relative, the validation
    videos within CLI_VIDEO_TOL, the same artifact names, and the written
    checkpoint's tensors: the frozen ones equal; of the trained ones the
    update (checkpoint minus the start the trainer's init_state saw), the
    card's against the CPU's: the norm of their difference within
    TUNE_UPDATE_TOL of the norm of the CPU's update (an update the card never
    applied reads 1, checked below), 99.9 % of the coordinates within
    0.05 lr, and every one within two AdamW steps (2 x 2.1 lr: a coordinate
    whose gradient is at its rounding noise may step the other way)."""
    import shutil

    import torch

    from fatezero_tpu_torch.cli import train as tcli
    from fatezero_tpu_torch.common.checkpoint import _flatten, read_safetensors
    from fatezero_tpu_torch.common.config import load_config
    from fatezero_tpu_torch.convert.to_flax import unet_state_to_flax
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
    from fatezero_tpu_torch.trainer.ddpm_trainer import DDPMTrainer

    def start_tensors(trainer, args, kwargs, state):  # copies: on the CPU .numpy() shares the masters
        flat = _flatten(unet_state_to_flax(tcli._host_state(trainer.unet.state_dict(), state["master"])))
        return {k: v.copy() for k, v in flat.items()}

    work = os.path.join(REPO, "build", "train_smoke_tiny")
    shutil.rmtree(work, ignore_errors=True)
    cfg = load_config(TUNE_TINY).to_dict()
    cfg["dataset_config"]["path"] = write_frames(os.path.join(work, "frames"), 8, (80, 96), seed=3)
    cfg.update(config=TUNE_TINY, mixed_precision="no", train_steps=2, validation_steps=2, checkpointing_steps=2,
               validation_sample_logger_config={"num_inference_steps": 2})
    lr = float(cfg["learning_rate"])
    runs = {}
    for dev in ("cuda", "cpu"):
        with Recorder(sync=False) as rec:
            chunks = rec.wrap(DDPMTrainer, "run_steps", keep=True)
            decoded = rec.wrap(FateZeroPipeline, "decode_latents", keep=True)
            starts = rec.wrap(DDPMTrainer, "init_state", keep=start_tensors)
            logdir, _ = tcli.train(**cfg, logdir=os.path.join(work, dev), device=dev)
        losses = torch.cat([c[1][3][1].float().cpu() for c in chunks])
        videos = [c[1][3] for c in decoded]
        ck = {comp: read_safetensors(os.path.join(logdir, "checkpoint_2", comp, "flax_model.safetensors"))
              for comp in ("unet", "vae", "text_encoder")}
        runs[dev] = (logdir, losses, videos, ck, artifact_names(logdir), starts[0][1])
    (gdir, gl, gv, gck, gnames, gstart), (cdir, cl, cv, cck, cnames, cstart) = runs["cuda"], runs["cpu"]
    if gnames != cnames:
        raise AssertionError(f"tiny tuning CLI artifacts differ card vs CPU: {sorted(set(gnames) ^ set(cnames))[:10]}")
    loss_err = float(((gl - cl).abs() / cl.abs()).max())
    vid_err = max(float(np.abs(a - b).max()) for a, b in zip(gv, cv))
    frozen_diff, trained = [], []
    for comp in sorted(cck):
        for key, ref in cck[comp].items():
            got = gck[comp][key]
            if comp == "unet" and any(p in key for p in ("attn_temporal", "to_q", "conv_temporal", "lora_temporal")):
                trained.append(key)
            elif not np.array_equal(got, ref):
                frozen_diff.append(f"{comp}/{key}")
    start_diff = [k for k in cstart if not np.array_equal(gstart[k], cstart[k])]

    def update_errors(card):
        """(norm ratio, share within 0.05 lr, max |diff| / lr) of the card's
        update `card - start` against the CPU's."""
        du_g = np.concatenate([(card[k] - gstart[k]).ravel() for k in trained])
        du_c = np.concatenate([(cck["unet"][k] - cstart[k]).ravel() for k in trained])
        diff = np.abs(du_g - du_c)
        return (float(np.linalg.norm(diff) / np.linalg.norm(du_c)), float((diff <= 0.05 * lr).mean()),
                float(diff.max() / lr))

    def update_ok(errs):
        return errs[0] <= TUNE_UPDATE_TOL and errs[1] >= 0.999 and errs[2] <= 4.2

    upd = update_errors(gck["unet"]) if trained else (np.inf, 0.0, np.inf)
    null = update_errors(gstart) if trained else (np.inf, 0.0, np.inf)  # the card never updating
    log(f"[train-cli tiny] {len(cnames)} artifacts, names equal; losses card {gl.tolist()} cpu {cl.tolist()} "
        f"max rel err {loss_err:.3e} (tol 1e-4); validation videos {len(gv)} max_abs_err {vid_err:.3e} "
        f"(tol {CLI_VIDEO_TOL}); checkpoint_2: {len(trained)} trained tensors, update card vs cpu: "
        f"|diff|/|cpu update| {upd[0]:.3e} (tol {TUNE_UPDATE_TOL}), share within 0.05 lr {upd[1]:.6f} (tol 0.999), "
        f"max |diff| {upd[2]:.3f} lr (tol 4.2); an unapplied update reads {null[0]:.3e} / {null[1]:.6f} / "
        f"{null[2]:.3f} and fails; frozen tensors differing {len(frozen_diff)}, start tensors differing "
        f"{len(start_diff)}")
    if not (len(gv) == len(cv) >= 1 and len(gl) == len(cl) == 2 and trained):
        raise AssertionError(f"tiny tuning CLI: {len(gv)} / {len(cv)} videos, {len(gl)} / {len(cl)} losses")
    if update_ok(null):
        raise AssertionError(f"the update check passes a card run that never updated: {null}")
    if not (loss_err <= 1e-4 and vid_err <= CLI_VIDEO_TOL and update_ok(upd) and not frozen_diff
            and not start_diff):
        raise AssertionError(f"the tiny tuning CLI run on the card disagrees with the CPU's: update {upd}, "
                             f"frozen {frozen_diff[:3]}, start {start_diff[:3]}")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def tiny_streaming_reference():
    """The streaming store at a small size, card against CPU, fp32: the tiny
    UNet with the blend config's model_config and sharp_cross_state's
    weights, 2 frames of 16x16 seeded latents, seeded text embeddings, 3
    steps. invert(store=...) card against CPU (trajectory within 1e-3 x
    max|x|, every stored map within MODES_PAYLOAD_TOL); then each edit on the
    card from the CPU's store and trajectory against the CPU's: sample with
    the teaser's refine + reweight controller, with the blend config's
    replace controller and both blends, with both blends at strength 0.5,
    and the save/swap edit (the 'save' loop, then the swap against the CPU's
    save store). Held: latents within 1e-3 x max|x|, every normalised blend
    map within MODES_MAP_TOL with the CPU's threshold band empty, the
    recorded masks equal."""
    import torch

    from fatezero_tpu_torch.models.loader import load_models, load_state
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
    from fatezero_tpu_torch.ptp.controller import make_controller
    from fatezero_tpu_torch.ptp.store import AttentionStore

    steps = 3
    rng = np.random.default_rng(13)
    lat = rng.standard_normal((1, 2, 16, 16, 4)).astype(np.float32)
    emb = [rng.standard_normal((2, 77, 32)).astype(np.float32) for _ in range(2)]
    teaser = dict(is_replace_controller=False, cross_replace_steps=0.8, self_replace_steps=0.8,
                  eq_params={"words": ["watercolor"], "values": [10]})
    modes = [  # name, prompts, controller keywords, strength
        ("refine + reweight", (SOURCE, TARGET), teaser, 1.0),
        ("replace, both blends", (POSCHE_SOURCE, POSCHE_TARGET), POSCHE_P2P, 1.0),
        ("both blends, strength 0.5", (POSCHE_SOURCE, POSCHE_TARGET), POSCHE_P2P, 0.5),
        ("save/swap", (POSCHE_SOURCE, POSCHE_TARGET), {**POSCHE_P2P, "use_inversion_attention": False}, 1.0),
    ]
    out, ref, state, faults = {}, {}, None, []
    for dev in (torch.device("cpu"), torch.device("cuda")):
        m = load_models("random:tiny", POSCHE_MODEL, torch.float32, device=dev)
        state = state or sharp_cross_state(m.unet, seed=7)
        load_state(m.unet, state, dev)
        pipe = FateZeroPipeline(m.unet, None, None, m.tokenizer, m.schedule, store_dtype=torch.float32, device=dev)
        x, es, et = (torch.from_numpy(a).to(dev) for a in (lat, *emb))
        store = AttentionStore()
        traj = pipe.invert(x, es, steps, store=store)
        if dev.type == "cpu":
            ref.update(store=store, traj=traj)
        else:
            t_err = max(float((a - b).abs().max()) for a, b in zip(traj, ref["traj"]))
            t_tol = 1e-3 * max(1.0, max(float(b.abs().max()) for b in ref["traj"]))
            m_err = max(float((a - b).abs().max()) for i in range(steps) for k, v in store.step_maps(i).items()
                        for a, b in zip(v, ref["store"].step_maps(i)[k]))
            log(f"[stream reference] tiny invert(store=...) card vs CPU: trajectory max_abs_err {t_err:.3e} "
                f"(tol {t_tol:.3e}), stored maps max_abs_err {m_err:.3e} (tol {MODES_PAYLOAD_TOL}), "
                f"{store.step_bytes[0]} bytes a step")
            if not (t_err <= t_tol and m_err <= MODES_PAYLOAD_TOL):
                faults.append(f"invert: trajectory {t_err:.3e}, maps {m_err:.3e}")
        # every edit reads the CPU's store and trajectory
        store, traj = ref["store"], ref["traj"]
        res = out[dev.type] = {}
        for name, prompts, kw, strength in modes:
            ctl = make_controller(m.tokenizer, list(prompts), steps, **kw)
            n_used = steps if strength == 1.0 else int(steps * strength)
            init = traj[n_used]
            if name == "save/swap":
                save = AttentionStore()
                first = pipe.sample(init, es, steps, edit_store=save)
                res["save"] = (first.float().cpu(), [], None)
                if dev.type == "cpu":
                    ref["save"] = save
                save = ref["save"]
                fn = lambda: pipe.sample(init, et, steps, controller=ctl, inv_store=save,  # noqa: E731
                                         inverted_latents=[init] + list(save.latents_store))
            else:
                fn = lambda: pipe.sample(init, et, steps, controller=ctl, inv_store=store,  # noqa: E731
                                         inverted_latents=traj, strength=strength)
            latent, calls = recorded_blends(fn)
            masks = [np.stack(b.mask_list) for b in (ctl.attention_blend, ctl.latent_blend) if b is not None]
            res[name] = (latent.float().cpu(), calls, masks)
        del m, pipe
    for name in ["save"] + [mode[0] for mode in modes]:
        (a, calls_a, masks_a), (b, calls_b, masks_b) = out["cuda"][name], out["cpu"][name]
        err = float((a - b).abs().max())
        tol = 1e-3 * max(1.0, float(b.abs().max()))
        map_err = max((float((na - nb).abs().max()) for (na, _), (nb, _) in zip(calls_a, calls_b)), default=0.0)
        in_band = sum(int(((nb - th).abs() <= MODES_MAP_TOL).sum()) for nb, th in calls_b)
        same = masks_b is None or all(np.array_equal(x, y) for x, y in zip(masks_a, masks_b))
        mean = [round(float(mk.mean()), 4) for mk in masks_b or []]
        log(f"[stream reference] tiny {name}: latent max_abs_err {err:.3e} (tol {tol:.3e}); {len(calls_b)} blend "
            f"maps max_abs_err {map_err:.3e} (tol {MODES_MAP_TOL}), {in_band} CPU pixels within it of their "
            f"threshold; masks equal {same}, mask means {mean}")
        if not (torch.isfinite(a).all() and err <= tol and map_err <= MODES_MAP_TOL and in_band == 0 and same
                and len(calls_a) == len(calls_b)):
            faults.append(f"{name}: latent {err:.3e} (tol {tol:.3e}), maps {map_err:.3e}, band {in_band}, "
                          f"masks equal {same}")
    if faults:
        raise AssertionError("tiny streaming edit, card vs CPU: " + "; ".join(faults))
    torch.cuda.empty_cache()


def flax_file_bytes(module):
    """Predicted size of a component's flax_model.safetensors written in fp32:
    4 bytes a parameter (the JSON header comes on top)."""
    return 4 * sum(p.numel() for p in module.state_dict().values())


def train_cli_full_width(name, path, work, frames, class_dir, overrides, kernels, reset_counts, check_plain):
    """A shipped tuning config through cli.train.run at full SD-1.4 width, as
    shipped but for `overrides`, its frames and class images (synthetic) and
    its logdir; ./ckpt/... is absent, so the loader builds random:sd. Prints
    the `[train-cli]` line; returns (its numbers, the tuned UNet's tensors on
    the host, the logdir)."""
    import torch

    from fatezero_tpu_torch.cli import train as tcli
    from fatezero_tpu_torch.common.config import load_config
    from fatezero_tpu_torch.models.loader import load_models
    from fatezero_tpu_torch.ops.flash_attention import FLASH_MIN_QUERIES
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
    from fatezero_tpu_torch.trainer.ddpm_trainer import DDPMTrainer

    cfg = load_config(path).to_dict()
    cfg["dataset_config"]["path"] = frames
    if class_dir is not None:
        cfg["dataset_config"]["class_data_root"] = class_dir
    apply_overrides(cfg, overrides)
    cfg.update(config=path, logdir=os.path.join(work, name))
    seen = {}
    init_state = DDPMTrainer.init_state

    def snapshot(trainer):
        st = init_state(trainer)
        seen["trainer"] = trainer
        seen["frozen"] = {n: p.detach().clone() for n, p in trainer.unet.named_parameters()
                          if n not in trainer.trainable}
        seen["start"] = {n: p.detach().clone() for n, p in trainer.trainable.items()}
        return st

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with Recorder() as rec:
        steps_s = rec.wrap(DDPMTrainer, "step")
        chunks_s = rec.wrap(DDPMTrainer, "run_steps", keep=True)
        samples_s = rec.wrap(FateZeroPipeline, "sample")
        decodes_s = rec.wrap(FateZeroPipeline, "decode_latents")
        DDPMTrainer.init_state = snapshot
        try:
            logdir, state = tcli.run(cfg)
        finally:
            DDPMTrainer.init_state = init_state
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    check_plain(f"train-cli {name}")
    trainer = seen.pop("trainer")
    unet = trainer.unet
    with open(os.path.join(logdir, "phase_timings.json")) as f:
        timings = {k: v["seconds"] for k, v in json.load(f).items()}
    train_steps = int(cfg["train_steps"])
    vsteps, csteps = int(cfg.get("validation_steps") or 0), int(cfg.get("checkpointing_steps") or 0)
    n_val = train_steps // vsteps if vsteps else 0
    editing = cfg.get("editing_config") or {}
    prompts = list(editing.get("editing_prompts", [cfg["dataset_config"].get("prompt", "")]))
    seeds = list(editing.get("sample_seeds", [0]))
    vsteps_ddim = int(editing.get("num_inference_steps", 10))
    strength = float(editing.get("strength", 1.0) or 1.0)
    n_used = min(vsteps_ddim, int(vsteps_ddim * strength)) if strength < 1.0 else vsteps_ddim
    lat = RES // 8
    sites = count_sites(unet, FLASH_MIN_QUERIES, lat)
    plain = k1_per_forward(unet, lat, "plain")
    expect = dict(
        flash_forward=2 * sites * train_steps + n_val * plain * (vsteps_ddim + len(prompts) * len(seeds) * n_used),
        flash_dq=sites * train_steps, flash_dkv=sites * train_steps,
    )
    frozen_moved = [n for n, p in unet.named_parameters() if n in seen["frozen"]
                    and not torch.equal(p.detach(), seen["frozen"][n])]
    moved = [n for n, p in trainer.trainable.items() if not torch.equal(p.detach(), seen["start"][n])]
    ckpts = sorted(d for d in os.listdir(logdir) if d.startswith("checkpoint_"))
    ck_bytes = {d: dir_bytes(os.path.join(logdir, d)) for d in ckpts}
    meta = load_models("random:sd", cfg.get("model_config"), device="meta")
    ck_predicted = sum(flax_file_bytes(mod) for mod in (meta.unet, meta.vae, meta.text_encoder))
    names = set(artifact_names(logdir))
    want = {"log.log", "config.yml", "phase_timings.json"}
    for c in range(csteps, train_steps + 1, csteps) if csteps else ():
        want |= {f"checkpoint_{c}/{comp}/{f}" for comp in ("unet", "vae", "text_encoder")
                 for f in ("config.json", "flax_model.safetensors")}
        want |= {f"checkpoint_{c}/training_state.pt", f"checkpoint_{c}/scheduler/scheduler_config.json"}
    for v in range(vsteps, train_steps + 1, vsteps) if vsteps else ():
        want |= {f"validation_{v}/step_{v}.gif"} | {f"validation_{v}/step_{v}_{i}_{s}.gif"
                                                     for i in range(len(prompts)) for s in seeds}
    missing = sorted(want - names)
    val_s = [t for t, _ in samples_s]
    result = dict(
        config=os.path.relpath(path, REPO), overrides=overrides, wall_s=wall, phase_seconds=timings,
        step_s=[t for t, _ in steps_s], chunks=[(int(call[1][4]), t) for t, call in chunks_s],
        validation_sample_s=val_s, validation_decode_s=[t for t, _ in decodes_s],
        validation_artifact_s=timings.get("validation", 0.0) - timings.get("validation_invert", 0.0)
        - sum(val_s) - sum(t for t, _ in decodes_s),
        checkpoint_bytes=ck_bytes, checkpoint_flax_predicted=ck_predicted, peak_gib=peak / 2**30,
        launches=launches, expected=expect, sites=sites, k1_plain_per_forward=plain,
        trainable_moved=f"{len(moved)} of {len(seen['start'])}", frozen_moved=len(frozen_moved),
        final_loss=load_config(os.path.join(logdir, "config.yml")).to_dict()["final_loss"],
    )
    log(f"[train-cli] {name}: {json.dumps(result)}")
    if missing:
        raise AssertionError(f"train-cli {name}: missing artifacts {missing[:10]}")
    for kname, n in expect.items():
        if launches[kname] != n:
            raise AssertionError(f"train-cli {name}: {kname} launched {launches[kname]} times, the shapes give {n}")
    if frozen_moved or not moved or not np.isfinite(result["final_loss"]) or state["step"] != train_steps:
        raise AssertionError(f"train-cli {name}: frozen moved {frozen_moved[:3]}, {len(moved)} trainable moved, "
                             f"final loss {result['final_loss']}, step {state['step']}")
    tuned = {n: p.detach().cpu() for n, p in unet.state_dict().items()}
    del seen, trainer, unet, state
    return result, tuned, logdir


def tuned_edit(work, frames, ckpt, tuned, kernels, reset_counts, check_plain):
    """config/teaser/jeep_posche.yaml through cli.edit.run on the tuned jeep
    checkpoint: the UNet it loads must equal the tuned one bit for bit."""
    import torch

    from fatezero_tpu_torch.cli import edit as ecli

    loaded, load_models = {}, ecli.load_models

    def capture(*args, **kwargs):
        bundle = load_models(*args, **kwargs)
        loaded["unet"] = bundle.unet
        return bundle

    ecli.load_models = capture
    try:
        result = cli_full_width("tuned_jeep_posche", EDIT_POSCHE, work, frames, kernels, reset_counts, check_plain,
                                overrides={"pretrained_model_path": ckpt,
                                           "editing_config": {"num_inference_steps": TUNED_EDIT_STEPS}})
    finally:
        ecli.load_models = load_models
    state = loaded.pop("unet").state_dict()
    differ = [k for k, v in tuned.items() if not torch.equal(state[k].cpu(), v)]
    log(f"[train-cli] tuned jeep_posche: the loaded UNet's {len(state)} tensors against the tuned ones: "
        f"{len(differ)} differ; keys equal {set(state) == set(tuned)}")
    if differ or set(state) != set(tuned):
        raise AssertionError(f"the edit CLI did not load the tuned UNet: {differ[:5]}")
    return result


def train_cli_phase(kernels, reset_counts, check_plain):
    """The tuning CLI at full width: config/tune/jeep.yaml (the per-step path
    with class images, validation and a checkpoint), the edit CLI on its
    checkpoint, then config/tune/man_skate.yaml (the chunked path)."""
    import shutil

    import torch

    from fatezero_tpu_torch.common.config import load_config

    work = os.path.join(REPO, "build", "train_smoke")
    shutil.rmtree(work, ignore_errors=True)
    results = {}
    try:
        # 512x640 frames: the short side scales to 512 and the random crop runs
        frames = write_frames(os.path.join(work, "frames"), FRAMES, (RES, 640), seed=11)
        edit_frames = write_frames(os.path.join(work, "edit_frames"), FRAMES, (RES, RES), seed=7)
        class_dir = write_frames(os.path.join(work, "class"), 3, (RES, RES), seed=12)
        prompts = load_config(TUNE_JEEP).to_dict()["editing_config"]["editing_prompts"][:1]  # of 3
        jeep = dict(train_steps=TUNE_CLI_STEPS, validation_steps=TUNE_CLI_STEPS, checkpointing_steps=TUNE_CLI_STEPS,
                    editing_config={"num_inference_steps": VALIDATION_STEPS, "editing_prompts": prompts})
        (results["jeep"], tuned, logdir), _ = phase("train-cli jeep", lambda: train_cli_full_width(
            "jeep", TUNE_JEEP, work, frames, class_dir, jeep, kernels, reset_counts, check_plain))
        torch.cuda.empty_cache()
        ckpt = os.path.join(logdir, f"checkpoint_{TUNE_CLI_STEPS}")
        results["tuned_edit"], _ = phase("cli tuned jeep_posche", lambda: tuned_edit(
            work, edit_frames, ckpt, tuned, kernels, reset_counts, check_plain))
        del tuned
        shutil.rmtree(logdir, ignore_errors=True)
        torch.cuda.empty_cache()
        man = dict(train_steps=TUNE_CLI_STEPS, validation_steps=0, checkpointing_steps=0)  # jeep's run writes one
        (results["man_skate"], _, logdir), _ = phase("train-cli man_skate", lambda: train_cli_full_width(
            "man_skate", TUNE_MAN, work, frames, None, man, kernels, reset_counts, check_plain))
        # run_steps calls step once an update, so both paths time every step
        if [c[0] for c in results["man_skate"]["chunks"]] != [TUNE_CLI_STEPS]:
            raise AssertionError(f"man_skate did not take the chunked path: {results['man_skate']['chunks']}")
        if results["jeep"]["chunks"] or len(results["jeep"]["step_s"]) != TUNE_CLI_STEPS:
            raise AssertionError("jeep (class images) did not take the per-step path")
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


# ---------------------------------------------------------- streaming store
def stream_full_width(name, path, work, frames, overrides, kernels, reset_counts, check_plain):
    """A shipped config on the streaming store through cli.edit.run at full
    width (random:sd, bf16, synthetic 512^2 frames). Prints the `[stream]`
    line: bytes a step predicted and held (and on disk), the copy seconds,
    inversion and editing seconds, peak memory, K1's launches against the
    sites' shapes; for an inversion store also the streaming edit against
    the fused path's replay edit on the same trajectory (bf16, informational)."""
    import torch

    from fatezero_tpu_torch.cli import edit as ecli
    from fatezero_tpu_torch.common.config import load_config
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
    from fatezero_tpu_torch.pipelines.p2p_validation_loop import P2pSampleLogger
    from fatezero_tpu_torch.ptp.store import AttentionStore

    cfg = load_config(path).to_dict()
    cfg["dataset_config"]["path"] = frames
    apply_overrides(cfg, overrides)
    cfg["logdir"] = os.path.join(work, name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with Recorder() as rec:
        appends = rec.wrap(AttentionStore, "append_step", keep=lambda store, *_: store)  # not the maps
        inverts = rec.wrap(FateZeroPipeline, "invert", keep=True)
        samples = rec.wrap(FateZeroPipeline, "sample", keep=True)
        plans = rec.wrap(FateZeroPipeline, "plan_capture", keep=True)
        logdir, videos = ecli.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    check_plain(f"stream {name}")
    with open(os.path.join(logdir, "phase_timings.json")) as f:
        timings = {k: v["seconds"] for k, v in json.load(f).items()}
    editing = cfg["editing_config"]
    steps = int(editing["num_inference_steps"])
    prompts = list(editing["editing_prompts"])
    pipe = (inverts or samples)[0][1][0]
    latents_shape = (1, FRAMES, RES // 8, RES // 8, 4)
    per_step = pipe.store_step_bytes(torch.empty(latents_shape, device="meta"))
    stores = {}
    for _, store in appends:
        stores.setdefault(id(store), store)
    held = [s.step_bytes for s in stores.values()]
    copy_s = [s.copy_seconds for s in stores.values()]
    pickles = [os.path.join(logdir, f) for f in os.listdir(logdir) if f.endswith(".pkl")]
    stream = k1_per_forward(pipe.unet, RES // 8, "stream")
    if inverts:  # the streaming inversion, then one streaming edit per prompt
        k1_expect = steps * stream * (1 + len(prompts))
    else:  # invert_fast without a capture, then the save loop and the swap edits
        if plans:
            raise AssertionError(f"stream {name}: the save/swap edit planned a capture it never reads")
        k1_expect = steps * k1_per_forward(pipe.unet, RES // 8, "plain") + len(prompts) * steps * stream
    names = set(artifact_names(logdir))
    want = {"input.gif", "grid.gif", "step_0.gif", "config.yml", "log.log", "phase_timings.json"}
    want |= {f"step_0_{i}_0.gif" for i in range(len(prompts))}
    if cfg.get("disk_store"):
        want |= {f"{i:03d}.pkl" for i in range(steps)} | {"cross_attention/attn.gif"}
    missing = sorted(want - names)
    finite = all(np.isfinite(v).all() and v.shape == (FRAMES, RES, RES, 3) for v in videos)
    result = dict(
        config=os.path.relpath(path, REPO), overrides=overrides, wall_s=wall, phase_seconds=timings,
        bytes_per_step_predicted=per_step, bytes_per_step_held=held, pickle_bytes=sum(map(os.path.getsize, pickles)),
        copy_s_per_step=copy_s, peak_gib=peak / 2**30, k1=launches["flash_forward"], k1_expected=k1_expect,
        k1_stream_per_forward=stream, launches=launches, artifacts=len(names), videos_finite=finite,
    )
    if inverts:
        # the fused path's replay edit on the streaming inversion's trajectory
        obj, args, kwargs, traj_host = inverts[0][1]
        latents, emb_src = args[0], args[1]
        logger = P2pSampleLogger(editing_prompts=prompts, logdir=os.path.join(work, "replay"),
                                 source_prompt=editing.get("source_prompt", ""), num_inference_steps=steps,
                                 p2p_config=editing.get("p2p_config", {}))
        edited = [c[1][3] for c in samples if c[1][2].get("controller") is not None]
        traj = torch.stack([t.to(obj.device) for t in traj_host])
        diffs = []
        for idx, prompt in enumerate(prompts):
            ctl = logger._controller_for(obj, idx, prompt)
            fused, _ = obj.edit_fast(traj, emb_src, obj.encode_prompt(prompt), ctl, steps)
            diffs.append(float((fused.float() - edited[idx].float()).abs().max()))
        result.update(stream_vs_replay_max_abs=diffs, latent_max_abs=float(edited[0].abs().max()))
        del traj, latents
        check_plain(f"stream {name} replay")  # that edit is no main path
    log(f"[stream] {name}: {json.dumps(result)}")
    if missing or not finite or len(videos) != len(prompts):
        raise AssertionError(f"stream {name}: missing {missing[:10]}, finite {finite}, {len(videos)} videos")
    if launches["flash_forward"] != k1_expect:
        raise AssertionError(f"stream {name}: K1 launched {launches['flash_forward']} times, the shapes give {k1_expect}")
    if any(b != per_step for steps_held in held for b in steps_held):
        raise AssertionError(f"stream {name}: {per_step} bytes a step predicted, held {held}")
    return result


def stream_phase(kernels, reset_counts, check_plain):
    """The streaming store at full width: the disk-store config as shipped,
    then config/teaser/jeep_watercolor.yaml's save/swap edit."""
    import shutil

    import torch

    work = os.path.join(REPO, "build", "stream_smoke")
    shutil.rmtree(work, ignore_errors=True)
    results = {}
    try:
        frames = write_frames(os.path.join(work, "frames"), FRAMES, (RES, RES), seed=7)
        results["disk_store"], _ = phase("stream disk_store", lambda: stream_full_width(
            "disk_store", DISK_STORE, work, frames, {"editing_config": {"num_inference_steps": DISK_STORE_STEPS}},
            kernels, reset_counts, check_plain))
        shutil.rmtree(os.path.join(work, "disk_store"), ignore_errors=True)
        torch.cuda.empty_cache()
        over = {"editing_config": {"use_inversion_attention": False, "num_inference_steps": SAVE_SWAP_STEPS}}
        results["save_swap"], _ = phase("stream save/swap", lambda: stream_full_width(
            "save_swap", CLI_TEASER, work, frames, over, kernels, reset_counts, check_plain))
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


# ------------------------------------------------------- sweep and evaluation
SWEEP_CONFIG = os.path.join(REPO, "config", "dataset_sweep.yaml")
BENCH_CONFIG = os.path.join(REPO, "config", "bench_clean_prompt.yaml")
SWEEP_VIDEOS = 1
# card against CPU, both fp32 (matmuls and the patch product in full fp32,
# the resize in fp32 on both): unit-norm 512-d features after 12 layers
# differ by ~2e-7 on an H100 (PERF.md), Tem-Con by ~1e-7
EVAL_FEATURE_TOL = 1e-5
EVAL_TEMCON_TOL = 1e-5
# Frame-Acc thresholds P(target) >= P(source), i.e. the logit gap (target
# minus source at the reference's scale of 100) >= 0. Card and CPU gaps
# differed by at most 1.9e-5 on an H100 (PERF.md); every gap is held within
# EVAL_GAP_BAND of the CPU's, so a frame farther than that from the tie
# cannot change its decision by rounding, and its decisions must agree
EVAL_GAP_BAND = 1e-3


def sweep_phase(kernels, reset_counts, check_plain):
    """config/dataset_sweep.yaml through cli.dataset_sweep.run at full SD-1.4
    width, as shipped (its p2p grid, its editing block: 3 DDIM steps, one
    replace edit) but for random:sd in bf16 and SWEEP_VIDEOS videos of FRAMES seeded
    RES^2 PNG frames at image_size RES (the frame loader's exact case), run
    from a work directory so that the runs' result/ folders land there.
    Each run is measured alone (the sweep's call of cli.edit.test is
    wrapped): wall, phase_timings.json, the capture plan, peak memory, K1's
    launches against the sites' count and the frame loader that ran. The
    result folders must be distinct and hold every artifact. Returns
    (work dir, [run dict]); the caller removes the work dir."""
    import copy
    import shutil

    import torch
    import yaml

    from fatezero_tpu_torch import native
    from fatezero_tpu_torch.cli import dataset_sweep
    from fatezero_tpu_torch.common.config import load_config
    from fatezero_tpu_torch.data.dataset import ImageSequenceDataset
    from fatezero_tpu_torch.models.unet3d import UNet3DConfig, UNetPseudo3DConditionModel
    from fatezero_tpu_torch.pipelines import fatezero_pipeline as FPM

    work = os.path.join(REPO, "build", "sweep_smoke")
    shutil.rmtree(work, ignore_errors=True)
    cfg = load_config(SWEEP_CONFIG).to_dict()
    cfg["pretrained_model_path"] = "random:sd"
    shipped = cfg["datasets"][0]
    cfg["datasets"] = []
    for v in range(SWEEP_VIDEOS):
        ds = copy.deepcopy(shipped)
        ds["dataset_config"].update(path=write_frames(os.path.join(work, f"video_{v}"), FRAMES, (RES, RES), seed=20 + v),
                                    n_sample_frame=FRAMES, sampling_rate=1, image_size=RES)
        cfg["datasets"].append(ds)
    config = os.path.join(work, "dataset_sweep.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    meta = UNetPseudo3DConditionModel(UNet3DConfig(), dtype=torch.bfloat16, device="meta")

    runs, test = [], dataset_sweep.test
    loads = {"native": 0, "pil": 0}
    load_batch, load_frames = native.load_batch, ImageSequenceDataset._load_frames

    def native_load(*args, **kwargs):
        loads["native"] += 1
        return load_batch(*args, **kwargs)

    def pil_load(self, indices):
        loads["pil"] += 1
        return load_frames(self, indices)

    def measured(**sub):
        loads.update(native=0, pil=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with Recorder() as rec:
            plans = rec.wrap(FPM.FateZeroPipeline, "plan_capture", keep=lambda o, a, kw, out: (kw["window"], out))
            out = test(**sub)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        logdir, videos = os.path.abspath(out[0]), out[1]  # the cwd is the work dir
        k1 = {fn.__name__: fn.launches for fn in kernels}["flash_forward"]
        check_plain(f"sweep {len(runs)}")
        with open(os.path.join(logdir, "phase_timings.json")) as f:
            timings = {k: v["seconds"] for k, v in json.load(f).items()}
        window, plan = plans[0][1]
        steps = int(sub["editing_config"]["num_inference_steps"])
        prompts = list(sub["editing_config"]["editing_prompts"])
        expect, _ = cli_k1_expected(meta, RES // 8, steps, len(prompts), plan, window)
        frames = [os.path.join(logdir, f"step_0_{i}_0") for i in range(len(prompts))]
        names = set(artifact_names(logdir))
        want = {"input.gif", "grid.gif", "config.yml", "log.log", "phase_timings.json"} | {
            f"step_0_{i}_0/{j:05d}.png" for i in range(len(prompts)) for j in range(FRAMES)}
        finite = all(np.isfinite(v).all() and v.shape == (FRAMES, RES, RES, 3) for v in videos)
        loader = "native" if loads["native"] and not loads["pil"] else ("pil" if loads["pil"] and not loads["native"] else loads)
        run = dict(logdir=os.path.relpath(logdir, work), video=sub["dataset_config"]["path"],
                   self_replace_steps=sub["editing_config"]["p2p_config"][0]["self_replace_steps"],
                   wall_s=wall, phase_seconds=timings, plan=plan, window=window,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, k1=k1, k1_expected=expect,
                   frame_loader=loader, artifacts=len(names), videos_finite=finite)
        log(f"[sweep] run {len(runs)}: {json.dumps(run)}")
        missing = sorted(want - names)
        if missing or not finite or len(videos) != len(prompts):
            raise AssertionError(f"sweep run {len(runs)}: missing {missing[:5]}, finite {finite}, {len(videos)} videos")
        if k1 != expect:
            raise AssertionError(f"sweep run {len(runs)}: K1 launched {k1} times, the sites' shapes give {expect}")
        if not isinstance(loader, str):
            raise AssertionError(f"sweep run {len(runs)}: both frame loaders ran {loader}")
        runs.append(dict(run, logdir=logdir, frames=frames, source=sub["dataset_config"]["prompt"], targets=prompts))
        return out

    cwd = os.getcwd()
    dataset_sweep.test, native.load_batch, ImageSequenceDataset._load_frames = measured, native_load, pil_load
    try:
        os.chdir(work)
        phase("sweep (dataset_sweep.run)", lambda: dataset_sweep.run(config))
    finally:
        os.chdir(cwd)
        dataset_sweep.test, native.load_batch, ImageSequenceDataset._load_frames = test, load_batch, load_frames
    logdirs = [r["logdir"] for r in runs]
    log(f"[sweep] {len(runs)} runs into {[os.path.relpath(d, work) for d in logdirs]}")
    if len(runs) != SWEEP_VIDEOS * len(cfg["p2p_grid"]) or len(set(logdirs)) != len(runs):
        raise AssertionError(f"the sweep ran {len(runs)} edits into {len(set(logdirs))} distinct folders")
    torch.cuda.empty_cache()
    return work, runs


def eval_phase(work, runs):
    """cli.evaluate.run over the sweep's result frame folders (an `items:`
    bench) with a seeded random ViT-B/32, on the card and on the CPU in this
    process: the same n, items and missing list; per item Tem-Con within
    EVAL_TEMCON_TOL and Frame-Acc equal where every frame clears
    EVAL_GAP_BAND; image and text features within EVAL_FEATURE_TOL, and every
    frame's Frame-Acc decision equal outside the band, with the stub tokens
    and with a BPE tokenizer of the prompts (with which some frames must
    clear it). Then the shipped config/bench_clean_prompt.yaml (the
    reference's schema) against a synthetic results tree keyed by two of its
    names, on the card: n, missing and per_item as the JAX package's CPU
    test has them. Last, image_features' frames per second on the card."""
    import warnings

    import torch
    import yaml

    from fatezero_tpu_torch.cli import evaluate
    from fatezero_tpu_torch.common.image_util import load_image_folder
    from fatezero_tpu_torch.eval.clip_metrics import CLIPEvaluator, load_evaluator
    from fatezero_tpu_torch.models.tokenizer import CLIPTokenizer
    from fatezero_tpu_torch.scripts import card

    items = [{"folder": os.path.relpath(folder, work), "source_prompt": r["source"], "target_prompt": target}
             for r in runs for folder, target in zip(r["frames"], r["targets"])]
    bench = os.path.join(work, "eval_items.yaml")
    with open(bench, "w") as f:
        yaml.safe_dump({"clip_checkpoint": None, "results_root": work, "items": items}, f)
    outs = {}
    for dev in ("cuda", "cpu"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs[dev], dt = phase(f"evaluate.run ({dev})", lambda: evaluate.run(bench, device=dev))
        if not any("RANDOM weights" in str(w.message) for w in caught):
            raise AssertionError("load_evaluator did not warn about its random weights")
        log(f"[eval] evaluate.run on {dev}: {dt:.3f} s, frame_acc {outs[dev]['frame_acc']} tem_con "
            f"{outs[dev]['tem_con']} n {outs[dev]['n']} missing {outs[dev]['missing']} "
            f"random_weights {outs[dev]['random_weights']}")
    g, c = outs["cuda"], outs["cpu"]
    if not (g["n"] == c["n"] == len(items) and g["missing"] == c["missing"] == [] and g["random_weights"] is True
            and set(g["per_item"]) == set(c["per_item"]) == {it["folder"] for it in items}):
        raise AssertionError(f"evaluate.run card vs CPU: n {g['n']}/{c['n']}, missing {g['missing']}/{c['missing']}")

    # The features again, from evaluators with the same weights: with the
    # stub tokens evaluate.run used, and with a BPE tokenizer of the prompts'
    # words. The stub's ids follow Python's salted hash, and where the
    # highest id (the pooled token) is a word both prompts share at the same
    # place, the two text features are equal and every gap is 0, so only the
    # BPE tokens (the EOT id highest, as in CLIP) ensure that frames clear
    # the band.
    evs = {dev: load_evaluator(None, seed=0, device=dev) for dev in ("cuda", "cpu")}
    tokdir = os.path.join(work, "tokenizer")
    write_tokenizer(tokdir, " ".join(p for it in items for p in (it["source_prompt"], it["target_prompt"])))
    bpe = {d: CLIPEvaluator(ev.model, CLIPTokenizer.from_pretrained(tokdir, subfolder=""), random_weights=True)
           for d, ev in evs.items()}
    feat_err = txt_err = 0.0
    counts = {"stub": [0, 0], "bpe": [0, 0]}  # frames outside, inside the band
    for it in items:
        frames = np.stack(load_image_folder(os.path.join(work, it["folder"]))).astype(np.float32) / 255.0
        prompts = [it["source_prompt"], it["target_prompt"]]
        img = {d: ev.image_features(frames).float().cpu() for d, ev in evs.items()}
        feat_err = max(feat_err, (img["cuda"] - img["cpu"]).abs().max().item())
        pg, pc = g["per_item"][it["folder"]], c["per_item"][it["folder"]]
        line = []
        for tokens, pair in (("stub", evs), ("bpe", bpe)):
            txt = {d: ev.text_features(prompts).float().cpu() for d, ev in pair.items()}
            txt_err = max(txt_err, (txt["cuda"] - txt["cpu"]).abs().max().item())
            gap = {d: (100.0 * img[d] @ txt[d].t()).diff(dim=-1)[:, 0] for d in img}  # target - source
            clear = gap["cpu"].abs() > EVAL_GAP_BAND
            counts[tokens][0] += int(clear.sum())
            counts[tokens][1] += int((~clear).sum())
            if (gap["cuda"] - gap["cpu"]).abs().max().item() > EVAL_GAP_BAND:
                raise AssertionError(f"{it['folder']}: logit gaps differ card vs CPU by more than {EVAL_GAP_BAND}")
            if not torch.equal(gap["cuda"][clear] >= 0, gap["cpu"][clear] >= 0):
                raise AssertionError(f"{it['folder']}: a Frame-Acc decision differs card vs CPU outside the band")
            if tokens == "stub" and bool(clear.all()) and pg["frame_acc"] != pc["frame_acc"]:
                raise AssertionError(f"{it['folder']}: Frame-Acc card {pg['frame_acc']} vs CPU {pc['frame_acc']}")
            line.append(f"{tokens} gaps (CPU) {[round(x, 5) for x in gap['cpu'].tolist()]}, max |card - CPU| "
                        f"{(gap['cuda'] - gap['cpu']).abs().max().item():.3e}, {int(clear.sum())} of {len(clear)} clear")
        log(f"[eval] {it['folder']}: card frame_acc {pg['frame_acc']} tem_con {pg['tem_con']:.7f}; CPU frame_acc "
            f"{pc['frame_acc']} tem_con {pc['tem_con']:.7f}; band {EVAL_GAP_BAND}; " + "; ".join(line))
        if abs(pg["tem_con"] - pc["tem_con"]) > EVAL_TEMCON_TOL:
            raise AssertionError(f"{it['folder']}: Tem-Con card {pg['tem_con']} vs CPU {pc['tem_con']}")
    log(f"[eval] features card vs CPU: image max_abs_err {feat_err:.3e}, text {txt_err:.3e} (tol {EVAL_FEATURE_TOL}); "
        f"frames outside, inside the gap band: stub tokens {counts['stub']}, BPE tokens {counts['bpe']}")
    if not (feat_err <= EVAL_FEATURE_TOL and txt_err <= EVAL_FEATURE_TOL):
        raise AssertionError("CLIP features disagree card vs CPU")
    if counts["bpe"][0] == 0:
        raise AssertionError(f"no frame's logit gap clears the band {EVAL_GAP_BAND}: Frame-Acc was not compared")

    # the reference schema, as tests/test_eval_clip.py runs it through the JAX CLI
    tree = os.path.join(work, "bench_tree")
    for i, name in enumerate(("swan_cartoon", "car_watercolor")):
        write_frames(os.path.join(tree, name), 3, (48, 48), seed=30 + i)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = evaluate.run(BENCH_CONFIG, results_root=tree, device="cuda")
    names = [it["folder"] for it in evaluate.normalize_bench(evaluate.load_config(BENCH_CONFIG).to_dict())]
    want_missing = [n for n in names if n not in ("swan_cartoon", "car_watercolor")]
    log(f"[eval] bench_clean_prompt.yaml: n {out['n']}, per_item {sorted(out['per_item'])}, "
        f"{len(out['missing'])} missing of {len(names)}, frame_acc {out['frame_acc']} tem_con {out['tem_con']}")
    if not (out["n"] == 2 and set(out["per_item"]) == {"swan_cartoon", "car_watercolor"}
            and out["missing"] == want_missing and np.isfinite([out["frame_acc"], out["tem_con"]]).all()):
        raise AssertionError(f"bench_clean_prompt.yaml on the card: {out}")

    # image_features (preprocess + tower) on one sweep video, timed on the card
    frames = np.stack(load_image_folder(os.path.join(work, items[0]["folder"]))).astype(np.float32) / 255.0
    ev, reps = evs["cuda"], 10
    ev.image_features(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ev.image_features(frames)
    torch.cuda.synchronize()
    fps = reps * len(frames) / (time.perf_counter() - t0)
    log(f"[eval] image_features on the card: {fps:.1f} frames/s ({len(frames)} frames of {frames.shape[1]}x"
        f"{frames.shape[2]} a call, host decode excluded); {card()}")
    del evs
    torch.cuda.empty_cache()
    return dict(card=g, cpu=c, feature_err=feat_err, text_err=txt_err, band_counts=counts, fps=fps)


def native_phase():
    """The C++ frame loader on this machine. Where it builds: load_batch
    against the PIL path on seeded frames, bit-equal at native resolution,
    the gap printed when downscaling. Where it does not: why, printed, and
    native_loader=True must raise while the auto mode reads with PIL."""
    import shutil

    from fatezero_tpu_torch import native
    from fatezero_tpu_torch.data.dataset import ImageSequenceDataset

    work = os.path.join(REPO, "build", "native_smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        path = write_frames(os.path.join(work, "frames"), 4, (RES, RES), seed=40)
        kw = dict(path=path, n_sample_frame=4, sampling_rate=1)
        pil = ImageSequenceDataset(**kw, image_size=RES, native_loader=False)[0]["images"]
        try:
            lib = native.build()
            native.get_lib()
        except native.NativeLoaderUnavailable as e:
            lines = str(e).splitlines()
            why = next((ln for ln in lines if "error" in ln), lines[-1])
            log(f"[native] the C++ frame loader is unavailable on this machine: {why}")
            try:
                ImageSequenceDataset(**kw, image_size=RES, native_loader=True)[0]
            except native.NativeLoaderUnavailable:
                log("[native] native_loader=True raised NativeLoaderUnavailable, as it must")
            else:
                raise AssertionError("native_loader=True did not raise without the library")
            auto = ImageSequenceDataset(**kw, image_size=RES)[0]["images"]
            if not np.array_equal(auto, pil):
                raise AssertionError("the auto mode without the library does not read the PIL path's clip")
            log("[native] auto mode read the PIL path's clip")
            return dict(available=False, reason=str(e))
        paths = [os.path.join(path, f) for f in sorted(os.listdir(path))]
        exact = native.load_batch(paths, RES)
        down = ImageSequenceDataset(**kw, image_size=RES // 2, native_loader=True)[0]["images"]
        ref = ImageSequenceDataset(**kw, image_size=RES // 2, native_loader=False)[0]["images"]
        gap = np.abs(down - ref)
        log(f"[native] built {os.path.relpath(lib, REPO)}; at {RES}^2 bit-equal to PIL {np.array_equal(exact, pil)}; "
            f"downscaled to {RES // 2}^2 max |native - PIL| {gap.max():.4f}, mean {gap.mean():.5f}")
        if not np.array_equal(exact, pil):
            raise AssertionError("the native loader differs from PIL at native resolution")
        return dict(available=True, downscale_max=float(gap.max()), downscale_mean=float(gap.mean()))
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------- device mesh
MESH = (1, 2, 2)  # data, seq, tensor: 4 gloo ranks sharing the one card
MESH_STEPS = 2  # the mesh edit, the streaming store and the NCCL CLI pairs (the configs run 10 or 50)
# the clip of the NCCL world-of-one disk-store and tuning CLI pairs (the edit CLI's
# pair runs FRAMES): each holds a run under a process group to the run without one,
# bit for bit, and spends its seconds writing artifacts of every frame
MESH_CLI_FRAMES = 2
# rel_l2 of the (1,2,2) fp32 run against the world of one, stated before the
# first chip run: only the order of the sums over ranks differs (K1 and the
# GEMMs on local rows, the halo exact); on the CPU one fp32 ulp of input moves
# the tiny edit by ~1e-5 of its largest value and the mesh as much, and the
# full-width UNet runs 3 + 3 steps under CFG 7.5 and a x10 reweight
MESH_FP32_TOL = {"traj": 1e-4, "stored": 1e-3}
# the teaser's controller (refine, reweight "watercolor" x10, cross 0.8, self 0.8)
MESH_EDITS = {"stored": dict(is_replace_controller=False, cross_replace_steps=0.8, self_replace_steps=0.8,
                             eq_params={"words": ["watercolor"], "values": [10]}, mode="stored")}
# [mesh-train]: config/tune/jeep.yaml's model (lora 160, gradient checkpointing,
# the default sparse-causal [-1, 'first'] at every width) over the teaser's
# weights (the same tensors: the two configs differ in behaviour only), one
# AdamW update with the temporal convs trained
MESH_TRAIN = dict(model_config={"sparse_causal_indices": (-1, "first"), "least_sc_channel": 0}, lr=1e-3,
                  seed=TUNE_SEED, keep_state=False)
# fp32 (1,2,2) update against the world of one, stated before the first chip
# run: on the CPU (random:tiny) the update differs by 3.1e-4 rel_l2, the
# clipped gradients by 6.5e-6, the loss and the gradient norm by ~1e-7
# (AdamW's first step turns on the last bits of gradients near its eps); a
# gradient lost at a halo or a partial tensor sum moves the clipped gradients
# by O(1e-1) and the update with them
MESH_TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "grads": 1e-4, "update": 1e-2}
MESH_STREAM_TOL = {"traj": 1e-4, "edited": 1e-3}  # rel_l2, as the fused edit's MESH_FP32_TOL
STORE_BYTES_BF16 = 777_265_152  # the disk-store config's store a step, bf16, 8 x 512^2 (the sites' shapes)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def nccl_world_of_one(fn):
    """fn() with the environment torchrun gives a world of one, its process
    group torn down after; returns (fn's result, the group's backend)."""
    import torch.distributed as dist

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    os.environ.update(env)
    try:
        out = fn()
        return out, dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key in env:
            os.environ.pop(key)


def rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def dict_rel_l2(a: dict, b: dict) -> float:
    """rel_l2 of two dicts of tensors taken as one vector each."""
    num = sum(float((a[n].double() - v.double()).square().sum()) for n, v in b.items())
    den = sum(float(v.double().square().sum()) for v in b.values())
    return (num / den) ** 0.5


def mesh_edit_checks(sharded, single):
    """[mesh]: the fused edit on the mesh, fp32 against the world of one, bf16
    finite; K1 launches and payload per rank in each dtype."""
    import torch

    from fatezero_tpu_torch.models.loader import _unet_cfg_overrides
    from fatezero_tpu_torch.models.unet3d import UNet3DConfig, UNetPseudo3DConditionModel

    ref = single["float32"]
    for rank in sharded:
        got = rank["float32"]
        errs = {}
        for key, a, b in [("traj", got["traj"], ref["traj"])] + [
                (k, got["edited"][k], ref["edited"][k]) for k in ref["edited"]]:
            rel = rel_l2(a, b)
            errs[key] = dict(rel_l2=rel, max_abs=float((a - b).abs().max()), max=float(b.abs().max()),
                             tol=MESH_FP32_TOL[key])
            if not (torch.isfinite(a).all() and rel <= MESH_FP32_TOL[key]):
                raise AssertionError(f"mesh rank {got['rank']}: {key} rel_l2 {rel} > {MESH_FP32_TOL[key]}")
        log(f"[mesh] fp32 rank {got['rank']} {got['coords']} vs world of one: {json.dumps(errs)}; "
            f"peak {got['peak_bytes'] / 2**30:.2f} GiB, seconds {got['seconds']:.3f}")
    log(f"[mesh] fp32 world of one: seconds {ref['seconds']:.3f}, peak {ref['peak_bytes'] / 2**30:.2f} GiB, "
        f"K1 {json.dumps(ref['k1_launches'])}, payload {ref['payload_held']}")
    meta = UNetPseudo3DConditionModel(UNet3DConfig(**_unet_cfg_overrides(TEASER)), device="meta")
    expect = {"invert": MESH_STEPS * k1_per_forward(meta, RES // 8, "capture"),
              "stored": MESH_STEPS * k1_per_forward(meta, RES // 8, "edit")}
    for rank in sharded:
        for dtype, tag in (("float32", "fp32"), ("bfloat16", "bf16")):
            got = rank[dtype]
            log(f"[mesh] {tag} rank {got['rank']} {got['coords']}: K1 {json.dumps(got['k1_launches'])} "
                f"(unsharded count {json.dumps(expect)}), payload predicted {got['payload_predicted']} held "
                f"{got['payload_held']}, peak {got['peak_bytes'] / 2**30:.2f} GiB, seconds {got['seconds']:.3f} "
                f"(four ranks share the card)")
            if got["k1_launches"] != expect:
                raise AssertionError(f"mesh rank {got['rank']} {tag}: K1 {got['k1_launches']}, the sites give {expect}")
            if got["payload_predicted"] != got["payload_held"]:
                raise AssertionError(f"mesh rank {got['rank']} {tag}: payload predicted {got['payload_predicted']}, "
                                     f"held {got['payload_held']}")
        if not all(torch.isfinite(v).all() for v in rank["bfloat16"]["edited"].values()):
            raise AssertionError(f"mesh rank {rank['bfloat16']['rank']}: bf16 edit not finite")


def mesh_train_checks(sharded, single, start):
    """[mesh-train]: one fp32 update on the mesh against the world of one's
    (loss, gradient norm, clipped gradients, the update after - before), and
    per rank K1/K2/K3 of the fp32 and the bf16 update against the unsharded
    count from the sites' shapes; frozen tensors untouched."""
    import numpy as np
    import torch

    from fatezero_tpu_torch.models.loader import _unet_cfg_overrides
    from fatezero_tpu_torch.models.unet3d import UNet3DConfig, UNetPseudo3DConditionModel
    from fatezero_tpu_torch.ops.flash_attention import FLASH_MIN_QUERIES

    cfg = UNet3DConfig(**{**_unet_cfg_overrides(TEASER), **MESH_TRAIN["model_config"], "gradient_checkpointing": True})
    sites = count_sites(UNetPseudo3DConditionModel(cfg, device="meta"), FLASH_MIN_QUERIES, RES // 8)
    expect = {"K1": 2 * sites, "K2": sites, "K3": sites}  # the checkpointed forward runs twice
    ref = single["float32"]
    got0 = sharded[0]["float32"]
    delta = {n: v - start[n] for n, v in ref["trainable"].items()}
    errs = dict(
        loss=abs(got0["loss"] - ref["loss"]) / abs(ref["loss"]),
        grad_norm=abs(got0["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
        grads=dict_rel_l2(got0["grads"], ref["grads"]),
        update=dict_rel_l2({n: v - start[n] for n, v in got0["trainable"].items()}, delta),
    )
    log(f"[mesh-train] fp32 update (1,2,2) vs world of one: {json.dumps(errs)} (tol {json.dumps(MESH_TRAIN_TOL)}); "
        f"loss {got0['loss']:.6f} vs {ref['loss']:.6f}, gradient norm {got0['grad_norm']:.6f} vs "
        f"{ref['grad_norm']:.6f}; world of one: peak {ref['peak_bytes'] / 2**30:.2f} GiB, seconds "
        f"{ref['seconds']:.3f}, launches {json.dumps(ref['launches'])}")
    bad = {k: v for k, v in errs.items() if not v <= MESH_TRAIN_TOL[k]}
    if bad or ref["launches"] != expect:
        raise AssertionError(f"mesh-train: beyond tolerance {bad}, or the world of one launched "
                             f"{ref['launches']} against {expect}")
    for rank in sharded:
        for dtype, got in rank.items():
            log(f"[mesh-train] {dtype} rank {got['rank']} {got['coords']}: loss {got['loss']:.6f}, gradient norm "
                f"{got['grad_norm']:.6f}, K1/K2/K3 {json.dumps(got['launches'])} (unsharded count "
                f"{json.dumps(expect)}), frozen moved {len(got['frozen_moved'])}, peak "
                f"{got['peak_bytes'] / 2**30:.2f} GiB, seconds {got['seconds']:.3f} (four ranks share the card)")
            if got["launches"] != expect or got["frozen_moved"] or not np.isfinite([got["loss"], got["grad_norm"]]).all():
                raise AssertionError(f"mesh-train rank {got['rank']} {dtype}: launches {got['launches']} against "
                                     f"{expect}, frozen moved {got['frozen_moved'][:3]}, loss {got['loss']}")
            if dtype == "float32" and abs(got["loss"] - ref["loss"]) > MESH_TRAIN_TOL["loss"] * abs(ref["loss"]):
                raise AssertionError(f"mesh-train rank {got['rank']}: loss {got['loss']} against {ref['loss']}")
        if "trainable" in rank["bfloat16"]:
            moved = sum(not torch.equal(v, start[n].to(torch.bfloat16).float())
                        for n, v in rank["bfloat16"]["trainable"].items())
            if not moved:
                raise AssertionError("mesh-train: the bf16 update moved no trainable tensor")


def mesh_stream_checks(sharded, single, unet_cfg):
    """[mesh-stream]: the streaming inversion and edit on the mesh, fp32
    against the world of one; per rank the store's bytes a step predicted and
    held, their sum the world of one's, the bf16 store a step's prediction
    summing to STORE_BYTES_BF16, the disk store's pickles per rank, K1."""
    import torch

    from fatezero_tpu_torch.models.unet3d import UNetPseudo3DConditionModel
    from fatezero_tpu_torch.ops import schedule as S
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline

    ref = single["float32"]
    meta = UNetPseudo3DConditionModel(unet_cfg, device="meta")
    k1 = 2 * MESH_STEPS * k1_per_forward(meta, RES // 8, "stream")  # invert, then the edit
    lat = torch.empty(1, FRAMES, RES // 8, RES // 8, 4, device="meta")
    whole_bf16 = FateZeroPipeline(UNetPseudo3DConditionModel(unet_cfg, dtype=torch.bfloat16, device="meta"),
                                  None, None, None, S.make_schedule(device="cpu"), device="cpu",
                                  store_dtype=torch.bfloat16).store_step_bytes(lat)
    pickles = [n for rank in sharded for n in rank["float32"]["pickles"]]
    held_sum = sum(rank["float32"]["step_bytes"][0] for rank in sharded)
    log(f"[mesh-stream] world of one fp32: bytes a step {ref['step_bytes']} (predicted "
        f"{ref['step_bytes_predicted']}), seconds {ref['seconds']:.3f}, peak {ref['peak_bytes'] / 2**30:.2f} GiB, "
        f"K1 {ref['launches']['K1']}; the four ranks hold {held_sum} a step; bf16 store a step predicted "
        f"{whole_bf16} (expected {STORE_BYTES_BF16}); {len(pickles)} pickles, {len(set(pickles))} distinct")
    if held_sum != ref["step_bytes"][0] or whole_bf16 != STORE_BYTES_BF16 or len(set(pickles)) != len(pickles):
        raise AssertionError(f"mesh-stream: the ranks hold {held_sum} a step against the world of one's "
                             f"{ref['step_bytes']}, bf16 {whole_bf16}, pickles {pickles}")
    if len(pickles) != len(sharded) * MESH_STEPS or ref["launches"]["K1"] != k1:
        raise AssertionError(f"mesh-stream: {len(pickles)} pickles, world of one K1 {ref['launches']['K1']} vs {k1}")
    for rank in sharded:
        got = rank["float32"]
        errs = {key: rel_l2(got[key], ref[key]) for key in ("traj", "edited")}
        log(f"[mesh-stream] fp32 rank {got['rank']} {got['coords']} vs world of one: rel_l2 {json.dumps(errs)} "
            f"(tol {json.dumps(MESH_STREAM_TOL)}); bytes a step {got['step_bytes']} predicted "
            f"{got['step_bytes_predicted']}; K1 {got['launches']['K1']} (unsharded count {k1}); peak "
            f"{got['peak_bytes'] / 2**30:.2f} GiB, seconds {got['seconds']:.3f}")
        if any(not (torch.isfinite(got[k]).all() and errs[k] <= MESH_STREAM_TOL[k]) for k in errs):
            raise AssertionError(f"mesh-stream rank {got['rank']}: {errs} beyond {MESH_STREAM_TOL}")
        if got["step_bytes"] != [got["step_bytes_predicted"]] * MESH_STEPS or got["launches"]["K1"] != k1:
            raise AssertionError(f"mesh-stream rank {got['rank']}: bytes {got['step_bytes']} predicted "
                                 f"{got['step_bytes_predicted']}, K1 {got['launches']['K1']} vs {k1}")


def stream_fp32_witness(stream, edit):
    """The streaming edit against the fused stored edit, both the world of
    one's fp32 runs of the teaser model and controller at full width (the
    same weights, latents and embeddings; store dtype fp32). In bf16 the two
    part (the streaming path materialises every controlled site's bf16
    probabilities, the fused one keeps fp32 probabilities inside K1); in
    fp32 both keep fp32 probabilities, so the edits must agree within one
    bf16 unit of the largest value, as the edit modes' fp32 witness holds
    replay to stored."""
    import torch

    streamed, fused = stream["edited"], edit["edited"]["stored"]
    drift = rel_l2(stream["traj"][-1], edit["traj"][-1])
    err = float((streamed - fused).abs().max())
    tol = 2**-7 * float(fused.abs().max())
    finite = bool(torch.isfinite(streamed).all() and torch.isfinite(fused).all())
    log(f"[stream] fp32 witness ({MESH_STEPS} steps): streaming vs fused inversion rel_l2 at the noisiest latent "
        f"{drift:.3e}; streaming edit vs fused stored edit max_abs_err {err:.3e} of max "
        f"{float(fused.abs().max()):.3e} (tol {tol:.3e}), finite {finite}")
    if not (err <= tol and finite):
        raise AssertionError(f"fp32: the streaming edit disagrees with the fused stored edit ({err:.3e} > {tol:.3e})")


def mesh_memory(sharded, held, free, total):
    """Log the card's memory around the ranks: what this process kept and what
    was free before the spawn, and each job's largest reserve over the ranks
    (each rank's caching allocator reserves at least its peak allocation)."""
    gib = 2**-30
    jobs = {f"{job} {dtype}": max(r[job][dtype]["reserved_bytes"] for r in sharded)
            for job in sharded[0] for dtype in sharded[0][job]}
    log(f"[mesh] card memory: this process held {held * gib:.2f} GiB and {free * gib:.2f} of {total * gib:.2f} "
        f"GiB were free before the spawn; largest reserve of a rank per job (GiB) "
        f"{json.dumps({k: round(v * gib, 2) for k, v in jobs.items()})}, four ranks at most "
        f"{len(sharded) * max(jobs.values()) * gib:.2f} GiB")


def cli_pair(name, run_mesh, run_plain, compare):
    """A CLI run under NCCL as a world of one (mesh 1,1,1) against the same
    run without a mesh: `compare(mesh_out, plain_out)` -> (equal, detail)."""
    (out_mesh, backend), t_mesh = phase(f"mesh: {name}, NCCL world of one", lambda: nccl_world_of_one(run_mesh))
    out_plain, t_plain = phase(f"mesh: {name}, no mesh", run_plain)
    same, detail = compare(out_mesh, out_plain)
    log(f"[mesh] {name} world of one ({backend}) bit-equal to the run without a mesh: {same}; {detail}; "
        f"seconds {t_mesh:.3f} and {t_plain:.3f}")
    if backend != "nccl" or not same:
        raise AssertionError(f"the NCCL world-of-one {name} run differs from the run without a mesh")
    return t_mesh + t_plain


def edit_run(out):
    """An edit CLI run's (artifact names, videos) from its (logdir, videos)."""
    logdir, videos = out
    return artifact_names(logdir), videos


def same_edit_runs(a, b):
    (names_a, videos_a), (names_b, videos_b) = a, b
    same = len(videos_a) == len(videos_b) and all(np.array_equal(x, y) for x, y in zip(videos_a, videos_b))
    names = names_a == names_b
    return same and names, f"{len(videos_a)} videos equal {same}, artifact names equal {names}"


def same_train_runs(a, b):
    """Two tuning runs' folders: the same names, every checkpoint and
    validation file byte for byte (log.log, config.yml and phase_timings.json
    hold the folder and the seconds), the same masters."""
    import torch

    (out_a, state_a), (out_b, state_b) = a, b
    names = artifact_names(out_a)
    differ = [n for n in names if n not in ("log.log", "config.yml", "phase_timings.json") and
              open(os.path.join(out_a, n), "rb").read() != open(os.path.join(out_b, n), "rb").read()]
    masters = all(torch.equal(state_a["master"][n], m) for n, m in state_b["master"].items())
    same = names == artifact_names(out_b) and not differ and masters
    return same, f"{len(names)} files, differing {differ[:5]}, masters equal {masters}"


def mesh_phase():
    """The edit, one tuning update and the streaming store on a (1,2,2) device
    mesh at full width (fatezero_tpu_torch/scripts/dryrun_mesh.py): random:sd
    drawn once and saved for the ranks to read, FRAMES x RES^2. Four gloo
    ranks share the card (NCCL refuses two ranks on one device), spawned
    once for the three jobs: the teaser's stored edit at MESH_STEPS steps in
    fp32 and bf16 ([mesh]), one jeep-model update in fp32 and bf16
    ([mesh-train]), and the disk-store config's streaming inversion and edit
    in fp32, pickled per rank ([mesh-stream]); a world of one (in this
    process) runs the fp32 jobs, whose streaming and fused edits are also
    held to each other (the fp32 witness). tests/test_torch_sharding*.py
    hold every mode, optimizer and branch on a mesh. Then the edit CLI
    (FRAMES frames), its disk-store branch and the tuning CLI (MESH_CLI_FRAMES
    frames), each under NCCL as a world of one (mesh 1,1,1) against the same
    run without a mesh, bit for bit."""
    import shutil

    import torch

    from fatezero_tpu_torch.cli import edit as cli
    from fatezero_tpu_torch.cli import train as tcli
    from fatezero_tpu_torch.common.config import load_config
    from fatezero_tpu_torch.parallel.sharding import Mesh
    from fatezero_tpu_torch.scripts import dryrun_mesh as D

    work = os.path.join(REPO, "build", "mesh_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        path, t_prep = phase("mesh: draw and save random:sd, embeddings, controllers", lambda: D.prepare(
            os.path.join(work, "inputs.pt"), "random:sd", TEASER, FRAMES, RES, MESH_STEPS, seed=0, edits=MESH_EDITS))
        data = torch.load(path, weights_only=False, mmap=True)
        unet_cfg = data["unet_cfg"]
        fp32 = ("float32",)
        both = ("float32", "bfloat16")
        jobs = [("edit", D.edit_job, (path, both), {}),
                ("train", D.train_job, (path, both), dict(MESH_TRAIN, tensors="rank0")),
                ("stream", D.stream_job, (path, fp32), dict(disk_dir=os.path.join(work, "pickles"),
                                                          keep_average=False))]
        # the four ranks need the card to themselves: this process gives back
        # what its earlier paths cached
        gc.collect()
        torch.cuda.empty_cache()
        held, (free, total) = torch.cuda.memory_reserved(), torch.cuda.mem_get_info()
        sharded, t_mesh = phase(f"mesh: {MESH} gloo ranks on one card: edit, train, stream", lambda: D.launch(
            D.jobs, MESH, "cuda", "gloo", args=(jobs,), workdir=work))
        mesh_memory(sharded, held, free, total)
        shutil.rmtree(os.path.join(work, "pickles"), ignore_errors=True)
        jobs = [("edit", D.edit_job, (path, fp32), {}), ("train", D.train_job, (path, fp32), MESH_TRAIN),
                ("stream", D.stream_job, (path, fp32), dict(keep_average=False))]
        single, t_one = phase("mesh: world of one, fp32: edit, train, stream", lambda: D.jobs(
            Mesh((1, 1, 1), "cuda"), jobs))
        mesh_edit_checks([r["edit"] for r in sharded], single["edit"])
        start = {n: data["unet"][n].float() for n in single["train"]["float32"]["trainable"]}
        mesh_train_checks([r["train"] for r in sharded], single["train"], start)
        mesh_stream_checks([r["stream"] for r in sharded], single["stream"], unet_cfg)
        stream_fp32_witness(single["stream"]["float32"], single["edit"]["float32"])
        del data, sharded, single

        # the CLIs under NCCL as a world of one, against the same runs without a mesh
        clip = write_frames(os.path.join(work, "clip"), FRAMES, (RES, RES), seed=7)
        frames = write_frames(os.path.join(work, "frames"), MESH_CLI_FRAMES, (RES, RES), seed=7)
        cfg = load_config(CLI_TEASER).to_dict()
        cfg["dataset_config"]["path"] = clip
        cfg["editing_config"]["num_inference_steps"] = MESH_STEPS
        t_cli = cli_pair("edit CLI", lambda: edit_run(cli.run(dict(cfg, logdir=os.path.join(work, "cli_mesh")),
                                                              mesh="1,1,1")),
                         lambda: edit_run(cli.run(dict(cfg, logdir=os.path.join(work, "cli_plain")))), same_edit_runs)
        dcfg = load_config(DISK_STORE).to_dict()
        dcfg["dataset_config"].update(path=frames, n_sample_frame=MESH_CLI_FRAMES)
        dcfg["editing_config"]["num_inference_steps"] = MESH_STEPS
        t_disk = cli_pair("edit CLI disk_store", lambda: edit_run(cli.run(
            dict(dcfg, logdir=os.path.join(work, "disk_mesh")), mesh="1,1,1")),
                          lambda: edit_run(cli.run(dict(dcfg, logdir=os.path.join(work, "disk_plain")))), same_edit_runs)
        shutil.rmtree(os.path.join(work, "disk_mesh"), ignore_errors=True)
        shutil.rmtree(os.path.join(work, "disk_plain"), ignore_errors=True)
        tcfg = load_config(TUNE_JEEP).to_dict()
        tcfg["dataset_config"].update(path=frames, n_sample_frame=MESH_CLI_FRAMES)
        tcfg["dataset_config"].pop("class_data_root")  # the chunked path (the per-step one runs in [train-cli])
        tcfg.update(config=TUNE_JEEP, train_steps=MESH_STEPS, checkpointing_steps=MESH_STEPS,
                    validation_steps=MESH_STEPS)
        tcfg["editing_config"]["editing_prompts"] = tcfg["editing_config"]["editing_prompts"][:1]
        tcfg["validation_sample_logger_config"] = dict(tcfg.get("validation_sample_logger_config") or {},
                                                       num_inference_steps=MESH_STEPS)
        t_train = cli_pair("tuning CLI", lambda: tcli.run(dict(tcfg, logdir=os.path.join(work, "train_mesh")),
                                                          mesh="1,1,1"),
                           lambda: tcli.run(dict(tcfg, logdir=os.path.join(work, "train_plain"))), same_train_runs)
        log(f"[mesh] seconds: prepare {t_prep:.3f}, mesh ranks {t_mesh:.3f}, world of one {t_one:.3f}, "
            f"edit CLI pair {t_cli:.3f}, disk-store CLI pair {t_disk:.3f}, tuning CLI pair {t_train:.3f}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------- the port's bench
BENCH_RUNS = (  # (tag, the bench's knobs): its modes at full width, cut from 50 steps
    ("fused", {"BENCH_STEPS": "10", "BENCH_VIZ": "1"}),
    ("replay", {"BENCH_STEPS": "10", "BENCH_REPLAY": "1"}),
    ("stream", {"BENCH_STEPS": "3", "BENCH_MODE": "stream"}),
)
BENCH_MODULE_STEPS = 3  # the run of `python3 -m fatezero_tpu_torch.scripts.bench` as a process
BENCH_DETAIL = {"invert_s", "edit_s", "edit_viz_s", "flash_grad_err", "backend", "mode", "stored_payload",
                "stored_rows", "model_config", "device", "peak_bytes", "k1_launches", "k2_launches", "k3_launches"}


def bench_k1_expected(unet, latent, knobs):
    """K1 launches of a bench run from the sites' shapes: (the timed inversion
    and edit, which the bench counts itself; every launch of the run: the
    probe's one, the warm-up and timed passes, and with viz its two edits)."""
    steps = int(knobs["BENCH_STEPS"])
    viz = knobs.get("BENCH_VIZ", "1") == "1"
    if knobs.get("BENCH_MODE") == "stream":
        timed = 2 * steps * k1_per_forward(unet, latent, "stream")
        return timed, 1 + 2 * timed
    if knobs.get("BENCH_REPLAY") == "1":
        # the teaser's controller has no blend: edit_fast replays inline, one
        # 3-row forward a step (with viz the (latent/4)^2 cross sites materialise)
        invert = steps * k1_per_forward(unet, latent, "plain")
        edit, edit_viz = (steps * k1_per_forward(unet, latent, "inline, no blend", m)
                          for m in (None, (latent // 4) ** 2))
        return invert + edit, 1 + 2 * (invert + edit) + (2 * edit_viz if viz else 0)
    # a full capture (the smoke requires it), which reads no edit window
    plan = (0, steps)
    invert = cli_k1_expected(unet, latent, steps, 0, plan, steps)[0]
    edit = cli_k1_expected(unet, latent, steps, 1, plan, steps, viz=False)[0] - invert
    edit_viz = cli_k1_expected(unet, latent, steps, 1, plan, steps)[0] - invert
    return invert + edit, 1 + 2 * (invert + edit) + (2 * edit_viz if viz else 0)


def check_bench_result(tag, result, knobs, unet):
    """bench.py's keys plus the card's; finite times; the plan; K1 against the
    sites' shapes, K2 = K3 = 1 (the probe)."""
    d = result["detail"]
    steps = int(knobs["BENCH_STEPS"])
    stream = knobs.get("BENCH_MODE") == "stream"
    replay = knobs.get("BENCH_REPLAY") == "1"
    timed_k1, _ = bench_k1_expected(unet, RES // 8, knobs)
    want_rows = None if stream or replay else [0, steps]
    problems = []
    if set(result) != {"metric", "value", "unit", "vs_baseline", "detail"} or set(d) != BENCH_DETAIL:
        problems.append(f"keys {sorted(result)} / {sorted(d)}")
    if not all(np.isfinite([result["value"], result["vs_baseline"], d["invert_s"], d["edit_s"]])):
        problems.append("a time is not finite")
    if d["backend"] != "cuda" or d["mode"] != ("stream" if stream else "fused"):
        problems.append(f"backend {d['backend']} mode {d['mode']}")
    if d["stored_rows"] != want_rows or d["stored_payload"] is not (want_rows is not None):
        problems.append(f"stored_rows {d['stored_rows']} (want {want_rows}), stored_payload {d['stored_payload']}")
    if d["k1_launches"] != timed_k1 or d["k2_launches"] != 1 or d["k3_launches"] != 1:
        problems.append(f"K1 {d['k1_launches']} (the shapes give {timed_k1}), K2 {d['k2_launches']}, "
                        f"K3 {d['k3_launches']} (want 1 each)")
    if (d["edit_viz_s"] is None) is (not stream and knobs.get("BENCH_VIZ", "1") == "1"):
        problems.append(f"edit_viz_s {d['edit_viz_s']}")
    if problems:
        raise AssertionError(f"bench {tag}: " + "; ".join(problems))


def bench_phase(kernels, reset_counts, check_plain):
    """The port's headline bench (fatezero_tpu_torch/scripts/bench.py) at full
    width, FRAMES x RES^2, bf16, teaser model: `main` in this process in each
    of BENCH_RUNS, every launch count set to 0 before and read after each;
    then the module as a process of its own (its re-execution under
    PYTHONHASHSEED=0 and its one JSON line). Returns each kernel's launches
    over the in-process runs."""
    import subprocess

    import torch

    from fatezero_tpu_torch.models.loader import load_models
    from fatezero_tpu_torch.scripts import bench

    unet = load_models("random:sd", bench.TEASER, torch.bfloat16, device="meta").unet  # the sites' shapes
    totals = {fn.__name__: 0 for fn in kernels}
    for tag, knobs in BENCH_RUNS:
        reset_counts()
        result, _ = phase(f"bench {tag}", lambda: bench.main("cuda", "random:sd", env=knobs))
        launches = {fn.__name__: fn.launches for fn in kernels}
        log(f"[bench] {tag} {json.dumps(knobs)}: {json.dumps(result)}; launches {json.dumps(launches)}")
        check_plain(f"bench {tag}")
        check_bench_result(tag, result, knobs, unet)
        _, k1_all = bench_k1_expected(unet, RES // 8, knobs)
        if (launches["flash_forward"], launches["flash_dq"], launches["flash_dkv"]) != (k1_all, 1, 1):
            raise AssertionError(f"bench {tag}: K1/K2/K3 launched {launches}, the run gives {k1_all}/1/1")
        for name, n in launches.items():
            totals[name] += n
        gc.collect()
        torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONHASHSEED",) and not k.startswith("BENCH_")}
    knobs = {"BENCH_STEPS": str(BENCH_MODULE_STEPS)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "fatezero_tpu_torch.scripts.bench"], cwd=REPO,
                          env={**env, **knobs}, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"python3 -m fatezero_tpu_torch.scripts.bench exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    result = json.loads(lines[-1])
    log(f"[bench] module {json.dumps(knobs)}, {wall:.1f} s as a process: {json.dumps(result)}")
    check_bench_result("module", result, knobs, unet)
    return totals


def run_eval_paths(kernels, reset_counts, check_plain):
    """The sweep, the evaluation of its folders and the frame loader (c4-c6)."""
    import shutil

    work = None
    try:
        work, runs = sweep_phase(kernels, reset_counts, check_plain)
        phase("eval (card vs CPU)", lambda: eval_phase(work, runs))
    finally:
        shutil.rmtree(work or os.path.join(REPO, "build", "sweep_smoke"), ignore_errors=True)
    phase("native frame loader", native_phase)


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

    # Random weights are set-up, not a path: the paths below build random:sd
    # a dozen times, each time ~15 s of numpy draws on the host. The draws
    # depend only on the parameters' names and shapes and the seed, and
    # load_state copies them, so one host copy per (model, seed) serves every
    # load; the CLIs' load_models seconds then hold no draws.
    from fatezero_tpu_torch.models import loader as L

    draws, random_state = {}, L.random_state

    def cached_random_state(module, seed, names=None):
        key = (tuple((k, tuple(v.shape)) for k, v in sorted(module.state_dict().items())), seed,
               None if names is None else tuple(sorted(names)))
        if key not in draws:
            draws[key] = random_state(module, seed, names)
        return draws[key]

    L.random_state = cached_random_state

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
    phase("reference (tiny CLI run, card vs CPU)", tiny_cli_reference)
    phase("reference (tiny tuning CLI, card vs CPU)", tiny_train_cli_reference)
    phase("reference (tiny streaming edit, card vs CPU)", tiny_streaming_reference)

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

    # ---- main path b3: the edit CLI on the shipped teaser and blend configs
    cli_phase(kernels, reset_counts, check_plain)

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

    # ---- main paths c2 and c3: the tuning CLI, with the edit CLI on its
    # checkpoint; the streaming store through the edit CLI
    train_cli_phase(kernels, reset_counts, check_plain)
    stream_phase(kernels, reset_counts, check_plain)

    # ---- main paths c4-c6: the dataset x p2p-grid sweep, the CLIP evaluation
    # of its result folders card vs CPU, the C++ frame loader
    run_eval_paths(kernels, reset_counts, check_plain)

    # ---- main path c7: the port's headline bench, before the mesh: its
    # tensors and cache are given back before the ranks are spawned
    bench_launches, _ = phase("bench (fatezero_tpu_torch.scripts.bench)", lambda: bench_phase(
        kernels, reset_counts, check_plain))

    # ---- main path c8: the edit on a device mesh (ranks spawned on the card)
    mesh_phase()

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
                 "fatezero_tpu/ops/flash_attention.py:93",
                 edit_launches["flash_forward"] + bench_launches["flash_forward"]),
        k2.entry("K2 flash_attention backward dQ", "fatezero_tpu_torch/csrc/flash_bwd.cu",
                 "fatezero_tpu/ops/flash_attention.py:185", tune_launches["flash_dq"] + bench_launches["flash_dq"]),
        k3.entry("K3 flash_attention backward dK/dV", "fatezero_tpu_torch/csrc/flash_bwd.cu",
                 "fatezero_tpu/ops/flash_attention.py:220", tune_launches["flash_dkv"] + bench_launches["flash_dkv"]),
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
