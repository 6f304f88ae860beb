"""Headline benchmark: car-turn 8-frame 512^2, 50-step DDIM inversion + edit.

    python3 -m fatezero_tpu_torch.scripts.bench [--device cpu] [--model random:tiny]

Counterpart of the root bench.py. It times the teaser workload (the full
SD-1.4 UNet, randomly initialised: weights change neither the operations nor
the memory traffic; the teaser's model_config and prompt-to-prompt refine
edit with CFG) on the card and prints ONE JSON line. Reference baseline
(BASELINE.md): 60 s inversion + 40 s editing on an RTX 3090, 100 s end to
end; vs_baseline = 100 s / ours, scaled for reduced runs.

Modes, as in bench.py:

* ``fused`` (default): a warm-up and a timed ``invert_fast`` that captures
  the payload rows ``plan_capture`` fits under FZ_PAYLOAD_BUDGET_GB (every
  row, a hybrid's prefix, or none: replay), then a warm-up and a timed
  ``edit_fast`` from that payload; with BENCH_VIZ=1 also the viz edit
  (``edit_viz_s``). BENCH_REPLAY=1 times the replay edit (for the teaser's
  controller, which has no blend, ``edit_fast`` replays inline: one 3-row
  forward a step, as in the JAX package). A capture or a
  stored edit that runs out of device memory (``torch.cuda.OutOfMemoryError``,
  nothing else) falls back to replay, reported as ``stored_payload: false``.
* ``stream``: the reference-shaped streaming store, ``invert(store=...)`` and
  ``sample(inv_store=...)``, each warmed up with a fresh store first.

Every invocation first runs the flash-gradient probe: FlashAttention's
forward and backward (K1, K2, K3 on the card) against an explicit fp32
softmax under autograd, raising above 5e-2.

Environment knobs (bench.py's, with its defaults): BENCH_STEPS (50),
BENCH_FRAMES (8), BENCH_RES (512), BENCH_MODE (fused|stream),
BENCH_SAVE_SELF (1), BENCH_FULL_SC (0: the teaser model_config; 1: the
default one), BENCH_VIZ (1), BENCH_REPLAY (0), FZ_PAYLOAD_BUDGET_GB (8).

The stub tokenizer maps words with Python's salted ``hash``, so run as a
module this script re-executes itself once under PYTHONHASHSEED=0 when the
variable is unset: the token ids, and so the random-weight workload, are the
same in every process. Text encoding and the VAE are outside the timed work.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Mapping, Optional

import numpy as np
import torch

BASELINE_S = 100.0  # 60 s inversion + 40 s edit, docs/EditingGuidance.md:74
SOURCE = "a silver jeep driving down a curvy road in the countryside"
TARGET = "watercolor painting of a silver jeep driving down a curvy road in the countryside"
# the reference's published 60 s / 40 s are for the teaser workload, whose
# model_config is ['mid'] sparse-causal + least_sc_channel 640 with temporal
# LoRA rank 160 (config/teaser/jeep_watercolor.yaml:79-82)
TEASER = {"lora": 160, "SparseCausalAttention_index": ["mid"], "least_sc_channel": 640}
PROBE_SHAPE = (4, 256, 64)  # rows, tokens, head dim
PROBE_SCALE = 0.125
PROBE_TOL = 5e-2


@dataclasses.dataclass(frozen=True)
class Settings:
    """bench.py's environment knobs."""

    steps: int = 50
    frames: int = 8
    res: int = 512
    mode: str = "fused"
    save_self: bool = True
    full_sc: bool = False
    viz: bool = True
    replay: bool = False
    budget_gb: float = 8.0

    @classmethod
    def from_env(cls, env: Mapping[str, str]) -> "Settings":
        s = cls(
            steps=int(env.get("BENCH_STEPS", 50)),
            frames=int(env.get("BENCH_FRAMES", 8)),
            res=int(env.get("BENCH_RES", 512)),
            mode=env.get("BENCH_MODE", "fused"),
            save_self=bool(int(env.get("BENCH_SAVE_SELF", 1))),
            full_sc=bool(int(env.get("BENCH_FULL_SC", 0))),
            viz=bool(int(env.get("BENCH_VIZ", 1))),
            replay=bool(int(env.get("BENCH_REPLAY", 0))),
            budget_gb=float(env.get("FZ_PAYLOAD_BUDGET_GB", 8)),
        )
        if s.mode not in ("fused", "stream"):
            raise ValueError(f"BENCH_MODE must be fused or stream, got {s.mode!r}")
        return s


def _launches() -> tuple:
    """The (K1, K2, K3) wrappers' launch counts."""
    from fatezero_tpu_torch.ops import flash_attention as FA

    return FA.flash_forward.launches, FA.flash_dq.launches, FA.flash_dkv.launches


def flash_grad_probe(device) -> tuple:
    """FlashAttention's gradients against an explicit fp32 softmax's, every run.

    The always-on check of the kernels' backward on the card: a regression
    fails the bench instead of hiding behind the tests. Returns (the largest
    gradient difference, the (K1, K2, K3) launches it made); raises
    AssertionError at PROBE_TOL or above, and on the card unless each kernel
    launched once."""
    from fatezero_tpu_torch.ops.flash_attention import FlashAttention

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(PROBE_SHAPE, generator=gen).to(device) for _ in range(3))
    before = _launches()
    with torch.enable_grad():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        g_flash = torch.autograd.grad(FlashAttention.apply(*leaves, PROBE_SCALE).sum(), leaves)
        launches = tuple(a - b for a, b in zip(_launches(), before))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        p = torch.softmax(leaves[0] @ leaves[1].transpose(1, 2) * PROBE_SCALE, dim=-1)
        g_ref = torch.autograd.grad((p @ leaves[2]).sum(), leaves)
    err = max(float((a - b).abs().max()) for a, b in zip(g_flash, g_ref))
    if not err < PROBE_TOL:
        raise AssertionError(f"flash-attention backward deviates from reference grad: {err}")
    if torch.device(device).type == "cuda" and launches != (1, 1, 1):
        raise AssertionError(f"the probe launched K1, K2, K3 {launches} times, not once each")
    return err, launches


def setup(cfg: Settings, device, model: str = "random:sd") -> SimpleNamespace:
    """The pipeline (bf16 on the card, fp32 on the CPU; no VAE), the two
    prompts' embeddings, bench.py's latents and the teaser controller's maker."""
    from fatezero_tpu_torch.models.loader import load_models
    from fatezero_tpu_torch.models.tokenizer import StubTokenizer
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
    from fatezero_tpu_torch.ptp.controller import make_controller

    device = torch.device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    m = load_models(model, {} if cfg.full_sc else TEASER, dtype=dtype, seed=0, device=device)
    tokenizer = StubTokenizer()
    pipe = FateZeroPipeline(m.unet, None, m.text_encoder, tokenizer, m.schedule, store_dtype=dtype, device=device)
    lat = cfg.res // 8
    latents = torch.from_numpy(
        np.random.RandomState(0).randn(1, cfg.frames, lat, lat, 4).astype(np.float32)).to(device)

    def controller():
        # the teaser's prompt-1 block: refine + reweight 'watercolor' x10
        # (config/teaser/jeep_watercolor.yaml:60-68)
        return make_controller(
            tokenizer, [SOURCE, TARGET], num_steps=cfg.steps, is_replace_controller=False,
            cross_replace_steps=0.8, self_replace_steps=0.8,
            eq_params={"words": ["watercolor"], "values": [10]}, save_self_attention=cfg.save_self,
        )

    return SimpleNamespace(pipe=pipe, latents=latents, emb_src=pipe.encode_prompt(SOURCE),
                           emb_tgt=pipe.encode_prompt(TARGET), controller=controller)


class _Clock:
    """Timed windows that each end in a device synchronisation; the peak device
    memory and the K1 launches over the windows."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.peak = 0
        self.k1 = 0

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def time(self, fn, count_k1: bool = True):
        self.sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        k1 = _launches()[0]
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        dt = time.perf_counter() - t0
        if count_k1:
            self.k1 += _launches()[0] - k1
        if self.cuda:
            self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        return out, dt


def _oom_note(what: str, err: BaseException) -> None:
    print(f"[bench] {what} hit device OOM; falling back to replay. Cause: {str(err).splitlines()[0][:200]}",
          file=sys.stderr, flush=True)


def _fused(cfg: Settings, b: SimpleNamespace, clock: _Clock) -> dict:
    pipe, latents, emb_src, emb_tgt = b.pipe, b.latents, b.emb_src, b.emb_tgt
    steps = cfg.steps
    replay, rows = cfg.replay, None
    if not replay:
        rows = pipe.plan_capture(latents, steps, window=b.controller().edit_window(steps),
                                 budget_bytes=cfg.budget_gb * 1e9)
        replay = rows is None
        print(f"[bench] capture plan: rows={rows}", file=sys.stderr, flush=True)

    def invert():
        if replay:
            return pipe.invert_fast(latents, emb_src, steps), None
        return pipe.invert_fast(latents, emb_src, steps, capture=True, capture_rows=rows)

    # each warm-up's output is dropped at once: two live copies of the ~GB
    # stored capture would not fit
    oom = False
    try:
        invert()  # warm-up
        clock.sync()
    except torch.cuda.OutOfMemoryError as e:
        if replay:
            raise
        oom = True
        _oom_note(f"invert-capture rows={rows}", e)
    if oom:
        # the failed capture's tensors may sit in reference cycles of the
        # exception's frames: collect them, or the replay finds memory pinned
        _release(clock)
        replay = True
        invert()
    _release(clock)
    (traj, stored), t_invert = clock.time(invert)

    def edit(viz=False):
        return pipe.edit_fast(traj, emb_src, emb_tgt, b.controller(), steps, stored=stored, viz=viz,
                              stored_row0=rows[0] if (rows and stored is not None) else 0)

    oom = False
    try:
        edit()  # warm-up
        clock.sync()
    except torch.cuda.OutOfMemoryError as e:
        if stored is None:
            raise
        oom = True
        _oom_note("stored-payload edit", e)
    if oom:
        stored = None  # drop the payload; the edit replays
        _release(clock)
        edit()
    (out, _), t_edit = clock.time(edit)
    t_viz = None
    if cfg.viz:
        # the product default (save_cross_attention: true in P2pSampleLogger):
        # the mid-resolution cross maps materialise and their average is kept
        edit(viz=True)
        _, t_viz = clock.time(lambda: edit(viz=True), count_k1=False)
    stored_payload = not replay and stored is not None
    return dict(out=out, invert_s=t_invert, edit_s=t_edit, edit_viz_s=t_viz, stored_payload=stored_payload,
                stored_rows=list(rows) if stored_payload and rows else None)


def _stream(cfg: Settings, b: SimpleNamespace, clock: _Clock) -> dict:
    from fatezero_tpu_torch.ptp.store import AttentionStore

    pipe, steps = b.pipe, cfg.steps

    def invert(store):
        return pipe.invert(b.latents, b.emb_src, steps, store=store, save_self_attention=cfg.save_self)

    invert(AttentionStore())  # warm-up, on a store of its own
    _release(clock)  # the warm-up's host store (GBs at full size) before the timed one
    store = AttentionStore()
    traj, t_invert = clock.time(lambda: invert(store))

    def edit():
        return pipe.sample(traj[-1], b.emb_tgt, num_inference_steps=steps, guidance_scale=7.5,
                           controller=b.controller(), inv_store=store, inverted_latents=traj[1:])

    edit()  # warm-up
    out, t_edit = clock.time(edit)
    return dict(out=out, invert_s=t_invert, edit_s=t_edit, edit_viz_s=None, stored_payload=False, stored_rows=None)


def _release(clock: _Clock) -> None:
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()


def run(cfg: Settings, device="cuda", model: str = "random:sd") -> tuple:
    """The probe, then the mode's timed inversion and edit: (the JSON line's
    object, the edited latents [1, f, h, w, 4])."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the bench runs on a CUDA card (pass device='cpu' for the plain versions)")
        from fatezero_tpu_torch import csrc

        csrc.build_all(("flash_fwd.cu", "flash_bwd.cu"))
    flash_grad_err, (_, k2, k3) = flash_grad_probe(device)
    b = setup(cfg, device, model)
    print(f"[bench] target token ids: {b.pipe.tokenizer.tokenize_ids(TARGET)}", file=sys.stderr, flush=True)
    clock = _Clock(device)
    with torch.inference_mode():
        r = (_fused if cfg.mode == "fused" else _stream)(cfg, b, clock)
    out = r.pop("out")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("the edited latents are not finite: a time for a NaN edit is no result")
    total = r["invert_s"] + r["edit_s"]
    scale = (50 / cfg.steps) * (8 / cfg.frames) * (512 / cfg.res) ** 2  # normalise a reduced run
    detail = {
        "invert_s": round(r["invert_s"], 2),
        "edit_s": round(r["edit_s"], 2),
        "edit_viz_s": None if r["edit_viz_s"] is None else round(r["edit_viz_s"], 2),
        "flash_grad_err": round(flash_grad_err, 6),
        "backend": device.type,
        "mode": cfg.mode,
        "stored_payload": r["stored_payload"],
        "stored_rows": r["stored_rows"],
        "model_config": "default (full-SC stress)" if cfg.full_sc
        else "teaser-exact (lora160, ['mid'], least_sc_channel=640, eq x10)",
    }
    if device.type == "cuda":
        from fatezero_tpu_torch.scripts import card

        detail.update(device=card(), peak_bytes=clock.peak, k1_launches=clock.k1, k2_launches=k2, k3_launches=k3)
    result = {
        "metric": f"car-turn {cfg.frames}f {cfg.res}^2 {cfg.steps}-step inversion+edit wall-clock",
        "value": round(total, 2),
        "unit": "s",
        "vs_baseline": round(BASELINE_S / (total * scale), 3),
        "detail": detail,
    }
    return result, out


def main(device="cuda", model: str = "random:sd", env: Optional[Mapping[str, str]] = None) -> dict:
    """Run the bench with the knobs of `env` (the process environment by
    default) on `device`, the card unless the caller asks for the CPU;
    `model` is a load_models path ('random:sd', or 'random:tiny' for a small
    run). Returns the JSON line's object."""
    cfg = Settings.from_env(os.environ if env is None else env)
    return run(cfg, device, model)[0]


def _cli() -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--model", default="random:sd", help="random:sd (default) or random:tiny")
    args = parser.parse_args()
    if os.environ.get("PYTHONHASHSEED") is None:
        # the stub tokenizer's ids follow Python's hash seed: fix it, once
        env = {**os.environ, "PYTHONHASHSEED": "0"}
        os.execve(sys.executable, [sys.executable, "-m", __spec__.name, *sys.argv[1:]], env)
    print(json.dumps(main(args.device, args.model)), flush=True)


if __name__ == "__main__":
    _cli()
