"""The port's program spans and counters (common/profiling.py) on the CPU.

A tiny stored edit, an inline replay edit and one checkpointed tuning
update, with and without a torch profiler: what the recorder holds, that
every span closes, that each root's total is its own self time plus its
descendants', that the spans reach the profiler's events, and that the
materialised-site counter equals the count from the sites' shapes. The
recorder's arithmetic under many threads, and a span open on one thread
while another opens its own, with collection forced on.
"""
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from fatezero_tpu_torch.cli import edit as cli
from fatezero_tpu_torch.common import profiling as P
from fatezero_tpu_torch.common.config import load_config
from fatezero_tpu_torch.models.loader import load_models
from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
from fatezero_tpu_torch.ptp.context import MAX_CONTROLLED_TOKENS
from fatezero_tpu_torch.ptp.controller import make_controller
from fatezero_tpu_torch.trainer.ddpm_trainer import DDPMTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, RES, STEPS = 2, 128, 2
SOURCE = "a silver jeep driving"
TARGET = "watercolor painting of a silver jeep driving"
UNET = ("fz.unet.forward", "fz.unet.resnet", "fz.unet.group_norm", "fz.unet.attention",
        "fz.unet.temporal_attention", "fz.unet.feed_forward")
PIPELINE = ("fz.pipeline.encode_prompt", "fz.pipeline.encode_video", "fz.pipeline.invert_fast",
            "fz.pipeline.edit_fast", "fz.pipeline.decode_latents")
TRAINER = ("fz.trainer.step", "fz.trainer.forward", "fz.trainer.backward", "fz.trainer.optimizer")


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    return load_models("random:tiny", {"gradient_checkpointing": True}, seed=0, device="cpu")


@pytest.fixture(scope="module")
def pipe(models):
    return FateZeroPipeline(models.unet, models.vae, models.text_encoder, models.tokenizer,
                            schedule=models.schedule, store_dtype=torch.float32, device="cpu")


def _controller(tokenizer):
    # the teaser's refine + reweight block
    return make_controller(tokenizer, [SOURCE, TARGET], num_steps=STEPS, is_replace_controller=False,
                           cross_replace_steps=0.8, self_replace_steps=0.8,
                           eq_params={"words": ["watercolor"], "values": [10]})


def _frames():
    return torch.rand(F, RES, RES, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1


def _edit_calls(pipe, stored: bool):
    """The unit of an edit as root calls: [(root span, call)], each call
    taking the previous calls' results from `out`."""
    out = {}
    ctl = _controller(pipe.tokenizer)
    calls = [
        ("fz.pipeline.encode_prompt", lambda: out.update(src=pipe.encode_prompt(SOURCE))),
        ("fz.pipeline.encode_prompt", lambda: out.update(tgt=pipe.encode_prompt(TARGET))),
        ("fz.pipeline.encode_video", lambda: out.update(lat=pipe.encode_video(_frames()))),
    ]
    if stored:
        calls += [
            ("fz.pipeline.plan_capture", lambda: out.update(rows=pipe.plan_capture(
                out["lat"], STEPS, window=ctl.edit_window(STEPS), budget_bytes=1e12))),
            ("fz.pipeline.invert_fast", lambda: out.update(zip(("traj", "stored"), pipe.invert_fast(
                out["lat"], out["src"], STEPS, capture=True, capture_rows=out["rows"])))),
        ]
    else:
        calls += [("fz.pipeline.invert_fast", lambda: out.update(
            traj=pipe.invert_fast(out["lat"], out["src"], STEPS), stored=None))]
    calls += [
        ("fz.pipeline.edit_fast", lambda: out.update(latent=pipe.edit_fast(
            out["traj"], out["src"], out["tgt"], ctl, STEPS, stored=out["stored"])[0])),
        ("fz.pipeline.decode_latents", lambda: pipe.decode_latents(out["latent"])),
    ]
    return calls


def _update_calls(models):
    trainer = DDPMTrainer(models.unet, models.vae, schedule=models.schedule, learning_rate=1e-5,
                          train_temporal_conv=True)
    state = trainer.init_state()
    emb = torch.randn(1, 77, models.unet.cfg.cross_attention_dim, generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    return [("fz.trainer.step", lambda: trainer.step(state, _frames(), emb, gen))]


def _unit(kind, models, pipe):
    return _update_calls(models) if kind == "update" else _edit_calls(pipe, kind == "stored")


def _profiled_roots(calls):
    """Each root call under the profiler, the recorder reset before it:
    [(root, recorded)], and the names of the profiler's events."""
    out = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for root, call in calls:
            P.reset()
            call()
            out.append((root, P.recorded()))
    return out, {e.name for e in prof.events()}


def _merged(roots):
    spans, counters = {}, {}
    for _, rec in roots:
        for name, s in rec["spans"].items():
            m = spans.setdefault(name, {"calls": 0, "total_s": 0.0, "self_s": 0.0})
            for k in m:
                m[k] += s[k]
        for name, n in rec["counters"].items():
            counters[name] = counters.get(name, 0) + n
    return spans, counters


def _cross_sites(pipe, lat, emb):
    """Controlled cross-attention sites of one UNet forward, from their query counts."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.append(args[0].shape[2]))
             for name, m in pipe.unet.named_modules() if name.endswith("attn2")]
    try:
        with torch.inference_mode():
            pipe.unet(lat, 1, emb[-1:])
    finally:
        for h in hooks:
            h.remove()
    return sum(1 for s in seen if s <= MAX_CONTROLLED_TOKENS)


@pytest.fixture(scope="module")
def traced(models, pipe):
    """Each unit's per-root records and profiler event names, traced once."""
    return {kind: _profiled_roots(_unit(kind, models, pipe)) for kind in ("stored", "replay", "update")}


def test_nothing_collects_without_a_profiler(pipe):
    P.reset()
    assert P.span("fz.a") is P.span("fz.b")  # one shared no-op object
    for _, call in _edit_calls(pipe, stored=True):
        call()
    P.count("ptp.materialised")
    assert P.recorded() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("kind, names", [
    ("stored", PIPELINE + ("fz.pipeline.plan_capture", "fz.ptp.step", "fz.ptp.site") + UNET),
    ("replay", PIPELINE + ("fz.ptp.step", "fz.ptp.site") + UNET),
    ("update", TRAINER + UNET),
])
def test_a_traced_unit_records_its_spans(traced, kind, names):
    roots, events = traced[kind]
    spans, _ = _merged(roots)
    assert set(names) <= set(spans), sorted(set(names) - set(spans))
    assert all(name.startswith("fz.") for name in spans)
    assert set(names) <= events  # the same names as annotations in the profiler's trace
    assert ("fz.pipeline.plan_capture" in spans) == (kind == "stored")


@pytest.mark.parametrize("kind", ["stored", "replay", "update"])
def test_each_root_is_its_self_time_and_its_descendants(traced, kind):
    roots, _ = traced[kind]
    for root, rec in roots:
        spans = rec["spans"]
        assert spans[root]["calls"] == 1, (root, spans[root])
        total = spans[root]["total_s"]
        covered = sum(s["self_s"] for s in spans.values())
        assert total > 0 and abs(covered - total) <= 0.02 * total, (root, total, covered)
        assert all(0 <= s["self_s"] <= s["total_s"] + 1e-9 for s in spans.values())


def test_materialised_sites_follow_the_sites_shapes(traced, pipe):
    lat = pipe.encode_video(_frames())
    cross = _cross_sites(pipe, lat, pipe.encode_prompt(SOURCE))
    assert cross > 0
    _, stored = _merged(traced["stored"][0])
    # the capture keeps every controlled cross site's probabilities: the planner's
    # meta forward and each capturing inversion forward; the stored edit fuses in value space
    assert stored["ptp.materialised"] == cross * (STEPS + 1)
    _, replay = _merged(traced["replay"][0])
    assert replay.get("ptp.materialised", 0) == 0  # the inline edit stays in value space


def test_the_checkpointed_backward_recomputes_inside_the_update(traced):
    roots, _ = traced["update"]
    (_, rec), = roots
    spans = rec["spans"]
    # every resnet runs twice: the forward, and its block's recomputation in the backward
    forward_only = spans["fz.unet.forward"]["calls"]
    assert forward_only == 1
    assert spans["fz.unet.resnet"]["calls"] % 2 == 0 and spans["fz.unet.resnet"]["calls"] >= 2
    step = spans["fz.trainer.step"]["total_s"]
    parts = sum(spans[n]["total_s"] for n in TRAINER[1:])
    assert parts <= step and spans["fz.trainer.backward"]["self_s"] < spans["fz.trainer.backward"]["total_s"]
    assert all(0 <= s["self_s"] <= s["total_s"] for s in spans.values())  # every span closed


def test_phases_and_the_trace_file(tmp_path):
    """The edit CLI's `profile: true`: its profile holds its phases from the
    video's encoding to the last edit, and spans.json the program's spans."""
    rng = np.random.default_rng(0)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(F):
        Image.fromarray(rng.integers(0, 256, (80, 96, 3), dtype=np.uint8)).save(frames / f"{i:05d}.png")
    d = load_config(os.path.join(REPO, "config", "demo_tiny.yaml")).to_dict()
    d["dataset_config"].update(path=str(frames), n_sample_frame=F, sampling_rate=1, image_size=64)
    d["editing_config"].update(num_inference_steps=STEPS, clip_length=F)
    P.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with P.span("fz.before"):  # the CLI's profile resets the recorder
            pass
    logdir, _ = cli.test(**d, config="demo_tiny.yaml", logdir=str(tmp_path / "run"), profile=True, device="cpu")
    rec = json.loads(open(os.path.join(logdir, "trace", "spans.json")).read())
    phases = ("fz.cli.vae_encode", "fz.cli.inversion", "fz.cli.editing")
    assert set(phases + PIPELINE + ("fz.pipeline.plan_capture", "fz.ptp.step", "fz.ptp.site") + UNET) <= set(
        rec["spans"]), sorted(rec["spans"])
    assert "fz.before" not in rec["spans"] and rec["counters"]["ptp.materialised"] > 0
    assert all(rec["spans"][p]["calls"] == 1 for p in phases)
    assert all(0 <= s["self_s"] <= s["total_s"] for s in rec["spans"].values())
    assert all(p in open(os.path.join(logdir, "trace", "trace.json")).read() for p in phases)
    timings = json.loads(open(os.path.join(logdir, "phase_timings.json")).read())
    assert {"load_models", "vae_encode", "inversion", "editing"} <= set(timings)


def test_a_thread_keeps_its_own_stack(monkeypatch):
    """A span open on one thread is no parent of the spans another thread
    opens meanwhile (the autograd engine's recomputation on the card)."""
    monkeypatch.setattr(P, "_collecting", lambda: True)
    P.reset()
    started, done = threading.Event(), threading.Event()

    def other():
        started.wait(10)
        for _ in range(50):
            with P.span("fz.test.other"):
                sum(range(2000))
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with P.span("fz.test.outer"):
        started.set()
        assert done.wait(30)
    t.join(10)
    assert not t.is_alive()
    spans = P.recorded()["spans"]
    assert spans["fz.test.other"]["calls"] == 50
    outer = spans["fz.test.outer"]
    assert outer["calls"] == 1
    assert outer["self_s"] == pytest.approx(outer["total_s"])  # the other thread's spans are not its children
    P.reset()


def test_the_recorder_loses_no_update_across_threads(monkeypatch):
    monkeypatch.setattr(P, "_collecting", lambda: True)
    P.reset()
    threads_n, spans_n = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(spans_n):
                with P.span("fz.test.stress"):
                    P.count("test.stress")

        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    rec = P.recorded()
    assert rec["spans"]["fz.test.stress"]["calls"] == threads_n * spans_n
    assert rec["counters"]["test.stress"] == threads_n * spans_n
    stress = rec["spans"]["fz.test.stress"]
    assert 0 < stress["self_s"] == pytest.approx(stress["total_s"])
    P.reset()
