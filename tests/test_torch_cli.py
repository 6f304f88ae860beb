"""The port's edit CLI (fatezero_tpu_torch.cli.edit) against the JAX package's.

Parity: the JAX package writes its random:tiny weights as a flax-native
checkpoint (save_pipeline_checkpoint) into a tmp folder; config/demo_tiny.yaml,
cut to 2 frames of 64x64 synthetic PNGs and 2 DDIM steps, runs from that
checkpoint through fatezero_tpu.cli.edit.test once (a module fixture) and
through the port's test(device="cpu"). Held: the decoded videos within atol
2e-3 (the CLI tolerance of tests/test_cli.py), the same artifact names (gifs,
mp4s, frame folders, the atten gifs, the blend-mask PNGs, config.yml,
log.log, phase_timings.json), and the mask PNGs equal. A mask thresholds a
normalised map, so two runs could flip a pixel lying within rounding of the
threshold: every map the port's masks threshold is recorded and must keep
clear of its threshold by more than BAND, so no pixel can flip.

Also: every shipped config parses to the JAX package's dict and wires its
controllers through the port; the streaming branches under `sharding:` as
a world of one equal their runs without a mesh; the edit CLI's
out-of-memory fallback; a config whose
pipeline target names the JAX package builds the port's class with jax never
imported (`python -m fatezero_tpu_torch.cli.edit --config`, in a
subprocess); the generation-mode guard; the payload budget gate (replay at
FZ_PAYLOAD_BUDGET_GB=0, a hybrid at a budget of one row).
"""
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from fatezero_tpu.common.config import load_config as jload_config
from fatezero_tpu_torch.cli import edit as cli
from fatezero_tpu_torch.common.config import instantiate_from_config, load_config, save_config
from fatezero_tpu_torch.models.loader import _unet_cfg_overrides
from fatezero_tpu_torch.models.tokenizer import StubTokenizer
from fatezero_tpu_torch.models.unet3d import UNet3DConfig
from fatezero_tpu_torch.pipelines import fatezero_pipeline as FPM
from fatezero_tpu_torch.ptp.controller import make_controller
from fatezero_tpu_torch.ptp.spatial_blend import blend_map

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, "config")
DEMO = os.path.join(CONFIG_DIR, "demo_tiny.yaml")
WORKLOADS = sorted(
    p for p in glob.glob(os.path.join(CONFIG_DIR, "**", "*.yaml"), recursive=True)
    if os.path.relpath(p, CONFIG_DIR).count(os.sep)
)
ATOL = 2e-3
BAND = 1e-3
FRAMES, STEPS = 2, 2


def _rel(p):
    return os.path.relpath(p, CONFIG_DIR)


def _frames(path):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(FRAMES):
        Image.fromarray(rng.integers(0, 256, (80, 96, 3), dtype=np.uint8)).save(os.path.join(path, f"{i:05d}.png"))
    return str(path)


def _demo(frames, **top):
    """config/demo_tiny.yaml cut to FRAMES frames of 64x64 and STEPS steps."""
    d = load_config(DEMO).to_dict()
    d["dataset_config"].update(path=frames, n_sample_frame=FRAMES, sampling_rate=1, image_size=64)
    d["editing_config"].update(num_inference_steps=STEPS, clip_length=FRAMES)
    d.update(config="demo_tiny.yaml", **top)
    return d


def _names(root):
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    from fatezero_tpu.cli.edit import test as jtest
    from fatezero_tpu.common.checkpoint import save_pipeline_checkpoint
    from fatezero_tpu.models.loader import load_models as jload_models

    root = tmp_path_factory.mktemp("cli")
    frames = _frames(root / "frames")
    demo = load_config(DEMO).to_dict()
    b = jload_models("random:tiny", demo["model_config"], seed=0)
    ckpt = save_pipeline_checkpoint(str(root / "ckpt"), b.unet.cfg, b.unet_params, b.vae.cfg, b.vae_params,
                                    b.text_encoder.cfg, b.text_params)
    jlog, jvideos = jtest(**_demo(frames, pretrained_model_path=ckpt, logdir=str(root / "jax")))
    maps = []  # (normalised map, threshold) of every mask the port computes

    def recorded(m, alpha, target_hw, th, use_pool=True):
        norm = blend_map(m, alpha, target_hw, use_pool)
        maps.append((norm, th))
        return (norm > th).float()

    original, FPM.blend_mask = FPM.blend_mask, recorded
    try:
        tlog, tvideos = cli.test(**_demo(frames, pretrained_model_path=ckpt, logdir=str(root / "torch"),
                                         device="cpu"))
    finally:
        FPM.blend_mask = original
    return dict(root=root, frames=frames, ckpt=ckpt, jlog=jlog, jvideos=jvideos, tlog=tlog, tvideos=tvideos,
                maps=maps)


def test_videos_match_jax(parity):
    assert len(parity["tvideos"]) == len(parity["jvideos"]) == 2
    for t, j in zip(parity["tvideos"], parity["jvideos"]):
        assert t.shape == (FRAMES, 64, 64, 3) and np.isfinite(t).all()
        np.testing.assert_allclose(t, np.asarray(j), atol=ATOL)


def test_artifact_names_match_jax(parity):
    names = _names(parity["tlog"])
    assert names == _names(parity["jlog"])
    for name in ("input.gif", "grid.gif", "step_0.gif", "step_0atten.gif", "step_0_0_0.gif", "step_0_1_0.gif",
                 "step_0_0_0atten.gif", "step_0_1_0atten.gif", "config.yml", "log.log", "phase_timings.json",
                 "step_0_0_0/00001.png"):
        assert name in names, name
    with open(os.path.join(parity["tlog"], "phase_timings.json")) as f:
        assert set(json.load(f)) == {"load_models", "vae_encode", "inversion", "editing"}


def test_masks_match_jax(parity):
    """One PNG per (step, frame) under each blend's folder of prompt 1, equal
    to JAX's; the maps behind them clear of their thresholds."""
    assert parity["maps"]
    for norm, th in parity["maps"]:
        margin = (norm - th).abs().min().item()
        assert margin > BAND, f"a mask pixel lies {margin:.2e} from its threshold {th}"
    for sub in ("latent_blend_mask", "attention_blend_mask"):
        tdir = os.path.join(parity["tlog"], "prompt_1", sub)
        pngs = sorted(os.listdir(tdir))
        assert len(pngs) == STEPS * FRAMES, pngs
        for f in pngs:
            a = np.asarray(Image.open(os.path.join(tdir, f)))
            b = np.asarray(Image.open(os.path.join(parity["jlog"], "prompt_1", sub, f)))
            assert a.ndim == 2 and set(np.unique(a)) <= {0, 255}
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("budget,plan", [("0", None), ("row", (1, 1))], ids=["replay", "hybrid"])
def test_payload_budget_gate(parity, tmp_path, monkeypatch, budget, plan):
    """Below one step's payload the CLI replays (and logs it); at one row's
    budget it captures one row (a hybrid). Both edits stay within ATOL of the
    full capture's."""
    calls = []
    plan_capture = FPM.FateZeroPipeline.plan_capture

    def planned(self, latents, *args, **kwargs):
        calls.append(plan_capture(self, latents, *args, **kwargs))
        return calls[-1]

    if budget == "row":
        lat = torch.empty(1, FRAMES, 8, 8, 4)
        m = cli.load_models(parity["ckpt"], {}, device="meta")
        pipe = FPM.FateZeroPipeline(m.unet, m.vae, m.text_encoder, m.tokenizer, m.schedule, device="cpu")
        budget = str(1.5 * pipe.capture_payload_bytes(lat, 1) / 1e9)
    monkeypatch.setenv("FZ_PAYLOAD_BUDGET_GB", budget)
    monkeypatch.setattr(FPM.FateZeroPipeline, "plan_capture", planned)
    logdir, videos = cli.run(_demo(parity["frames"], pretrained_model_path=parity["ckpt"],
                                   logdir=str(tmp_path / "run"), device="cpu"))
    assert calls == [plan]
    with open(os.path.join(logdir, "log.log")) as f:
        text = f.read()
    assert ("replay rematerialization" in text) == (plan is None)
    assert ("trimmed attention capture to inversion rows [1, 2)" in text) == (plan is not None)
    for t, ref in zip(videos, parity["tvideos"]):
        np.testing.assert_allclose(t, ref, atol=ATOL)


def test_generation_mode_guard():
    with pytest.raises(ValueError, match="use_inversion_attention"):
        cli.test(config="x.yaml", editing_config={"use_invertion_latents": False, "use_inversion_attention": True},
                 device="cpu")


@pytest.mark.parametrize(
    "over",
    [
        {"disk_store": True},
        {"editing_config": {"save_attention_maps": True}},
        {"editing_config": {"use_inversion_attention": False}},
        {"editing_config": {"use_invertion_latents": False, "use_inversion_attention": False}},
    ],
    ids=["sharding", "save_attention_maps", "save_swap", "generation"],
)
def test_unported_paths_raise(parity, tmp_path, over):
    """Each streaming branch runs under `sharding: {mesh: auto}` in one
    process, a world of one, and writes what the run without a mesh writes:
    the same artifact names and the same videos, bit for bit. A mesh of more
    devices than processes raises without a process group."""
    runs = []
    for name, sharding in (("plain", None), ("mesh", {"mesh": "auto"})):
        d = _demo(parity["frames"], pretrained_model_path=parity["ckpt"], logdir=str(tmp_path / name))
        d["editing_config"].update(over.get("editing_config", {}))
        d.update({k: v for k, v in over.items() if k != "editing_config"}, sharding=sharding)
        runs.append(cli.test(**d, device="cpu"))
    (plain, pvideos), (mesh, mvideos) = runs
    assert _names(mesh) == _names(plain) and len(mvideos) == len(pvideos) > 0
    for a, b in zip(mvideos, pvideos):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="needs a process group"):
        cli.run(DEMO, mesh="1,4,2", device="cpu")


def test_oom_fallback_replays(parity, tmp_path, monkeypatch):
    """The capturing inversion runs out of device memory once (raised here on
    the CPU): the run drops the payload, inverts again without capture and
    edits by replay. It writes the artifacts of an ordinary run, and its edit
    is a `stored_attention: false` run's."""
    original = FPM.FateZeroPipeline.invert_fast
    raised = []

    def invert_fast(self, *args, capture=False, **kwargs):
        if capture and not raised:
            raised.append(True)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (raised by the test)")
        return original(self, *args, capture=capture, **kwargs)

    monkeypatch.setattr(FPM.FateZeroPipeline, "invert_fast", invert_fast)
    log, videos = cli.test(**_demo(parity["frames"], pretrained_model_path=parity["ckpt"],
                                   logdir=str(tmp_path / "oom"), device="cpu"))
    monkeypatch.setattr(FPM.FateZeroPipeline, "invert_fast", original)
    replay = _demo(parity["frames"], pretrained_model_path=parity["ckpt"], logdir=str(tmp_path / "replay"),
                   device="cpu")
    replay["editing_config"]["stored_attention"] = False
    _, replay_videos = cli.test(**replay)
    assert raised == [True]
    with open(os.path.join(log, "log.log")) as f:
        assert "falling back to replay rematerialization" in f.read()
    assert _names(log) == _names(parity["tlog"])
    assert len(videos) == len(replay_videos) > 0
    for a, b in zip(videos, replay_videos):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", WORKLOADS, ids=_rel)
def test_shipped_config_parses_and_wires(path):
    """As tests/test_shipped_configs.py, through the port: the config parses to
    the JAX package's dict, and each editing prompt's controller builds."""
    cfg = load_config(path).to_dict()
    assert cfg == jload_config(path).to_dict()
    editing = cfg.get("editing_config", {}) or {}
    ds = cfg.get("dataset_config", {})
    clip_len = editing.get("clip_length")
    if clip_len is not None:
        assert isinstance(clip_len, int), f"unresolved interpolation: {clip_len!r}"
    source = editing.get("source_prompt", ds.get("prompt", ""))
    steps = int(editing.get("num_inference_steps", 50))
    p2p = editing.get("p2p_config", {}) or {}
    for idx, prompt in enumerate(editing.get("editing_prompts", [])):
        block = dict(p2p.get(idx, p2p.get(str(idx), {})) or {})
        cross = block.get("cross_replace_steps", 0.8)
        if isinstance(cross, dict) and set(cross) == {"default_"}:
            cross = cross["default_"]
        ctrl = make_controller(
            StubTokenizer(),
            [source, str(prompt)],
            num_steps=steps,
            is_replace_controller=block.get("is_replace_controller", True),
            cross_replace_steps=cross,
            self_replace_steps=block.get("self_replace_steps", 0.0),
            blend_words=block.get("blend_words"),
            eq_params=block.get("eq_params"),
            blend_th=block.get("blend_th", (0.3, 0.3)),
            blend_latents=block.get("blend_latents", False),
            blend_self_attention=block.get("blend_self_attention", False),
            use_inversion_attention=block.get("use_inversion_attention", True),
        )
        assert ctrl.alpha_time_words.shape[0] == steps + 1
    UNet3DConfig(**_unet_cfg_overrides(cfg.get("model_config", {}) or {}))


def test_pipeline_target_maps_to_the_port(parity, tmp_path):
    """`python -m fatezero_tpu_torch.cli.edit --config` with the shipped
    target `fatezero_tpu.pipelines.fatezero_pipeline.FateZeroPipeline`: the
    port's class is built and jax is never imported (imports of jax fail)."""
    d = _demo(parity["frames"], pretrained_model_path="random:tiny", logdir=str(tmp_path / "run"))
    d["test_pipeline_config"] = {"target": "fatezero_tpu.pipelines.fatezero_pipeline.FateZeroPipeline"}
    d["editing_config"]["num_inference_steps"] = 1
    path = str(tmp_path / "cfg.yaml")
    save_config(d, path)
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
        "import runpy\n"
        "import fatezero_tpu_torch.cli.edit as E\n"
        "built = []\n"
        "orig = E.instantiate_from_config\n"
        "def rec(cfg, **kw):\n"
        "    p = orig(cfg, **kw); built.append(type(p)); return p\n"
        "E.instantiate_from_config = rec\n"
        f"sys.argv = ['edit', '--config', {path!r}, '--device', 'cpu']\n"
        "E.main()\n"
        "from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline\n"
        "assert built == [FateZeroPipeline], built\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'fatezero_tpu.')) for k in sys.modules if sys.modules[k] is not None)\n"
        "print('ok')\n"
    )
    # one thread, as in this process: the tier-1 run's workers share the host
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
    assert os.path.exists(os.path.join(tmp_path, "run", "grid.gif"))


def test_unknown_port_target_raises():
    with pytest.raises(ImportError, match="fatezero_tpu_torch.pipelines.fatezero_pipeline.NoSuchPipeline"):
        instantiate_from_config({"target": "fatezero_tpu.pipelines.fatezero_pipeline.NoSuchPipeline"})
    # a target outside the JAX package imports as written
    assert instantiate_from_config({"target": "collections.OrderedDict", "params": {"a": 1}}) == {"a": 1}
