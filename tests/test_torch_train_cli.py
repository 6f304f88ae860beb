"""The port's tuning CLI (fatezero_tpu_torch.cli.train) against the JAX package's, at tiny width.

Setup: the JAX package writes its random:tiny weights as a flax-native
checkpoint; config/tune_demo_tiny.yaml is cut to 2 synthetic 80x96 frames
(64x64 random crops), 2 steps, validation and a checkpoint at step 2 and
2-step validation sampling. Both packages' `train` run from that checkpoint
on the CPU, in fp32.

* Learning rate 0 (the weights cannot move, so the two runs' different
  randoms do not matter): the validation videos within 2e-3 (the CLI
  tolerance of tests/test_cli.py), and the same artifact and checkpoint file
  names, but for the optimizer state's file (the JAX package writes
  training_state.safetensors of optax leaves, the port training_state.pt)
  and the port's phase_timings.json.
* Learning rate 1e-4: the JAX package's `load_models` reads the port's
  checkpoint_2, and its UNet forward equals the port's tuned UNet forward
  within 1e-5 x max|eps| (fp32, sums in other orders); the frozen weights
  are bit-identical to the checkpoint the run started from; the port's edit
  CLI runs from that checkpoint.
* The per-step path with class images (prior preservation), chunk
  boundaries for validation and checkpoint periods 2 and 3, and
  `resume_from`.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from fatezero_tpu_torch.cli import train as cli
from fatezero_tpu_torch.common.config import load_config
from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
from fatezero_tpu_torch.trainer.ddpm_trainer import DDPMTrainer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUNE = os.path.join(REPO, "config", "tune_demo_tiny.yaml")
DEMO = os.path.join(REPO, "config", "demo_tiny.yaml")
FRAMES = 2
ATOL = 2e-3


def _frames(path, n=FRAMES, hw=(80, 96), seed=0):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(os.path.join(path, f"{i:05d}.png"))
    return str(path)


def _tune(frames, ckpt, logdir, **top):
    d = load_config(TUNE).to_dict()
    d["dataset_config"].update(path=frames, n_sample_frame=FRAMES, sampling_rate=1)
    d.update(pretrained_model_path=ckpt, logdir=logdir, train_steps=2, validation_steps=2, checkpointing_steps=2,
             validation_sample_logger_config={"num_inference_steps": 2}, config="tune_demo_tiny.yaml")
    d.update(top)
    return d


def _names(root):
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)


class _Decoded:
    """Records every video a pipeline class decodes."""

    def __init__(self, cls, monkeypatch):
        self.videos = []
        original = cls.decode_latents

        def decode(pipe, latents, *args, **kwargs):
            video = original(pipe, latents, *args, **kwargs)
            self.videos.append(np.asarray(video))
            return video

        monkeypatch.setattr(cls, "decode_latents", decode)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from fatezero_tpu.common.checkpoint import save_pipeline_checkpoint
    from fatezero_tpu.models.loader import load_models as jload_models

    root = tmp_path_factory.mktemp("train")
    frames = _frames(root / "frames")
    b = jload_models("random:tiny", {}, seed=0)
    ckpt = save_pipeline_checkpoint(str(root / "ckpt"), b.unet.cfg, b.unet_params, b.vae.cfg, b.vae_params,
                                    b.text_encoder.cfg, b.text_params)
    # learning rate 0 in both packages, decoded videos recorded
    from fatezero_tpu.cli.train import train as jtrain
    from fatezero_tpu.pipelines.fatezero_pipeline import FateZeroPipeline as JPipeline

    mp = pytest.MonkeyPatch()
    try:
        jdec, tdec = _Decoded(JPipeline, mp), _Decoded(FateZeroPipeline, mp)
        jlog, _ = jtrain(**_tune(frames, ckpt, str(root / "jax0"), learning_rate=0.0))
        tlog, tstate = cli.train(**_tune(frames, ckpt, str(root / "torch0"), learning_rate=0.0), device="cpu")
    finally:
        mp.undo()
    # learning rate 1e-4, the port only
    tlog1, state1 = cli.train(**_tune(frames, ckpt, str(root / "torch1"), learning_rate=1e-4), device="cpu")
    return dict(root=root, frames=frames, ckpt=ckpt, jlog=jlog, tlog=tlog, jvideos=jdec.videos,
                tvideos=tdec.videos, tlog1=tlog1, state1=state1)


def test_validation_videos_match_jax(setup):
    assert len(setup["tvideos"]) == len(setup["jvideos"]) == 1  # one prompt, one seed
    for t, j in zip(setup["tvideos"], setup["jvideos"]):
        assert t.shape == (FRAMES, 64, 64, 3) and np.isfinite(t).all()
        np.testing.assert_allclose(t, j, atol=ATOL)


def test_artifact_and_checkpoint_names_match_jax(setup):
    jnames = set(_names(setup["jlog"]))
    tnames = set(_names(setup["tlog"]))
    assert jnames - tnames == {"checkpoint_2/training_state.safetensors"}
    assert tnames - jnames == {"checkpoint_2/training_state.pt", "phase_timings.json"}
    for name in ("log.log", "config.yml", "checkpoint_2/unet/flax_model.safetensors",
                 "checkpoint_2/unet/config.json", "checkpoint_2/vae/flax_model.safetensors",
                 "checkpoint_2/text_encoder/flax_model.safetensors", "checkpoint_2/scheduler/scheduler_config.json"):
        assert name in tnames, name
    assert "validation_2/step_2.gif" in tnames
    cfg = load_config(os.path.join(setup["tlog"], "config.yml")).to_dict()
    assert cfg["train_steps"] == 2 and np.isfinite(cfg["final_loss"])


def test_jax_loads_the_tuned_checkpoint(setup):
    import jax.numpy as jnp

    from fatezero_tpu.models.loader import load_models as jload_models
    from fatezero_tpu_torch.models.loader import load_models

    ck = os.path.join(setup["tlog1"], "checkpoint_2")
    jb = jload_models(ck, {}, seed=0)
    tuned = load_models(ck, {}, device="cpu")
    start = load_models(setup["ckpt"], {}, device="cpu")
    state = setup["state1"]
    moved = 0
    for name, p in tuned.unet.named_parameters():
        ref = dict(start.unet.named_parameters())[name]
        if name in state["master"]:
            torch.testing.assert_close(p, state["master"][name], atol=0, rtol=0)
            moved += not torch.equal(p, ref)
        else:
            assert torch.equal(p, ref), name
    assert moved > 0
    rng = np.random.RandomState(0)
    lat = rng.randn(1, FRAMES, 8, 8, 4).astype(np.float32)
    emb = rng.randn(1, 77, 32).astype(np.float32)
    jeps = np.asarray(jb.unet.apply(jb.unet_params, jnp.asarray(lat), jnp.int32(500), jnp.asarray(emb)))
    with torch.inference_mode():
        teps = tuned.unet(torch.from_numpy(lat), 500, torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(teps, jeps, atol=1e-5 * np.abs(jeps).max(), rtol=0)


def test_edit_cli_runs_on_the_tuned_checkpoint(setup, tmp_path):
    from fatezero_tpu_torch.cli import edit

    d = load_config(DEMO).to_dict()
    d["dataset_config"].update(path=setup["frames"], n_sample_frame=FRAMES, sampling_rate=1, image_size=64)
    d["editing_config"].update(num_inference_steps=2, clip_length=FRAMES)
    # a tuned run's folder: the CLI runs once per checkpoint_* inside it
    outs = edit.run(d, pretrained_model_path=setup["tlog1"], logdir=str(tmp_path / "edit"), device="cpu",
                    model_config={})
    assert len(outs) == 1
    logdir, videos = outs[0]
    assert len(videos) == 2 and all(np.isfinite(v).all() and v.shape == (FRAMES, 64, 64, 3) for v in videos)
    assert os.path.exists(os.path.join(logdir, "grid.gif"))


def test_per_step_path_with_class_images(setup, tmp_path, monkeypatch):
    """class_data_root: each step takes the next dataset item and its class
    image (prior preservation on), not the chunked path."""
    calls = []
    step = DDPMTrainer.step

    def recorded(self, state, images, text_emb, gen, class_images=None, class_text_emb=None):
        calls.append((tuple(images.shape), None if class_images is None else tuple(class_images.shape),
                      class_text_emb is not None))
        return step(self, state, images, text_emb, gen, class_images, class_text_emb)

    monkeypatch.setattr(DDPMTrainer, "step", recorded)
    monkeypatch.setattr(DDPMTrainer, "run_steps", None)  # the chunked path must not run
    cls_dir = _frames(tmp_path / "class", n=3, hw=(72, 72), seed=1)
    d = _tune(setup["frames"], setup["ckpt"], str(tmp_path / "run"), learning_rate=1e-4, prior_preservation=1.0,
              validation_steps=0, checkpointing_steps=0)
    d["dataset_config"].update(class_data_root=cls_dir, class_data_prompt="a photo of a car")
    logdir, state = cli.train(**d, device="cpu")
    assert calls == [((FRAMES, 64, 64, 3), (1, 64, 64, 3), True)] * 2
    assert state["step"] == 2 and not os.path.exists(os.path.join(logdir, "checkpoint_2"))


def test_chunk_boundaries(setup, tmp_path, monkeypatch):
    """Validation every 2 and checkpoints every 3 steps over 7: each chunk
    stops at the next multiple of either, so every event fires."""
    steps, at = 0, []
    for _ in range(10):
        if steps >= 7:
            break
        steps += cli.chunk_length(steps, 7, [2, 3])
        at.append(steps)
    assert at == [2, 3, 4, 6, 7]

    chunks = []
    run_steps = DDPMTrainer.run_steps

    def recorded(self, state, frames, emb, gen, n, crop=None):
        chunks.append(n)
        return run_steps(self, state, frames, emb, gen, n, crop=crop)

    monkeypatch.setattr(DDPMTrainer, "run_steps", recorded)
    logdir, state = cli.train(**_tune(setup["frames"], setup["ckpt"], str(tmp_path / "run"), learning_rate=0.0,
                                      train_steps=7, validation_steps=2, checkpointing_steps=3,
                                      validation_sample_logger_config={"num_inference_steps": 1}),
                              device="cpu")
    assert chunks == [2, 1, 1, 2, 1] and state["step"] == 7
    names = set(os.listdir(logdir))
    assert {"validation_2", "validation_4", "validation_6", "checkpoint_3", "checkpoint_6"} <= names
    assert not {"validation_3", "checkpoint_2", "checkpoint_4"} & names


def test_resume_from(setup, tmp_path, monkeypatch):
    """resume_from restores the step, the fp32 masters and the optimizer
    state of checkpoint_2 and trains only the remaining steps."""
    chunks = []
    run_steps = DDPMTrainer.run_steps

    def recorded(self, state, frames, emb, gen, n, crop=None):
        chunks.append(n)
        return run_steps(self, state, frames, emb, gen, n, crop=crop)

    monkeypatch.setattr(DDPMTrainer, "run_steps", recorded)
    ck = os.path.join(setup["tlog1"], "checkpoint_2")
    d = _tune(setup["frames"], setup["ckpt"], str(tmp_path / "done"), learning_rate=1e-4, resume_from=ck)
    _, state = cli.train(**d, device="cpu")
    assert chunks == [] and state["step"] == 2
    for name, m in state["master"].items():
        torch.testing.assert_close(m, setup["state1"]["master"][name], atol=0, rtol=0)
    saved = setup["state1"]["optimizer"].state_dict()["state"]
    for i, st in state["optimizer"].state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(saved[i][k])), (i, k)
    d = _tune(setup["frames"], setup["ckpt"], str(tmp_path / "more"), learning_rate=1e-4, resume_from=ck,
              train_steps=3, validation_steps=0, checkpointing_steps=3)
    _, state = cli.train(**d, device="cpu")
    assert chunks == [1] and state["step"] == 3


def test_multi_device_raises(setup, tmp_path):
    """Tuning under `sharding: {mesh: auto}` in one process, a world of one,
    writes what the run without a mesh writes: the same file names, the same
    checkpoint and validation files byte for byte (but log.log, config.yml
    and phase_timings.json, which hold the run's folder and seconds), the
    same masters. A mesh of more devices than processes raises without a
    process group."""
    runs = []
    for name, sharding in (("plain", None), ("mesh", {"mesh": "auto"})):
        d = _tune(setup["frames"], setup["ckpt"], str(tmp_path / name), learning_rate=1e-4, sharding=sharding)
        runs.append(cli.train(**d, device="cpu"))
    (plain, pstate), (mesh, mstate) = runs
    assert _names(mesh) == _names(plain)
    for name in _names(plain):
        if name not in ("log.log", "config.yml", "phase_timings.json"):
            with open(os.path.join(plain, name), "rb") as a, open(os.path.join(mesh, name), "rb") as b:
                assert a.read() == b.read(), name
    for n, m in pstate["master"].items():
        assert torch.equal(mstate["master"][n], m), n
    with pytest.raises(RuntimeError, match="needs a process group"):
        cli.run(TUNE, mesh="1,4,2", device="cpu")


def test_runs_in_one_second_get_their_own_folders(tmp_path, monkeypatch):
    """Without a logdir, tuning runs of one config that start in the same
    second (the clock frozen here) each get a folder of their own: the edit
    CLI's `logdir_for`. Each run is stopped once its folder exists."""
    import time

    strftime = time.strftime
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "2026-01-01T00-00-00" if "%S" in fmt else strftime(fmt, *a))
    monkeypatch.chdir(tmp_path)

    def stop(*args, **kwargs):
        raise InterruptedError

    monkeypatch.setattr(cli, "load_models", stop)
    for _ in range(3):
        with pytest.raises(InterruptedError):
            cli.train(config="a/tune.yaml", device="cpu")
    base = os.path.join("result", "tune", "2026-01-01T00-00-00")
    assert sorted(os.listdir(os.path.dirname(base))) == [os.path.basename(p) for p in (base, f"{base}_1", f"{base}_2")]
    assert all(os.path.isfile(os.path.join(p, "log.log")) for p in (base, f"{base}_1", f"{base}_2"))
