"""The edit CLI's streaming branches against the JAX package's CLI, at tiny width.

Both CLIs run from one flax-native random:tiny checkpoint the JAX package
wrote, on 2 synthetic 64x64 frames, 2 DDIM steps, on the CPU in fp32:

* `disk_store`: config/low_resource_teaser/jeep_watercolor_ddim_10_steps_disk_store.yaml
  cut to that size: `invert` into an AttentionStore pickled into the logdir,
  its cross-attention GIF, then the streaming edit (`save_attention_maps`
  takes the same path with the store in memory; tests/test_torch_streaming.py
  holds that edit with both blends);
* `use_inversion_attention: false` with 2 prompts (demo_tiny without its
  per-prompt override): the first prompt's 'save' sample, then the swap
  edit against it;
* generation mode (`use_invertion_latents: false`) with two sample seeds,
  each from the JAX package's noise handed to the port (its own comes from a
  seeded torch.Generator).

Held: the decoded videos within 2e-3 (the CLI tolerance of tests/test_cli.py)
and the same artifact names (the per-step pickles included).
"""
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fatezero_tpu_torch.cli import edit as cli
from fatezero_tpu_torch.common.config import load_config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISK = os.path.join(REPO, "config", "low_resource_teaser", "jeep_watercolor_ddim_10_steps_disk_store.yaml")
DEMO = os.path.join(REPO, "config", "demo_tiny.yaml")
ATOL = 2e-3
FRAMES, STEPS = 2, 2


def _frames(path):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(FRAMES):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(os.path.join(path, f"{i:05d}.png"))
    return str(path)


def _cut(path, frames, **editing):
    d = load_config(path).to_dict()
    d["dataset_config"].update(path=frames, n_sample_frame=FRAMES, sampling_rate=1, image_size=64)
    d["editing_config"].update(num_inference_steps=STEPS, clip_length=FRAMES, **editing)
    d["config"] = os.path.basename(path)
    return d


def _names(root):
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    from fatezero_tpu.common.checkpoint import save_pipeline_checkpoint
    from fatezero_tpu.models.loader import load_models as jload_models

    root = tmp_path_factory.mktemp("streaming_cli")
    out = {"root": root, "frames": _frames(root / "frames")}
    for name, path in (("disk", DISK), ("demo", DEMO)):
        b = jload_models("random:tiny", load_config(path).to_dict()["model_config"], seed=0)
        out[name] = save_pipeline_checkpoint(str(root / f"ckpt_{name}"), b.unet.cfg, b.unet_params, b.vae.cfg,
                                             b.vae_params, b.text_encoder.cfg, b.text_params)
    return out


def _demo_no_inversion_attention(frames):
    d = _cut(DEMO, frames, use_inversion_attention=False)
    d["editing_config"]["p2p_config"][1].pop("use_inversion_attention")
    return d


CASES = {
    "disk_store": lambda frames: ("disk", _cut(DISK, frames)),
    "no_inversion_attention": lambda frames: ("demo", _demo_no_inversion_attention(frames)),
    "generation": lambda frames: ("demo", _cut(DEMO, frames, use_invertion_latents=False,
                                                use_inversion_attention=False, sample_seeds=[0, 1])),
}


@pytest.mark.parametrize("case", list(CASES))
def test_streaming_cli_matches_jax(ckpts, tmp_path, monkeypatch, case):
    from fatezero_tpu.cli.edit import test as jtest

    which, d = CASES[case](ckpts["frames"])
    d["pretrained_model_path"] = ckpts[which]
    if case == "disk_store":
        assert d["disk_store"] is True
    jlog, jvideos = jtest(**d, logdir=str(tmp_path / "jax"))

    draws = []

    def jax_noise(seed, shape):
        draws.append(seed)
        return torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape)))

    monkeypatch.setattr(cli, "generation_noise", jax_noise)
    tlog, tvideos = cli.test(**d, logdir=str(tmp_path / "torch"), device="cpu")
    assert len(tvideos) == len(jvideos) >= 1
    for t, j in zip(tvideos, jvideos):
        assert t.shape == (FRAMES, 64, 64, 3) and np.isfinite(t).all()
        np.testing.assert_allclose(t, np.asarray(j), atol=ATOL)
    names = _names(tlog)
    assert names == _names(jlog)
    if case == "disk_store":
        assert [n for n in names if n.endswith(".pkl")] == [f"{i:03d}.pkl" for i in range(STEPS)]
        assert "cross_attention/attn.gif" in names
    if case == "generation":
        # one logger per seed, in its own folder; the tag keeps sample_seeds[0]
        assert draws == [0, 1] and "seed_1/step_0_1_0.gif" in names
    else:
        assert draws == []
