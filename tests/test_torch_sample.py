"""The port's plain sampling (sample_fast, sample) and the tuning run's SampleLogger against the JAX package.

`sample_fast` and `sample` without a controller on the tiny UNet of
tests/test_torch_pipeline.py (teaser switches, F=2, 16x16 latents, 3 DDIM
steps, every flax leaf from numpy) at strength 1 and 0.5, from the same
noisy latent: held to 1e-5 x max|x| (fp32; CFG 7.5 amplifies the eps
differences, as there).

SampleLogger (pipelines/validation_loop.py) with random:tiny loaded by both
packages from one flax-native checkpoint the JAX package wrote: in
trajectory mode (two prompts, two seeds, strength 0.5, from the port's
invert_fast trajectory handed to both) and in generation mode with the JAX
package's noise handed to the port (its own comes from a seeded
torch.Generator; there each `sample` call is recorded and its starting
latent stands for the sample: the noise must be JAX's and the arguments
equal). Held: every decoded video within 2e-3 (the CLI tolerance of
tests/test_cli.py), the returned grid entries, and the same artifact names.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fatezero_tpu.models.tokenizer import StubTokenizer
from fatezero_tpu.models.unet3d import UNet3DConfig as JConfig
from fatezero_tpu.models.unet3d import UNetPseudo3DConditionModel as JUNet
from fatezero_tpu.pipelines.fatezero_pipeline import FateZeroPipeline as JPipeline
from fatezero_tpu_torch.convert.from_flax import unet_state_from_flax
from fatezero_tpu_torch.models.loader import load_state
from fatezero_tpu_torch.models.unet3d import UNet3DConfig, UNetPseudo3DConditionModel
from fatezero_tpu_torch.pipelines import validation_loop as VL
from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
from test_torch_pipeline import _random_flax

torch.set_num_threads(1)
TINY = dict(block_out_channels=(32, 64, 128, 128), attention_head_dim=4, cross_attention_dim=16, norm_num_groups=8)
TEASER = dict(lora=160, sparse_causal_indices=("mid",), least_sc_channel=64)
F, HW, STEPS = 2, 16, 3
ATOL = 2e-3


@pytest.fixture(scope="module")
def unets():
    cfg = {**TINY, **TEASER}
    jm = JUNet(cfg=JConfig(**cfg))
    params = _random_flax(jm, jnp.zeros((1, F, HW, HW, 4)), jnp.int32(1), jnp.zeros((1, 77, 16)), seed=3)
    tok = StubTokenizer()
    jpipe = JPipeline(jm, params, None, None, None, None, tok, store_dtype=jnp.float32)
    tm = UNetPseudo3DConditionModel(UNet3DConfig(**cfg))
    load_state(tm, unet_state_from_flax(jax.tree.map(np.asarray, params)), "cpu")
    pipe = FateZeroPipeline(tm, None, None, tok, store_dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(11)
    return dict(jpipe=jpipe, pipe=pipe, lat=rng.randn(1, F, HW, HW, 4).astype(np.float32),
                emb=rng.randn(2, 77, 16).astype(np.float32))


@pytest.mark.parametrize("strength", [1.0, 0.5])
def test_sample_fast_matches_jax(unets, strength):
    lat, emb = unets["lat"], unets["emb"]
    jout = np.asarray(unets["jpipe"].sample_fast(jnp.asarray(lat), jnp.asarray(emb), STEPS, strength=strength))
    out = unets["pipe"].sample_fast(torch.from_numpy(lat), torch.from_numpy(emb), STEPS, strength=strength)
    assert tuple(out.shape) == (1, F, HW, HW, 4)
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-5 * np.abs(jout).max(), rtol=0)
    # sample without a controller or an edit_store is the same loop
    again = unets["pipe"].sample(torch.from_numpy(lat), torch.from_numpy(emb), STEPS, strength=strength)
    torch.testing.assert_close(again, out, atol=0, rtol=0)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from fatezero_tpu.common.checkpoint import save_pipeline_checkpoint
    from fatezero_tpu.models.loader import load_models as jload_models
    from fatezero_tpu_torch.models.loader import load_models

    root = tmp_path_factory.mktemp("sample")
    b = jload_models("random:tiny", {}, seed=0)
    ckpt = save_pipeline_checkpoint(str(root / "ckpt"), b.unet.cfg, b.unet_params, b.vae.cfg, b.vae_params,
                                    b.text_encoder.cfg, b.text_params)
    jb = jload_models(ckpt, {}, seed=0)
    jpipe = JPipeline(jb.unet, jb.unet_params, jb.vae, jb.vae_params, jb.text_encoder, jb.text_params,
                      jb.tokenizer, schedule=jb.schedule)
    tb = load_models(ckpt, {}, device="cpu")
    pipe = FateZeroPipeline(tb.unet, tb.vae, tb.text_encoder, tb.tokenizer, tb.schedule, device="cpu")
    video = (np.random.RandomState(2).rand(F, 64, 64, 3) * 2 - 1).astype(np.float32)
    return dict(root=root, jpipe=jpipe, pipe=pipe, video=video)


def _names(root):
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)


LOGGER = dict(editing_prompts=["a silver jeep driving", "a red jeep driving"], clip_length=F,
              sample_seeds=[3, 5], num_inference_steps=2, guidance_scale=7.5)


def _compare(tiny, tag, jkw, tkw, logger_kw, n_runs=4):
    from fatezero_tpu.pipelines.validation_loop import SampleLogger as JSampleLogger

    jl = JSampleLogger(logdir=str(tiny["root"] / f"jax_{tag}"), **logger_kw)
    tl = VL.SampleLogger(logdir=str(tiny["root"] / f"torch_{tag}"), **logger_kw)
    jout = jl.log_sample_images(tiny["jpipe"], 4, **jkw)
    tout = tl.log_sample_images(tiny["pipe"], 4, **tkw)
    assert len(tout) == len(jout) == ("image" in tkw) + n_runs  # the input, then prompts x seeds
    for t, j in zip(tout, jout):
        assert t.shape == np.asarray(j).shape
        # annotated videos are uint8: one unit where a pixel rounds the other way
        tol = 1 if t.dtype == np.uint8 else ATOL
        np.testing.assert_allclose(t.astype(np.float32), np.asarray(j).astype(np.float32), atol=tol)
    assert _names(tl.logdir) == _names(jl.logdir)
    assert "step_4.gif" in _names(tl.logdir) and "step_4_0_5.gif" in _names(tl.logdir)


def test_sample_logger_trajectory_mode(tiny):
    pipe = tiny["pipe"]
    latents = pipe.encode_video(torch.from_numpy(tiny["video"]))
    traj = pipe.invert_fast(latents, pipe.encode_prompt("a silver jeep driving"), 2)
    kw = dict(LOGGER, strength=0.5)
    _compare(tiny, "traj", dict(image=tiny["video"], traj=jnp.asarray(traj.numpy())),
             dict(image=tiny["video"], traj=traj), kw)


def test_sample_logger_generation_mode(tiny, monkeypatch):
    """No trajectory: each seed's noise at [1, F, 64, 64, 4]; the port gets
    JAX's draws. No input video: its 64x64 frames would not stack with the
    512x512 samples in the grid (in either package)."""
    shapes = []

    def jax_noise(seed, shape):
        shapes.append(tuple(shape))
        return torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape)))

    monkeypatch.setattr(VL, "generation_noise", jax_noise)
    # sampling a 64x64 latent takes minutes of CPU in either package, and
    # `sample` is held to JAX above: record each call, return its starting
    # latent, and let that stand for the decoded video
    calls = {"jpipe": [], "pipe": []}
    for key in calls:
        def sample(init, emb, rec=calls[key], **kw):
            rec.append((np.asarray(init), np.asarray(emb), kw))
            return init

        monkeypatch.setattr(tiny[key], "sample", sample)
        monkeypatch.setattr(tiny[key], "decode_latents",
                            lambda lat: np.clip(np.asarray(lat)[0, ..., :3] / 2.0 + 0.5, 0.0, 1.0))
    _compare(tiny, "gen", {}, {}, LOGGER)
    assert shapes == [(1, F, 64, 64, 4)] * 4
    for (ti, te, tk), (ji, je, jk) in zip(calls["pipe"], calls["jpipe"]):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(te, je, atol=1e-5)
        assert tk == jk == dict(num_inference_steps=2, guidance_scale=7.5, strength=1.0)


def test_generation_noise_is_seeded():
    a, b = VL.generation_noise(3, (1, 2, 8, 8, 4)), VL.generation_noise(3, (1, 2, 8, 8, 4))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, VL.generation_noise(4, (1, 2, 8, 8, 4)))
