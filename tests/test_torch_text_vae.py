"""The port's CLIP text encoder, VAE and the pipeline's text/VAE stages
against the JAX package, at tiny width.

Weights are drawn with numpy for the flax trees and reach the port through
convert/from_flax.py. Tolerances, fp32 on both sides: CLIP hidden states
2e-4 (the CLIP parity bound of PARITY.md:40; measured far below); VAE
moments and images 1e-4 absolute on O(1) values through ~30 convolutions;
the decoded video 1e-4 (clipped to [0, 1]).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fatezero_tpu.models.clip import CLIPTextConfig as JTextConfig
from fatezero_tpu.models.clip import CLIPTextModel as JText
from fatezero_tpu.models.tokenizer import StubTokenizer
from fatezero_tpu.models.vae import AutoencoderKL as JVAE
from fatezero_tpu.models.vae import VAEConfig as JVAEConfig
from fatezero_tpu.pipelines.fatezero_pipeline import FateZeroPipeline as JPipeline
from fatezero_tpu_torch.convert.from_flax import clip_text_state_from_flax, vae_state_from_flax
from fatezero_tpu_torch.models.clip import CLIPTextModel
from fatezero_tpu_torch.models.loader import TINY_TEXT, TINY_VAE, load_state
from fatezero_tpu_torch.models.vae import AutoencoderKL
from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline

torch.set_num_threads(1)


def _random_flax(model, *args, seed=0):
    """A flax param tree for `model` with every leaf drawn from numpy."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)

    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    leaves = [fill(p, s) for p, s in flat]
    return jax.tree.map(np.asarray, jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), leaves))


def _jtext_cfg():
    return JTextConfig(**{k: getattr(TINY_TEXT, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads")})


@pytest.fixture(scope="module")
def models():
    jtext = JText(cfg=_jtext_cfg())
    tparams = _random_flax(jtext, jnp.zeros((1, 77), jnp.int32), seed=1)
    text = CLIPTextModel(TINY_TEXT)
    load_state(text, clip_text_state_from_flax(tparams), "cpu")

    jvae = JVAE(cfg=JVAEConfig(block_out_channels=TINY_VAE.block_out_channels, norm_num_groups=8))
    vparams = _random_flax(jvae, jnp.zeros((1, 32, 32, 3)), seed=2)
    vae = AutoencoderKL(TINY_VAE)
    load_state(vae, vae_state_from_flax(vparams), "cpu")

    tok = StubTokenizer(vocab_size=TINY_TEXT.vocab_size)
    jpipe = JPipeline(None, None, jvae, vparams, jtext, tparams, tok)
    pipe = FateZeroPipeline(None, vae, text, tok, device="cpu")
    return jpipe, pipe


def test_clip_text_matches(models):
    jpipe, pipe = models
    prompt = "watercolor painting of a silver jeep driving"
    ref = np.asarray(jpipe.encode_prompt(prompt))
    got = pipe.encode_prompt(prompt)
    assert tuple(got.shape) == (2, 77, TINY_TEXT.hidden_size) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=0)


def test_vae_encode_decode_match(models):
    jpipe, pipe = models
    video = np.random.RandomState(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = np.array(jpipe.encode_video(jnp.asarray(video)))
    lat = pipe.encode_video(torch.from_numpy(video))
    assert tuple(lat.shape) == (1, 2, 4, 4, 4) == ref.shape and lat.dtype == torch.float32
    np.testing.assert_allclose(lat.numpy(), ref, atol=1e-4, rtol=0)
    jdec = jpipe.decode_latents(jnp.asarray(ref), chunk=1)
    dec = pipe.decode_latents(torch.from_numpy(ref), chunk=1)
    assert dec.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(dec, np.asarray(jdec), atol=1e-4, rtol=0)


def test_vae_posterior_sample(models):
    """With a generator the posterior is sampled: mean + std * N(0, 1)."""
    _, pipe = models
    video = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    mean = pipe.encode_video(video)
    a = pipe.encode_video(video, generator=torch.Generator().manual_seed(0))
    b = pipe.encode_video(video, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.allclose(a, mean)
