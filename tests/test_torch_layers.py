"""The port's layers, norms, video ops and resnet block against the JAX package.

Weights are drawn with numpy for the flax tree and reach the port through
convert/from_flax.py; inputs are seeded numpy arrays. Tolerance 2e-5
absolute/relative on O(1) outputs: fp32 on both sides (JAX at 'highest'
matmul precision), only the summation order differs. Gathers are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fatezero_tpu.models import layers as JL
from fatezero_tpu.models import resnet as JR
from fatezero_tpu.ops import fused_norm as JN
from fatezero_tpu.ops import video_ops as JV
from fatezero_tpu_torch.convert.from_flax import unet_state_from_flax
from fatezero_tpu_torch.models import layers as L
from fatezero_tpu_torch.models import resnet as R
from fatezero_tpu_torch.models.loader import load_state
from fatezero_tpu_torch.ops import fused_norm as N
from fatezero_tpu_torch.ops import video_ops as V

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
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), leaves)


def _t(a):
    return torch.from_numpy(np.asarray(a))



@pytest.mark.parametrize("batch_dims", [1, 2])
def test_group_norm_matches(batch_dims):
    x = np.random.RandomState(0).randn(2, 3, 4, 4, 16).astype(np.float32) * 3 + 1
    jm = JL.FusedGroupNorm(num_groups=4, epsilon=1e-6, batch_dims=batch_dims)
    params = _random_flax(jm, jnp.asarray(x), seed=1)
    ref = jm.apply(params, jnp.asarray(x))
    tm = L.FusedGroupNorm(4, 16, eps=1e-6, batch_dims=batch_dims)
    load_state(tm, unet_state_from_flax(params), "cpu")
    np.testing.assert_allclose(tm(_t(x)).detach().numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_layer_norm_and_feed_forward_match():
    x = np.random.RandomState(2).randn(2, 3, 5, 16).astype(np.float32)
    np.testing.assert_allclose(
        N._ln_math(_t(x), torch.full((16,), 1.5), torch.full((16,), 0.1), 1e-5).numpy(),
        np.asarray(JN._ln_math(jnp.asarray(x), jnp.full((16,), 1.5), jnp.full((16,), 0.1), 1e-5)),
        atol=2e-5, rtol=2e-5,
    )
    jm = JL.FeedForward(16)
    params = _random_flax(jm, jnp.asarray(x), seed=3)
    tm = L.FeedForward(16)
    load_state(tm, unet_state_from_flax(params), "cpu")
    np.testing.assert_allclose(
        tm(_t(x)).detach().numpy(), np.asarray(jm.apply(params, jnp.asarray(x))), atol=2e-5, rtol=2e-5
    )
    ts = np.array([1, 500, 981])
    np.testing.assert_allclose(
        L.get_timestep_embedding(_t(ts), 32).numpy(),
        np.asarray(JL.get_timestep_embedding(jnp.asarray(ts), 32)),
        atol=2e-5, rtol=2e-5,
    )


@pytest.mark.parametrize("stride", [1, 2])
def test_video_ops_match(stride):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 4, 6, 8).astype(np.float32)
    w = rng.randn(3, 8, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    pairs = [
        (V.temporal_conv(_t(x), _t(w), _t(b), stride), JV.temporal_conv(x, w, b, stride)),
        (V.temporal_avgpool(_t(x), 3, stride), JV.temporal_avgpool(jnp.asarray(x), 3, stride)),
        (V.upsample_nearest_2x(_t(x)), JV.upsample_nearest_2x(jnp.asarray(x))),
        (V.temporal_linear_upsample_2x(_t(x)), JV.temporal_linear_upsample_2x(jnp.asarray(x))),
        (V.avgpool_2x(_t(x)), JV.avgpool_2x(jnp.asarray(x))),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("spec", [(-1, "first"), ("mid",), ("last", 1)])
def test_sparse_gather_matches(spec):
    kv = np.random.RandomState(5).randn(2, 4, 3, 8).astype(np.float32)
    got = V.gather_sparse_kv(_t(kv), spec, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JV.gather_sparse_kv(jnp.asarray(kv), spec, 4)))
    refs = V.referenced_frames(4, spec)
    assert refs == JV.referenced_frames(4, spec)
    sel = np.random.RandomState(6).randn(2, len(refs), 2, 3, 5).astype(np.float32)
    np.testing.assert_array_equal(
        V.regather_headsplit_kv(_t(sel), spec, 4, 2).numpy(),
        np.asarray(JV.regather_headsplit_kv(jnp.asarray(sel), spec, 4, 2)),
    )


@pytest.mark.parametrize("lora", [None, 4])
def test_resnet_block_matches(lora):
    rng = np.random.RandomState(7)
    x = rng.randn(1, 3, 8, 8, 16).astype(np.float32)
    temb = rng.randn(1, 32).astype(np.float32)
    jm = JR.ResnetBlockPseudo3D(24, temb_channels=32, groups=8, lora_rank=lora)
    params = _random_flax(jm, jnp.asarray(x), jnp.asarray(temb), seed=8)
    tm = R.ResnetBlockPseudo3D(16, 24, 32, groups=8, lora_rank=lora)
    load_state(tm, unet_state_from_flax(params), "cpu")
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(temb))
    np.testing.assert_allclose(tm(_t(x), _t(temb)).detach().numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
