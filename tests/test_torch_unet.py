"""The port's UNet against the JAX package, at tiny width.

Weights are drawn with numpy for the flax tree (every leaf random, temporal
and LoRA parts included, so the inflated paths do real work) and reach the
port through convert/from_flax.py. Inputs are seeded numpy arrays.

Tolerances (fp32 on both sides, JAX at 'highest' matmul precision): 5e-5
absolute on eps of magnitude ~2 through ~40 layers (measured differences are
~4e-6), 2e-5 on the captured payloads (probabilities and q/k of O(1)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fatezero_tpu.models.unet3d import UNet3DConfig as JConfig
from fatezero_tpu.models.unet3d import UNetPseudo3DConditionModel as JUNet
from fatezero_tpu.ptp.context import StoreContext as JStoreContext
from fatezero_tpu_torch.convert.from_flax import unet_state_from_flax
from fatezero_tpu_torch.models.loader import load_state
from fatezero_tpu_torch.models.unet3d import UNet3DConfig, UNetPseudo3DConditionModel
from fatezero_tpu_torch.ptp.context import StoreContext

torch.set_num_threads(1)
TINY = dict(block_out_channels=(32, 64, 128, 128), attention_head_dim=4, cross_attention_dim=16, norm_num_groups=8)
TEASER = dict(lora=160, sparse_causal_indices=("mid",), least_sc_channel=64)
F, HW = 2, 16


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



def _models(switches):
    kw = {**TINY, **switches}
    jm = JUNet(cfg=JConfig(**kw))
    params = _random_flax(jm, jnp.zeros((1, F, HW, HW, 4)), jnp.int32(1), jnp.zeros((1, 77, 16)), seed=9)
    tm = UNetPseudo3DConditionModel(UNet3DConfig(**kw))
    load_state(tm, unet_state_from_flax(jax.tree.map(np.asarray, params)), "cpu")
    return jm, params, tm


@pytest.mark.parametrize(
    "switches,capture",
    [({}, None), ({}, "probs"), (TEASER, "qk")],
    ids=["tiny-forward", "tiny-store-probs", "teaser-store-qk"],
)
def test_unet_forward_and_capture(switches, capture):
    """eps and, with a StoreContext, every captured site in visit order:
    'probs' stores self and cross probabilities (materialised sites),
    'qk' stores cross probabilities and self (q, k) (the inversion's capture)."""
    jm, params, tm = _models(switches)
    rng = np.random.RandomState(10)
    b = 2 if capture is None else 1
    x = rng.randn(b, F, HW, HW, 4).astype(np.float32)
    ctx = rng.randn(b, 77, 16).astype(np.float32)

    def make_ctx(cls, dtype):
        if capture is None:
            return None
        return cls(save_self_attention=True, store_dtype=dtype, self_qk=capture == "qk")

    @jax.jit
    def jfwd(params, x, c):
        jctx = make_ctx(JStoreContext, jnp.float32)
        out = jm.apply(params, x, jnp.int32(500), c, attn_ctx=jctx)
        return out, (jctx.captured, jctx.captured_qk) if jctx else None

    ref, jcap = jfwd(params, jnp.asarray(x), jnp.asarray(ctx))
    tctx = make_ctx(StoreContext, torch.float32)
    with torch.no_grad():
        out = tm(_t(x), 500, _t(ctx), attn_ctx=tctx)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5)
    if capture is None:
        return
    jprobs, jqk = jcap
    n_sites = 0
    for key, maps in jprobs.items():
        assert len(tctx.captured[key]) == len(maps), key
        for a, b_ in zip(maps, tctx.captured[key]):
            np.testing.assert_allclose(b_.numpy(), np.asarray(a), atol=2e-5, rtol=2e-5)
            n_sites += 1
    for key, pairs in jqk.items():
        assert len(tctx.captured_qk[key]) == len(pairs), key
        for (qa, ka), (qb, kb) in zip(pairs, tctx.captured_qk[key]):
            np.testing.assert_allclose(qb.numpy(), np.asarray(qa), atol=2e-5, rtol=2e-5)
            np.testing.assert_allclose(kb.numpy(), np.asarray(ka), atol=2e-5, rtol=2e-5)
            n_sites += 1
    assert n_sites == 32  # 16 transformer sites x (self, cross)
