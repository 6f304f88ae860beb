"""The whole slice of the port against the JAX package, at tiny width.

invert_fast(capture=True) then edit_fast(stored=...) with the teaser's
controller (refine, reweight x10, cross 0.8, self 0.8) on the TINY UNet with
the teaser switches (LoRA, ['mid'] sparse-causal, least_sc_channel=64), F=2,
16x16 latents, 3 DDIM steps. Compared: the latent trajectory, every stored
payload leaf (JAX's converted to logical layout with _payload_to_logical),
and the edited latent.

Tolerances, fp32 on both sides: trajectory 2e-5 absolute on values up to ~4
(measured ~3e-6); payload 2e-5 (probabilities and q/k of O(1), measured
~1e-5); edited latent 1e-5 relative to its largest magnitude (~26 here, CFG
7.5 and the x10 reweight amplify the eps differences; measured ~6e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fatezero_tpu.models.tokenizer import StubTokenizer
from fatezero_tpu.models.unet3d import UNet3DConfig as JConfig
from fatezero_tpu.models.unet3d import UNetPseudo3DConditionModel as JUNet
from fatezero_tpu.pipelines.fatezero_pipeline import FateZeroPipeline as JPipeline
from fatezero_tpu.pipelines.fatezero_pipeline import _payload_to_logical
from fatezero_tpu.ptp.controller import make_controller as jmake_controller
from fatezero_tpu_torch.convert.from_flax import unet_state_from_flax
from fatezero_tpu_torch.models.loader import load_state
from fatezero_tpu_torch.models.unet3d import UNet3DConfig, UNetPseudo3DConditionModel
from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
from fatezero_tpu_torch.ptp.controller import make_controller

torch.set_num_threads(1)
TINY = dict(block_out_channels=(32, 64, 128, 128), attention_head_dim=4, cross_attention_dim=16, norm_num_groups=8)
TEASER = dict(lora=160, sparse_causal_indices=("mid",), least_sc_channel=64)
F, HW, STEPS = 2, 16, 3
SOURCE = "a silver jeep driving"
TARGET = "watercolor painting of a silver jeep driving"


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


def _controller(make, tok):
    return make(
        tok, [SOURCE, TARGET], num_steps=STEPS, is_replace_controller=False,
        cross_replace_steps=0.8, self_replace_steps=0.8,
        eq_params={"words": ["watercolor"], "values": [10]},
    )


@pytest.fixture(scope="module")
def slices():
    cfg = {**TINY, **TEASER}
    jm = JUNet(cfg=JConfig(**cfg))
    params = _random_flax(jm, jnp.zeros((1, F, HW, HW, 4)), jnp.int32(1), jnp.zeros((1, 77, 16)), seed=3)
    tok = StubTokenizer()
    rng = np.random.RandomState(5)
    lat = rng.randn(1, F, HW, HW, 4).astype(np.float32)
    emb_src = rng.randn(2, 77, 16).astype(np.float32)
    emb_tgt = rng.randn(2, 77, 16).astype(np.float32)

    jpipe = JPipeline(jm, params, None, None, None, None, tok, store_dtype=jnp.float32)
    jtraj, jstored = jpipe.invert_fast(jnp.asarray(lat), jnp.asarray(emb_src), STEPS, capture=True)
    jout, _ = jpipe.edit_fast(
        jtraj, jnp.asarray(emb_src), jnp.asarray(emb_tgt), _controller(jmake_controller, tok), STEPS,
        stored=jstored,
    )

    tm = UNetPseudo3DConditionModel(UNet3DConfig(**cfg))
    load_state(tm, unet_state_from_flax(jax.tree.map(np.asarray, params)), "cpu")
    pipe = FateZeroPipeline(tm, None, None, tok, store_dtype=torch.float32, device="cpu")
    traj, stored = pipe.invert_fast(torch.from_numpy(lat), torch.from_numpy(emb_src), STEPS, capture=True)
    out, aux = pipe.edit_fast(
        traj, torch.from_numpy(emb_src), torch.from_numpy(emb_tgt), _controller(make_controller, tok), STEPS,
        stored=stored,
    )
    return dict(
        jax=(np.asarray(jtraj), _payload_to_logical(jstored), np.asarray(jout)),
        torch=(traj, stored, out, aux),
        pipe=pipe, tok=tok, emb=(emb_src, emb_tgt),
    )


def test_trajectory_matches(slices):
    jtraj = slices["jax"][0]
    traj = slices["torch"][0]
    assert tuple(traj.shape) == (STEPS + 1, 1, F, HW, HW, 4) == jtraj.shape
    np.testing.assert_allclose(traj.numpy(), jtraj, atol=2e-5, rtol=0)


def test_stored_payload_matches(slices):
    jst = slices["jax"][1]
    st = slices["torch"][1]
    n = 0
    for key, maps in jst["probs"].items():
        assert len(st["probs"][key]) == len(maps), key
        for a, b in zip(maps, st["probs"][key]):
            assert tuple(b.shape) == a.shape and b.shape[0] == STEPS
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5, rtol=0)
            n += 1
    for key, pairs in jst["qk"].items():
        assert len(st["qk"][key]) == len(pairs), key
        for (qa, ka), (qb, kb) in zip(pairs, st["qk"][key]):
            np.testing.assert_allclose(qb.numpy(), np.asarray(qa), atol=2e-5, rtol=0)
            np.testing.assert_allclose(kb.numpy(), np.asarray(ka), atol=2e-5, rtol=0)
            n += 1
    assert n == 32


def test_edited_latent_matches(slices):
    jout = slices["jax"][2]
    out, aux = slices["torch"][2], slices["torch"][3]
    assert aux == {}
    assert tuple(out.shape) == (1, F, HW, HW, 4)
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-5 * np.abs(jout).max(), rtol=0)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(stored=None),
        dict(viz=True),
        dict(strength=0.5),
        dict(stored_row0=1),
    ],
    ids=["replay", "viz", "strength", "hybrid"],
)
def test_modes_not_ported_raise(slices, kwargs):
    """The modes beside the full stored edit run here and give a finite latent
    of the right shape (tests/test_torch_edit_modes.py holds them to JAX and
    to each other): replay (no payload; with use_inversion_attention and no
    attention blend it runs inline), viz, strength 0.5, and a hybrid whose
    payload rows [1, 4) serve the first two steps."""
    pipe, tok = slices["pipe"], slices["tok"]
    traj, stored = slices["torch"][0], slices["torch"][1]
    emb_src, emb_tgt = (torch.from_numpy(e) for e in slices["emb"])
    kw = dict(stored=stored)
    kw.update(kwargs)
    out, aux = pipe.edit_fast(traj, emb_src, emb_tgt, _controller(make_controller, tok), STEPS, **kw)
    assert tuple(out.shape) == (1, F, HW, HW, 4) and bool(torch.isfinite(out).all())
    if kwargs.get("viz"):
        assert tuple(aux["cross_avg"].shape) == (1, F, (HW // 4) ** 2, 77)
        np.testing.assert_allclose(aux["cross_avg"].sum(-1).numpy(), 1.0, atol=1e-5)
    else:
        assert aux == {}


def test_blends_partial_capture_and_streaming_store_raise(slices):
    """Blends and a partial capture, which once raised, build and run: a
    blend controller has both blenders, and a capture of rows [1, 2) holds
    one row of every payload leaf at that inversion step."""
    pipe, tok = slices["pipe"], slices["tok"]
    ctl = make_controller(tok, [SOURCE, TARGET], STEPS, blend_words=[["jeep"], ["jeep"]],
                          blend_latents=True, blend_self_attention=True)
    assert ctl.latent_blend is not None and ctl.attention_blend is not None
    assert ctl.latent_blend.alpha_layers.sum() > 0
    emb_src = torch.from_numpy(slices["emb"][0])
    full = slices["torch"][1]
    lat = torch.from_numpy(slices["jax"][0][0])
    traj, part = pipe.invert_fast(lat, emb_src, STEPS, capture=True, capture_rows=(1, 1))
    np.testing.assert_array_equal(traj.numpy(), slices["torch"][0].numpy())
    for key, maps in full["probs"].items():
        for a, b in zip(maps, part["probs"][key]):
            assert b.shape[0] == 1
            np.testing.assert_array_equal(b[0].numpy(), a[1].numpy())
    for key, pairs in full["qk"].items():
        for (qa, ka), (qb, kb) in zip(pairs, part["qk"][key]):
            np.testing.assert_array_equal(qb[0].numpy(), qa[1].numpy())
            np.testing.assert_array_equal(kb[0].numpy(), ka[1].numpy())
