"""The port's spatial blends and blend controller against the JAX package.

Held on the same seeded numpy inputs, no UNet: `_resize_nearest` at
non-integer ratios, `_maxpool3`, `blend_map`/`blend_mask`,
`SpatialBlender.mask_for` ('source', 'both', with substruct words),
`latent_blend_active`, `apply_latent_blend`, `word_alpha_layers` and
`make_controller` under each blend setting.

Tolerances, fp32 on both sides: the normalised maps 1e-6 absolute (values in
[0, 1]; sums of 5 maps x heads x 77 words in another order). The binary
masks threshold those maps, so a pixel within that tolerance of the
threshold could flip between the two: masks are compared exactly outside the
band |m - th| <= BAND, and each case asserts that no pixel lies inside it
at its seed. Index and selection ops (resize, pool, latent blend) are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fatezero_tpu.models.tokenizer import StubTokenizer as JTokenizer
from fatezero_tpu.ptp import spatial_blend as J
from fatezero_tpu.ptp.controller import make_controller as jmake_controller
from fatezero_tpu_torch.models.tokenizer import StubTokenizer
from fatezero_tpu_torch.ptp import spatial_blend as T
from fatezero_tpu_torch.ptp.controller import make_controller

MAP_TOL = 1e-6
BAND = 1e-5
P, F, H = 2, 3, 4
SOURCE = "a silver jeep driving down a curvy road in the countryside,"
TARGET = "a Porsche car driving down a curvy road in the countryside,"
WORDS = [["silver", "jeep"], ["Porsche", "car"]]


def _maps(seed, sizes=(16, 16, 16, 16, 16), p=P):
    """Softmax-normalised [p, f, heads, s, 77] maps, one per s."""
    rng = np.random.RandomState(seed)
    out = []
    for s in sizes:
        x = rng.randn(p, F, H, s, 77).astype(np.float32) * 2.0
        e = np.exp(x - x.max(-1, keepdims=True))
        out.append((e / e.sum(-1, keepdims=True)).astype(np.float32))
    return out


def _alpha(seed, p=P):
    rng = np.random.RandomState(seed)
    a = np.zeros((p, 77), np.float32)
    for i in range(p):
        a[i, rng.choice(np.arange(1, 12), 2, replace=False)] = 1.0
    return a


def _hold_mask(t_mask, j_mask, t_norm, th):
    """Masks equal outside the threshold band, and the band empty."""
    t_mask, j_mask, t_norm = (np.asarray(a) for a in (t_mask, j_mask, t_norm))
    near = np.abs(t_norm - th) <= BAND
    assert not near.any(), f"{int(near.sum())} pixels within {BAND} of th={th}"
    np.testing.assert_array_equal(t_mask[~near], j_mask[~near])


@pytest.mark.parametrize("src_hw", [(4, 4), (6, 6), (5, 7)])
@pytest.mark.parametrize("hw", [(4, 4), (8, 8), (6, 10), (3, 5)])
def test_resize_nearest_matches_jax(src_hw, hw):
    x = np.random.RandomState(0).randn(P, F, *src_hw).astype(np.float32)
    got = T._resize_nearest(torch.from_numpy(x), hw).numpy()
    np.testing.assert_array_equal(got, np.asarray(J._resize_nearest(jnp.asarray(x), hw)))


def test_maxpool3_matches_jax():
    x = np.random.RandomState(1).randn(P, F, 5, 7).astype(np.float32) - 3.0  # negatives at the border
    np.testing.assert_array_equal(T._maxpool3(torch.from_numpy(x)).numpy(), np.asarray(J._maxpool3(jnp.asarray(x))))


@pytest.mark.parametrize("use_pool", [True, False])
@pytest.mark.parametrize("hw", [(4, 4), (8, 8), (6, 6), (32, 32)])
def test_blend_mask_matches_jax(use_pool, hw):
    maps, alpha = _maps(2), _alpha(3)
    tm = [torch.from_numpy(m) for m in maps]
    t_norm = T.blend_map(tm, torch.from_numpy(alpha), hw, use_pool).numpy()
    j_agg = J._aggregate([jnp.asarray(m) for m in maps], jnp.asarray(alpha))
    if use_pool:
        j_agg = J._maxpool3(j_agg)
    j_agg = J._resize_nearest(j_agg, hw)
    j_norm = np.asarray(j_agg / jnp.maximum(j_agg.max(axis=(-2, -1), keepdims=True), 1e-12))
    np.testing.assert_allclose(t_norm, j_norm, atol=MAP_TOL, rtol=0)
    for th in (0.3, 0.5):
        t_mask = T.blend_mask(tm, torch.from_numpy(alpha), hw, th, use_pool).numpy()
        j_mask = J.blend_mask([jnp.asarray(m) for m in maps], jnp.asarray(alpha), hw, th, use_pool)
        assert t_mask.shape == (P, F, *hw) and set(np.unique(t_mask)) <= {0.0, 1.0}
        _hold_mask(t_mask, j_mask, t_norm, th)


def _blenders(choose, substruct):
    kw = dict(num_steps=10, start_blend=0.2, end_blend=0.8, th=(0.3, 0.4), prompt_choose=choose,
              substruct_words=[["road"], ["road"]] if substruct else None)
    return (T.SpatialBlender.create([SOURCE, TARGET], WORDS, StubTokenizer(), **kw),
            J.SpatialBlender.create([SOURCE, TARGET], WORDS, JTokenizer(), **kw))


@pytest.mark.parametrize("choose,substruct", [("source", False), ("both", False), ("both", True), ("source", True)])
def test_mask_for_matches_jax(choose, substruct):
    tb, jb = _blenders(choose, substruct)
    np.testing.assert_array_equal(tb.alpha_layers, jb.alpha_layers)
    assert (tb.start_blend, tb.end_blend, tb.th, tb.prompt_choose) == (jb.start_blend, jb.end_blend, jb.th,
                                                                     jb.prompt_choose)
    if substruct:
        np.testing.assert_array_equal(tb.substruct_layers, jb.substruct_layers)
    p = 1 if choose == "source" else P  # the source row alone, or [inversion, edit]
    maps = _maps(4, p=p)
    tm = [torch.from_numpy(m) for m in maps]
    hw = (8, 8)
    t_mask = tb.mask_for(tm, hw).numpy()
    j_mask = np.asarray(jb.mask_for([jnp.asarray(m) for m in maps], hw))
    assert t_mask.shape == j_mask.shape == (p, F, *hw)
    rows = slice(0, 1) if choose == "source" else slice(None)
    alphas = [(torch.from_numpy(tb.alpha_layers[rows]), True, tb.th[0])]
    if substruct:
        alphas.append((torch.from_numpy(tb.substruct_layers[rows]), False, tb.th[1]))
    for alpha, pool, th in alphas:  # every map the mask thresholds keeps clear of its band
        norm = T.blend_map(tm, alpha, hw, pool).numpy()
        assert not (np.abs(norm - th) <= BAND).any()
    np.testing.assert_array_equal(t_mask, j_mask)


def test_latent_blend_active_and_record_match_jax(tmp_path):
    """The blend window as JAX's; recording masks (`save_path`) belongs to the
    streaming store's sample, which is not ported, so asking for it raises
    instead of being ignored."""
    tb, jb = _blenders("both", False)
    assert [tb.latent_blend_active(i) for i in range(10)] == [jb.latent_blend_active(i) for i in range(10)]
    with pytest.raises(NotImplementedError, match="save_path"):
        make_controller(StubTokenizer(), [SOURCE, TARGET], num_steps=10, blend_words=WORDS, blend_latents=True,
                        save_path=str(tmp_path))
    assert not any(tmp_path.iterdir())


def test_apply_latent_blend_matches_jax():
    rng = np.random.RandomState(6)
    x, inv = rng.randn(1, F, 8, 8, 4).astype(np.float32), rng.randn(1, F, 8, 8, 4).astype(np.float32)
    mask = (rng.rand(P, F, 8, 8) > 0.5).astype(np.float32)
    got = T.apply_latent_blend(*(torch.from_numpy(a) for a in (x, inv, mask))).numpy()
    np.testing.assert_array_equal(got, np.asarray(J.apply_latent_blend(*(jnp.asarray(a) for a in (x, inv, mask)))))


@pytest.mark.parametrize(
    "blend_latents,blend_self_attention,words",
    [(False, False, WORDS), (True, False, WORDS), (False, True, WORDS), (True, True, WORDS), (True, True, None)],
    ids=["words-only", "latents", "self-attention", "both", "no-words"],
)
def test_make_controller_blends_match_jax(blend_latents, blend_self_attention, words):
    kw = dict(num_steps=10, is_replace_controller=True, cross_replace_steps={"default_": 0.5},
              self_replace_steps=0.5, blend_words=words, blend_th=[0.3, 0.3],
              blend_latents=blend_latents, blend_self_attention=blend_self_attention)
    tc = make_controller(StubTokenizer(), [SOURCE, TARGET], **kw)
    jc = jmake_controller(JTokenizer(), [SOURCE, TARGET], **kw)
    for name in ("latent_blend", "attention_blend"):
        tb, jb = getattr(tc, name), getattr(jc, name)
        assert (tb is None) == (jb is None), name
        if tb is not None:
            np.testing.assert_array_equal(tb.alpha_layers, jb.alpha_layers)
            assert (tb.start_blend, tb.end_blend, tb.th, tb.prompt_choose) == (
                jb.start_blend, jb.end_blend, jb.th, jb.prompt_choose)
    has_blend = words is not None and (blend_latents or blend_self_attention)
    assert (tc.latent_blend is not None or tc.attention_blend is not None) == has_blend
    assert [tc.edit_window(n) for n in (4, 7, 10)] == [jc.edit_window(n) for n in (4, 7, 10)]
    np.testing.assert_array_equal(tc.alpha_time_words, np.asarray(jc.alpha_time_words))
    assert tc.cross_edit_kind == jc.cross_edit_kind == "replace"
