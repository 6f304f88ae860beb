"""The port's edit modes against the JAX package and against each other, at tiny width.

The tiny UNet with jeep_posche_local_latent_blend's model_config (lora 160,
the default sparse-causal [-1, 'first']), F=2, 16x16 latents, a replace
controller (cross 0.5, self 0.5) with blend_words [['silver', 'jeep'],
['Porsche', 'car']] and both blends (th 0.3), 3 DDIM steps. One
module-scoped fixture inverts with the port and runs the JAX package's
edit_fast(stored=...) once at strength 1 and once at 0.5 on the port's own
trajectory and payload (in JAX's at-rest layout), so that the comparison
sees the edit alone: the inversion and its payload are held to JAX by
tests/test_torch_pipeline.py, and the capture at this model_config by the
drop_replay_rows cases here.

Held to JAX: the stored edit with both blends (latent and the aux masks),
strength 0.5, and drop_replay_rows (a capture-only forward and a 3-row
forward at 40x40 latents, where the last up block is past the controlled
size; at 16x16 nothing is dropped). Held to a torch mode already held to
JAX: replay to stored, inline to stored (a replay with
use_inversion_attention and no attention blend IS the inline mode), hybrid
(k = 2 of 4 steps, a stored prefix, a replay middle and an identity-gated
stored tail where the controller leaves one) to replay, under both blends'
settings and both use_inversion_attention settings, and viz to stored.

Tolerances, fp32 on both sides: edited latents 1e-5 x max|x| against JAX
(as tests/test_torch_pipeline.py; measured ~6e-6, see _random_flax) and
against torch replay or stored (measured 0: the same maps, the same
forward); against the inline mode 1e-4 x max|x| (a 3-row batch sums in
another order and CFG 7.5 amplifies it); captured maps and (q, k) 1e-4
absolute (values up to ~1 and sharp softmaxes). The blend masks threshold
m / max(m): each mask is held exactly, and every normalised map the edit
thresholds is shown to keep clear of its threshold by BAND, so no pixel
could flip between two runs that agree to within the tolerance.
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
from fatezero_tpu.pipelines.fatezero_pipeline import _payload_at_rest
from fatezero_tpu.ptp.context import StoreContext as JStoreContext
from fatezero_tpu.ptp.controller import make_controller as jmake_controller
from fatezero_tpu_torch.convert.from_flax import unet_state_from_flax
from fatezero_tpu_torch.models.loader import load_state
from fatezero_tpu_torch.models.unet3d import UNet3DConfig, UNetPseudo3DConditionModel
from fatezero_tpu_torch.pipelines import fatezero_pipeline as FP
from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
from fatezero_tpu_torch.ptp import spatial_blend as SB
from fatezero_tpu_torch.ptp.context import StoreContext
from fatezero_tpu_torch.ptp.controller import make_controller

torch.set_num_threads(1)
TINY = dict(block_out_channels=(32, 64, 128, 128), attention_head_dim=4, cross_attention_dim=16, norm_num_groups=8)
MODEL = dict(lora=160)
F, HW, STEPS, HYBRID_STEPS = 2, 16, 3, 4
SOURCE = "a silver jeep driving down a curvy road"
TARGET = "a Porsche car driving down a curvy road"
WORDS = [["silver", "jeep"], ["Porsche", "car"]]
JAX_TOL, INLINE_TOL = 1e-5, 1e-4
BAND = 1e-4


def _controller(make, tok, steps=STEPS, blend_latents=True, blend_self_attention=True, cross=0.5, **kw):
    return make(
        tok, [SOURCE, TARGET], num_steps=steps, is_replace_controller=True, cross_replace_steps=cross,
        self_replace_steps=0.5, blend_words=WORDS, blend_th=[0.3, 0.3], blend_latents=blend_latents,
        blend_self_attention=blend_self_attention, **kw,
    )


def _random_flax(model, *args, seed=0):
    """Every leaf drawn from numpy; the cross-attention q and k kernels 3x
    larger, so that the cross maps vary over the image and the blend masks
    are neither all 1 nor all 0 (at 1x every map is within 20 % of its max,
    and every mask is 1). Sharper attention amplifies the two packages'
    rounding from step to step: ~2e-5 x max|x| after the 3 inversion steps,
    which is why the JAX edit starts from the port's trajectory."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(seed)

    def fill(path, s):
        keys = [str(getattr(k, "key", k)) for k in path]
        name = keys[-1]
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        gain = 3.0 if "attn2" in keys and keys[-2] in ("to_q", "to_k") else 1.0
        return (gain * rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)

    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), [fill(p, s) for p, s in flat])


class _Thresholds:
    """Records m / max(m) and the threshold of every blend_mask the pipeline calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, maps, alpha, target_hw, th, use_pool=True):
        norm = SB.blend_map(maps, alpha, target_hw, use_pool)
        self.calls.append((norm, th))
        return (norm > th).float()

    def margin(self):
        return min(float((norm - th).abs().min()) for norm, th in self.calls)


@pytest.fixture(scope="module")
def run():
    cfg = {**TINY, **MODEL}
    jm = JUNet(cfg=JConfig(**cfg))
    params = _random_flax(jm, jnp.zeros((1, F, HW, HW, 4)), jnp.int32(1), jnp.zeros((1, 77, 16)), seed=7)
    tok = StubTokenizer()
    rng = np.random.RandomState(8)
    lat = rng.randn(1, F, HW, HW, 4).astype(np.float32)
    emb_src = rng.randn(2, 77, 16).astype(np.float32)
    emb_tgt = rng.randn(2, 77, 16).astype(np.float32)

    tm = UNetPseudo3DConditionModel(UNet3DConfig(**cfg))
    load_state(tm, unet_state_from_flax(jax.tree.map(np.asarray, params)), "cpu")
    pipe = FateZeroPipeline(tm, None, None, tok, store_dtype=torch.float32, device="cpu")
    es, et = torch.from_numpy(emb_src), torch.from_numpy(emb_tgt)
    traj, stored = pipe.invert_fast(torch.from_numpy(lat), es, STEPS, capture=True)

    jpipe = JPipeline(jm, params, None, None, None, None, tok, store_dtype=jnp.float32)
    jstored = _payload_at_rest(jax.tree.map(lambda t: jnp.asarray(t.numpy()), stored))
    jax_out = {}
    for strength in (1.0, 0.5):
        jout, jaux = jpipe.edit_fast(
            jnp.asarray(traj.numpy()), jnp.asarray(emb_src), jnp.asarray(emb_tgt),
            _controller(jmake_controller, tok), STEPS, strength=strength, stored=jstored,
        )
        jax_out[strength] = (np.asarray(jout), jax.tree.map(np.asarray, jaux))
    return dict(jm=jm, params=params, tm=tm, tok=tok, pipe=pipe, lat=lat, es=es, et=et, traj=traj, stored=stored,
                jax_out=jax_out)


def _edit(run, controller, steps=STEPS, traj=None, **kw):
    """edit_fast with every blend threshold recorded: (latent, aux, smallest |m/max - th|)."""
    rec = _Thresholds()
    mp = pytest.MonkeyPatch()
    mp.setattr(FP, "blend_mask", rec)
    try:
        out, aux = run["pipe"].edit_fast(
            run["traj"] if traj is None else traj, run["es"], run["et"], controller, steps, **kw
        )
    finally:
        mp.undo()
    return out, aux, (rec.margin() if rec.calls else None)


@pytest.fixture(scope="module")
def stored_edit(run):
    return _edit(run, _controller(make_controller, run["tok"]), stored=run["stored"])


def _close(a, b, tol):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, atol=tol * np.abs(b).max(), rtol=0)


def test_stored_blended_edit_matches_jax(run, stored_edit):
    out, aux, margin = stored_edit
    jout, jaux = run["jax_out"][1.0]
    assert margin > BAND, f"a blend map lies within {margin:.2e} of its threshold"
    assert tuple(out.shape) == (1, F, HW, HW, 4)
    assert sorted(aux) == sorted(jaux) == ["attn_mask", "latent_mask"]
    assert tuple(aux["attn_mask"].shape) == (STEPS, 1, F, HW, HW)  # the largest controlled self site
    assert tuple(aux["latent_mask"].shape) == (STEPS, 2, F, HW, HW)
    for key in aux:
        np.testing.assert_array_equal(aux[key].numpy(), jaux[key])
    assert 0 < aux["latent_mask"].mean() < 1 and 0 < aux["attn_mask"].mean() < 1
    _close(out, jout, JAX_TOL)


def test_strength_matches_jax(run):
    out, aux, margin = _edit(run, _controller(make_controller, run["tok"]), stored=run["stored"], strength=0.5)
    jout, jaux = run["jax_out"][0.5]
    n_used = int(STEPS * 0.5)
    assert margin > BAND
    assert aux["latent_mask"].shape[0] == aux["attn_mask"].shape[0] == n_used
    for key in aux:
        np.testing.assert_array_equal(aux[key].numpy(), jaux[key])
    _close(out, jout, JAX_TOL)


def test_replay_matches_stored(run, stored_edit):
    out, aux, margin = _edit(run, _controller(make_controller, run["tok"]))
    assert margin > BAND
    for key in stored_edit[1]:
        np.testing.assert_array_equal(aux[key].numpy(), stored_edit[1][key].numpy())
    _close(out, stored_edit[0], JAX_TOL)


def test_inline_matches_stored(run):
    """No attention blend and use_inversion_attention: the replay runs inline."""
    ctl = _controller(make_controller, run["tok"], blend_self_attention=False)
    out, aux, margin = _edit(run, ctl)
    ref, ref_aux, ref_margin = _edit(run, ctl, stored=run["stored"])
    assert min(margin, ref_margin) > BAND
    np.testing.assert_array_equal(aux["latent_mask"].numpy(), ref_aux["latent_mask"].numpy())
    _close(out, ref, INLINE_TOL)


@pytest.mark.parametrize("use_inversion_attention", [True, False], ids=["inv-attn", "no-inv-attn"])
@pytest.mark.parametrize("blend_self_attention", [True, False], ids=["attn-blend", "no-attn-blend"])
@pytest.mark.parametrize("blend_latents", [True, False], ids=["latent-blend", "no-latent-blend"])
def test_hybrid_matches_replay(run, blend_latents, blend_self_attention, use_inversion_attention):
    """k = 2 payload rows of 4 steps: a stored prefix of 2 steps, then replay
    up to the edit window (cross 0.75: 3 steps without blends, all 4 with),
    then, without blends, one identity-gated stored step that reads row 0.
    The blend sums carry across the segments."""
    pipe, tok = run["pipe"], run["tok"]
    blends = blend_latents or blend_self_attention

    def ctl():
        return _controller(make_controller, tok, HYBRID_STEPS, blend_latents, blend_self_attention, cross=0.75,
                           use_inversion_attention=use_inversion_attention)

    lat = torch.from_numpy(run["lat"])
    per_step = pipe.capture_payload_bytes(lat, 1)
    plan = pipe.plan_capture(lat, HYBRID_STEPS, ctl().edit_window(HYBRID_STEPS), 2.5 * per_step,
                             use_inversion_attention=use_inversion_attention)
    assert plan == ((2, 2) if use_inversion_attention else (0, 2))
    window = ctl().edit_window(HYBRID_STEPS)
    assert window == (HYBRID_STEPS if blends else 3)  # a tail of identity steps without blends
    traj, stored = pipe.invert_fast(lat, run["es"], HYBRID_STEPS, capture=True, capture_rows=plan)
    assert FP._payload_rows(stored) == 2
    out, aux, margin = _edit(run, ctl(), HYBRID_STEPS, traj, stored=stored, stored_row0=plan[0])
    ref, ref_aux, ref_margin = _edit(run, ctl(), HYBRID_STEPS, traj)
    if blends:
        assert min(margin, ref_margin) > BAND
    for key in ref_aux:
        np.testing.assert_array_equal(aux[key].numpy(), ref_aux[key].numpy())
    inline_ref = use_inversion_attention and not blend_self_attention
    _close(out, ref, INLINE_TOL if inline_ref else JAX_TOL)


def test_viz_cross_avg(run, stored_edit):
    out, aux, _ = _edit(run, _controller(make_controller, run["tok"]), stored=run["stored"], viz=True)
    avg = aux["cross_avg"]
    assert tuple(avg.shape) == (1, F, (HW // 4) ** 2, 77)
    np.testing.assert_allclose(avg.sum(-1).numpy(), 1.0, atol=1e-5)
    # the blends already materialise the viz sites: nothing else moves
    np.testing.assert_array_equal(out.numpy(), stored_edit[0].numpy())


@pytest.mark.parametrize("mode", ["capture_only", "three_rows", "low_res"])
def test_drop_replay_rows_matches_jax(run, mode):
    hw = HW if mode == "low_res" else 40  # at 40^2 the last up block has 1600 > 1024 queries
    rows = 1 if mode == "capture_only" else 3
    rng = np.random.RandomState(9)
    x = rng.randn(rows, F, hw, hw, 4).astype(np.float32)
    ctx_emb = rng.randn(rows, 77, 16).astype(np.float32)
    @jax.jit
    def jax_forward(params, x, emb):
        jctx = JStoreContext(save_self_attention=False, store_dtype=jnp.float32, self_qk=True)
        out = run["jm"].apply(params, x, jnp.int32(500), emb, attn_ctx=jctx, drop_replay_rows=1)
        return out, jctx.captured, jctx.captured_qk

    jout, jcaptured, jcaptured_qk = jax_forward(run["params"], jnp.asarray(x), jnp.asarray(ctx_emb))
    tctx = StoreContext(save_self_attention=False, store_dtype=torch.float32, self_qk=True)
    with torch.inference_mode():
        tout = run["tm"](torch.from_numpy(x), 500, torch.from_numpy(ctx_emb), attn_ctx=tctx, drop_replay_rows=1)
    if mode == "capture_only":
        assert tout is None and jout is None
    else:
        assert tuple(tout.shape) == tuple(jout.shape) == ((3 if mode == "low_res" else 2), F, hw, hw, 4)
        _close(tout, jout, JAX_TOL)
    n = 0
    for key, maps in jcaptured.items():
        assert len(tctx.captured[key]) == len(maps), key
        for a, b in zip(maps, tctx.captured[key]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0)
            n += 1
    for key, pairs in jcaptured_qk.items():
        for (qa, ka), (qb, kb) in zip(pairs, tctx.captured_qk[key]):
            np.testing.assert_allclose(qb.numpy(), np.asarray(qa), atol=1e-4, rtol=0)
            np.testing.assert_allclose(kb.numpy(), np.asarray(ka), atol=1e-4, rtol=0)
            n += 1
    assert n > 0


def test_capture_payload_bytes_predicts_the_payload(run):
    pipe, lat = run["pipe"], torch.from_numpy(run["lat"])
    stored = run["stored"]
    actual = sum(t.numel() * t.element_size() for t in FP._payload_leaves(stored))
    assert pipe.capture_payload_bytes(lat, STEPS) == actual
    _, part = pipe.invert_fast(lat, run["es"], STEPS, capture=True, capture_rows=(1, 1))
    assert sum(t.numel() * t.element_size() for t in FP._payload_leaves(part)) == pipe.capture_payload_bytes(lat, 1)


@pytest.mark.parametrize("use_inversion_attention", [True, False])
def test_plan_capture_at_three_budgets(run, use_inversion_attention):
    pipe, lat = run["pipe"], torch.from_numpy(run["lat"])
    per_step = pipe.capture_payload_bytes(lat, 1)
    kw = dict(use_inversion_attention=use_inversion_attention)
    assert pipe.plan_capture(lat, 10, 10, 10 * per_step, **kw) == (0, 10)
    assert pipe.plan_capture(lat, 10, 10, 4.5 * per_step, **kw) == ((6, 4) if use_inversion_attention else (0, 4))
    assert pipe.plan_capture(lat, 10, 3, 4.5 * per_step, **kw) == ((7, 3) if use_inversion_attention else (0, 3))
    assert pipe.plan_capture(lat, 10, 10, 4.5 * per_step, strength=0.5, **kw) == (
        (1, 4) if use_inversion_attention else (0, 4))
    assert pipe.plan_capture(lat, 10, 10, 0.5 * per_step, **kw) is None
