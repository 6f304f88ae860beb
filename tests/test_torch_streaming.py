"""The port's streaming store (invert, sample, AttentionStore) against the JAX package, at tiny width.

The tiny UNet with jeep_posche_local_latent_blend's model_config (lora 160,
the default sparse-causal [-1, 'first']), F=2, 16x16 latents, 3 DDIM steps,
every flax leaf drawn from numpy with the cross-attention q and k 3x larger
so that the blend masks vary (as tests/test_torch_edit_modes.py). One
module-scoped fixture runs both packages' `invert(store=...)` once; the
edits then run in both packages from the port's store and trajectory (JAX
gets a copy of them in its own AttentionStore), so each comparison sees the
edit alone.

Held to JAX: the inversion's trajectory and every stored map; `sample` with
the teaser's refine + reweight controller, with a replace controller and
both blends (latent, and the blenders' recorded masks, exactly), with both
blends at strength 0.5, the 'save' loop (its latent and captured maps) and
the swap edit against that save store (use_inversion_attention false, both
blends); `sample` without a controller is `sample_fast`. The disk store
holds what the memory store holds, and an edit from it equals the edit from
memory bit for bit.

Tolerances, fp32 on both sides: trajectory 1e-4 x max|x| (sharp attention
amplifies the two packages' rounding over the 3 inversion steps, ~2e-5 x
max|x|), the maps the inversion and the save loop store 5e-4 absolute
(probabilities of the sharp cross sites, which three passes of the two
packages' rounding move by up to 1.6e-4); edited latents 1e-5 x max|x| (as
tests/test_torch_pipeline.py). Each blend mask thresholds m / max(m): masks are held
exactly, with every normalised map shown to keep clear of its threshold by
BAND, so no pixel could flip between two runs that agree within tolerance.
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
from fatezero_tpu.ptp.controller import make_controller as jmake_controller
from fatezero_tpu.ptp.store import AttentionStore as JStore
from fatezero_tpu_torch.convert.from_flax import unet_state_from_flax
from fatezero_tpu_torch.models.loader import load_state
from fatezero_tpu_torch.models.unet3d import UNet3DConfig, UNetPseudo3DConditionModel
from fatezero_tpu_torch.pipelines import fatezero_pipeline as FP
from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
from fatezero_tpu_torch.ptp.controller import make_controller
from fatezero_tpu_torch.ptp.store import AttentionStore
from test_torch_edit_modes import _random_flax, _Thresholds  # the cross q/k 3x larger

torch.set_num_threads(1)
TINY = dict(block_out_channels=(32, 64, 128, 128), attention_head_dim=4, cross_attention_dim=16, norm_num_groups=8)
MODEL = dict(lora=160)
F, HW, STEPS = 2, 16, 3
SOURCE = "a silver jeep driving down a curvy road"
TARGET = "a Porsche car driving down a curvy road"
WORDS = [["silver", "jeep"], ["Porsche", "car"]]
TEASER_TARGET = "watercolor painting of a silver jeep driving down a curvy road"
TRAJ_TOL, STORE_TOL, EDIT_TOL = 1e-4, 5e-4, 1e-5
BAND = 1e-4


CONTROLLERS = {
    "refine_reweight": dict(prompts=[SOURCE, TEASER_TARGET], is_replace_controller=False, cross_replace_steps=0.8,
                            self_replace_steps=0.8, eq_params={"words": ["watercolor"], "values": [10]}),
    "replace_blends": dict(prompts=[SOURCE, TARGET], is_replace_controller=True, cross_replace_steps=0.5,
                           self_replace_steps=0.5, blend_words=WORDS, blend_th=[0.3, 0.3], blend_latents=True,
                           blend_self_attention=True),
}


def _controller(make, tok, kind, **kw):
    c = dict(CONTROLLERS[kind])
    prompts = c.pop("prompts")
    return make(tok, prompts, num_steps=STEPS, **c, **kw)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _jax_store(store: AttentionStore) -> JStore:
    """The JAX package's store holding a copy of the port's maps and latents."""
    js = JStore()
    for i in range(store.num_steps):
        js.append_step({k: [_np(m) for m in v] for k, v in store.step_maps(i).items()}, _np(store.latents_store[i]))
    return js


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
    store = AttentionStore()
    traj = pipe.invert(torch.from_numpy(lat), torch.from_numpy(emb_src), STEPS, store=store)

    jpipe = JPipeline(jm, params, None, None, None, None, tok, store_dtype=jnp.float32)
    jstore = JStore()
    jtraj = jpipe.invert(jnp.asarray(lat), jnp.asarray(emb_src), STEPS, store=jstore)
    return dict(pipe=pipe, jpipe=jpipe, tok=tok, store=store, traj=traj, jstore=jstore, jtraj=jtraj,
                emb_tgt=emb_tgt, copy=_jax_store(store))


def test_invert_store_matches(run):
    traj, jtraj = run["traj"], run["jtraj"]
    assert len(traj) == len(jtraj) == STEPS + 1
    scale = max(float(np.abs(j).max()) for j in jtraj)
    for t, j in zip(traj, jtraj):
        assert tuple(t.shape) == (1, F, HW, HW, 4)
        np.testing.assert_allclose(t.numpy(), j, atol=TRAJ_TOL * scale, rtol=0)
    store, jstore = run["store"], run["jstore"]
    assert store.num_steps == jstore.num_steps == STEPS
    n = 0
    for i in range(STEPS):
        ours, theirs = store.step_maps(i), jstore.step_maps(i)
        assert set(ours) == set(theirs)
        for key in theirs:
            assert len(ours[key]) == len(theirs[key]), key
            for a, b in zip(ours[key], theirs[key]):
                assert tuple(a.shape) == b.shape
                np.testing.assert_allclose(a.numpy(), b, atol=STORE_TOL, rtol=0)
                n += 1
        np.testing.assert_allclose(store.latents_store[i].numpy(), np.asarray(jstore.latents_store[i]),
                                   atol=TRAJ_TOL * scale, rtol=0)
    assert n > 0 and all(b > 0 for b in store.step_bytes)
    avg, javg = store.get_average_attention(), jstore.get_average_attention()
    for key in javg:
        for a, b in zip(avg[key], javg[key]):
            np.testing.assert_allclose(a.numpy(), b, atol=STORE_TOL, rtol=0)


@pytest.mark.parametrize(
    "kind,strength",
    [("refine_reweight", 1.0), ("replace_blends", 1.0), ("replace_blends", 0.5)],
    ids=["refine_reweight", "replace_blends", "blends_strength_0.5"],
)
def test_sample_edit_matches_jax(run, monkeypatch, kind, strength):
    pipe, jpipe, tok, store, traj = run["pipe"], run["jpipe"], run["tok"], run["store"], run["traj"]
    n_used = STEPS if strength == 1.0 else int(STEPS * strength)
    init = traj[n_used]
    jctl, ctl = _controller(jmake_controller, tok, kind), _controller(make_controller, tok, kind)
    jout = jpipe.sample(jnp.asarray(init.numpy()), jnp.asarray(run["emb_tgt"]), STEPS, controller=jctl,
                        inv_store=run["copy"], inverted_latents=[t.numpy() for t in traj], strength=strength)
    thresholds = _Thresholds()
    monkeypatch.setattr(FP, "blend_mask", thresholds)
    out = pipe.sample(init, torch.from_numpy(run["emb_tgt"]), STEPS, controller=ctl, inv_store=store,
                      inverted_latents=traj, strength=strength)
    jout = np.asarray(jout)
    assert tuple(out.shape) == (1, F, HW, HW, 4)
    np.testing.assert_allclose(out.numpy(), jout, atol=EDIT_TOL * np.abs(jout).max(), rtol=0)
    for name in ("latent_blend", "attention_blend"):
        ours, theirs = getattr(ctl, name), getattr(jctl, name)
        if theirs is None:
            assert ours is None
            continue
        assert ours.counter == theirs.counter == n_used
        assert len(ours.mask_list) == len(theirs.mask_list) == n_used
        for a, b in zip(ours.mask_list, theirs.mask_list):
            np.testing.assert_array_equal(a, np.asarray(b))
    if kind == "replace_blends":
        masks = np.stack(ctl.latent_blend.mask_list)
        assert 0.0 < masks.mean() < 1.0, "the masks must vary for this test to see them"
        assert thresholds.margin() > BAND


def test_save_then_swap_matches_jax(run):
    """use_inversion_attention false: the first prompt's 'save' loop captures
    its own maps, the second edits against them with both blends."""
    pipe, jpipe, tok, traj = run["pipe"], run["jpipe"], run["tok"], run["traj"]
    init, emb = traj[STEPS], run["emb_tgt"]
    save, jsave = AttentionStore(), JStore()
    lat = pipe.sample(init, torch.from_numpy(emb[::-1].copy()), STEPS, edit_store=save)
    jlat = jpipe.sample(jnp.asarray(init.numpy()), jnp.asarray(emb[::-1].copy()), STEPS, edit_store=jsave)
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), atol=EDIT_TOL * np.abs(np.asarray(jlat)).max(), rtol=0)
    assert save.num_steps == jsave.num_steps == STEPS
    for i in range(STEPS):
        for key, maps in jsave.step_maps(i).items():
            assert len(save.step_maps(i)[key]) == len(maps)
            for a, b in zip(save.step_maps(i)[key], maps):
                np.testing.assert_allclose(a.numpy(), b, atol=STORE_TOL, rtol=0)

    kw = dict(use_inversion_attention=False)
    jctl = _controller(jmake_controller, tok, "replace_blends", **kw)
    ctl = _controller(make_controller, tok, "replace_blends", **kw)
    jout = np.asarray(jpipe.sample(
        jnp.asarray(init.numpy()), jnp.asarray(emb), STEPS, controller=jctl, inv_store=_jax_store(save),
        inverted_latents=[init.numpy()] + [t.numpy() for t in save.latents_store]))
    out = pipe.sample(init, torch.from_numpy(emb), STEPS, controller=ctl, inv_store=save,
                      inverted_latents=[init] + list(save.latents_store))
    np.testing.assert_allclose(out.numpy(), jout, atol=EDIT_TOL * np.abs(jout).max(), rtol=0)
    for a, b in zip(ctl.latent_blend.mask_list, jctl.latent_blend.mask_list):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_sample_without_controller_is_sample_fast(run):
    pipe, traj = run["pipe"], run["traj"]
    emb = torch.from_numpy(run["emb_tgt"])
    for strength in (1.0, 0.5):
        a = pipe.sample(traj[-1], emb, STEPS, strength=strength)
        b = pipe.sample_fast(traj[-1], emb, STEPS, strength=strength)
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_disk_store_round_trip(run, tmp_path):
    """The disk store pickles one file per step and reads back what the memory
    store holds; an edit from it is the edit from memory, bit for bit."""
    pipe, tok, traj = run["pipe"], run["tok"], run["traj"]
    disk = AttentionStore(disk_store=True, store_dir=str(tmp_path / "store"))
    dtraj = pipe.invert(traj[0], torch.from_numpy(run["emb_tgt"][::-1].copy()), STEPS, store=disk)
    mem = AttentionStore()
    mtraj = pipe.invert(traj[0], torch.from_numpy(run["emb_tgt"][::-1].copy()), STEPS, store=mem)
    assert sorted(p.name for p in (tmp_path / "store").iterdir()) == [f"{i:03d}.pkl" for i in range(STEPS)]
    assert all(isinstance(e, str) for e in disk.attention_store_all_step)
    for a, b in zip(dtraj, mtraj):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    for i in range(STEPS):
        for key, maps in mem.step_maps(i).items():
            for a, b in zip(disk.step_maps(i)[key], maps):
                torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert disk.step_bytes == mem.step_bytes
    outs = []
    for store, tr in ((disk, dtraj), (mem, mtraj)):
        ctl = _controller(make_controller, tok, "replace_blends")
        outs.append(pipe.sample(tr[-1], torch.from_numpy(run["emb_tgt"]), STEPS, controller=ctl, inv_store=store,
                                inverted_latents=tr))
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
