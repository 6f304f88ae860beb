"""Tuning on a device mesh (fatezero_tpu_torch/parallel/sharding.py, trainer/ddpm_trainer.py) against one process, on the CPU.

Ranks are gloo processes spawned by fatezero_tpu_torch/scripts/dryrun_mesh.py
(`launch`), one launch per mesh shared by the file's tests through module
fixtures; the world of one runs in the test process on a one-process
`Mesh((1,1,1))`. fp32, the random:tiny geometry with the teaser's switches
(LoRA 160, ['mid'], least_sc_channel 64) and every weight redrawn with
fan-in scaling (as tests/test_torch_sharding.py), 4 frames of 128^2, so the
16^2-latent sites reach the FlashAttention Function (its plain versions on
the CPU).

* The differentiable collectives, (1,2,2): the gradient of a fixed random
  projection of each op's output, with respect to its input and to every
  parameter, on the mesh (the input's gradient gathered over 'seq', the
  parameters' summed over 'seq' and gathered over 'tensor') against the
  dense one-device computation: the sparse-causal halo ([-1, 'first'],
  ['mid'], [-2, 'last'], [1] and a hop past the neighbour), the temporal
  conv's halo (stride 1) and whole-clip form (stride 2, the resamplers),
  the GroupNorm over frames, and megatron's f and g around Attention,
  TemporalAttention and the GEGLU FeedForward. Within 1e-5 of the largest
  gradient: sums over ranks run in another order.
* One DDPMTrainer update on (1,2,2) with JAX's draws, for AdamW, AdamW8bit
  and Adafactor, with gradient checkpointing on and off, and one with prior
  preservation; one on (2,1,1) (data replicas) with prior preservation;
  each against the same update in a world of one: the loss within 1e-5
  relative, the updated trainables gathered whole within the tolerances of
  tests/test_torch_trainer.py (>= 99.9% of coordinates within 1e-3 lr, every
  one within 2.1 lr: AdamW's first step turns on the last bits of gradients
  near its eps, and the sums run in another order), the frozen weights
  untouched, and the optimizer state and masters of the world of one's
  layout. The checkpointed mesh update equals the uncheckpointed one within
  1e-7 lr (the recomputation repeats the forward's collectives in order).
* The JAX package's DDPMTrainer on params sharded over (1,2,2) of the 8
  virtual XLA devices (shard_params, GSPMD), one AdamW update from the same
  weights and draws, against the port's ranks, with the same tolerances.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fatezero_tpu_torch.convert.from_flax import unet_state_from_flax
from fatezero_tpu_torch.convert.to_flax import unet_state_to_flax, vae_state_to_flax
from fatezero_tpu_torch.models.attention import Attention, TemporalAttention
from fatezero_tpu_torch.models.layers import FeedForward, FusedGroupNorm
from fatezero_tpu_torch.ops import video_ops as V
from fatezero_tpu_torch.parallel.sharding import Mesh, seq_mesh_scope, shard_unet_, tensor_gather, tensor_layout
from fatezero_tpu_torch.scripts import dryrun_mesh as D
from fatezero_tpu_torch.trainer.ddpm_trainer import Draws
from test_torch_sharding import _fan_in_state

torch.set_num_threads(1)
# The JAX package is imported inside the tests that run it: the spawned ranks
# import this module for their functions and need only the port.
FRAMES, RES, LR, PRIOR = 4, 128, 1e-3, 0.5
SPECS = {"prev_first": [-1, "first"], "mid": ["mid"], "prev2_last": [-2, "last"], "next": [1], "hop": [-3, "first"]}
UPDATES = {  # name -> train_job keyword arguments
    "adamw": dict(optimizer="adamw"),
    "adamw_no_checkpointing": dict(optimizer="adamw", gradient_checkpointing=False),
    "adamw8bit": dict(optimizer="adamw8bit"),
    "adamw8bit_no_checkpointing": dict(optimizer="adamw8bit", gradient_checkpointing=False),
    "adafactor": dict(optimizer="adafactor"),
    "adafactor_no_checkpointing": dict(optimizer="adafactor", gradient_checkpointing=False),
    "adamw_prior": dict(optimizer="adamw", prior_preservation=PRIOR),
}
GRAD_TOL = 1e-5


def _draw(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# ------------------------------------------------------------ rank functions
def _grad_cases(rng):
    """(name, module or None, call(module, x), input) of each op held here."""
    x5 = _draw(rng, 2, FRAMES, 3, 3, 8)
    x4 = _draw(rng, 2, FRAMES, 6, 16)
    w, b = _draw(rng, 3, 8, 6), _draw(rng, 6)
    cases = [(f"halo_{n}", None, lambda m, x, s=spec: V.gather_sparse_kv(x, s, FRAMES), x4) for n, spec in SPECS.items()]
    cases += [
        ("temporal_conv", None, lambda m, x: V.temporal_conv(x, w, b), x5),
        ("temporal_conv_stride2", None, lambda m, x: V.temporal_conv(x, w, b, stride=2), x5),
        ("temporal_avgpool", None, lambda m, x: V.temporal_avgpool(x), x5),
        ("temporal_upsample", None, lambda m, x: V.temporal_linear_upsample_2x(x), x5),
    ]
    gn = FusedGroupNorm(4, 8, batch_dims=1)
    with torch.no_grad():
        gn.weight.copy_(1.0 + 0.1 * _draw(rng, 8))
        gn.bias.copy_(0.1 * _draw(rng, 8))
    cases.append(("group_norm_over_frames", gn, lambda m, x: m(x), 2.0 * x5 + 1.0))
    torch.manual_seed(3)
    temporal = TemporalAttention(16, 4, 4)
    torch.nn.init.normal_(temporal.to_out[0].weight, std=0.2)
    torch.nn.init.normal_(temporal.to_out[0].bias, std=0.2)
    ctx = _draw(rng, 2, 5, 12)
    cases += [
        ("attention_prev_first", Attention(16, 4, 4), lambda m, x: m(x, sparse_indices=[-1, "first"]), x4),
        ("cross_attention", Attention(16, 4, 4, cross_attention_dim=12), lambda m, x: m(x, ctx), x4),
        ("temporal_attention", temporal, lambda m, x: m(x), x4),
        ("geglu_feed_forward", FeedForward(16), lambda m, x: m(x), x4),
    ]
    return cases


def _grads(module, call, x, proj, mesh=None):
    """d(sum(call(module, x) * proj)) / d(x, each parameter); on a mesh x and
    proj hold this rank's frames and the module this rank's weights."""
    x = x.clone().requires_grad_()
    params = dict(module.named_parameters()) if module is not None else {}
    for p in params.values():
        p.grad = None
    with seq_mesh_scope(mesh):
        y = call(module, x)
        (y * proj.to(y.dtype)).sum().backward()
    return x.grad, {n: p.grad for n, p in params.items()}


def _collective_grads(mesh):
    """In a rank: each op's gradients on the mesh, made whole, beside the dense ones."""
    import copy

    rng = np.random.default_rng(11)
    out = {}
    for name, module, call, x in _grad_cases(rng):
        y = call(module, x)
        proj = _draw(np.random.default_rng(len(name)), *y.shape)
        dx, dparams = _grads(module, call, x, proj)
        sharded = None if module is None else shard_unet_(copy.deepcopy(module), mesh)
        layout = {} if module is None else tensor_layout(sharded)
        gx, gparams = _grads(sharded, call, mesh.local_frames(x), mesh.local_frames(proj), mesh)
        whole = {}
        for n, g in gparams.items():
            g = mesh._sum(g.clone(), "seq")  # each rank's frames' share of the gradient
            whole[n] = tensor_gather(g, *layout[n], mesh=mesh) if n in layout else g
        out[name] = dict(dx=(mesh.all_frames(gx), dx), params={n: (whole[n], dparams[n]) for n in dparams})
    return out


def _rank(mesh, path, updates, draws):
    out = {"grads": _collective_grads(mesh) if mesh.seq > 1 else None, "updates": {}}
    for name, kw in updates.items():
        d = None if kw.get("prior_preservation") else draws
        out["updates"][name] = D.train_job(mesh, path, lr=LR, draws=d, **kw)["float32"]
    return out


# ------------------------------------------------------------------ fixtures
def _jax_draws(key):
    """The draws JAX's _update makes from `key` (tests/test_torch_trainer.py)."""
    import jax
    import jax.numpy as jnp

    rng_t, rng_n, rng_vae, _ = jax.random.split(key, 4)
    lat = (FRAMES, RES // 8, RES // 8, 4)
    return Draws(t=torch.tensor(np.asarray(jax.random.randint(rng_t, (1,), 0, 1000))).long(),
                 noise=torch.tensor(np.asarray(jax.random.normal(rng_n, (1, *lat), jnp.float32))),
                 vae_noise=torch.tensor(np.asarray(jax.random.normal(rng_vae, lat, jnp.float32))))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    path = D.prepare(str(tmp / "inputs.pt"), frames=FRAMES, res=RES, steps=1, edits={})
    data = torch.load(path, weights_only=False)
    data["unet"] = _fan_in_state(data["unet"])
    data["vae"] = _fan_in_state(data["vae"], seed=4)
    data["class_images"] = np.random.default_rng(5).uniform(-1, 1, (1, RES, RES, 3)).astype(np.float32)
    torch.save(data, path)
    import jax

    key = jax.random.PRNGKey(0)
    draws = _jax_draws(key)
    ranks = D.launch(_rank, (1, 2, 2), "cpu", args=(path, UPDATES, draws), workdir=str(tmp))
    replicas = D.launch(_rank, (2, 1, 1), "cpu", args=(path, {"adamw_prior": UPDATES["adamw_prior"]}, draws),
                        workdir=str(tmp))
    one = Mesh((1, 1, 1), "cpu")
    single = {name: D.train_job(one, path, lr=LR, draws=None if kw.get("prior_preservation") else draws,
                                **kw)["float32"] for name, kw in UPDATES.items()}
    return dict(path=path, ranks=ranks, replicas=replicas, single=single, key=key, draws=draws)


# --------------------------------------------------------------------- tests
@pytest.mark.parametrize("name", [f"halo_{n}" for n in SPECS] + [
    "temporal_conv", "temporal_conv_stride2", "temporal_avgpool", "temporal_upsample", "group_norm_over_frames",
    "attention_prev_first", "cross_attention", "temporal_attention", "geglu_feed_forward"])
def test_collective_gradient_matches_dense(setup, name):
    for rank in setup["ranks"]:
        case = rank["grads"][name]
        got, ref = case["dx"]
        assert got.shape == ref.shape and float(ref.abs().max()) > 0
        torch.testing.assert_close(got, ref, atol=GRAD_TOL * float(ref.abs().max()), rtol=0)
        for n, (got, ref) in case["params"].items():
            assert got.shape == ref.shape, n
            torch.testing.assert_close(got, ref, atol=GRAD_TOL * float(ref.abs().max()), rtol=0, msg=n)


def _agree(got, ref):
    gaps = torch.cat([(got[n] - v).abs().reshape(-1) for n, v in ref.items()]) / LR
    assert float(gaps.max()) <= 2.1, float(gaps.max())
    assert float((gaps <= 1e-3).double().mean()) >= 0.999, float((gaps <= 1e-3).double().mean())


def _same_layout(a, b):
    """Two optimizer state dicts (or master dicts) of one structure, shapes and dtypes."""
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _same_layout(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_layout(x, y)
    elif torch.is_tensor(b):
        assert torch.is_tensor(a) and a.shape == b.shape and a.dtype == b.dtype
    else:
        assert a == b or isinstance(b, float)


@pytest.mark.parametrize("mesh,name", [("ranks", n) for n in UPDATES] + [("replicas", "adamw_prior")])
def test_update_matches_world_of_one(setup, mesh, name):
    ref = setup["single"][name]
    assert np.isfinite(ref["loss"]) and not ref["frozen_moved"]
    for rank in setup[mesh]:
        got = rank["updates"][name]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        assert not got["frozen_moved"]
        assert set(got["trainable"]) == set(ref["trainable"])
        _agree(got["trainable"], ref["trainable"])
        _same_layout(got["optimizer"], ref["optimizer"])
        _same_layout(got["master"], ref["master"])


def test_checkpointed_mesh_update_equals_uncheckpointed(setup):
    for rank in setup["ranks"]:
        for opt in ("adamw", "adamw8bit", "adafactor"):
            a, b = rank["updates"][opt], rank["updates"][f"{opt}_no_checkpointing"]
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-7)
            for n, v in b["trainable"].items():
                torch.testing.assert_close(a["trainable"][n], v, atol=1e-7 * LR, rtol=0, msg=n)


def test_tensor_ranks_hold_one_update(setup):
    """The gathered trainables and the masters are one tensor on every rank."""
    first = setup["ranks"][0]["updates"]["adamw"]
    for rank in setup["ranks"][1:]:
        for n, v in first["master"].items():
            assert torch.equal(rank["updates"]["adamw"]["master"][n], v), n


def test_update_matches_jax_sharded(setup):
    """The JAX package's DDPMTrainer, its params sharded over (1,2,2) of the
    virtual XLA devices, one AdamW update with the same weights and draws."""
    import jax
    import jax.numpy as jnp
    from fatezero_tpu.models.unet3d import UNet3DConfig as JConfig
    from fatezero_tpu.models.unet3d import UNetPseudo3DConditionModel as JUNet
    from fatezero_tpu.models.vae import AutoencoderKL as JVAE
    from fatezero_tpu.models.vae import VAEConfig as JVAEConfig
    from fatezero_tpu.parallel.sharding import make_mesh as jmake_mesh
    from fatezero_tpu.parallel.sharding import shard_params
    from fatezero_tpu.trainer import ddpm_trainer as JT

    data = torch.load(setup["path"], weights_only=False)
    cfg = data["unet_cfg"]
    jcfg = JConfig(block_out_channels=cfg.block_out_channels, attention_head_dim=cfg.attention_head_dim,
                   cross_attention_dim=cfg.cross_attention_dim, norm_num_groups=cfg.norm_num_groups,
                   lora=cfg.lora, sparse_causal_indices=cfg.sparse_causal_indices,
                   least_sc_channel=cfg.least_sc_channel, gradient_checkpointing=True)
    vcfg = JVAEConfig(**{f.name: getattr(data["vae_cfg"], f.name) for f in dataclasses.fields(JVAEConfig)})
    params = unet_state_to_flax({k: v.numpy() for k, v in data["unet"].items()})
    vae_params = vae_state_to_flax({k: v.numpy() for k, v in data["vae"].items()})
    mesh = jmake_mesh(jax.devices()[:4], (1, 2, 2))
    jtrainer = JT.DDPMTrainer(JUNet(cfg=jcfg), JVAE(cfg=vcfg), vae_params, None, None, learning_rate=LR,
                              train_temporal_conv=True)
    state = jtrainer.init_state(shard_params(params, mesh))
    with mesh:
        new, loss = jtrainer.step(state, jnp.asarray(data["video"]), jnp.asarray(data["emb_src"][-1:].numpy()),
                                  setup["key"])
    after = unet_state_from_flax(jax.tree.map(np.asarray, new["params"]))
    ref = {n: torch.from_numpy(np.asarray(after[n])) for n in setup["single"]["adamw"]["trainable"]}
    for rank in setup["ranks"]:
        got = rank["updates"]["adamw"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        _agree(got["trainable"], ref)
