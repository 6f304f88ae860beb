"""The port's one-shot tuning trainer against the JAX package, at tiny width.

The UNet is the tiny geometry with the tuning switches of config/tune/jeep.yaml
(LoRA 160, gradient checkpointing, temporal convs trained); every flax leaf is
drawn with numpy (so every trainable parameter gets a gradient) and reaches
the port through convert/from_flax.py. Frames are 2; the 128x128 case puts
256 queries at the 16x16-latent sites, so they go through the port's
FlashAttention Function (its plain versions on the CPU).

Tolerances, fp32 on both sides: the loss to 1e-5 relative. AdamW's first
step moves each coordinate by lr * g / (|g| + 1e-8) plus decay; the clipped
gradients have norm 1 over ~2.3M coordinates and ~1% of them lie within a
decade of that eps, where the ratio turns on the last bits of the gradient,
whose sums run in other orders on the two sides (one at the rounding noise
could even flip its sign). So at least 99.9% of the trainable coordinates
are held to 1e-3 of the learning rate, and every one to a single step, 2.1 lr
(measured: 99.9% within 3.2e-4 lr, the worst at 0.43 lr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fatezero_tpu.models.unet3d import UNet3DConfig as JConfig
from fatezero_tpu.models.unet3d import UNetPseudo3DConditionModel as JUNet
from fatezero_tpu.models.vae import AutoencoderKL as JVAE
from fatezero_tpu.models.vae import VAEConfig as JVAEConfig
from fatezero_tpu.trainer import ddpm_trainer as JT
from fatezero_tpu_torch.convert.from_flax import unet_state_from_flax, vae_state_from_flax
from fatezero_tpu_torch.models.loader import TINY_UNET, TINY_VAE, load_state
from fatezero_tpu_torch.models.unet3d import UNet3DConfig, UNetPseudo3DConditionModel
from fatezero_tpu_torch.models.vae import AutoencoderKL
from fatezero_tpu_torch.ops import schedule as S
from fatezero_tpu_torch.trainer import ddpm_trainer as T

torch.set_num_threads(1)
TUNE = dict(lora=160, gradient_checkpointing=True)
F, LR = 2, 1e-3


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


@pytest.fixture(scope="module")
def models():
    jm = JUNet(cfg=JConfig(**TINY_UNET, **TUNE))
    params = _random_flax(jm, jnp.zeros((1, F, 8, 8, 4)), jnp.int32(1), jnp.zeros((1, 77, 32)), seed=4)
    jvae = JVAE(cfg=JVAEConfig(block_out_channels=TINY_VAE.block_out_channels, norm_num_groups=8))
    vae_params = _random_flax(jvae, jnp.zeros((1, 64, 64, 3)), seed=5)
    return jm, params, jvae, vae_params


def _port(params, vae_params):
    unet = UNetPseudo3DConditionModel(UNet3DConfig(**TINY_UNET, **TUNE), device="meta")
    load_state(unet, unet_state_from_flax(jax.tree.map(np.asarray, params)), "cpu")
    vae = AutoencoderKL(TINY_VAE, device="meta")
    load_state(vae, vae_state_from_flax(jax.tree.map(np.asarray, vae_params)), "cpu")
    return unet, vae


def _trainer(unet, vae, **kw):
    kw = {"learning_rate": LR, "train_temporal_conv": True, **kw}
    return T.DDPMTrainer(unet, vae, schedule=S.make_schedule(device="cpu"), **kw)


def test_trainable_names_match_jax_mask(models):
    """The port trains exactly the parameters whose flax leaves JAX's
    trainable_mask selects (LoRA pairs included, norm_temporal frozen)."""
    jm, params, jvae, vae_params = models
    mask = JT.trainable_mask(params, train_temporal_conv=True)
    flags = jax.tree.map(lambda m, p: np.full(np.shape(p), bool(m)), mask, params)
    image = {k: bool(v.all()) for k, v in unet_state_from_flax(flags).items()}
    unet, vae = _port(params, vae_params)
    trainer = _trainer(unet, vae)
    assert set(trainer.trainable) == {k for k, m in image.items() if m}
    assert any(".conv_temporal.down." in k for k in trainer.trainable)
    assert not any("norm_temporal" in k for k in trainer.trainable)
    frozen = {n for n, p in unet.named_parameters() if not p.requires_grad}
    assert frozen == {k for k, m in image.items() if not m}


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("res,prior", [(64, None), (128, None), (64, 0.5)], ids=["64", "128", "64-prior"])
def test_update_matches_jax(models, res, prior):
    """One update with JAX's own draws: loss, trainable params after the step,
    frozen params untouched; with prior preservation on one class image."""
    jm, params, jvae, vae_params = models
    rng = np.random.RandomState(res)
    images = (rng.rand(F, res, res, 3) * 2 - 1).astype(np.float32)
    emb = rng.randn(1, 77, 32).astype(np.float32)
    cls = (rng.rand(1, res, res, 3) * 2 - 1).astype(np.float32) if prior else None
    cls_emb = rng.randn(1, 77, 32).astype(np.float32) if prior else None
    key = jax.random.PRNGKey(res)

    jtrainer = JT.DDPMTrainer(jm, jvae, vae_params, None, None, learning_rate=LR, train_temporal_conv=True,
                              prior_preservation=prior)
    jstate = jtrainer.init_state(params)
    jcls = None if cls is None else (jnp.asarray(cls), jnp.asarray(cls_emb))
    jnew, jloss = jtrainer.step(jstate, jnp.asarray(images), jnp.asarray(emb), key, *(jcls or ()))

    # the draws JAX's _update makes from `key`
    rng_t, rng_n, rng_vae, rng2 = jax.random.split(key, 4)
    lat = (F, res // 8, res // 8, 4)
    draws = T.Draws(
        t=_t(jax.random.randint(rng_t, (1,), 0, 1000)).long(),
        noise=_t(jax.random.normal(rng_n, (1, *lat), jnp.float32)),
        vae_noise=_t(jax.random.normal(rng_vae, lat, jnp.float32)),
    )
    if prior:
        rng_t2, rng_n2 = jax.random.split(rng2)
        draws.class_t = _t(jax.random.randint(rng_t2, (1,), 0, 1000)).long()
        draws.class_noise = _t(jax.random.normal(rng_n2, (1, 1, *lat[1:]), jnp.float32))
        draws.class_vae_noise = _t(jax.random.normal(rng_vae, (1, *lat[1:]), jnp.float32))
    unet, vae = _port(params, vae_params)
    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    trainer = _trainer(unet, vae, prior_preservation=prior)
    state = trainer.init_state()
    tcls = () if cls is None else (torch.from_numpy(cls), torch.from_numpy(cls_emb))
    loss = trainer._update(state, torch.from_numpy(images), torch.from_numpy(emb), draws, *tcls)
    assert state["step"] == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    after = unet_state_from_flax(jax.tree.map(np.asarray, jnew["params"]))
    errs = []
    for name, p in unet.named_parameters():
        if name in trainer.trainable:
            errs.append(np.abs(p.detach().numpy() - after[name]).ravel())
            assert not torch.equal(p.detach(), before[name]), name
        else:
            assert torch.equal(p.detach(), before[name]), name
            np.testing.assert_array_equal(after[name], before[name].numpy(), err_msg=name)
    errs = np.concatenate(errs)
    assert errs.max() <= 2.1 * LR, errs.max() / LR
    assert np.mean(errs <= 1e-3 * LR) >= 0.999, np.mean(errs <= 1e-3 * LR)


def test_run_steps_deterministic_and_frozen(models):
    """run_steps with a random crop: same generator seed, same losses and params;
    frozen params bit-identical; trainable ones move."""
    _, params, _, vae_params = models
    frames = torch.from_numpy((np.random.RandomState(0).rand(F, 80, 96, 3) * 2 - 1).astype(np.float32))
    emb = torch.from_numpy(np.random.RandomState(1).randn(1, 77, 32).astype(np.float32))
    runs = []
    for _ in range(2):
        unet, vae = _port(params, vae_params)
        before = {n: p.detach().clone() for n, p in unet.named_parameters()}
        trainer = _trainer(unet, vae)
        state, losses = trainer.run_steps(trainer.init_state(), frames, emb, torch.Generator().manual_seed(7), 2,
                                          crop=(64, 64))
        assert losses.shape == (2,) and bool(torch.isfinite(losses).all()) and state["step"] == 2
        for n, p in unet.named_parameters():
            if n in trainer.trainable:
                assert not torch.equal(p.detach(), before[n]), n
            else:
                assert torch.equal(p.detach(), before[n]), n
        runs.append((losses, {n: p.detach().clone() for n, p in trainer.trainable.items()}))
    torch.testing.assert_close(runs[0][0], runs[1][0], atol=0, rtol=0)
    for n, p in runs[0][1].items():
        torch.testing.assert_close(p, runs[1][1][n], atol=0, rtol=0)


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit", "adafactor"])
def test_save_load_round_trip(models, tmp_path, optimizer):
    """A resumed run continues exactly as the uninterrupted one."""
    _, params, _, vae_params = models
    frames = torch.from_numpy((np.random.RandomState(2).rand(F, 64, 64, 3) * 2 - 1).astype(np.float32))
    emb = torch.from_numpy(np.random.RandomState(3).randn(1, 77, 32).astype(np.float32))

    unet, vae = _port(params, vae_params)
    trainer = _trainer(unet, vae, optimizer=optimizer)
    gen = torch.Generator().manual_seed(11)
    state, _ = trainer.run_steps(trainer.init_state(), frames, emb, gen, 1)
    T.save_training_state(str(tmp_path), state)
    gen_state = gen.get_state()
    _, straight = trainer.run_steps(state, frames, emb, gen, 1)

    unet2, vae2 = _port(params, vae_params)
    trainer2 = _trainer(unet2, vae2, optimizer=optimizer)
    state2 = T.load_training_state(str(tmp_path), trainer2, trainer2.init_state())
    assert state2["step"] == 1
    gen2 = torch.Generator()
    gen2.set_state(gen_state)
    _, resumed = trainer2.run_steps(state2, frames, emb, gen2, 1)
    torch.testing.assert_close(resumed, straight, atol=0, rtol=0)
    for n, p in trainer.trainable.items():
        torch.testing.assert_close(trainer2.trainable[n], p, atol=0, rtol=0)

    other = _trainer(*_port(params, vae_params), train_temporal_conv=False)
    with pytest.raises(ValueError):
        T.load_training_state(str(tmp_path), other, other.init_state())


@pytest.mark.parametrize(
    "name,warmup",
    [("constant", 0), ("constant_with_warmup", 5), ("linear", 0), ("linear", 5), ("cosine", 5),
     ("cosine_with_restarts", 0), ("polynomial", 3)],
)
def test_lr_schedule_matches_optax(name, warmup):
    ref = JT.make_lr_schedule(name, 1e-4, 40, warmup, num_cycles=3, power=2.0)
    got = T.make_lr_schedule(name, 1e-4, 40, warmup, num_cycles=3, power=2.0)
    for step in range(0, 50):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, atol=1e-12, err_msg=f"step {step}")


def test_schedule_training_ops_match_jax():
    """add_noise, get_velocity and ddpm_step against the JAX schedule."""
    from fatezero_tpu.ops import schedule as JS

    rng = np.random.RandomState(0)
    x = rng.randn(2, 2, 4, 4, 4).astype(np.float32)
    n = rng.randn(2, 2, 4, 4, 4).astype(np.float32)
    t = np.array([3, 700])
    js, ts = JS.make_schedule(), S.make_schedule(device="cpu")
    for fn in ("add_noise", "get_velocity"):
        ref = getattr(JS, fn)(js, jnp.asarray(x), jnp.asarray(n), jnp.asarray(t))
        got = getattr(S, fn)(ts, torch.from_numpy(x), torch.from_numpy(n), torch.from_numpy(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6, err_msg=fn)
    for step in (0, 1, 500, 999):
        ref = JS.ddpm_step(js, jnp.asarray(n[:1]), jnp.asarray(step), jnp.asarray(x[:1]), jnp.asarray(n[1:]))
        got = S.ddpm_step(ts, torch.from_numpy(n[:1]), step, torch.from_numpy(x[:1]), torch.from_numpy(n[1:]))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5, err_msg=f"ddpm t={step}")


def test_gradient_checkpointing_keeps_gradients(models):
    """Recomputing each block in the backward pass gives the gradients of the
    plain backward (same ops, same order: identical in fp32 on the CPU)."""
    _, params, _, _ = models
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(1, F, 16, 16, 4).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(1, 77, 32).astype(np.float32))
    grads = []
    for remat in (True, False):
        unet = UNetPseudo3DConditionModel(UNet3DConfig(**TINY_UNET, **{**TUNE, "gradient_checkpointing": remat}),
                                          device="meta")
        load_state(unet, unet_state_from_flax(jax.tree.map(np.asarray, params)), "cpu")
        unet(x, torch.tensor([500]), ctx).square().mean().backward()
        grads.append({n: p.grad for n, p in unet.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][n], atol=1e-7, rtol=1e-6, msg=n)
