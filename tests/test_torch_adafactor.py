"""The port's Adafactor (trainer/adafactor.py) against optax.adafactor.

The optimizer alone: four steps of optax.adafactor(learning_rate) at its
defaults and of the port's Adafactor on the same parameters and gradients,
drawn with numpy: a factored matrix (both dims >= 128), a matrix with one
small dim (a full second moment), a 1-D vector, a 4-D conv kernel (factored
over its two largest dims), a tensor whose RMS is below the 1e-3 floor, and
a gradient large enough that the block-RMS clip acts. Held to 1e-6 relative
to each parameter's largest magnitude after every step (fp32; the factors'
means sum in other orders).

One `DDPMTrainer(optimizer="adafactor")` update on the tiny tuning UNet
against the JAX trainer's with the same draws (as tests/test_torch_trainer.py
does for AdamW). At the first step the unfactored update is
lr * RMS(p) * g / |g|: a coordinate whose gradient is at the rounding noise
of the two packages' sums can flip its sign, so at least 99.9 % of the
trainable coordinates are held to 1e-3 of lr * max(RMS(p), 1e-3) and every
one to a single step's width, 2.1 of it; the loss to 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fatezero_tpu.trainer import ddpm_trainer as JT
from fatezero_tpu_torch.convert.from_flax import unet_state_from_flax
from fatezero_tpu_torch.trainer import ddpm_trainer as T
from fatezero_tpu_torch.trainer.adafactor import Adafactor, factored_dims

torch.set_num_threads(1)
SHAPES = {"factored": (256, 384), "one_small_dim": (64, 300), "vector": (300,), "conv4d": (160, 128, 3, 3),
          "tiny_rms": (130, 140)}
LR, STEPS = 1e-2, 4


def test_factored_dims_match_optax():
    from optax._src.factorized import _factored_dims

    for shape in list(SHAPES.values()) + [(128, 128), (3, 128, 129), (127, 1000), (1000, 128, 2)]:
        assert factored_dims(shape) == _factored_dims(shape, True, 128), shape


def test_optimizer_matches_optax():
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    params["tiny_rms"] *= 1e-4
    grads = [{k: (rng.randn(*s) * (30.0 if i == 2 else 1.0)).astype(np.float32) for k, s in SHAPES.items()}
             for i in range(STEPS)]

    tx = optax.adafactor(learning_rate=LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = Adafactor(list(tp.values()), lr=LR)
    for i in range(STEPS):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads[i].items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[i][k])
        opt.step()
        for k, p in tp.items():
            ref = np.asarray(jp[k])
            np.testing.assert_allclose(p.numpy(), ref, atol=1e-6 * np.abs(ref).max(), rtol=0,
                                       err_msg=f"{k} after step {i + 1}")
    assert set(opt.state[tp["factored"]]) == {"step", "v_row", "v_col"}
    assert set(opt.state[tp["vector"]]) == {"step", "v"}
    assert opt.state[tp["conv4d"]]["v_row"].shape == (128, 3, 3)  # the 160 dim reduced
    assert opt.state[tp["conv4d"]]["v_col"].shape == (160, 3, 3)


def test_update_matches_jax(tmp_path):
    """One adafactor update of the tiny tuning UNet with JAX's own draws."""
    from test_torch_trainer import F, TUNE, _port, _random_flax, _t

    from fatezero_tpu.models.unet3d import UNet3DConfig as JConfig
    from fatezero_tpu.models.unet3d import UNetPseudo3DConditionModel as JUNet
    from fatezero_tpu.models.vae import AutoencoderKL as JVAE
    from fatezero_tpu.models.vae import VAEConfig as JVAEConfig
    from fatezero_tpu_torch.models.loader import TINY_UNET, TINY_VAE
    from fatezero_tpu_torch.ops import schedule as S

    jm = JUNet(cfg=JConfig(**TINY_UNET, **TUNE))
    params = _random_flax(jm, jnp.zeros((1, F, 8, 8, 4)), jnp.int32(1), jnp.zeros((1, 77, 32)), seed=4)
    jvae = JVAE(cfg=JVAEConfig(block_out_channels=TINY_VAE.block_out_channels, norm_num_groups=8))
    vae_params = _random_flax(jvae, jnp.zeros((1, 64, 64, 3)), seed=5)
    res, lr = 64, 1e-3
    rng = np.random.RandomState(9)
    images = (rng.rand(F, res, res, 3) * 2 - 1).astype(np.float32)
    emb = rng.randn(1, 77, 32).astype(np.float32)
    key = jax.random.PRNGKey(9)

    jtrainer = JT.DDPMTrainer(jm, jvae, vae_params, None, None, learning_rate=lr, train_temporal_conv=True,
                              optimizer="adafactor")
    jnew, jloss = jtrainer.step(jtrainer.init_state(params), jnp.asarray(images), jnp.asarray(emb), key)
    rng_t, rng_n, rng_vae, _ = jax.random.split(key, 4)
    lat = (F, res // 8, res // 8, 4)
    draws = T.Draws(
        t=_t(jax.random.randint(rng_t, (1,), 0, 1000)).long(),
        noise=_t(jax.random.normal(rng_n, (1, *lat), jnp.float32)),
        vae_noise=_t(jax.random.normal(rng_vae, lat, jnp.float32)),
    )
    unet, vae = _port(params, vae_params)
    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    trainer = T.DDPMTrainer(unet, vae, schedule=S.make_schedule(device="cpu"), learning_rate=lr,
                            train_temporal_conv=True, optimizer="adafactor")
    state = trainer.init_state()
    assert isinstance(state["optimizer"], Adafactor)
    loss = trainer._update(state, torch.from_numpy(images), torch.from_numpy(emb), draws)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    after = unet_state_from_flax(jax.tree.map(np.asarray, jnew["params"]))
    errs, moved = [], 0
    for name, p in unet.named_parameters():
        if name in trainer.trainable:
            b = before[name].double()
            step = lr * max(float(b.square().mean().sqrt()), 1e-3)
            errs.append(np.abs(p.detach().numpy() - after[name]).ravel() / step)
            moved += not torch.equal(p.detach(), before[name])
        else:
            assert torch.equal(p.detach(), before[name]), name
    # a parameter the loss does not reach has a zero gradient and stays (no decay here)
    assert moved > 0.9 * len(trainer.trainable), (moved, len(trainer.trainable))
    errs = np.concatenate(errs)
    assert errs.max() <= 2.1, errs.max()
    assert np.mean(errs <= 1e-3) >= 0.999, np.mean(errs <= 1e-3)

    # the optimizer state resumes
    T.save_training_state(str(tmp_path), state)
    unet2, vae2 = _port(params, vae_params)
    trainer2 = T.DDPMTrainer(unet2, vae2, schedule=S.make_schedule(device="cpu"), learning_rate=lr,
                             train_temporal_conv=True, optimizer="adafactor")
    state2 = T.load_training_state(str(tmp_path), trainer2, trainer2.init_state())
    for p, p2 in zip(state["optimizer"].param_groups[0]["params"], state2["optimizer"].param_groups[0]["params"]):
        for k, v in state["optimizer"].state[p].items():
            v2 = state2["optimizer"].state[p2][k]
            assert (v == v2) if not torch.is_tensor(v) else torch.equal(v, v2)


@pytest.mark.parametrize("bad", ["sgd"])
def test_unknown_optimizer_raises(bad):
    with pytest.raises(ValueError, match="unknown optimizer"):
        T.DDPMTrainer(torch.nn.Linear(2, 2), torch.nn.Linear(2, 2), optimizer=bad)
