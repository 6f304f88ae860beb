"""The port's optimizers against optax, on the same sequence of gradients.

* `AdamW8bit` (trainer/adam8bit.py) against the JAX package's `adamw8bit`:
  parameters and the int8 moment codes and scales after each step. Both sides
  compute in fp32 with the same operation order; log1p/expm1 may differ in
  the last bit between the two libraries, so a code may land one step over
  at a rounding boundary: codes are held to 1 step and to at most 0.1% of
  them differing, scales to 1e-6 relative.
* torch's `AdamW`, as the trainer builds it, against `optax.adamw`: the
  decoupled decay p(1 - lr wd) of torch and the added wd p of optax give the
  same parameters up to fp32 rounding.

Parameters are held to 2e-7 of the largest parameter per step taken (about
two fp32 units in the last place per step); a wrong update rule (decay,
bias correction, step size) moves them by ~lr * wd or more, orders above.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fatezero_tpu.trainer.adam8bit import adamw8bit
from fatezero_tpu_torch.trainer.adam8bit import AdamW8bit, _dequantize, _quantize

torch.set_num_threads(1)
SHAPES = [(300,), (64, 40), (8, 3, 3, 3)]


def _grads(steps, seed=0):
    rng = np.random.RandomState(seed)
    # magnitudes spread over ~3 decades, as real gradients are
    return [[(rng.randn(*s) * np.exp(rng.randn(*s))).astype(np.float32) for s in SHAPES] for _ in range(steps)]


def _close(p, ref, steps):
    np.testing.assert_allclose(p, ref, rtol=0, atol=2e-7 * steps * np.abs(ref).max())


def _params(seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


def test_quantize_matches_jax():
    from fatezero_tpu.trainer.adam8bit import _dequantize as jdeq
    from fatezero_tpu.trainer.adam8bit import _quantize as jq

    x = _grads(1)[0][1]
    q, scale = _quantize(torch.from_numpy(x), 256)
    ref = jq(jnp.asarray(x), 256)
    np.testing.assert_allclose(scale.numpy(), np.asarray(ref.scale), rtol=1e-6)
    assert np.abs(q.numpy().astype(int) - np.asarray(ref.q).astype(int)).max() <= 1
    back = _dequantize(q, scale, x.shape, 256).numpy()
    np.testing.assert_allclose(back, np.asarray(jdeq(ref, x.shape, 256)), rtol=2e-2, atol=1e-6)


def test_adamw8bit_matches_jax():
    lr, wd, steps = 1e-2, 1e-2, 10
    params = _params()
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = AdamW8bit(tparams, lr=lr, weight_decay=wd)
    tx = adamw8bit(lr, weight_decay=wd)
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    for step, grads in enumerate(_grads(steps), start=1):
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for i, (p, jp) in enumerate(zip(tparams, jparams)):
            _close(p.detach().numpy(), np.asarray(jp), step)
            st = opt.state[p]
            for key, jq in (("m", jstate[0].m[i]), ("v", jstate[0].v[i])):
                codes = st[f"{key}_q"].numpy().astype(int)
                ref = np.asarray(jq.q).astype(int)
                assert np.abs(codes - ref).max() <= 1, key
                assert np.mean(codes != ref) <= 1e-3, key
                np.testing.assert_allclose(st[f"{key}_scale"].numpy(), np.asarray(jq.scale), rtol=1e-6)
        assert int(jstate[0].count) == opt.state[tparams[0]]["step"]


def test_state_is_int8_blockwise():
    p = torch.nn.Parameter(torch.zeros(1000))
    p.grad = torch.ones(1000)
    opt = AdamW8bit([p], lr=1e-3)
    opt.step()
    st = opt.state[p]
    assert st["m_q"].dtype == torch.int8 and st["m_q"].numel() == 1024
    assert st["m_scale"].shape == (4,) and st["v_scale"].dtype == torch.float32


@pytest.mark.parametrize("lr,wd", [(1e-2, 1e-2), (1e-3, 0.1)])
def test_torch_adamw_matches_optax(lr, wd):
    params = _params(seed=2)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = torch.optim.AdamW(tparams, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    tx = optax.adamw(lr, weight_decay=wd)
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    for grads in _grads(20, seed=3):
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    for p, jp in zip(tparams, jparams):
        _close(p.detach().numpy(), np.asarray(jp), 20)
