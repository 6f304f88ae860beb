"""fatezero_tpu_torch.ops.schedule against the JAX package's schedule.

Same timesteps, model outputs and samples (numpy, seeded) go through both.
Tolerance: 1e-6 relative, fp32 arithmetic of the same closed-form formulas
(only rounding of sqrt/division may differ in the last bit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fatezero_tpu.ops import schedule as JS
from fatezero_tpu_torch.ops import schedule as S

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("beta_schedule", ["scaled_linear", "linear", "squaredcos_cap_v2"])
@pytest.mark.parametrize("set_alpha_to_one", [False, True])
def test_tables_and_grid(beta_schedule, set_alpha_to_one):
    js = JS.make_schedule(beta_schedule=beta_schedule, set_alpha_to_one=set_alpha_to_one)
    ts = S.make_schedule(beta_schedule=beta_schedule, set_alpha_to_one=set_alpha_to_one, device="cpu")
    np.testing.assert_array_equal(np.asarray(js.betas), ts.betas.numpy())
    np.testing.assert_array_equal(np.asarray(js.alphas_cumprod), ts.alphas_cumprod.numpy())
    assert float(js.final_alpha_cumprod) == float(ts.final_alpha_cumprod)
    for steps in (3, 10, 50):
        np.testing.assert_array_equal(JS.ddim_timesteps(js, steps), S.ddim_timesteps(ts, steps))


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_steps_match(prediction_type):
    js = JS.make_schedule(prediction_type=prediction_type)
    ts = S.make_schedule(prediction_type=prediction_type, device="cpu")
    rng = np.random.RandomState(0)
    sample = rng.randn(1, 2, 4, 4, 4).astype(np.float32)
    out = rng.randn(1, 2, 4, 4, 4).astype(np.float32)
    steps = 10
    for t in S.ddim_timesteps(ts, steps):
        t = int(t)
        for name in ("ddim_invert_step", "ddim_denoise_step"):
            ref = getattr(JS, name)(js, jnp.asarray(out), jnp.int32(t), jnp.asarray(sample), steps)
            got = getattr(S, name)(ts, torch.from_numpy(out), t, torch.from_numpy(sample), steps)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        x0_ref, eps_ref = JS.pred_original_sample(js, jnp.asarray(out), jnp.int32(t), jnp.asarray(sample))
        x0, eps = S.pred_original_sample(ts, torch.from_numpy(out), torch.tensor(t), torch.from_numpy(sample))
        np.testing.assert_allclose(x0.numpy(), np.asarray(x0_ref), **TOL)
        np.testing.assert_allclose(eps.numpy(), np.asarray(eps_ref), **TOL)


def test_per_batch_timesteps_and_cfg():
    js, ts = JS.make_schedule(), S.make_schedule(device="cpu")
    rng = np.random.RandomState(1)
    sample = rng.randn(2, 2, 4, 4, 4).astype(np.float32)
    out = rng.randn(2, 2, 4, 4, 4).astype(np.float32)
    t = np.array([1, 901])  # t - T/S < 0 for the first row: the final-alpha boundary
    ref = JS.ddim_denoise_step(js, jnp.asarray(out), jnp.asarray(t), jnp.asarray(sample), 10)
    got = S.ddim_denoise_step(ts, torch.from_numpy(out), torch.from_numpy(t), torch.from_numpy(sample), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    ref = JS.classifier_free_guidance(jnp.asarray(out[:1]), jnp.asarray(out[1:]), 7.5)
    got = S.classifier_free_guidance(torch.from_numpy(out[:1]), torch.from_numpy(out[1:]), 7.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
