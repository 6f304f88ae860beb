"""K4's module, the port's LayerNorm Function, against the JAX package.

`fatezero_tpu.ops.fused_norm.layer_norm` runs its Pallas kernel in interpret
mode (patched as tests/test_fused_norm.py does); its VJP is autodiff of
`_ln_math`. The port's `layer_norm` runs `_ln_math` on a CPU tensor (K4's
plain version) with the same backward. Tolerances, fp32 on both sides: 2e-5
on the forward (the JAX package's own bound against flax), 1e-4 on the
gradients, which sum over rows (scale, bias) or columns (x).

The test marked `gpu` holds K4 against `_ln_math` on the card; it skips where
no CUDA device is present.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fatezero_tpu.ops import fused_norm as JFN
from fatezero_tpu_torch.models.layers import FusedLayerNorm
from fatezero_tpu_torch.ops import fused_norm as FN

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    orig = JFN.pl.pallas_call
    monkeypatch.setattr(JFN.pl, "pallas_call", functools.partial(orig, interpret=True))
    monkeypatch.setattr(JFN.jax, "default_backend", lambda: "tpu")


def _inputs(r, c, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, r, c) * 3 + 1).astype(np.float32)
    scale = (rng.randn(c) * 0.2 + 1).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    g = rng.randn(2, r, c).astype(np.float32)
    return x, scale, bias, g


@pytest.mark.parametrize("r,c", [(256, 320), (300, 1280), (8, 64), (77, 768)])
def test_layer_norm_forward_and_vjp_match_jax(r, c):
    x, scale, bias, g = _inputs(r, c, seed=r + c)
    jx, js, jb = jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)
    ref, vjp = jax.vjp(lambda x, s, b: JFN.layer_norm(x, s, b, 1e-5), jx, js, jb)
    ref_grads = vjp(jnp.asarray(g))
    tx, ts, tb = (torch.from_numpy(a).requires_grad_() for a in (x, scale, bias))
    out = FN.layer_norm(tx, ts, tb, 1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    grads = torch.autograd.grad(out, (tx, ts, tb), torch.from_numpy(g))
    for got, want, name in zip(grads, ref_grads, ("x", "scale", "bias")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4, err_msg=name)


def test_fused_layer_norm_flag(monkeypatch):
    """FusedLayerNorm takes the K4 Function only under FZ_PALLAS_LN=1, as the
    JAX module does, and both routes compute the same function."""
    x, scale, bias, _ = _inputs(16, 320, seed=3)
    mod = FusedLayerNorm(320)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_()
    monkeypatch.delenv("FZ_PALLAS_LN", raising=False)
    plain = mod(xt)
    monkeypatch.setenv("FZ_PALLAS_LN", "1")
    fused = mod(xt)
    assert type(fused.grad_fn).__name__ != type(plain.grad_fn).__name__
    assert "LayerNorm" in type(fused.grad_fn).__name__
    torch.testing.assert_close(fused, plain, atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is a CUDA kernel with no CPU mode)")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, c in [(4096, 320), (300, 640), (77, 768), (1024, 1280)]:
        x = (2 * torch.randn(rows, c, device="cuda", generator=gen) + 0.5).to(dt)
        scale = 1 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
        before = FN.layer_norm_kernel.launches
        out = FN.layer_norm_kernel(x, scale, bias, 1e-5)
        assert FN.layer_norm_kernel.launches == before + 1 and out.dtype == dt
        ref = FN._ln_math(x, scale, bias, 1e-5).float()
        # fp32: summation order only; bf16: one unit in the last place at the largest output
        tol = 1e-5 * max(1.0, ref.abs().max().item()) if dt == torch.float32 else 2**-7 * ref.abs().max().item()
        torch.testing.assert_close(out.float(), ref, atol=tol, rtol=0)
