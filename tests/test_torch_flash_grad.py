"""The port's differentiable flash attention (K1 + K2/K3) against the JAX package.

On the CPU the port's `FlashAttention` runs its plain versions
(`attention_with_lse` forward, `flash_bwd_reference` backward); the JAX side
differentiates `fatezero_tpu.ops.flash_attention.flash_attention`, whose
custom VJP runs the Pallas forward and the `_dq_kernel`/`_dkv_kernel`
backward in interpret mode (FZ_FLASH_INTERPRET=1, as
tests/test_flash_attention.py does). Shapes and tolerance (2e-4, fp32 on both
sides, sums in other orders) are those of that file's gradient test.

The tests marked `gpu` hold K1 (with its log-sum-exp), K2 and K3 against
their plain versions on the card; they skip where no CUDA device is present.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fatezero_tpu.ops import flash_attention as JFA
from fatezero_tpu_torch.ops import flash_attention as FA

torch.set_num_threads(1)
SHAPES = [(256, 256, 64), (300, 520, 40), (128, 640, 80)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FZ_FLASH_INTERPRET", "1")


def _qkv(sq, skv, d, seed, dv=None):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, n, w).astype(np.float32) for n, w in ((sq, d), (skv, d), (skv, dv or d))]


@pytest.mark.parametrize("sq,skv,d", SHAPES)
def test_grads_match_jax_kernels(sq, skv, d):
    q, k, v = _qkv(sq, skv, d, seed=sq + skv + d)
    scale = d**-0.5

    def loss_flash(q, k, v):
        return jnp.sum(jnp.sin(JFA.flash_attention(q, k, v, scale, block_q=128, block_kv=256)))

    ref = jax.grad(loss_flash, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = FA.flash_attention(tq, tk, tv, scale)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(torch.sin(out).sum(), (tq, tk, tv))
    for g, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4, rtol=2e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("sq,skv,d", SHAPES)
def test_lse_and_kernel_wrappers_on_cpu(sq, skv, d):
    """The forward's LSE is the row logsumexp, and the K2/K3 wrappers on a CPU
    tensor are flash_bwd_reference (the formulas of the JAX kernels)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(sq, skv, d, seed=7))
    do = torch.from_numpy(np.random.RandomState(8).randn(2, sq, d).astype(np.float32))
    scale = d**-0.5
    o, lse = FA.flash_forward(q, k, v, scale, with_lse=True)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(o, FA.xla_attention(q, k, v, scale), atol=2e-5, rtol=2e-5)
    dq, dk, dv = FA.flash_bwd_reference(q, k, v, o, lse, do, scale)
    torch.testing.assert_close(FA.flash_dq(q, k, v, o, lse, do, scale), dq, atol=0, rtol=0)
    for a, b in zip(FA.flash_dkv(q, k, v, o, lse, do, scale), (dk, dv)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_wide_v_backward_raises():
    """The double-wide V of the value-space edit is inference-only, as in JAX."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(256, 77, 40, seed=1, dv=80))
    out = FA.flash_attention(q, k, v, 40**-0.5)
    with pytest.raises(NotImplementedError):
        out.sum().backward()


def test_no_graph_without_grad():
    q, k, v = (torch.from_numpy(a) for a in _qkv(256, 77, 40, seed=2))
    assert FA.flash_attention(q, k, v, 40**-0.5).grad_fn is None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_kernels_match_plain(dtype):
    """K1 with LSE, K2 and K3 against their plain versions on the card, and the
    Function launching all three under autograd: path-like shapes, then the
    tile-edge shapes of chip_smoke.py's check_backward_edges (query counts and
    KV lengths around the 64-row tiles), then bf16 operands each in turn 2
    bytes off a 16-byte boundary."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1-K3 are CUDA kernels with no CPU mode)")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(4, 300, 77, 40), (2, 1024, 2048, 80), (2, 256, 512, 160)]
    shapes += [(2, sq, skv, d) for d in (40, 80, 160) for sq in (1, 63, 64, 65, 127, 129, 300)
               for skv in (1, 63, 64, 65, 77, 129, 200)]
    for rows, sq, skv, d in shapes:
        q, k, v, do = (torch.randn(rows, n, d, device="cuda", generator=gen).to(dt) for n in (sq, skv, skv, sq))
        scale = d**-0.5
        before = (FA.flash_forward.launches, FA.flash_dq.launches, FA.flash_dkv.launches)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        out = FA.flash_attention(qg, kg, vg, scale)
        assert out.grad_fn is not None
        grads = torch.autograd.grad(out, (qg, kg, vg), do)
        after = (FA.flash_forward.launches, FA.flash_dq.launches, FA.flash_dkv.launches)
        assert [b - a for a, b in zip(before, after)] == [1, 1, 1]
        o_ref, lse_ref = FA.attention_with_lse(q, k, v, scale)
        o, lse = FA.flash_forward(q, k, v, scale, with_lse=True)
        torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
        refs = FA.flash_bwd_reference(q, k, v, o, lse, do, scale)
        for g, r in zip(grads, refs):
            r = r.float()
            # fp32: summation order only; bf16: one unit in the last place at
            # the largest gradient (both round the same fp32 value)
            tol = 1e-4 * max(1.0, r.abs().max().item()) if dt == torch.float32 else 2**-7 * r.abs().max().item() + 1e-4
            torch.testing.assert_close(g.float(), r, atol=tol, rtol=0)
    if dt != torch.bfloat16:
        return

    def shifted(t):  # the same values, contiguous, 2 bytes off the boundary
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
        out = buf[1:1 + t.numel()].view(t.shape)
        out.copy_(t)
        return out

    for d in (40, 80, 160):
        q, k, v, do = (torch.randn(2, n, d, device="cuda", generator=gen).to(dt) for n in (129, 77, 77, 129))
        o, lse = FA.flash_forward(q, k, v, d**-0.5, with_lse=True)
        for which in range(5):
            ops = [shifted(t) if i == which else t for i, t in enumerate((q, k, v, o, do))]
            got = (FA.flash_dq(*ops[:4], lse, ops[4], d**-0.5), *FA.flash_dkv(*ops[:4], lse, ops[4], d**-0.5))
            for g, r in zip(got, FA.flash_bwd_reference(q, k, v, o, lse, do, d**-0.5)):
                r = r.float()
                torch.testing.assert_close(g.float(), r, atol=2**-7 * r.abs().max().item() + 1e-4, rtol=0)
