"""K1's module, fatezero_tpu_torch.ops.flash_attention, against the JAX package.

On the CPU the port's `flash_attention` computes with its plain version; the
JAX side runs its Pallas kernel in interpret mode (FZ_FLASH_INTERPRET=1, as
tests/test_flash_attention.py does). Tolerance 2e-5: fp32 on both sides, the
Pallas kernel's online softmax sums in another order than one softmax (the
JAX package's own flash test uses the same bound).

The test marked `gpu` holds the CUDA kernel against the plain version on the
card; it skips where no CUDA device is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fatezero_tpu.ops import flash_attention as JFA
from fatezero_tpu_torch.ops import flash_attention as FA

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FZ_FLASH_INTERPRET", "1")


def _qkv(shape_q, shape_k, shape_v, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in (shape_q, shape_k, shape_v)]


@pytest.mark.parametrize("sq", [256, 300])
@pytest.mark.parametrize("skv", [77, 256, 300])
@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("wide_v", [False, True])
def test_flash_matches_jax_kernel(sq, skv, d, wide_v):
    dv = 2 * d if wide_v else d
    q, k, v = _qkv((2, sq, d), (2, skv, d), (2, skv, dv), seed=sq + skv + d + dv)
    scale = d**-0.5
    ref = JFA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    assert got.shape == (2, sq, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("sq,skv,d", [(256, 77, 40), (300, 300, 80)])
def test_negative_scale_matches_jax_kernel(sq, skv, d):
    """A negative scale, which the JAX kernel takes: on the card the wrapper
    launches K1 with -q and -scale (chip_smoke.py holds that to the plain
    version), on the CPU it is the plain version."""
    q, k, v = _qkv((2, sq, d), (2, skv, d), (2, skv, d), seed=sq + skv + 1)
    scale = -(d**-0.5)
    ref = JFA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("s", [64, 256])
def test_fused_attention_5d_frame_broadcast(s, monkeypatch):
    """5-D [b, f, h, s, d] queries against a frame-broadcast [b, 1, h, 77, d]
    cross context: >= 256 queries fold to kernel rows (JAX _fold_flash, the
    Pallas kernel), fewer take the plain math (JAX xla_attention)."""
    b, f, h, d, kv = 2, 3, 2, 40, 77
    q, k, v = _qkv((b, f, h, s, d), (b, 1, h, kv, d), (b, 1, h, kv, d), seed=s)
    scale = d**-0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    ref = JFA._fold_flash(jq, jk, jv, scale) if s >= 256 else JFA.xla_attention(jq, jk, jv, scale)

    folded = []
    real_flash = FA.flash_attention

    def recording_flash(q3, k3, v3, scale):
        folded.append((tuple(q3.shape), tuple(k3.shape), tuple(v3.shape)))
        return real_flash(q3, k3, v3, scale)

    monkeypatch.setattr(FA, "flash_attention", recording_flash)
    got = FA.fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if s >= 256:
        assert folded == [((b * f * h, s, d), (b * f * h, kv, d), (b * f * h, kv, d))]
    else:
        assert folded == []


def test_plain_attention_softmax_in_fp32():
    """bf16 inputs: the plain version computes in fp32 and returns bf16."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv((1, 8, 40), (1, 77, 40), (1, 77, 40), 3))
    out = FA.xla_attention(q, k, v, 40**-0.5)
    ref = FA.xla_attention(q.float(), k.float(), v.float(), 40**-0.5)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref, atol=2**-7 * ref.abs().max().item(), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel with no CPU mode)")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    # path-like shapes, then the tile-edge shapes of chip_smoke.py: KV lengths
    # around the 64-key tile, a ragged query tile, every head dim
    shapes = [(4, 300, 77, 40, 40), (2, 1024, 1024, 80, 160), (2, 256, 256, 160, 160)]
    shapes += [(2, sq, skv, d, d) for d in (40, 80, 160) for sq in (256, 300) for skv in (1, 63, 64, 65, 77, 128, 129, 200)]
    for rows, sq, skv, d, dv in shapes:
        q = torch.randn(rows, sq, d, device="cuda", generator=gen).to(dt)
        k = torch.randn(rows, skv, d, device="cuda", generator=gen).to(dt)
        v = torch.randn(rows, skv, dv, device="cuda", generator=gen).to(dt)
        before = FA.flash_forward.launches
        out = FA.flash_attention(q, k, v, d**-0.5)
        assert FA.flash_forward.launches == before + 1
        ref = FA.xla_attention(q, k, v, d**-0.5)
        tol = 1e-4 if dt == torch.float32 else 2**-7 * ref.float().abs().max().item() + 1e-4
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
