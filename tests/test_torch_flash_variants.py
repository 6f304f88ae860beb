"""K1b and K1c (fatezero_tpu_torch.ops.flash_variants) and the boundary probe
(fatezero_tpu_torch.scripts.bench_kernel_boundary) against the JAX scripts.

On the CPU the port's wrappers compute with their plain versions; the JAX
side runs the scripts' Pallas kernels in interpret mode. Inputs are fp32,
drawn with numpy from a seed.

* K1b: `flash_bf16_reference` against scripts/bench_flash_variants.py's
  `flash_bf16` (its `pl.pallas_call` wrapped with interpret=True), with the
  same KV tile: P is rounded to bf16 relative to the running max of its tile,
  so the tile is part of the function. Tolerance atol 1e-4 for all but 0.1 %
  of the outputs: both round the same fp32 values to bf16 and differ by fp32
  summation order; the rest are probabilities rounded one bf16 unit apart,
  each within one unit of the largest probability times max|v|. A reference
  that rounds P at the row's final max misses 1e-4 in ~20 % of the outputs.
* K1c: `merged_attention_reference` against scripts/bench_kernel_boundary.py's
  `_fwd_call_merged` (FZ_FLASH_INTERPRET=1). Tolerance 2e-5, K1's: fp32 on
  both sides, the online softmax sums in another order than one softmax.
* The site: the port's `site_ship` and `site_merged` against the JAX
  `site_merged` at a small size. Tolerance 1e-4 * max(1, max|ref|): fp32
  LayerNorm, four projections and attention, summed in other orders.

Tests marked `gpu` hold each CUDA kernel against its plain version on the
card; they skip where no CUDA device is present.
"""
import functools
import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fatezero_tpu_torch.ops import flash_variants as FV
from fatezero_tpu_torch.scripts import bench_kernel_boundary as TB

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    """Import scripts/<name>.py by path, leaving jax's compilation cache
    setting and sys.path as they were (the scripts change both)."""
    cache_dir, path = jax.config.jax_compilation_cache_dir, list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def jax_variants():
    return _load_script("bench_flash_variants")


@pytest.fixture(scope="module")
def jax_boundary():
    return _load_script("bench_kernel_boundary")


def _randn(rng, *shapes):
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize(
    "sq,skv,d,dv", [(256, 200, 40, 40), (128, 77, 40, 80), (256, 300, 80, 80)], ids=["ragged2tiles", "cross-wideV", "d80-3tiles"]
)
def test_k1b_reference_matches_jax_kernel(jax_variants, monkeypatch, sq, skv, d, dv):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    q, k, v = _randn(np.random.RandomState(sq + skv + d + dv), (2, sq, d), (2, skv, d), (2, skv, dv))
    scale = d**-0.5
    block_kv = 128  # the JAX call's KV tile: min(block_kv, round_up(skv, 128))
    ref = np.asarray(jax_variants.flash_bf16(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, 128, block_kv))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = FV.flash_bf16_reference(tq, tk, tv, scale, block_kv)
    assert got.shape == (2, sq, dv) and got.dtype == torch.float32
    err = np.abs(got.numpy() - ref)
    # a probability that XLA's and torch's exp (or S summed in another order)
    # put on either side of a bf16 rounding midpoint rounds one unit apart
    # (2^-7 p), moving its row by up to 2^-7 * (p / l) * |v|
    s = (tq * scale).bfloat16().float() @ tk.bfloat16().float().transpose(-1, -2)
    one_unit = 2**-7 * torch.softmax(s, dim=-1).max().item() * np.abs(v).max()
    assert (err > 1e-4).mean() <= 1e-3 and err.max() <= one_unit, (err.max(), (err > 1e-4).mean())
    if skv > block_kv:
        # the trap: rounding P at the row's final max (one tile) is another
        # function, off by more than 1e-4 in ~20 % of the outputs
        one_tile = FV.flash_bf16_reference(tq, tk, tv, scale, skv).numpy()
        assert (np.abs(one_tile - ref) > 1e-4).mean() > 0.05


def test_k1b_cpu_wrapper_uses_the_kernel_tile():
    q, k, v = map(torch.from_numpy, _randn(np.random.RandomState(1), (1, 64, 40), (1, 200, 40), (1, 200, 40)))
    ref = FV.flash_bf16_reference(q, k, v, 0.2, FV.K1B_BLOCK_KV)
    torch.testing.assert_close(FV.flash_bf16(q, k, v, 0.2), ref, atol=0, rtol=0)
    header = open(os.path.join(REPO, "fatezero_tpu_torch", "csrc", "flash_fwd.cuh")).read()
    assert int(re.search(r"constexpr int MMA_BK = (\d+);", header).group(1)) == FV.K1B_BLOCK_KV
    bf = FV.flash_bf16(*(t.to(torch.bfloat16) for t in (q, k, v)), 0.2)
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("sq,skv,d,heads", [(256, 77, 40, 3), (300, 300, 80, 2), (256, 77, 160, 2)])
def test_k1c_reference_matches_jax_kernel(jax_boundary, monkeypatch, sq, skv, d, heads):
    monkeypatch.setenv("FZ_FLASH_INTERPRET", "1")
    q, k, v = _randn(np.random.RandomState(sq + skv + d), (2, sq, heads * d), (2, skv, heads * d), (2, skv, heads * d))
    scale = d**-0.5
    ref = np.asarray(jax_boundary._fwd_call_merged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, 1024, 4096, heads))
    got = FV.flash_merged(*map(torch.from_numpy, (q, k, v)), scale, heads)
    assert got.shape == (2, sq, heads * d)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_k1c_negative_scale_matches_jax_kernel(jax_boundary, monkeypatch):
    """K1c at a negative scale, which the JAX kernel takes (the wrapper hands
    the card -q and -scale)."""
    monkeypatch.setenv("FZ_FLASH_INTERPRET", "1")
    sq, skv, d, heads = 256, 77, 40, 2
    q, k, v = _randn(np.random.RandomState(5), (2, sq, heads * d), (2, skv, heads * d), (2, skv, heads * d))
    scale = -(d**-0.5)
    ref = np.asarray(jax_boundary._fwd_call_merged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, 1024, 4096, heads))
    got = FV.flash_merged(*map(torch.from_numpy, (q, k, v)), scale, heads)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("site", ["ship", "merged"])
def test_boundary_site_matches_jax(jax_boundary, monkeypatch, site):
    monkeypatch.setenv("FZ_FLASH_INTERPRET", "1")
    b, f, s, kv, c = 1, 2, 256, 512, jax_boundary.C
    for name, value in dict(B=b, F=f, S=s, KV=kv, DTYPE=jnp.float32).items():
        monkeypatch.setattr(jax_boundary, name, value)
    rng = np.random.RandomState(7)
    x, kv_x = _randn(rng, (b, f, s, c), (b, f, kv, c))
    ws = [0.02 * w for w in _randn(rng, *[(c, c)] * 4)]
    g, b2 = 1.0 + 0.1 * rng.randn(c).astype(np.float32), 0.1 * rng.randn(c).astype(np.float32)
    args = [x, kv_x, *ws, g, b2]
    ref = np.asarray(jax_boundary.site_merged(*map(jnp.asarray, args)))
    fn = TB.site_ship if site == "ship" else TB.site_merged
    got = fn(*map(torch.from_numpy, args), heads=jax_boundary.H).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4 * max(1.0, np.abs(ref).max()), rtol=0)


def test_probe_defaults_are_full_width(jax_boundary):
    """The port's probe runs the JAX probe's site by default."""
    assert (TB.B, TB.F, TB.S, TB.C, TB.H, TB.KV) == (
        jax_boundary.B, jax_boundary.F, jax_boundary.S, jax_boundary.C, jax_boundary.H, jax_boundary.KV)
    assert TB.C // TB.H == jax_boundary.D and TB.DTYPE == torch.bfloat16
    import inspect

    for fn in (TB.site_ship, TB.site_merged):
        assert inspect.signature(fn).parameters["heads"].default == jax_boundary.H
    params = inspect.signature(TB.make_inputs).parameters
    assert params["device"].default == "cuda"
    assert [params[n].default for n in ("b", "f", "s", "c", "kv")] == [2, 8, 4096, 320, 8192]


def test_probe_mains_need_cuda(monkeypatch):
    from fatezero_tpu_torch.scripts import bench_flash_variants as TV

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (TV.main, TB.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_k1b_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1b is a CUDA kernel with no CPU mode)")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    # path-like shapes, then the tile-edge shapes of chip_smoke.py
    shapes = [(4, 300, 77, 40, 40), (2, 1024, 1024, 80, 80), (2, 256, 256, 160, 160)]
    shapes += [(2, sq, skv, d, d) for d in (40, 80, 160) for sq in (256, 300) for skv in (1, 63, 64, 65, 77, 128, 129, 200)]
    for rows, sq, skv, d, dv in shapes:
        q, k = (torch.randn(rows, n, d, device="cuda", generator=gen).to(dt) for n in (sq, skv))
        v = torch.randn(rows, skv, dv, device="cuda", generator=gen).to(dt)
        before = FV.flash_bf16.launches
        out = FV.flash_bf16(q, k, v, d**-0.5)
        assert FV.flash_bf16.launches == before + 1 and out.dtype == dt
        ref = FV.flash_bf16_reference(q, k, v, d**-0.5, FV.K1B_BLOCK_KV)
        # both round the same values to bf16; P may round the other way where
        # the two exps differ in the last fp32 place: one bf16 unit
        torch.testing.assert_close(out.float(), ref.float(), atol=2**-7 * ref.float().abs().max().item() + 1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_k1c_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1c is a CUDA kernel with no CPU mode)")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    # path-like shapes, then the tile-edge shapes of chip_smoke.py
    shapes = [(2, 8, 300, 77, 40), (2, 4, 1024, 2048, 80), (2, 2, 256, 77, 160)]
    shapes += [(2, 2, sq, skv, d) for d in (40, 80, 160) for sq in (256, 300) for skv in (1, 63, 64, 65, 77, 128, 129, 200)]
    for rows, heads, sq, skv, d in shapes:
        q, k, v = (torch.randn(rows, n, heads * d, device="cuda", generator=gen).to(dt) for n in (sq, skv, skv))
        before = FV.flash_merged.launches
        out = FV.flash_merged(q, k, v, d**-0.5, heads)
        assert FV.flash_merged.launches == before + 1 and out.dtype == dt
        ref = FV.merged_attention_reference(q, k, v, d**-0.5, heads)
        # fp32: summation order; bf16: one unit in the last place of the largest output
        tol = 1e-4 if dt == torch.float32 else 2**-7 * ref.float().abs().max().item() + 1e-4
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
