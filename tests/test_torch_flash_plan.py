"""`kernel_plan` and `bwd_kernel_plan` (fatezero_tpu_torch.ops.flash_attention):
the Python mirrors of the flash kernels' C dispatch (csrc/flash_fwd*.cu,
csrc/flash_fwd.cuh; csrc/flash_bwd.cu).

No kernel runs here: the card holds each kernel to its plain version and the
mirror to the built library's own answer (chip_smoke.py). These tests hold

* every shape the smoke and the probes drive to an asynchronous tensor-core
  path that fits one block's shared memory;
* the mirrors' constants to the ones parsed from the sources, so they cannot drift;
* misaligned or odd-width operands to the element loader, fp32 to its paths;
* the wrappers' CPU results to the plain versions, bit for bit (atol 0): on a
  CPU tensor a wrapper is its plain version and nothing else.
"""
import os
import re
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as C  # noqa: E402
from fatezero_tpu_torch.ops import flash_attention as FA  # noqa: E402
from fatezero_tpu_torch.ops import flash_variants as FV  # noqa: E402
from fatezero_tpu_torch.scripts import bench_flash_variants as TV  # noqa: E402

torch.set_num_threads(1)
BF16, F32 = torch.bfloat16, torch.float32
HEADER = open(os.path.join(REPO, "fatezero_tpu_torch", "csrc", "flash_fwd.cuh")).read()
BWD_SOURCE = open(os.path.join(REPO, "fatezero_tpu_torch", "csrc", "flash_bwd.cu")).read()

# (id, d, dv, merged, bf16_p) of every bf16 shape the smoke's checks and the probes drive
PATH_SHAPES = (
    [(f"K1 {s[0]}", s[1], s[4], False, False) for s in C.K1_SITES + [C.K1_WIDE_V]]
    + [(f"train {s[0]}", s[1], s[1], False, False) for s in C.TRAIN_SITES]
    + [(f"K1c {s[0]}", s[5], s[5], True, False) for s in C.K1C_SITES]
    + [(f"K1b {s[0]}", s[4], s[4], False, True) for s in TV.SHAPES]
    + [(f"K1 {s[0]} (probe)", s[4], s[4], False, False) for s in TV.SHAPES]
)


@pytest.mark.parametrize("name,d,dv,merged,bf16_p", PATH_SHAPES, ids=[s[0] for s in PATH_SHAPES])
def test_path_shapes_take_the_async_tensor_core_path(name, d, dv, merged, bf16_p):
    plan = FA.kernel_plan(d, dv, BF16, aligned=True, merged=merged, bf16_p=bf16_p)
    assert plan["path"] in ("wgmma", "mma.sync") and plan["loader"] == "async", plan
    assert plan["smem_bytes"] <= FA.SMEM_LIMIT == 232448
    assert plan["block_kv"] == FA.MMA_BK == FV.K1B_BLOCK_KV
    # the small head dims (the 64^2 and 32^2 sites) go through wgmma, 128 queries a block
    assert (plan["path"] == "wgmma") == (d <= 80 and dv <= 80)
    assert plan["block_q"] == (128 if d <= 80 and dv <= 80 else 64)


@pytest.mark.parametrize("name", [
    "MMA_BK", "MMA_PAD", "MMA_SMALL_DK", "MMA_SMALL_DVN", "MMA_WARPS_SMALL", "MMA_WARPS_LARGE",
    "MMA_STAGES_SMALL", "MMA_STAGES_LARGE", "WG_WARPS", "WG_STAGES", "WG_BAR_BYTES", "SMEM_LIMIT", "BQ", "BK",
])
def test_constants_equal_the_headers(name):
    found = re.findall(rf"^constexpr int {name} = (\d+);", HEADER, re.M)
    assert len(found) == 1, f"{name}: expected one `constexpr int {name} = N;` in flash_fwd.cuh, found {found}"
    assert int(found[0]) == getattr(FA, name)


def test_plan_geometry_follows_the_header_formulas():
    """MmaCfg and WgCfg in numbers: strides are odd multiples of 16 bytes, and
    the shared bytes are Q plus the ring (plus the barriers for wgmma)."""
    for expr in ("QS = DK * 16 + MMA_PAD", "VS = DVN * 8 + (DVN % 2 ? 0 : MMA_PAD)",
                 "SMEM = (BQ * QS + STAGES * STAGE) * 2", "SMEM = WG_BAR_BYTES + (BQ * QS + STAGES * STAGE) * 2",
                 "KTILE = MMA_BK * DK * 16", "VTILE = MMA_BK * DVN * 8"):
        assert expr in HEADER, expr
    for d, dk in ((40, 3), (80, 5), (160, 10)):
        assert ((16 * dk + FA.MMA_PAD) * 2 // 16) % 2 == 1
    # the mma.sync kernel at the small head dims takes what wgmma does not: here misaligned operands
    a = FA.kernel_plan(40, 40, BF16, aligned=False)
    wide = FA.kernel_plan(40, 80, BF16, aligned=False)
    assert a == dict(path="mma.sync", loader="element", block_q=128, block_kv=64, stages=3,
                     smem_bytes=2 * (128 * 56 + 3 * 64 * (56 + 40)))
    assert wide["smem_bytes"] == 2 * (128 * 56 + 3 * 64 * (56 + 88))
    b = FA.kernel_plan(40, 40, BF16)
    assert b == dict(path="wgmma", loader="async", block_q=128, block_kv=64, stages=3,
                     smem_bytes=128 + 2 * (128 * 56 + 3 * 64 * (48 + 40)))
    big = FA.kernel_plan(160, 160, BF16)
    assert big == dict(path="mma.sync", loader="async", block_q=64, block_kv=64, stages=2,
                       smem_bytes=2 * (64 * 168 + 2 * 64 * (168 + 168)))


@pytest.mark.parametrize("d,dv,aligned", [(40, 40, False), (80, 80, False), (160, 160, False), (36, 36, True),
                                          (40, 36, True), (44, 40, True), (1, 1, True)])
@pytest.mark.parametrize("kind", ["k1", "k1b", "k1c"])
def test_misaligned_or_odd_width_plans_the_element_loader(d, dv, aligned, kind):
    if kind == "k1c" and dv != d:
        dv = d
    plan = FA.kernel_plan(d, dv, BF16, aligned=aligned, merged=kind == "k1c", bf16_p=kind == "k1b")
    if aligned and d % 8 == 0 and dv % 8 == 0:
        assert plan["loader"] == "async"
    else:
        assert plan["path"] == "mma.sync" and plan["loader"] == "element", plan


def test_fp32_and_wide_v_plans():
    """fp32 runs on CUDA cores in K1 and K1c and is rounded while staged in K1b;
    bf16 with dv > 160 (the value-space edit's double-wide V at d 160) is K1's
    one bf16 shape off the tensor cores."""
    assert FA.kernel_plan(40, 40, F32)["path"] == "fma"
    assert FA.kernel_plan(80, 80, F32, merged=True)["path"] == "fma"
    assert FA.kernel_plan(40, 40, F32, bf16_p=True) == dict(
        path="mma.sync", loader="staged", block_q=128, block_kv=64, stages=3,
        smem_bytes=2 * (128 * 56 + 3 * 64 * (56 + 40)))
    assert FA.kernel_plan(40, 40, F32, aligned=False, bf16_p=True)["loader"] == "element"
    wide = FA.kernel_plan(160, 320, BF16)
    assert wide["path"] == "fma" and wide["smem_bytes"] == 4 * (32 * 161 + 64 * 161 + 64 * 320 + 32 * 64) <= FA.SMEM_LIMIT
    for bad in [dict(d=161, dv=40, dtype=BF16), dict(d=40, dv=321, dtype=BF16), dict(d=40, dv=200, dtype=BF16, bf16_p=True),
                dict(d=0, dv=40, dtype=BF16)]:
        with pytest.raises(ValueError):
            FA.kernel_plan(**bad)
    with pytest.raises(TypeError):
        FA.kernel_plan(40, 40, torch.float16)


@pytest.mark.parametrize("bad", [0.0, -0.1, float("nan")])
def test_k1_and_k1c_refuse_a_scale_that_is_not_positive_on_the_cpu_too(bad):
    """K1 and K1c take the running max before the scaling; their wrappers hand
    the kernels a positive scale (-q and -scale for a negative one, zero q and
    scale 1 for 0), so like the JAX kernels they take any scale but NaN, which
    they refuse on a CPU tensor as on the card. On the CPU a negative or zero
    scale is the plain version's, bit for bit. K1b scales q before the product
    and takes any scale."""
    q, k, v = _randn(0, (1, 256, 16), (1, 8, 16), (1, 8, 16))
    calls = (lambda: FA.flash_forward(q, k, v, bad)[0], lambda: FA.flash_forward(q, k, v, bad, with_lse=True)[1],
             lambda: FA.flash_attention(q, k, v, bad), lambda: FA.fused_attention(q, k, v, bad),
             lambda: FV.flash_merged(q, k, v, bad, 2))
    if bad != bad:
        for call in calls:
            with pytest.raises(ValueError, match="a number"):
                call()
        return
    refs = (FA.xla_attention(q, k, v, bad), FA.attention_with_lse(q, k, v, bad)[1], FA.xla_attention(q, k, v, bad),
            FA.xla_attention(q, k, v, bad), FV.merged_attention_reference(q, k, v, bad, 2))
    for call, ref in zip(calls, refs):
        torch.testing.assert_close(call(), ref, atol=0, rtol=0)
    torch.testing.assert_close(FV.flash_bf16(q, k, v, bad), FV.flash_bf16_reference(q, k, v, bad, FV.K1B_BLOCK_KV),
                               atol=0, rtol=0)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("site", C.TRAIN_SITES, ids=[s[0] for s in C.TRAIN_SITES])
def test_tuning_sites_plan_the_async_backward(site, kernel):
    """K2 and K3 at every tuning site: the tensor cores, the cp.async ring,
    one block's shared memory; K2 owns 128 queries a block, K3 128 keys at
    d 40 and 64 above."""
    d = site[1]
    plan = FA.bwd_kernel_plan(kernel, d, BF16)
    assert plan["path"] == "mma.sync" and plan["loader"] == "async", plan
    assert plan["smem_bytes"] <= FA.SMEM_LIMIT
    assert plan["stages"] == (FA.DKV_STAGES if kernel == "dkv" else FA.BWD_STAGES_SMALL if d <= 80 else FA.BWD_STAGES_LARGE)
    assert plan["block_q" if kernel == "dq" else "block_kv"] == (128 if kernel == "dq" or d <= 40 else 64)


@pytest.mark.parametrize("name", [
    "BWD_SMALL_DK", "BWD_NARROW_DK", "BWD_STAGES_SMALL", "BWD_STAGES_LARGE", "DQ_WARPS", "DQ_BK",
    "DKV_STAGES", "DKV_WARPS_NARROW", "DKV_WARPS", "DKV_BQ_NARROW", "DKV_BQ_SMALL",
    "DKV_BQ_LARGE", "F_ROWS", "F_TILE",
])
def test_bwd_constants_equal_the_sources(name):
    found = re.findall(rf"^constexpr int {name} = (\d+);", BWD_SOURCE, re.M)
    if name == "F_ROWS":  # F_THREADS / ROW_LANES
        found = [str(int(re.search(r"^constexpr int F_THREADS = (\d+);", BWD_SOURCE, re.M).group(1))
                     // int(re.search(r"^constexpr int ROW_LANES = (\d+);", BWD_SOURCE, re.M).group(1)))]
    assert len(found) == 1, f"{name}: expected one `constexpr int {name} = N;` in flash_bwd.cu, found {found}"
    assert int(found[0]) == getattr(FA, name)


def test_bwd_plan_geometry_follows_the_source_formulas():
    for expr in ("STAGE = 2 * BK * QS;", "SMEM = (2 * BQ * QS + STAGES * STAGE) * 2 + BQ * 4;",
                 "STAGE = 3 * BQ * QS + 4 * BQ;", "SMEM = (2 * BK * QS + STAGES * STAGE) * 2;",
                 "QS = DK * 16 + MMA_PAD;"):
        assert expr in BWD_SOURCE, expr
    for expr in ("BK = WARPS * 16;", "WARPS = DK <= BWD_NARROW_DK ? DKV_WARPS_NARROW : DKV_WARPS;",
                 "BQ = DQ_WARPS * 16;"):
        assert expr in BWD_SOURCE, expr
    assert FA.bwd_kernel_plan("dq", 40, BF16) == dict(path="mma.sync", loader="async", block_q=128, block_kv=64,
                                                      stages=3, smem_bytes=2 * (2 * 128 * 56 + 3 * 2 * 64 * 56) + 512)
    assert FA.bwd_kernel_plan("dkv", 40, BF16) == dict(path="mma.sync", loader="async", block_q=64, block_kv=128,
                                                       stages=3, smem_bytes=2 * (2 * 128 * 56 + 3 * (3 * 64 * 56 + 256)))
    assert FA.bwd_kernel_plan("dkv", 160, BF16) == dict(path="mma.sync", loader="async", block_q=16, block_kv=64,
                                                        stages=3, smem_bytes=2 * (2 * 64 * 168 + 3 * (3 * 16 * 168 + 64)))


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("d,aligned", [(40, False), (80, False), (160, False), (36, True), (44, True), (1, True)])
def test_bwd_misaligned_or_odd_width_plans_the_element_loader(kernel, d, aligned):
    plan = FA.bwd_kernel_plan(kernel, d, BF16, aligned=aligned)
    assert plan["path"] == "mma.sync" and plan["loader"] == "element", plan
    fp32 = FA.bwd_kernel_plan(kernel, d, F32, aligned=aligned)
    assert fp32["path"] == "fma" and fp32["smem_bytes"] <= FA.SMEM_LIMIT
    for bad in (0, 161):
        with pytest.raises(ValueError):
            FA.bwd_kernel_plan(kernel, bad, BF16)


def _randn(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in shapes]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("sq,skv,d", [(256, 77, 40), (300, 129, 80), (256, 200, 160)])
def test_cpu_wrappers_are_their_plain_versions(sq, skv, d, dtype):
    heads = 2
    q, k, v = (t.to(dtype) for t in _randn(sq + skv + d, (2, sq, heads * d), (2, skv, heads * d), (2, skv, heads * d)))
    qf, kf, vf = (t[..., :d].contiguous() for t in (q, k, v))
    scale = d**-0.5
    exact = dict(atol=0, rtol=0)
    out, lse = FA.flash_forward(qf, kf, vf, scale)
    assert lse is None
    torch.testing.assert_close(out, FA.xla_attention(qf, kf, vf, scale), **exact)
    torch.testing.assert_close(FA.flash_attention(qf, kf, vf, scale), out, **exact)
    out, lse = FA.flash_forward(qf, kf, vf, scale, with_lse=True)
    ref, ref_lse = FA.attention_with_lse(qf, kf, vf, scale)
    torch.testing.assert_close(out, ref, **exact)
    torch.testing.assert_close(lse, ref_lse, **exact)
    torch.testing.assert_close(FV.flash_bf16(qf, kf, vf, scale),
                               FV.flash_bf16_reference(qf, kf, vf, scale, FV.K1B_BLOCK_KV), **exact)
    torch.testing.assert_close(FV.flash_merged(q, k, v, scale, heads),
                               FV.merged_attention_reference(q, k, v, scale, heads), **exact)
    assert out.dtype == dtype and lse.dtype == F32
