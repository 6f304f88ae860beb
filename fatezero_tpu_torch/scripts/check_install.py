"""What this machine offers the port: the card, the toolchain, the kernels, the collectives.

    python3 -m fatezero_tpu_torch.scripts.check_install

The port's counterpart of the JAX package's test_install.py. It prints the
card's name and power limit; the torch, CUDA and nvcc versions; each kernel
under csrc/ built, and K1 with K2/K3 at one small bf16 shape against their
plain versions; whether the C++ frame loader (native/) builds, and if not,
why; NCCL's and gloo's availability, the device count, and one process group
of a single process brought up and torn down on each backend the machine
can run; in the gloo one, a backward through the mesh's differentiable
collectives (a sum over 'seq' and megatron's f/g pair over 'tensor') against
plain autograd. A machine without a card prints what it lacks and exits 0;
on a card any failed check exits 1.
"""
from __future__ import annotations

import os
import subprocess
import sys

import torch
import torch.distributed as dist

KERNEL_SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "layer_norm.cu", "flash_fwd_bf16.cu", "flash_fwd_merged.cu")
SHAPE = (4, 256, 256, 64)  # rows, queries, keys, head dim
TOL = 2e-2  # bf16 outputs of O(1); the kernels split P into two bf16 terms


def _report(name: str, ok, detail: str) -> bool:
    """Print one check: ok True/False, or None for what the machine lacks."""
    tag = {True: "ok", False: "FAILED", None: "missing"}[ok]
    print(f"{name}: {tag} ({detail})", flush=True)
    return ok is not False


def _nvcc_version() -> str:
    from fatezero_tpu_torch.csrc import _nvcc

    out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def _kernels_vs_plain() -> str:
    """K1 (with its LSE), K2 and K3 on one bf16 shape against their plain versions."""
    from fatezero_tpu_torch.ops import flash_attention as FA

    b, sq, skv, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for n in (sq, skv, skv, sq))
    scale = d ** -0.5
    o, lse = FA.flash_forward(q, k, v, scale, with_lse=True)
    o_ref, lse_ref = FA.attention_with_lse(q, k, v, scale)
    dq = FA.flash_dq(q, k, v, o, lse, do, scale)
    dk, dv = FA.flash_dkv(q, k, v, o, lse, do, scale)
    refs = FA.flash_bwd_reference(q, k, v, o, lse, do, scale)
    errs = {"K1": (o.float() - o_ref.float()).abs().max().item(), "K1 lse": (lse - lse_ref).abs().max().item()}
    for name, got, ref in zip(("K2 dq", "K3 dk", "K3 dv"), (dq, dk, dv), refs):
        errs[name] = ((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp(min=1e-6)).item()
    bad = {n: e for n, e in errs.items() if not e <= TOL}
    if bad:
        raise AssertionError(f"off their plain versions beyond {TOL}: {bad}")
    return ", ".join(f"{n} {e:.2e}" for n, e in errs.items()) + f" (tol {TOL}, bf16 {SHAPE})"


def _process_group(backend: str, device: torch.device, backward: bool = False) -> str:
    """One process group of a single process: an all_reduce and a broadcast,
    with `backward` also the training collectives' backward; then torn down."""
    store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    try:
        t = torch.ones(4, device=device)
        dist.all_reduce(t)
        dist.broadcast(t, src=0)
        if not torch.equal(t.cpu(), torch.ones(4)):
            raise AssertionError(f"a world of one summed to {t.tolist()}")
        if backward:
            _collective_backward(device)
    finally:
        dist.destroy_process_group()
    return f"world of one on {device}: all_reduce and broadcast" + (
        ", backward through _SeqSum and f/g" if backward else "")


def _collective_backward(device: torch.device) -> None:
    """A world of one's mesh: the gradient through one sum over 'seq' and one
    f/g pair (the autograd Functions themselves; a world of one's sums move
    nothing) around two matmuls equals plain autograd's."""
    from fatezero_tpu_torch.parallel import sharding as SH

    mesh = SH.make_mesh((1, 1, 1), device)
    gen = torch.Generator().manual_seed(0)
    x0, w1, w2 = (torch.randn(shape, generator=gen).to(device) for shape in ((3, 8), (8, 8), (8, 8)))
    grads = []
    for on_mesh in (True, False):
        x = x0.clone().requires_grad_()
        if on_mesh:
            h = SH._CopyToTensor.apply(x, mesh) @ w1  # f
            y = SH._TensorReduce.apply(h @ w2, mesh)  # g
            y = SH._SeqSum.apply(y * 1.0, mesh)
        else:
            y = x @ w1 @ w2
        y.square().sum().backward()
        grads.append(x.grad)
    if not torch.allclose(grads[0], grads[1], rtol=1e-6, atol=1e-6):
        raise AssertionError("the mesh's collectives' backward differs from plain autograd")


def main() -> int:
    from fatezero_tpu_torch import native
    from fatezero_tpu_torch.scripts import card

    card_ok = torch.cuda.is_available()
    ok = True
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if card_ok:
        ok &= _report("card", True, f"{card()}; {torch.cuda.device_count()} device(s)")
    else:
        _report("card", None, "torch.cuda.is_available() is false: the kernels and NCCL need an NVIDIA card")

    def check(name, fn, needs_card=True):
        nonlocal ok
        if needs_card and not card_ok:
            return _report(name, None, "no card")
        try:
            return _report(name, True, fn())
        except Exception as e:  # noqa: BLE001 - every failure is reported, and fails the run on a card
            ok &= _report(name, False if card_ok else None, f"{type(e).__name__}: {e}")
            return False

    check("nvcc", _nvcc_version, needs_card=False)
    from fatezero_tpu_torch import csrc

    if check("kernels built", lambda: ", ".join(os.path.basename(p) for p in csrc.build_all(KERNEL_SOURCES))):
        check("K1, K2, K3 vs plain", _kernels_vs_plain)
    try:
        _report("native frame loader", True, native.build())
    except native.NativeLoaderUnavailable as e:  # the PIL path serves instead
        _report("native frame loader", None, f"unavailable, frames load with PIL: {str(e).splitlines()[-1]}")
    _report("gloo", dist.is_gloo_available() or None, "torch.distributed backend")
    _report("nccl", dist.is_nccl_available() or None, "torch.distributed backend")
    if dist.is_gloo_available():
        check("gloo process group", lambda: _process_group("gloo", torch.device("cpu"), backward=True),
              needs_card=False)
    if dist.is_nccl_available():
        check("nccl process group", lambda: _process_group("nccl", torch.device("cuda", 0)))
    return 0 if ok or not card_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
