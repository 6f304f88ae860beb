"""The frozen counters against torch's FlopCounterMode over the plain reference,
and the reference against the port at the tiny size (float32, CPU)."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import weights as PW
from portbench import work
from portbench.reference import numerics, sd
from portbench.tests import tiny as T

CFG = T.load(f"{T.HERE}/tiny.json")


def _w(part):
    return PW.make(CFG, part, 7, "cpu", torch.float32)


def _counted(fn):
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("b,f,side", [(1, 4, 16), (2, 3, 8), (3, 1, 16)])
def test_unet_counter_matches_flop_counter(b, f, side):
    u = sd.UNet(_w("unet"), numerics.FP32(), CFG)
    x, ctx = torch.randn(b, f, side, side, 4), torch.randn(b, 77, 32)
    assert _counted(lambda: u.forward(x, 10, ctx)) == work.flops(work.unet_ops(CFG, b, f, side, side))


def test_vae_and_text_counters_match_flop_counter():
    v = sd.VAE(_w("vae"), numerics.FP32(), CFG)
    t = sd.TextEncoder(_w("text_encoder"), numerics.FP32(), CFG)
    assert _counted(lambda: v.encode(torch.rand(2, 32, 32, 3))) == work.flops(work.vae_encode_ops(CFG, 2, 32, 32))
    assert _counted(lambda: v.decode(torch.rand(2, 4, 4, 4))) == work.flops(work.vae_decode_ops(CFG, 2, 4, 4))
    ids = torch.randint(0, 1000, (2, 77))
    assert _counted(lambda: t.forward(ids)) == work.flops(work.text_ops(CFG, 2))


def test_backward_counts_input_and_trained_weight_gradients():
    ops = [work.Op(10.0, 0), work.Op(4.0, 0, trainable=True), work.Op(6.0, 0, core=True), work.Op(3.0, 0, no_dx=True)]
    assert work.backward_flops(ops) == 10 + 8 + 12 + 0


@pytest.mark.parametrize("part", ["unet", "vae", "text_encoder"])
def test_reference_matches_the_port(part):
    from portbench.drivers import common as C

    m = C.build_program(CFG, 7, "cpu", parts=(part,))
    W = PW.make(CFG, part, 7, "cpu", torch.float32)
    g = torch.Generator().manual_seed(0)
    if part == "unet":  # give the temporal parts a say: at init their outputs are zero
        params = dict(m.unet.named_parameters())
        for n, t in W.items():
            if "attn_temporal.to_out" in n or "conv_temporal.up" in n:
                t.copy_(torch.randn(t.shape, generator=g) * 0.02)
                params[n].data.copy_(t)
        x, ctx = torch.randn(2, 4, 16, 16, 4, generator=g), torch.randn(2, 77, 32, generator=g)
        with torch.no_grad():
            a = m.unet(x, 501, ctx)
            b = sd.UNet(W, numerics.FP32(), CFG).forward(x, 501, ctx)
    elif part == "vae":
        z = torch.randn(2, 4, 4, 4, generator=g)
        with torch.no_grad():
            a = m.vae.decode(z)
            b = sd.VAE(W, numerics.FP32(), CFG).decode(z)
    else:
        ids = torch.randint(0, 1000, (2, 77), generator=g)
        with torch.no_grad():
            a = m.text_encoder(ids)
            b = sd.TextEncoder(W, numerics.FP32(), CFG).forward(ids)
    assert float((a - b).norm() / b.norm()) < 1e-5


def test_weights_are_the_same_bits_for_a_seed():
    a, b = PW.make(CFG, "unet", 3, "cpu", torch.bfloat16), PW.make(CFG, "unet", 3, "cpu", torch.bfloat16)
    c = PW.make(CFG, "unet", 4, "cpu", torch.bfloat16)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
