"""The work a model needs at a cell's shapes: operations and bytes, from the
configuration alone.

Every product is counted at 2 operations per multiply-add, as
torch.utils.flop_counter counts them, over what the architecture computes
(portbench/reference/sd.py is the same computation written out): the
spatial and temporal convolutions, the linear layers, and the attention
products (scores and values, every query against every key it attends to).
Normalisations, activations and the DDIM arithmetic are not counted.

Bytes count each input read once and each output written once at 2 bytes an
element (bf16); an attention core counts its queries, its distinct keys and
values and its output. `attn` marks what runs inside the attention modules
(their projections and cores), which `attn_roofline.*` bounds.
`trainable` marks the products whose weights tuning updates (their weight
gradient is work the update needs), `core` the attention cores (whose
backward is two products for each forward one), and `no_dx` the first
convolution, whose input needs no gradient.
"""
from __future__ import annotations

import dataclasses
from typing import List

from portbench.reference.sd import lora_rank, sparse_frames

BPE = 2  # bytes an element, bf16


@dataclasses.dataclass(frozen=True)
class Op:
    flops: float
    nbytes: float
    attn: bool = False
    trainable: bool = False
    core: bool = False
    no_dx: bool = False


class _Ops(list):
    def linear(self, n, cin, cout, **kw):
        self.append(Op(2.0 * n * cin * cout, BPE * (n * cin + cin * cout + n * cout), **kw))

    def conv(self, n_in, n_out, cin, cout, k, **kw):
        self.append(Op(2.0 * n_out * cin * cout * k * k, BPE * (n_in * cin + cin * cout * k * k + n_out * cout), **kw))

    def tconv(self, n, cin, cout, **kw):
        self.append(Op(2.0 * n * cin * cout * 3, BPE * (n * cin + 3 * cin * cout + n * cout), **kw))


def unet_ops(cfg: dict, b: int, f: int, h: int, w: int, train_temporal_conv: bool = False) -> List[Op]:
    """One UNet forward on [b, f, h, w, 4] latents under a [b, 77, C] context."""
    u, mc = cfg["unet"], cfg.get("model_config", {})
    lora = mc.get("lora")
    sparse = tuple(mc.get("SparseCausalAttention_index", (-1, "first")))
    least = int(mc.get("least_sc_channel") or 0)
    heads, cross, ctx = u["attention_head_dim"], u["cross_attention_dim"], 77
    chs = u["block_out_channels"]
    ch0, temb = chs[0], chs[0] * 4
    ops = _Ops()

    def pconv(hh, ww, cin, cout, k, stride=1, **kw):
        ho, wo = hh // stride, ww // stride
        n = b * f * ho * wo
        ops.conv(b * f * hh * ww, n, cin, cout, k, **kw)
        if k > 1:
            r = lora_rank(lora, cout)
            tk = dict(trainable=train_temporal_conv)
            if r is None:
                ops.tconv(n, cout, cout, **tk)
            else:
                ops.tconv(n, cout, r, **tk)
                ops.tconv(n, r, cout, **tk)
        return ho, wo

    def resnet(hh, ww, cin, cout):
        pconv(hh, ww, cin, cout, 3)
        ops.linear(b, temb, cout)
        pconv(hh, ww, cout, cout, 3)
        if cin != cout:
            pconv(hh, ww, cin, cout, 1)

    def transformer(hh, ww, c):
        s = hh * ww
        n = b * f * s
        sp = () if (least and c < least) else sparse
        ops.linear(n, c, c)  # proj_in
        # attn1: sparse-causal self-attention
        ops.linear(n, c, c, attn=True, trainable=True)  # to_q
        ops.linear(n, c, c, attn=True)
        ops.linear(n, c, c, attn=True)
        groups = sparse_frames(f, sp) if sp and f > 1 else [list(range(f))]
        kv = s * len(groups)
        refs = len({i for g in groups for i in g})
        ops.append(Op(4.0 * n * kv * c, BPE * (2 * n * c + 2 * b * refs * s * c), attn=True, core=True))
        ops.linear(n, c, c, attn=True)  # to_out
        # attn2: text cross-attention
        ops.linear(n, c, c, attn=True, trainable=True)
        ops.linear(b * ctx, cross, c, attn=True)
        ops.linear(b * ctx, cross, c, attn=True)
        ops.append(Op(4.0 * n * ctx * c, BPE * (2 * n * c + 2 * b * ctx * c), attn=True, core=True))
        ops.linear(n, c, c, attn=True)
        # feed-forward (GEGLU, mult 4)
        ops.linear(n, c, 8 * c)
        ops.linear(n, 4 * c, c)
        if f > 1:  # temporal attention over frames, per pixel
            for _ in range(3):
                ops.linear(n, c, c, attn=True, trainable=True)
            ops.append(Op(4.0 * b * s * f * f * c, BPE * 4 * n * c, attn=True, core=True))
            ops.linear(n, c, c, attn=True, trainable=True)
        ops.linear(n, c, c)  # proj_out

    ops.linear(b, ch0, temb)
    ops.linear(b, temb, temb)
    pconv(h, w, u["in_channels"], ch0, 3, no_dx=True)
    skips, cin, hh, ww = [ch0], ch0, h, w
    n_blocks = len(chs)
    for i, kind in enumerate(u["down_block_types"]):
        cout = chs[i]
        for j in range(u["layers_per_block"]):
            resnet(hh, ww, cin if j == 0 else cout, cout)
            if kind.startswith("CrossAttn"):
                transformer(hh, ww, cout)
            skips.append(cout)
        if i < n_blocks - 1:
            hh, ww = pconv(hh, ww, cout, cout, 3, stride=2)
            skips.append(cout)
        cin = cout
    resnet(hh, ww, cin, cin)
    transformer(hh, ww, cin)
    resnet(hh, ww, cin, cin)
    rev = list(reversed(chs))
    for i, kind in enumerate(u["up_block_types"]):
        cout = rev[i]
        for j in range(u["layers_per_block"] + 1):
            resnet(hh, ww, (cin if j == 0 else cout) + skips.pop(), cout)
            if kind.startswith("CrossAttn"):
                transformer(hh, ww, cout)
        if i < n_blocks - 1:
            hh, ww = hh * 2, ww * 2
            pconv(hh, ww, cout, cout, 3)
        cin = cout
    pconv(hh, ww, ch0, u["out_channels"], 3)
    return list(ops)


def _vae_resnet(ops, n, cin, cout):
    ops.conv(n, n, cin, cout, 3)
    ops.conv(n, n, cout, cout, 3)
    if cin != cout:
        ops.conv(n, n, cin, cout, 1)


def _vae_mid(ops, images, s, c):
    n = images * s
    _vae_resnet(ops, n, c, c)
    for _ in range(3):
        ops.linear(n, c, c)
    ops.append(Op(4.0 * images * s * s * c, BPE * 4 * n * c, core=True))
    ops.linear(n, c, c)
    _vae_resnet(ops, n, c, c)


def vae_encode_ops(cfg: dict, images: int, h: int, w: int) -> List[Op]:
    v = cfg["vae"]
    chs = v["block_out_channels"]
    ops = _Ops()
    ops.conv(images * h * w, images * h * w, v["in_channels"], chs[0], 3)
    cin = chs[0]
    for i, ch in enumerate(chs):
        for j in range(v["layers_per_block"]):
            _vae_resnet(ops, images * h * w, cin if j == 0 else ch, ch)
        if i < len(chs) - 1:
            ops.conv(images * h * w, images * (h // 2) * (w // 2), ch, ch, 3)
            h, w = h // 2, w // 2
        cin = ch
    _vae_mid(ops, images, h * w, chs[-1])
    lat = v["latent_channels"]
    ops.conv(images * h * w, images * h * w, chs[-1], 2 * lat, 3)
    ops.conv(images * h * w, images * h * w, 2 * lat, 2 * lat, 1)
    return list(ops)


def vae_decode_ops(cfg: dict, images: int, h: int, w: int) -> List[Op]:
    v = cfg["vae"]
    rev = list(reversed(v["block_out_channels"]))
    lat = v["latent_channels"]
    ops = _Ops()
    n = images * h * w
    ops.conv(n, n, lat, lat, 1)
    ops.conv(n, n, lat, rev[0], 3)
    _vae_mid(ops, images, h * w, rev[0])
    cin = rev[0]
    for i, ch in enumerate(rev):
        for j in range(v["layers_per_block"] + 1):
            _vae_resnet(ops, images * h * w, cin if j == 0 else ch, ch)
        if i < len(rev) - 1:
            h, w = h * 2, w * 2
            ops.conv(images * h * w, images * h * w, ch, ch, 3)
        cin = ch
    ops.conv(images * h * w, images * h * w, rev[-1], v["out_channels"], 3)
    return list(ops)


def text_ops(cfg: dict, rows: int) -> List[Op]:
    t = cfg["text_encoder"]
    s, c, m = t["max_position_embeddings"], t["hidden_size"], t["intermediate_size"]
    n = rows * s
    ops = _Ops()
    for _ in range(t["num_hidden_layers"]):
        for _ in range(3):
            ops.linear(n, c, c)
        ops.append(Op(4.0 * rows * s * s * c, BPE * 4 * n * c, core=True))
        ops.linear(n, c, c)
        ops.linear(n, c, m)
        ops.linear(n, m, c)
    return list(ops)


def flops(ops: List[Op]) -> float:
    return sum(o.flops for o in ops)


def backward_flops(ops: List[Op]) -> float:
    """What a backward pass needs: every input gradient (two products for a
    core's one, none for the first convolution) and the weight gradients of
    the trained products."""
    total = 0.0
    for o in ops:
        if o.core:
            total += 2 * o.flops
            continue
        if not o.no_dx:
            total += o.flops
        if o.trainable:
            total += o.flops
    return total
