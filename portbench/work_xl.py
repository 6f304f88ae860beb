"""The work SDXL needs at a cell's shapes: operations and bytes, from the
configuration alone, counted as portbench/work.py counts SD-1.x's (2
operations a multiply-add over the products, bytes at 2 an element, `attn`
for what runs inside the attention modules), over what
portbench/reference/sdxl.py computes: each level's stack of transformer
blocks, the text-time add embedding, both text towers (the second's
projection included) and the VAE, whose counts are SD's.
"""
from __future__ import annotations

from typing import List

from portbench import work as W
from portbench.reference.sd import lora_rank, sparse_frames
from portbench.reference.sdxl import per_level


def unet_ops(cfg: dict, b: int, f: int, h: int, w: int) -> List[W.Op]:
    """One UNet forward on [b, f, h, w, 4] latents under a [b, 77, C] context."""
    u, mc = cfg["unet"], cfg.get("model_config", {})
    lora = mc.get("lora")
    sparse = tuple(mc.get("SparseCausalAttention_index", (-1, "first")))
    least = int(mc.get("least_sc_channel") or 0)
    cross, ctx = u["cross_attention_dim"], 77
    chs = u["block_out_channels"]
    n_levels = len(chs)
    depth = per_level(u.get("transformer_layers_per_block", 1), n_levels)
    ch0, temb = chs[0], chs[0] * 4
    ops = W._Ops()

    def pconv(hh, ww, cin, cout, k, stride=1):
        ho, wo = hh // stride, ww // stride
        n = b * f * ho * wo
        ops.conv(b * f * hh * ww, n, cin, cout, k)
        if k > 1:
            r = lora_rank(lora, cout)
            if r is None:
                ops.tconv(n, cout, cout)
            else:
                ops.tconv(n, cout, r)
                ops.tconv(n, r, cout)
        return ho, wo

    def resnet(hh, ww, cin, cout):
        pconv(hh, ww, cin, cout, 3)
        ops.linear(b, temb, cout)
        pconv(hh, ww, cout, cout, 3)
        if cin != cout:
            pconv(hh, ww, cin, cout, 1)

    def block(s, c, sp):
        n = b * f * s
        ops.linear(n, c, c, attn=True)  # attn1: sparse-causal self-attention
        ops.linear(n, c, c, attn=True)
        ops.linear(n, c, c, attn=True)
        groups = sparse_frames(f, sp) if sp and f > 1 else [list(range(f))]
        kv = s * len(groups)
        refs = len({i for g in groups for i in g})
        ops.append(W.Op(4.0 * n * kv * c, W.BPE * (2 * n * c + 2 * b * refs * s * c), attn=True, core=True))
        ops.linear(n, c, c, attn=True)
        ops.linear(n, c, c, attn=True)  # attn2: text cross-attention
        ops.linear(b * ctx, cross, c, attn=True)
        ops.linear(b * ctx, cross, c, attn=True)
        ops.append(W.Op(4.0 * n * ctx * c, W.BPE * (2 * n * c + 2 * b * ctx * c), attn=True, core=True))
        ops.linear(n, c, c, attn=True)
        ops.linear(n, c, 8 * c)  # feed-forward (GEGLU, mult 4)
        ops.linear(n, 4 * c, c)
        if f > 1:  # temporal attention over frames, per pixel
            for _ in range(3):
                ops.linear(n, c, c, attn=True)
            ops.append(W.Op(4.0 * b * s * f * f * c, W.BPE * 4 * n * c, attn=True, core=True))
            ops.linear(n, c, c, attn=True)

    def transformer(hh, ww, c, level):
        s = hh * ww
        sp = () if (least and c < least) else sparse
        ops.linear(b * f * s, c, c)  # proj_in
        for _ in range(depth[level]):
            block(s, c, sp)
        ops.linear(b * f * s, c, c)  # proj_out

    ops.linear(b, ch0, temb)
    ops.linear(b, temb, temb)
    ops.linear(b, u["projection_class_embeddings_input_dim"], temb)  # add_embedding
    ops.linear(b, temb, temb)
    pconv(h, w, u["in_channels"], ch0, 3)
    skips, cin, hh, ww = [ch0], ch0, h, w
    for i, kind in enumerate(u["down_block_types"]):
        cout = chs[i]
        for j in range(u["layers_per_block"]):
            resnet(hh, ww, cin if j == 0 else cout, cout)
            if kind.startswith("CrossAttn"):
                transformer(hh, ww, cout, i)
            skips.append(cout)
        if i < n_levels - 1:
            hh, ww = pconv(hh, ww, cout, cout, 3, stride=2)
            skips.append(cout)
        cin = cout
    resnet(hh, ww, cin, cin)
    transformer(hh, ww, cin, n_levels - 1)
    resnet(hh, ww, cin, cin)
    rev = list(reversed(chs))
    for i, kind in enumerate(u["up_block_types"]):
        cout = rev[i]
        for j in range(u["layers_per_block"] + 1):
            resnet(hh, ww, (cin if j == 0 else cout) + skips.pop(), cout)
            if kind.startswith("CrossAttn"):
                transformer(hh, ww, cout, n_levels - 1 - i)
        if i < n_levels - 1:
            hh, ww = hh * 2, ww * 2
            pconv(hh, ww, cout, cout, 3)
        cin = cout
    pconv(hh, ww, ch0, u["out_channels"], 3)
    return list(ops)


def tower_ops(t: dict, rows: int, projection: bool) -> List[W.Op]:
    """One text tower over [rows, 77] ids; with `projection`, the projection of its pooled state."""
    s, c, m = t["max_position_embeddings"], t["hidden_size"], t["intermediate_size"]
    n = rows * s
    ops = W._Ops()
    for _ in range(t["num_hidden_layers"]):
        for _ in range(3):
            ops.linear(n, c, c)
        ops.append(W.Op(4.0 * rows * s * s * c, W.BPE * 4 * n * c, core=True))
        ops.linear(n, c, c)
        ops.linear(n, c, m)
        ops.linear(n, m, c)
    if projection:
        ops.linear(rows, c, t["projection_dim"])
    return list(ops)


def text_ops(cfg: dict, rows: int) -> List[W.Op]:
    """Both towers over the same rows."""
    return tower_ops(cfg["text_encoder"], rows, False) + tower_ops(cfg["text_encoder_2"], rows, True)


def controlled_blocks(cfg: dict, h: int, w: int, max_queries: int = 32 * 32) -> int:
    """Transformer blocks with at most `max_queries` queries in one forward on h x w latents."""
    u = cfg["unet"]
    chs = u["block_out_channels"]
    n_levels = len(chs)
    depth = per_level(u.get("transformer_layers_per_block", 1), n_levels)
    total = 0
    for i, kind in enumerate(u["down_block_types"]):
        s = (h >> i) * (w >> i)
        if kind.startswith("CrossAttn") and s <= max_queries:
            total += u["layers_per_block"] * depth[i]
    s_mid = (h >> (n_levels - 1)) * (w >> (n_levels - 1))
    if s_mid <= max_queries:
        total += depth[-1]
    for i, kind in enumerate(u["up_block_types"]):
        level = n_levels - 1 - i
        s = (h >> level) * (w >> level)
        if kind.startswith("CrossAttn") and s <= max_queries:
            total += (u["layers_per_block"] + 1) * depth[level]
    return total
