"""Plain float32 Stable Diffusion 1.x, inflated as FateZero inflates it.

The reference the benchmark holds the program against. It follows the
published architecture (diffusers' UNet2DConditionModel, AutoencoderKL and
the CLIP ViT-L/14 text tower, with diffusers/HF parameter names) and
FateZero's inflation of the UNet to video:

* every 3x3 convolution gets a temporal convolution over frames after it:
  a Conv1d (dirac init) or, with `lora`, the rank-r pair down/up added to
  the spatial output (zero up projection);
* spatial self-attention reads, for each frame, the keys and values of the
  frames `SparseCausalAttention_index` names (ints are offsets, 'first',
  'mid', 'last' anchors), or its own frame below `least_sc_channel`;
* every transformer block ends with a temporal attention over frames per
  pixel (zero output projection at init).

Tensors are channels-last video [B, F, H, W, C]. Weights are a dict of
float32 tensors under the parameter names `*_spec` lists. Every product goes
through the precision policy `P` (numerics.py), so the same code is also the
float8 control. Attention is materialised (softmax in float32), one batch
row and frame at a time so that it fits; sites of at most `MAX_CONTROLLED`
queries hand their probabilities to `ctl(probs, place, is_cross)`, the hook
prompt-to-prompt editing works through. Nothing here is imported from the
program under test.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

MAX_CONTROLLED = 32 * 32  # FateZero edits attention maps of at most 32x32 queries
VAE_SCALE = 0.18215

Spec = List[Tuple[str, Tuple[int, ...], str]]  # (name, shape, init rule)


# ------------------------------------------------------------------- spec
def _init_rule(name: str, norms: set) -> str:
    """FateZero's init of random weights: dirac temporal convs, zero temporal
    attention outputs, LoRA up projections and biases, unit norm gains,
    N(0, 0.02) for everything else."""
    if name.endswith("conv_temporal.weight"):
        return "dirac"
    if name.endswith("bias") or "attn_temporal.to_out" in name or name.endswith("conv_temporal.up.weight"):
        return "zeros"
    if name in norms:
        return "ones"
    return "normal"


class _SpecBuilder:
    def __init__(self):
        self.items: List[Tuple[str, Tuple[int, ...]]] = []
        self.norms: set = set()

    def p(self, name, *shape):
        self.items.append((name, tuple(shape)))

    def linear(self, name, cin, cout, bias=True):
        self.p(f"{name}.weight", cout, cin)
        if bias:
            self.p(f"{name}.bias", cout)

    def norm(self, name, c):
        self.p(f"{name}.weight", c)
        self.p(f"{name}.bias", c)
        self.norms.add(f"{name}.weight")

    def conv(self, name, cin, cout, k):
        self.p(f"{name}.weight", cout, cin, k, k)
        self.p(f"{name}.bias", cout)

    def done(self) -> Spec:
        return [(n, s, _init_rule(n, self.norms)) for n, s in self.items]


def lora_rank(lora: Optional[int], channels: int) -> Optional[int]:
    if lora is None:
        return None
    return lora if lora <= channels else channels // 2


def _pseudo_conv(sb: _SpecBuilder, name, cin, cout, k, lora):
    sb.conv(name, cin, cout, k)
    if k <= 1:
        return
    r = lora_rank(lora, cout)
    if r is None:
        sb.p(f"{name}.conv_temporal.weight", cout, cout, 3)
        sb.p(f"{name}.conv_temporal.bias", cout)
    else:
        sb.p(f"{name}.conv_temporal.down.weight", r, cout, 3)
        sb.p(f"{name}.conv_temporal.up.weight", cout, r, 3)


def _attention(sb, name, dim, inner, kv_dim):
    sb.linear(f"{name}.to_q", dim, inner, bias=False)
    sb.linear(f"{name}.to_k", kv_dim, inner, bias=False)
    sb.linear(f"{name}.to_v", kv_dim, inner, bias=False)
    sb.linear(f"{name}.to_out.0", inner, dim)


def unet_spec(cfg: dict) -> Spec:
    u, mc = cfg["unet"], cfg.get("model_config", {})
    lora = mc.get("lora")
    sb = _SpecBuilder()
    chs = u["block_out_channels"]
    ch0, temb = chs[0], chs[0] * 4
    cross = u["cross_attention_dim"]

    def resnet(name, cin, cout):
        sb.norm(f"{name}.norm1", cin)
        _pseudo_conv(sb, f"{name}.conv1", cin, cout, 3, lora)
        sb.linear(f"{name}.time_emb_proj", temb, cout)
        sb.norm(f"{name}.norm2", cout)
        _pseudo_conv(sb, f"{name}.conv2", cout, cout, 3, lora)
        if cin != cout:
            _pseudo_conv(sb, f"{name}.conv_shortcut", cin, cout, 1, lora)

    def transformer(name, c):
        sb.norm(f"{name}.norm", c)
        sb.linear(f"{name}.proj_in", c, c)
        b = f"{name}.transformer_blocks.0"
        sb.norm(f"{b}.norm1", c)
        _attention(sb, f"{b}.attn1", c, c, c)
        sb.norm(f"{b}.norm2", c)
        _attention(sb, f"{b}.attn2", c, c, cross)
        sb.norm(f"{b}.norm3", c)
        sb.linear(f"{b}.ff.net.0.proj", c, c * 8)
        sb.linear(f"{b}.ff.net.2", c * 4, c)
        sb.norm(f"{b}.norm_temporal", c)
        _attention(sb, f"{b}.attn_temporal", c, c, c)
        sb.linear(f"{name}.proj_out", c, c)

    _pseudo_conv(sb, "conv_in", u["in_channels"], ch0, 3, lora)
    sb.linear("time_embedding.linear_1", ch0, temb)
    sb.linear("time_embedding.linear_2", temb, temb)
    n = len(chs)
    skips, cin = [ch0], ch0
    for i, kind in enumerate(u["down_block_types"]):
        cout = chs[i]
        for j in range(u["layers_per_block"]):
            resnet(f"down_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout)
            if kind.startswith("CrossAttn"):
                transformer(f"down_blocks.{i}.attentions.{j}", cout)
            skips.append(cout)
        if i < n - 1:
            _pseudo_conv(sb, f"down_blocks.{i}.downsamplers.0.conv", cout, cout, 3, lora)
            skips.append(cout)
        cin = cout
    cmid = chs[-1]
    resnet("mid_block.resnets.0", cmid, cmid)
    transformer("mid_block.attentions.0", cmid)
    resnet("mid_block.resnets.1", cmid, cmid)
    rev = list(reversed(chs))
    cin = cmid
    for i, kind in enumerate(u["up_block_types"]):
        cout = rev[i]
        for j in range(u["layers_per_block"] + 1):
            resnet(f"up_blocks.{i}.resnets.{j}", (cin if j == 0 else cout) + skips.pop(), cout)
            if kind.startswith("CrossAttn"):
                transformer(f"up_blocks.{i}.attentions.{j}", cout)
        if i < n - 1:
            _pseudo_conv(sb, f"up_blocks.{i}.upsamplers.0.conv", cout, cout, 3, lora)
        cin = cout
    sb.norm("conv_norm_out", ch0)
    _pseudo_conv(sb, "conv_out", ch0, u["out_channels"], 3, lora)
    return sb.done()


def vae_spec(cfg: dict) -> Spec:
    v = cfg["vae"]
    sb = _SpecBuilder()
    chs = v["block_out_channels"]
    lat = v["latent_channels"]

    def resnet(name, cin, cout):
        sb.norm(f"{name}.norm1", cin)
        sb.conv(f"{name}.conv1", cin, cout, 3)
        sb.norm(f"{name}.norm2", cout)
        sb.conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            sb.conv(f"{name}.conv_shortcut", cin, cout, 1)

    def mid(name, c):
        resnet(f"{name}.resnets.0", c, c)
        sb.norm(f"{name}.attentions.0.group_norm", c)
        for k in ("query", "key", "value", "proj_attn"):
            sb.linear(f"{name}.attentions.0.{k}", c, c)
        resnet(f"{name}.resnets.1", c, c)

    sb.conv("encoder.conv_in", v["in_channels"], chs[0], 3)
    cin = chs[0]
    for i, ch in enumerate(chs):
        for j in range(v["layers_per_block"]):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin if j == 0 else ch, ch)
        if i < len(chs) - 1:
            sb.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch, 3)
        cin = ch
    mid("encoder.mid_block", chs[-1])
    sb.norm("encoder.conv_norm_out", chs[-1])
    sb.conv("encoder.conv_out", chs[-1], 2 * lat, 3)
    rev = list(reversed(chs))
    sb.conv("decoder.conv_in", lat, rev[0], 3)
    mid("decoder.mid_block", rev[0])
    cin = rev[0]
    for i, ch in enumerate(rev):
        for j in range(v["layers_per_block"] + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin if j == 0 else ch, ch)
        if i < len(rev) - 1:
            sb.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch, 3)
        cin = ch
    sb.norm("decoder.conv_norm_out", rev[-1])
    sb.conv("decoder.conv_out", rev[-1], v["out_channels"], 3)
    sb.conv("quant_conv", 2 * lat, 2 * lat, 1)
    sb.conv("post_quant_conv", lat, lat, 1)
    return sb.done()


def text_spec(cfg: dict) -> Spec:
    t = cfg["text_encoder"]
    sb = _SpecBuilder()
    c, m = t["hidden_size"], t["intermediate_size"]
    sb.p("text_model.embeddings.token_embedding.weight", t["vocab_size"], c)
    sb.p("text_model.embeddings.position_embedding.weight", t["max_position_embeddings"], c)
    for i in range(t["num_hidden_layers"]):
        b = f"text_model.encoder.layers.{i}"
        for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sb.linear(f"{b}.self_attn.{k}", c, c)
        sb.norm(f"{b}.layer_norm1", c)
        sb.linear(f"{b}.mlp.fc1", c, m)
        sb.linear(f"{b}.mlp.fc2", m, c)
        sb.norm(f"{b}.layer_norm2", c)
    sb.norm("text_model.final_layer_norm", c)
    return sb.done()


SPECS = {"unet": unet_spec, "vae": vae_spec, "text_encoder": text_spec}


# ------------------------------------------------------------------ layers
def group_norm(x: torch.Tensor, w, b, groups: int, eps: float, batch_dims: int = 1) -> torch.Tensor:
    """GroupNorm over [..., C]: statistics per sample (the first `batch_dims`
    axes) and group, over every other axis."""
    shape = x.shape
    c = shape[-1]
    xg = x.reshape(*shape[:batch_dims], -1, groups, c // groups)
    red = tuple(range(batch_dims, xg.dim() - 2)) + (xg.dim() - 1,)
    mean = xg.mean(dim=red, keepdim=True)
    var = (xg - mean).square().mean(dim=red, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(shape)
    return y * w + b


def layer_norm(x, w, b, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def timestep_embedding(t: torch.Tensor, dim: int, flip: bool = True, shift: float = 0.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - shift))
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


def temporal_conv1d(P, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """nn.Conv1d(k=3, padding=1) over the frame axis of [B, F, H, W, Cin];
    w [Cout, Cin, 3]."""
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
    f = x.shape[1]
    out = sum(P.mm(xp[:, j:j + f], w[:, :, j].t()) for j in range(3))
    return out if b is None else out + b


class Runner:
    """One model's weights `W` under a precision policy `P`."""

    def __init__(self, W: Dict[str, torch.Tensor], P):
        self.W = W
        self.P = P

    def lin(self, name, x, bias=True):
        return self.P.lin(x, self.W[f"{name}.weight"], self.W.get(f"{name}.bias") if bias else None)


# -------------------------------------------------------------------- UNet
def sparse_frames(f: int, spec) -> List[List[int]]:
    out = []
    for index in spec:
        if isinstance(index, str):
            anchor = {"first": 0, "last": f - 1, "mid": (f - 1) // 2, "middle": (f - 1) // 2}[index]
            out.append([anchor] * f)
        else:
            out.append([min(max(i + int(index), 0), f - 1) for i in range(f)])
    return out


class UNet(Runner):
    def __init__(self, W, P, cfg: dict, ctl: Optional[Callable] = None):
        super().__init__(W, P)
        self.u = cfg["unet"]
        mc = cfg.get("model_config", {})
        self.lora = mc.get("lora")
        self.sparse = tuple(mc.get("SparseCausalAttention_index", (-1, "first")))
        self.least_sc = int(mc.get("least_sc_channel") or 0)
        self.ctl = ctl
        self.checkpoint = False

    def pconv(self, name, x, stride=1):
        b, f, h, w, c = x.shape
        weight = self.W[f"{name}.weight"]
        k = weight.shape[-1]
        y = self.P.conv(x.reshape(b * f, h, w, c), weight, self.W[f"{name}.bias"], stride, k // 2)
        y = y.reshape(b, f, *y.shape[1:])
        if k <= 1:
            return y
        if f"{name}.conv_temporal.down.weight" in self.W:
            d = temporal_conv1d(self.P, y, self.W[f"{name}.conv_temporal.down.weight"])
            return y + temporal_conv1d(self.P, d, self.W[f"{name}.conv_temporal.up.weight"])
        return temporal_conv1d(self.P, y, self.W[f"{name}.conv_temporal.weight"], self.W[f"{name}.conv_temporal.bias"])

    def gn(self, name, x, eps, batch_dims=1):
        return group_norm(x, self.W[f"{name}.weight"], self.W[f"{name}.bias"], self.u["norm_num_groups"], eps,
                          batch_dims)

    def resnet(self, name, x, temb):
        eps = self.u.get("norm_eps", 1e-5)
        h = self.pconv(f"{name}.conv1", F.silu(self.gn(f"{name}.norm1", x, eps)))
        h = h + self.lin(f"{name}.time_emb_proj", F.silu(temb))[:, None, None, None, :]
        h = self.pconv(f"{name}.conv2", F.silu(self.gn(f"{name}.norm2", h, eps)))
        if f"{name}.conv_shortcut.weight" in self.W:
            x = self.pconv(f"{name}.conv_shortcut", x)
        return x + h

    def attention(self, name, x, context, place, sparse):
        """x [b, f, s, c]; context [b, 77, c_cross] or None (self)."""
        b, f, s, c = x.shape
        heads = self.u["attention_head_dim"]
        d = c // heads
        q = self.lin(f"{name}.to_q", x, bias=False)
        src = x if context is None else context
        k = self.lin(f"{name}.to_k", src, bias=False)
        v = self.lin(f"{name}.to_v", src, bias=False)

        def split(t):  # [..., n, h*d] -> [..., h, n, d]
            return t.reshape(*t.shape[:-1], heads, d).transpose(-2, -3)

        qh = split(q)  # [b, f, h, s, d]
        if context is None:
            frames = sparse_frames(f, sparse) if sparse else [list(range(f))]
            kh = split(torch.cat([k[:, idx] for idx in frames], dim=2))  # [b, f, h, n*s, d]
            vh = split(torch.cat([v[:, idx] for idx in frames], dim=2))
        else:
            kh = split(k)[:, None].expand(b, f, heads, k.shape[1], d)
            vh = split(v)[:, None].expand(b, f, heads, k.shape[1], d)
        controlled = self.ctl is not None and s <= MAX_CONTROLLED
        if controlled:
            probs = torch.softmax(self.P.mm(qh, kh.transpose(-1, -2)) * d ** -0.5, dim=-1)
            probs = self.ctl(probs, place, context is not None)
            out = self.P.mm(probs, vh)
        else:
            out = torch.empty_like(qh)
            for i in range(b):
                for j in range(f):
                    p = torch.softmax(self.P.mm(qh[i, j], kh[i, j].transpose(-1, -2)) * d ** -0.5, dim=-1)
                    out[i, j] = self.P.mm(p, vh[i, j])
        out = out.transpose(-2, -3).reshape(b, f, s, c)
        return self.lin(f"{name}.to_out.0", out)

    def temporal_attention(self, name, x):
        b, f, s, c = x.shape
        heads = self.u["attention_head_dim"]
        d = c // heads

        def h5(t):
            return t.reshape(b, f, s, heads, d)

        q = h5(self.lin(f"{name}.to_q", x, bias=False))
        k = h5(self.lin(f"{name}.to_k", x, bias=False))
        v = h5(self.lin(f"{name}.to_v", x, bias=False))
        p = torch.softmax(self.P.einsum("bfshe,bgshe->bshfg", q, k) * d ** -0.5, dim=-1)
        out = self.P.einsum("bshfg,bgshe->bfshe", p, v).reshape(b, f, s, c)
        return self.lin(f"{name}.to_out.0", out)

    def transformer(self, name, x, context, place):
        b, f, hh, ww, c = x.shape
        sparse = () if (self.least_sc and c < self.least_sc) else self.sparse
        h = self.lin(f"{name}.proj_in", self.gn(f"{name}.norm", x, 1e-6, batch_dims=2)).reshape(b, f, hh * ww, c)
        blk = f"{name}.transformer_blocks.0"

        def ln(n, t):
            return layer_norm(t, self.W[f"{blk}.{n}.weight"], self.W[f"{blk}.{n}.bias"])

        h = h + self.attention(f"{blk}.attn1", ln("norm1", h), None, place, sparse)
        h = h + self.attention(f"{blk}.attn2", ln("norm2", h), context, place, sparse)
        proj = self.lin(f"{blk}.ff.net.0.proj", ln("norm3", h))
        a, gate = proj.chunk(2, dim=-1)
        h = h + self.lin(f"{blk}.ff.net.2", a * F.gelu(gate))
        if f > 1:
            h = h + self.temporal_attention(f"{blk}.attn_temporal", ln("norm_temporal", h))
        return self.lin(f"{name}.proj_out", h.reshape(b, f, hh, ww, c)) + x

    def _run(self, fn, *args):
        if self.checkpoint and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def forward(self, sample: torch.Tensor, t, context: torch.Tensor) -> torch.Tensor:
        """sample [B, F, H, W, 4], t int or [B], context [B, 77, C] -> eps [B, F, H, W, 4]."""
        u = self.u
        b = sample.shape[0]
        t = torch.as_tensor(t, device=sample.device)
        t = t.expand(b) if t.dim() == 0 else t
        ch0 = u["block_out_channels"][0]
        temb = timestep_embedding(t, ch0, u.get("flip_sin_to_cos", True), u.get("freq_shift", 0))
        temb = self.lin("time_embedding.linear_2", F.silu(self.lin("time_embedding.linear_1", temb)))
        x = self.pconv("conv_in", sample)
        skips = [x]
        n = len(u["block_out_channels"])
        for i, kind in enumerate(u["down_block_types"]):
            def down(x, temb, context, i=i, kind=kind):
                res = []
                for j in range(u["layers_per_block"]):
                    x = self.resnet(f"down_blocks.{i}.resnets.{j}", x, temb)
                    if kind.startswith("CrossAttn"):
                        x = self.transformer(f"down_blocks.{i}.attentions.{j}", x, context, "down")
                    res.append(x)
                if i < n - 1:
                    x = self.pconv(f"down_blocks.{i}.downsamplers.0.conv", x, stride=2)
                    res.append(x)
                return x, res

            x, res = self._run(down, x, temb, context)
            skips.extend(res)

        def mid(x, temb, context):
            x = self.resnet("mid_block.resnets.0", x, temb)
            x = self.transformer("mid_block.attentions.0", x, context, "mid")
            return self.resnet("mid_block.resnets.1", x, temb)

        x = self._run(mid, x, temb, context)
        for i, kind in enumerate(u["up_block_types"]):
            m = u["layers_per_block"] + 1
            pops = skips[-m:][::-1]
            del skips[-m:]

            def up(x, temb, context, *pops, i=i, kind=kind):
                for j in range(m):
                    x = self.resnet(f"up_blocks.{i}.resnets.{j}", torch.cat([x, pops[j]], dim=-1), temb)
                    if kind.startswith("CrossAttn"):
                        x = self.transformer(f"up_blocks.{i}.attentions.{j}", x, context, "up")
                if i < n - 1:
                    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                    x = self.pconv(f"up_blocks.{i}.upsamplers.0.conv", x)
                return x

            x = self._run(up, x, temb, context, *pops)
        x = F.silu(self.gn("conv_norm_out", x, u.get("norm_eps", 1e-5)))
        return self.pconv("conv_out", x)


# --------------------------------------------------------------------- VAE
class VAE(Runner):
    def __init__(self, W, P, cfg: dict):
        super().__init__(W, P)
        self.v = cfg["vae"]

    def conv(self, name, x, stride=1, padding=None):
        w = self.W[f"{name}.weight"]
        pad = w.shape[-1] // 2 if padding is None else padding
        return self.P.conv(x, w, self.W[f"{name}.bias"], stride, pad)

    def gn(self, name, x):
        return group_norm(x, self.W[f"{name}.weight"], self.W[f"{name}.bias"], self.v["norm_num_groups"], 1e-6)

    def resnet(self, name, x):
        h = self.conv(f"{name}.conv1", F.silu(self.gn(f"{name}.norm1", x)))
        h = self.conv(f"{name}.conv2", F.silu(self.gn(f"{name}.norm2", h)))
        if f"{name}.conv_shortcut.weight" in self.W:
            x = self.conv(f"{name}.conv_shortcut", x)
        return x + h

    def mid(self, name, x):
        x = self.resnet(f"{name}.resnets.0", x)
        a = f"{name}.attentions.0"
        n, h, w, c = x.shape
        t = self.gn(f"{a}.group_norm", x).reshape(n, h * w, c)
        q, k, v = (self.lin(f"{a}.{key}", t) for key in ("query", "key", "value"))
        out = torch.empty_like(q)
        for i in range(n):
            p = torch.softmax(self.P.mm(q[i], k[i].t()) * c ** -0.5, dim=-1)
            out[i] = self.P.mm(p, v[i])
        x = x + self.lin(f"{a}.proj_attn", out).reshape(n, h, w, c)
        return self.resnet(f"{name}.resnets.1", x)

    def encode(self, images: torch.Tensor):
        """[N, H, W, 3] in [-1, 1] -> (mean, logvar) [N, H/8, W/8, 4], unscaled."""
        v = self.v
        x = self.conv("encoder.conv_in", images)
        for i in range(len(v["block_out_channels"])):
            for j in range(v["layers_per_block"]):
                x = self.resnet(f"encoder.down_blocks.{i}.resnets.{j}", x)
            if i < len(v["block_out_channels"]) - 1:
                x = self.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", F.pad(x, (0, 0, 0, 1, 0, 1)), 2, 0)
        x = self.mid("encoder.mid_block", x)
        x = self.conv("encoder.conv_out", F.silu(self.gn("encoder.conv_norm_out", x)))
        mean, logvar = self.conv("quant_conv", x).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[N, h, w, 4] unscaled latents -> [N, 8h, 8w, 3]."""
        v = self.v
        x = self.mid("decoder.mid_block", self.conv("decoder.conv_in", self.conv("post_quant_conv", z)))
        for i in range(len(v["block_out_channels"])):
            for j in range(v["layers_per_block"] + 1):
                x = self.resnet(f"decoder.up_blocks.{i}.resnets.{j}", x)
            if i < len(v["block_out_channels"]) - 1:
                x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                x = self.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", x)
        return self.conv("decoder.conv_out", F.silu(self.gn("decoder.conv_norm_out", x)))


# -------------------------------------------------------------- CLIP text
class TextEncoder(Runner):
    def __init__(self, W, P, cfg: dict):
        super().__init__(W, P)
        self.t = cfg["text_encoder"]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """ids [B, 77] -> last hidden state [B, 77, C] (causal, final LayerNorm)."""
        t, W = self.t, self.W
        eps = t.get("layer_norm_eps", 1e-5)
        s = ids.shape[1]
        x = W["text_model.embeddings.token_embedding.weight"][ids] + W["text_model.embeddings.position_embedding.weight"][None, :s]
        b, _, c = x.shape
        heads = t["num_attention_heads"]
        d = c // heads
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()

        def ln(name, y):
            return layer_norm(y, W[f"{name}.weight"], W[f"{name}.bias"], eps)

        for i in range(t["num_hidden_layers"]):
            n = f"text_model.encoder.layers.{i}"
            h = ln(f"{n}.layer_norm1", x)

            def split(y):
                return y.reshape(b, s, heads, d).transpose(1, 2)

            q, k, v = (split(self.lin(f"{n}.self_attn.{p}", h)) for p in ("q_proj", "k_proj", "v_proj"))
            logits = self.P.mm(q, k.transpose(-1, -2)) * d ** -0.5
            p = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
            x = x + self.lin(f"{n}.self_attn.out_proj", self.P.mm(p, v).transpose(1, 2).reshape(b, s, c))
            h = self.lin(f"{n}.mlp.fc1", ln(f"{n}.layer_norm2", x))
            x = x + self.lin(f"{n}.mlp.fc2", h * torch.sigmoid(1.702 * h))
        return ln("text_model.final_layer_norm", x)
