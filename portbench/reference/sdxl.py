"""Plain float32 SDXL-base 1.0, inflated as FateZero inflates it.

The repository's reference for SDXL (stabilityai/stable-diffusion-xl-base-1.0;
Podell et al., arXiv:2307.01952): the benchmark's check holds the program
against it, and so do the CPU tests. It is diffusers' UNet2DConditionModel
under SDXL's unet/config.json, with diffusers parameter names:

* three levels; each level's attention sites hold `transformer_layers_per_block`
  transformer blocks (the mid block the last entry's) of
  `attention_head_dim` heads (diffusers' legacy name for the head count),
  between linear `proj_in` / `proj_out`;
* the text-time added embedding: `add_embedding` (a two-layer SiLU MLP)
  of the pooled text embeds and the sinusoids (`addition_time_embed_dim`
  wide each) of the six time ids, added to the time embedding;
* the context is the two text towers' penultimate hidden states (no final
  LayerNorm) side by side: CLIP ViT-L (quick_gelu) and OpenCLIP ViT-bigG
  (exact-erf gelu); the pooled embeds are bigG's final-LayerNorm state at the
  EOS token through `text_projection` (HF CLIPTextModelWithProjection);
* the VAE is SD's (portbench/reference/sd.py), scaled by the config's
  `scaling_factor`.

FateZero's inflation is sd.py's: temporal convolutions (LoRA pairs with
`lora`), sparse-causal self-attention from `least_sc_channel` up, and a
temporal attention at the end of every transformer block.

Departures from the published description, each also the program's:

* the pooled EOS state is read at each row's first `eos_token_id` (HF's
  rule for a tokenizer whose EOS is not its largest id; for CLIP's BPE
  vocabulary, whose EOS is the largest id, the same position);
* the unconditional row follows `force_zeros_for_empty_prompt` (SDXL's
  model_index.json): an empty negative prompt encodes as zeros, context and
  pooled embeds alike; the caller applies it (`EditReferenceXL`);
* the time ids are (H, W, 0, 0, H, W) of the clip's frames: the original
  size, no crop, the target size;
* the inversion and the edit use DDIM (reference/diffusion.py) on the
  published scheduler's betas, as FateZero does, not the published Euler
  sampler.

Nothing here is imported from the program under test.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import sd
from portbench.reference.diffusion import guidance
from portbench.reference.edit import EditReference
from portbench.reference.sd import MAX_CONTROLLED, Spec, layer_norm, sparse_frames, timestep_embedding


def per_level(value, n: int) -> List[int]:
    """A per-level key of the UNet config: one value for every level, or a list."""
    return [int(v) for v in value] if isinstance(value, (list, tuple)) else [int(value)] * n


def level_of(name: str, n: int) -> int:
    """The level of a UNet parameter or module name: down_blocks.i -> i, the
    mid block -> the last, up_blocks.i -> n - 1 - i."""
    head, _, rest = name.partition(".")
    if head == "mid_block":
        return n - 1
    i = int(rest.split(".", 1)[0])
    return i if head == "down_blocks" else n - 1 - i


# ------------------------------------------------------------------- spec
def unet_spec(cfg: dict) -> Spec:
    u, mc = cfg["unet"], cfg.get("model_config", {})
    lora = mc.get("lora")
    sb = sd._SpecBuilder()
    chs = u["block_out_channels"]
    n = len(chs)
    depth = per_level(u.get("transformer_layers_per_block", 1), n)
    ch0, temb = chs[0], chs[0] * 4
    cross = u["cross_attention_dim"]

    def resnet(name, cin, cout):
        sb.norm(f"{name}.norm1", cin)
        sd._pseudo_conv(sb, f"{name}.conv1", cin, cout, 3, lora)
        sb.linear(f"{name}.time_emb_proj", temb, cout)
        sb.norm(f"{name}.norm2", cout)
        sd._pseudo_conv(sb, f"{name}.conv2", cout, cout, 3, lora)
        if cin != cout:
            sd._pseudo_conv(sb, f"{name}.conv_shortcut", cin, cout, 1, lora)

    def transformer(name, c, level):
        sb.norm(f"{name}.norm", c)
        sb.linear(f"{name}.proj_in", c, c)
        for k in range(depth[level]):
            b = f"{name}.transformer_blocks.{k}"
            sb.norm(f"{b}.norm1", c)
            sd._attention(sb, f"{b}.attn1", c, c, c)
            sb.norm(f"{b}.norm2", c)
            sd._attention(sb, f"{b}.attn2", c, c, cross)
            sb.norm(f"{b}.norm3", c)
            sb.linear(f"{b}.ff.net.0.proj", c, c * 8)
            sb.linear(f"{b}.ff.net.2", c * 4, c)
            sb.norm(f"{b}.norm_temporal", c)
            sd._attention(sb, f"{b}.attn_temporal", c, c, c)
        sb.linear(f"{name}.proj_out", c, c)

    sd._pseudo_conv(sb, "conv_in", u["in_channels"], ch0, 3, lora)
    sb.linear("time_embedding.linear_1", ch0, temb)
    sb.linear("time_embedding.linear_2", temb, temb)
    sb.linear("add_embedding.linear_1", u["projection_class_embeddings_input_dim"], temb)
    sb.linear("add_embedding.linear_2", temb, temb)
    skips, cin = [ch0], ch0
    for i, kind in enumerate(u["down_block_types"]):
        cout = chs[i]
        for j in range(u["layers_per_block"]):
            resnet(f"down_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout)
            if kind.startswith("CrossAttn"):
                transformer(f"down_blocks.{i}.attentions.{j}", cout, i)
            skips.append(cout)
        if i < n - 1:
            sd._pseudo_conv(sb, f"down_blocks.{i}.downsamplers.0.conv", cout, cout, 3, lora)
            skips.append(cout)
        cin = cout
    cmid = chs[-1]
    resnet("mid_block.resnets.0", cmid, cmid)
    transformer("mid_block.attentions.0", cmid, n - 1)
    resnet("mid_block.resnets.1", cmid, cmid)
    rev = list(reversed(chs))
    cin = cmid
    for i, kind in enumerate(u["up_block_types"]):
        cout = rev[i]
        for j in range(u["layers_per_block"] + 1):
            resnet(f"up_blocks.{i}.resnets.{j}", (cin if j == 0 else cout) + skips.pop(), cout)
            if kind.startswith("CrossAttn"):
                transformer(f"up_blocks.{i}.attentions.{j}", cout, n - 1 - i)
        if i < n - 1:
            sd._pseudo_conv(sb, f"up_blocks.{i}.upsamplers.0.conv", cout, cout, 3, lora)
        cin = cout
    sb.norm("conv_norm_out", ch0)
    sd._pseudo_conv(sb, "conv_out", ch0, u["out_channels"], 3, lora)
    return sb.done()


def tower_spec(t: dict, projection: bool) -> Spec:
    """A CLIP text tower under HF's names; with `projection`, CLIPTextModelWithProjection's."""
    sb = sd._SpecBuilder()
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
    if projection:
        sb.linear("text_projection", c, t["projection_dim"], bias=False)
    return sb.done()


SPECS = {
    "unet": unet_spec,
    "vae": sd.vae_spec,
    "text_encoder": lambda cfg: tower_spec(cfg["text_encoder"], False),
    "text_encoder_2": lambda cfg: tower_spec(cfg["text_encoder_2"], True),
}


# -------------------------------------------------------------------- UNet
class UNetXL(sd.UNet):
    """sd.UNet with per-level heads and stack depths and the text-time embedding."""

    def __init__(self, W, P, cfg: dict, ctl=None):
        super().__init__(W, P, cfg, ctl)
        n = len(self.u["block_out_channels"])
        self.n = n
        self.heads = per_level(self.u["attention_head_dim"], n)
        self.depth = per_level(self.u.get("transformer_layers_per_block", 1), n)

    def attention(self, name, x, context, place, sparse):
        """x [b, f, s, c]; context [b, 77, c_cross] or None (self)."""
        b, f, s, c = x.shape
        heads = self.heads[level_of(name, self.n)]
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
            kh = split(torch.cat([k[:, idx] for idx in frames], dim=2))
            vh = split(torch.cat([v[:, idx] for idx in frames], dim=2))
        else:
            kh = split(k)[:, None].expand(b, f, heads, k.shape[1], d)
            vh = split(v)[:, None].expand(b, f, heads, k.shape[1], d)
        if self.ctl is not None and s <= MAX_CONTROLLED:
            probs = torch.softmax(self.P.mm(qh, kh.transpose(-1, -2)) * d ** -0.5, dim=-1)
            out = self.P.mm(self.ctl(probs, place, context is not None), vh)
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
        heads = self.heads[level_of(name, self.n)]
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
        for k in range(self.depth[level_of(name, self.n)]):
            blk = f"{name}.transformer_blocks.{k}"

            def ln(n, t, blk=blk):
                return layer_norm(t, self.W[f"{blk}.{n}.weight"], self.W[f"{blk}.{n}.bias"])

            h = h + self.attention(f"{blk}.attn1", ln("norm1", h), None, place, sparse)
            h = h + self.attention(f"{blk}.attn2", ln("norm2", h), context, place, sparse)
            a, gate = self.lin(f"{blk}.ff.net.0.proj", ln("norm3", h)).chunk(2, dim=-1)
            h = h + self.lin(f"{blk}.ff.net.2", a * F.gelu(gate))
            if f > 1:
                h = h + self.temporal_attention(f"{blk}.attn_temporal", ln("norm_temporal", h))
        return self.lin(f"{name}.proj_out", h.reshape(b, f, hh, ww, c)) + x

    def forward(self, sample: torch.Tensor, t, context: torch.Tensor, text_embeds: torch.Tensor,
                time_ids: torch.Tensor) -> torch.Tensor:
        """sample [B, F, H, W, 4], t int or [B], context [B, 77, C], text_embeds
        [B, P], time_ids [B, 6] -> eps [B, F, H, W, 4]."""
        u = self.u
        b = sample.shape[0]
        t = torch.as_tensor(t, device=sample.device)
        t = t.expand(b) if t.dim() == 0 else t
        flip, shift = u.get("flip_sin_to_cos", True), u.get("freq_shift", 0)
        temb = timestep_embedding(t, u["block_out_channels"][0], flip, shift)
        temb = self.lin("time_embedding.linear_2", F.silu(self.lin("time_embedding.linear_1", temb)))
        t_ids = timestep_embedding(time_ids.reshape(-1), u["addition_time_embed_dim"], flip, shift).reshape(b, -1)
        add = torch.cat([text_embeds.float(), t_ids], dim=-1)
        temb = temb + self.lin("add_embedding.linear_2", F.silu(self.lin("add_embedding.linear_1", add)))
        x = self.pconv("conv_in", sample)
        skips = [x]
        n = self.n
        for i, kind in enumerate(u["down_block_types"]):
            for j in range(u["layers_per_block"]):
                x = self.resnet(f"down_blocks.{i}.resnets.{j}", x, temb)
                if kind.startswith("CrossAttn"):
                    x = self.transformer(f"down_blocks.{i}.attentions.{j}", x, context, "down")
                skips.append(x)
            if i < n - 1:
                x = self.pconv(f"down_blocks.{i}.downsamplers.0.conv", x, stride=2)
                skips.append(x)
        x = self.resnet("mid_block.resnets.0", x, temb)
        x = self.transformer("mid_block.attentions.0", x, context, "mid")
        x = self.resnet("mid_block.resnets.1", x, temb)
        for i, kind in enumerate(u["up_block_types"]):
            for j in range(u["layers_per_block"] + 1):
                x = self.resnet(f"up_blocks.{i}.resnets.{j}", torch.cat([x, skips.pop()], dim=-1), temb)
                if kind.startswith("CrossAttn"):
                    x = self.transformer(f"up_blocks.{i}.attentions.{j}", x, context, "up")
            if i < n - 1:
                x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                x = self.pconv(f"up_blocks.{i}.upsamplers.0.conv", x)
        x = F.silu(self.gn("conv_norm_out", x, u.get("norm_eps", 1e-5)))
        return self.pconv("conv_out", x)


# -------------------------------------------------------------- CLIP text
ACTS = {"quick_gelu": lambda h: h * torch.sigmoid(1.702 * h), "gelu": F.gelu}


class TextTower(sd.Runner):
    """One CLIP text tower: ids [B, 77] -> (the penultimate hidden state
    [B, 77, C], the final LayerNorm's state at the first EOS, through
    `text_projection` where the tower has one)."""

    def __init__(self, W, P, t: dict):
        super().__init__(W, P)
        self.t = t

    def forward(self, ids: torch.Tensor, eos_token_id: int):
        t, W = self.t, self.W
        eps = t.get("layer_norm_eps", 1e-5)
        act = ACTS[t.get("hidden_act", "quick_gelu")]
        s = ids.shape[1]
        x = W["text_model.embeddings.token_embedding.weight"][ids] + W["text_model.embeddings.position_embedding.weight"][None, :s]
        b, _, c = x.shape
        heads = t["num_attention_heads"]
        d = c // heads
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()

        def ln(name, y):
            return layer_norm(y, W[f"{name}.weight"], W[f"{name}.bias"], eps)

        def split(y):
            return y.reshape(b, s, heads, d).transpose(1, 2)

        penultimate = None
        for i in range(t["num_hidden_layers"]):
            if i == t["num_hidden_layers"] - 1:
                penultimate = x
            n = f"text_model.encoder.layers.{i}"
            h = ln(f"{n}.layer_norm1", x)
            q, k, v = (split(self.lin(f"{n}.self_attn.{p}", h)) for p in ("q_proj", "k_proj", "v_proj"))
            logits = self.P.mm(q, k.transpose(-1, -2)) * d ** -0.5
            p = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
            x = x + self.lin(f"{n}.self_attn.out_proj", self.P.mm(p, v).transpose(1, 2).reshape(b, s, c))
            x = x + self.lin(f"{n}.mlp.fc2", act(self.lin(f"{n}.mlp.fc1", ln(f"{n}.layer_norm2", x))))
        last = ln("text_model.final_layer_norm", x)
        pooled = last[torch.arange(b, device=x.device), (ids == eos_token_id).int().argmax(dim=-1)]
        if "text_projection.weight" in W:
            pooled = self.lin("text_projection", pooled, bias=False)
        return penultimate, pooled


# -------------------------------------------------------------------- edit
class EditReferenceXL(EditReference):
    """reference/edit.py's edit for SDXL: a prompt encodes as (context
    [2, 77, C1 + C2], pooled [2, P]), with the empty uncond row zeros, and
    every UNet call adds the pooled embeds and the clip's time ids."""

    def __init__(self, W: Dict[str, Dict[str, torch.Tensor]], cfg: dict, P, mix: dict, tok: Dict, device,
                 eos_token_id: int):
        super().__init__(W, cfg, P, mix, tok, device)
        self.unet = UNetXL(W["unet"], P, cfg)
        self.text = TextTower(W["text_encoder"], P, cfg["text_encoder"])
        self.text_2 = TextTower(W["text_encoder_2"], P, cfg["text_encoder_2"])
        self.eos = eos_token_id
        self.scale = float(cfg["vae"]["scaling_factor"])
        self.down = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)

    @torch.no_grad()
    def encode_prompt(self, ids: np.ndarray, ids_2: Optional[np.ndarray] = None):
        """ids [2, 77] of (the empty prompt, a prompt) for each tower (the
        second tower's tokenizer's ids, or the same) -> (context, pooled)."""
        ids = torch.as_tensor(ids, device=self.device)
        ids_2 = ids if ids_2 is None else torch.as_tensor(ids_2, device=self.device)
        ctx_1, _ = self.text.forward(ids, self.eos)
        ctx_2, pooled = self.text_2.forward(ids_2, self.eos)
        context = torch.cat([ctx_1, ctx_2], dim=-1)
        keep = torch.tensor([0.0, 1.0], device=self.device)  # force_zeros_for_empty_prompt
        return context * keep[:, None, None], pooled * keep[:, None]

    @torch.no_grad()
    def encode_video(self, frames: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.vae.encode(frames[i:i + 1])[0][0] for i in range(frames.shape[0])])[None] * self.scale

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        z = latents[0] / self.scale
        out = torch.cat([self.vae.decode(z[i:i + 1]) for i in range(z.shape[0])])
        return (out / 2 + 0.5).clamp(0, 1)

    def _eps(self, x, t, emb):
        context, pooled = emb
        h, w = x.shape[2] * self.down, x.shape[3] * self.down
        time_ids = torch.tensor([[h, w, 0, 0, h, w]], dtype=torch.float32, device=x.device).expand(x.shape[0], 6)
        return self.unet.forward(x, t, context, pooled, time_ids)

    @torch.no_grad()
    def invert_step(self, x: torch.Tensor, i: int, emb_src):
        t = self.ts[self.steps - 1 - i]
        eps = self._eps(x, t, (emb_src[0][-1:], emb_src[1][-1:]))
        dt = 1000 // self.steps
        return self.sched.invert_step(eps, t, x, self.steps), eps, self.sched.eps_coef(t - dt, t)

    @torch.no_grad()
    def edit_step(self, x: torch.Tensor, i: int, source: torch.Tensor, emb_src, emb_tgt):
        t = self.ts[i]
        emb = (torch.cat([emb_src[0][-1:], emb_tgt[0]]), torch.cat([emb_src[1][-1:], emb_tgt[1]]))
        self.unet.ctl = lambda probs, place, is_cross: self.p2p.fuse(probs, is_cross, i)
        try:
            eps = self._eps(torch.cat([source, x, x]), t, emb)
        finally:
            self.unet.ctl = None
        eps = guidance(eps[1:2], eps[2:3], float(self.mix["guidance_scale"]))
        dt = 1000 // self.steps
        return self.sched.denoise_step(eps, t, x, self.steps), eps, self.sched.eps_coef(t, t - dt)
