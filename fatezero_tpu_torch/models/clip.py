"""CLIP (torch): the text encoder of Stable Diffusion and the ViT-B/32 dual
tower of the evaluation metrics.

Counterpart of fatezero_tpu/models/clip.py, with Hugging Face parameter names
(text_model.embeddings.token_embedding.weight, vision_model.pre_layrnorm.*
[sic], visual_projection.weight, ...), so an HF `CLIPModel` state_dict loads
as it is. One transformer serves both towers: self-attention materialised in
fp32 (causal for text), LayerNorms with fp32 statistics, a quick_gelu MLP
(or exact-erf gelu: `hidden_act`, as OpenCLIP ViT-bigG, SDXL's second
tower). A text tower returns its last hidden state after the final LayerNorm
or, with `output_layer="penultimate"` (SDXL's two towers), the input of its
last layer without it; the pooled EOS state is always the final LayerNorm's,
through `text_projection` (HF `CLIPTextModelWithProjection`'s name) where the
config has a `projection_dim`. Images enter channels-last, [B, S, S, 3], as
in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from fatezero_tpu_torch.common.profiling import spanned
from fatezero_tpu_torch.models.layers import FusedLayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    projection_dim: Optional[int] = None
    hidden_act: str = "quick_gelu"  # or "gelu" (exact erf)
    output_layer: str = "last"  # or "penultimate": the last layer's input, no final LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512


# SD-1.4's conditioning encoder and the paper-metric ViT-B/32 pair.
SD_TEXT_CONFIG = CLIPTextConfig()
VIT_B32_TEXT_CONFIG = CLIPTextConfig(hidden_size=512, intermediate_size=2048, num_heads=8, projection_dim=512)
VIT_B32_VISION_CONFIG = CLIPVisionConfig()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": torch.nn.functional.gelu}


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, num_heads: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_heads = num_heads
        self.dtype = dtype
        self.q_proj = nn.Linear(hidden, hidden, **kw)
        self.k_proj = nn.Linear(hidden, hidden, **kw)
        self.v_proj = nn.Linear(hidden, hidden, **kw)
        self.out_proj = nn.Linear(hidden, hidden, **kw)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        b, s, c = x.shape
        hd = c // self.num_heads

        def heads(t):
            return t.reshape(b, s, self.num_heads, hd).transpose(1, 2).float()

        logits = torch.matmul(heads(self.q_proj(x)), heads(self.k_proj(x)).transpose(-1, -2)) * (hd**-0.5)
        if causal:
            mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~mask, -1e10)
        probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs, heads(self.v_proj(x)))
        out = out.transpose(1, 2).reshape(b, s, c).to(self.dtype)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int, dtype=torch.float32, device=None, act: str = "quick_gelu"):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate, dtype=dtype, device=device)
        self.fc2 = nn.Linear(intermediate, hidden, dtype=dtype, device=device)
        self.act = ACTIVATIONS[act]

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads, **kw)
        self.layer_norm1 = FusedLayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size, **kw, act=getattr(cfg, "hidden_act", "quick_gelu"))
        self.layer_norm2 = FusedLayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)

    def forward(self, x, causal: bool):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype, device=device)
        self.position_embedding = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, dtype=dtype, device=device
        )

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        return self.token_embedding(input_ids) + self.position_embedding.weight[None, :s]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg, dtype=dtype, device=device) for _ in range(cfg.num_layers)]
        )

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, causal)
        return x


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg, dtype=dtype, device=device)
        self.encoder = CLIPEncoder(cfg, dtype=dtype, device=device)
        self.final_layer_norm = FusedLayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype=dtype, device=device)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.final_layer_norm(self.encoder(self.embeddings(input_ids), causal=True))

    def hidden_pair(self, input_ids: torch.Tensor):
        """(the last layer's input, the final LayerNorm's output)."""
        x = self.embeddings(input_ids)
        layers = self.encoder.layers
        for layer in layers[:-1]:
            x = layer(x, causal=True)
        return x, self.final_layer_norm(layers[-1](x, causal=True))


def pool_eot(hidden: torch.Tensor, input_ids: torch.Tensor, eos_token_id: Optional[int] = None) -> torch.Tensor:
    """The hidden state at each sequence's EOT token: the highest id (CLIP's
    convention), or the first `eos_token_id` when one is given."""
    if eos_token_id is None:
        pos = input_ids.argmax(dim=-1)
    else:
        pos = (input_ids == eos_token_id).int().argmax(dim=-1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), pos]


class CLIPTextModel(nn.Module):
    """Causal text transformer: input_ids [B, 77] -> its output hidden state
    [B, 77, C] (`output_layer`); with `pool`, also the EOT embedding of the
    final LayerNorm's output, through `text_projection` when the config has a
    `projection_dim`."""

    def __init__(self, cfg: CLIPTextConfig = SD_TEXT_CONFIG, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg, dtype=dtype, device=device)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False, dtype=dtype, device=device)

    @spanned("fz.clip.text")
    def forward(self, input_ids: torch.Tensor, pool: bool = False, eos_token_id: Optional[int] = None):
        if self.cfg.output_layer == "penultimate":
            x, last = self.text_model.hidden_pair(input_ids)
        else:
            x = last = self.text_model(input_ids)
        if not pool:
            return x
        pooled = pool_eot(last, input_ids, eos_token_id)
        if self.cfg.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return x, pooled


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size, **kw))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size, bias=False, **kw)
        self.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1, cfg.hidden_size, **kw)
        self.patch = cfg.patch_size

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] -> [B, 1 + (S/P)^2, C]: class token, then the patches in row order."""
        b, s, _, c = pixels.shape
        g, p = s // self.patch, self.patch
        # the stride-P PxP convolution as one product over non-overlapping
        # patches: a matmul, so it runs in fp32 on the card whatever cuDNN's
        # TF32 setting for convolutions is
        patches = pixels.to(self.class_embedding.dtype).reshape(b, g, p, g, p, c).permute(0, 1, 3, 5, 2, 4)
        w = self.patch_embedding.weight
        x = torch.matmul(patches.reshape(b, g * g, c * p * p), w.reshape(w.shape[0], -1).t())
        cls = self.class_embedding.expand(b, 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg, dtype=dtype, device=device)
        self.pre_layrnorm = FusedLayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype=dtype, device=device)
        self.encoder = CLIPEncoder(cfg, dtype=dtype, device=device)
        self.post_layernorm = FusedLayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype=dtype, device=device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] -> the class token's final state [B, C]."""
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixels)), causal=False)
        return self.post_layernorm(x[:, 0])


class CLIPVisionModel(nn.Module):
    """ViT image tower: [B, S, S, 3] -> the projected image embedding [B, proj]."""

    def __init__(self, cfg: CLIPVisionConfig = VIT_B32_VISION_CONFIG, dtype=torch.float32, device=None):
        super().__init__()
        self.vision_model = CLIPVisionTransformer(cfg, dtype=dtype, device=device)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False, dtype=dtype, device=device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision_model(pixels))


class CLIPModel(nn.Module):
    """Dual tower + logit scale: the evaluation model (Frame-Acc / Tem-Con),
    with HF `CLIPModel`'s parameter names."""

    def __init__(
        self,
        text_cfg: CLIPTextConfig = VIT_B32_TEXT_CONFIG,
        vision_cfg: CLIPVisionConfig = VIT_B32_VISION_CONFIG,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        if text_cfg.projection_dim != vision_cfg.projection_dim:
            raise ValueError(f"projection dims differ: text {text_cfg.projection_dim}, vision {vision_cfg.projection_dim}")
        kw = dict(dtype=dtype, device=device)
        self.text_model = CLIPTextTransformer(text_cfg, **kw)
        self.vision_model = CLIPVisionTransformer(vision_cfg, **kw)
        self.text_projection = nn.Linear(text_cfg.hidden_size, text_cfg.projection_dim, bias=False, **kw)
        self.visual_projection = nn.Linear(vision_cfg.hidden_size, vision_cfg.projection_dim, bias=False, **kw)
        self.logit_scale = nn.Parameter(torch.full((), math.log(1 / 0.07), device=device))

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_projection(pool_eot(self.text_model(input_ids), input_ids))

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision_model(pixels))

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """exp(logit_scale) * img^ @ txt^.T: [B_img, B_txt]."""
        img = self.encode_image(pixels)
        txt = self.encode_text(input_ids)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        return self.logit_scale.exp() * img @ txt.t()
