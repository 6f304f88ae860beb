"""CLIP text encoder (torch), the conditioning tower of Stable Diffusion.

Counterpart of fatezero_tpu/models/clip.py::CLIPTextModel, with Hugging Face
parameter names (text_model.embeddings.token_embedding.weight, ...). Causal
self-attention in fp32, LayerNorms with fp32 statistics, quick_gelu MLP.
The dual-tower evaluation model waits for the evaluation slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

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


SD_TEXT_CONFIG = CLIPTextConfig()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


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
    def __init__(self, hidden: int, intermediate: int, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate, dtype=dtype, device=device)
        self.fc2 = nn.Linear(intermediate, hidden, dtype=dtype, device=device)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads, **kw)
        self.layer_norm1 = FusedLayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size, **kw)
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
    def __init__(self, cfg: CLIPTextConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg, dtype=dtype, device=device) for _ in range(cfg.num_layers)]
        )


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg, dtype=dtype, device=device)
        self.encoder = CLIPEncoder(cfg, dtype=dtype, device=device)
        self.final_layer_norm = FusedLayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype=dtype, device=device)


class CLIPTextModel(nn.Module):
    """Causal text transformer: input_ids [B, 77] -> last_hidden_state [B, 77, C]."""

    def __init__(self, cfg: CLIPTextConfig = SD_TEXT_CONFIG, dtype=torch.float32, device=None):
        super().__init__()
        if cfg.projection_dim is not None:
            raise NotImplementedError("the projected (evaluation) text tower is not ported yet")
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg, dtype=dtype, device=device)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        x = tm.embeddings(input_ids)
        for layer in tm.encoder.layers:
            x = layer(x, causal=True)
        return tm.final_layer_norm(x)
