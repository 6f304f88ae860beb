"""Model bundles with deterministic random weights: `random:tiny` and `random:sd`.

Counterpart of the random-weight part of fatezero_tpu/models/loader.py.
Weights follow the rules of the JAX package's `_fast_init`: temporal conv
kernels get the dirac (identity) init, `attn_temporal.to_out` and the LoRA
up projections are zero, biases are zero, norm gains are one, and every
other weight is N(0, 0.02), drawn with numpy from `seed` in sorted key order.
The modules are built without storage (meta device), their weights made on
the host and moved to `device` once. Loading diffusers checkpoints and the
flax-native tuned checkpoints waits for a later slice.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
from torch import nn

from fatezero_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from fatezero_tpu_torch.models.layers import FusedGroupNorm, FusedLayerNorm
from fatezero_tpu_torch.models.tokenizer import StubTokenizer
from fatezero_tpu_torch.models.unet3d import UNet3DConfig, UNetPseudo3DConditionModel
from fatezero_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from fatezero_tpu_torch.ops import schedule as S

TINY_UNET = dict(
    block_out_channels=(32, 64, 128, 128),
    attention_head_dim=4,
    cross_attention_dim=32,
    norm_num_groups=8,
)
TINY_VAE = VAEConfig(block_out_channels=(16, 32, 32, 32), norm_num_groups=8)
TINY_TEXT = CLIPTextConfig(
    hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, vocab_size=1000
)


def _unet_cfg_overrides(model_config: dict) -> dict:
    """FateZero model_config keys -> UNet3DConfig fields."""
    out = {}
    if model_config.get("SparseCausalAttention_index") is not None:
        out["sparse_causal_indices"] = tuple(model_config["SparseCausalAttention_index"])
    if model_config.get("least_sc_channel"):
        out["least_sc_channel"] = int(model_config["least_sc_channel"])
    if model_config.get("temporal_downsample_time"):
        out["temporal_downsample_time"] = int(model_config["temporal_downsample_time"])
    if model_config.get("lora"):
        out["lora"] = int(model_config["lora"])
    if model_config.get("gradient_checkpointing"):
        out["gradient_checkpointing"] = True
    return out


def random_state(module: nn.Module, seed: int) -> dict:
    """Deterministic host weights for every parameter of `module` (numpy fp32)."""
    norm_params = {
        f"{name}.{p}"
        for name, m in module.named_modules()
        if isinstance(m, (FusedGroupNorm, FusedLayerNorm))
        for p in ("weight", "bias")
    }
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in sorted(module.state_dict().items()):
        shape = tuple(p.shape)
        if name.endswith("conv_temporal.weight"):
            w = np.zeros(shape, np.float32)  # dirac: identity centre tap
            w[:, :, shape[2] // 2] = np.eye(shape[0], shape[1], dtype=np.float32)
        elif name.endswith("bias") or "attn_temporal.to_out" in name or name.endswith("conv_temporal.up.weight"):
            w = np.zeros(shape, np.float32)
        elif name in norm_params:
            w = np.ones(shape, np.float32)
        else:
            w = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        state[name] = w
    return state


def load_state(module: nn.Module, state: dict, device) -> nn.Module:
    """Load a {key: numpy array} state_dict into `module` on `device`, keeping
    each parameter's own dtype (model dtype, fp32 for norms). Works for a
    module built on the meta device. The module owns its storage: the arrays
    are copied, never shared."""
    own = module.state_dict()
    missing = set(own) - set(state)
    extra = set(state) - set(own)
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {sorted(missing)[:5]}, unexpected {sorted(extra)[:5]}")
    tensors = {}
    for k, ref in own.items():
        v = torch.from_numpy(np.ascontiguousarray(state[k]))
        if tuple(v.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(v.shape)} vs {tuple(ref.shape)}")
        # a copy, so that training in place never writes into the caller's arrays
        tensors[k] = v.to(device=device, dtype=ref.dtype, copy=True)
    module.load_state_dict(tensors, assign=True)
    return module


def load_models(
    pretrained_model_path: str,
    model_config: Optional[dict] = None,
    dtype=torch.float32,
    seed: int = 0,
    device="cuda",
) -> SimpleNamespace:
    """Build (unet, vae, text_encoder, tokenizer, schedule) for `random:tiny` or `random:sd`
    on `device` (the card unless the caller asks for the CPU)."""
    if not pretrained_model_path.startswith("random:"):
        raise NotImplementedError(
            "only the random:tiny and random:sd builders are ported; checkpoint loading is not"
        )
    tag = pretrained_model_path.split(":", 1)[1]
    overrides = _unet_cfg_overrides(dict(model_config or {}))
    if tag == "tiny":
        unet_cfg = UNet3DConfig(**{**TINY_UNET, **overrides})
        vae_cfg, text_cfg = TINY_VAE, TINY_TEXT
    elif tag == "sd":
        unet_cfg = UNet3DConfig(**overrides)
        vae_cfg, text_cfg = VAEConfig(), CLIPTextConfig()
    else:
        raise ValueError(f"unknown random checkpoint {pretrained_model_path!r}")

    def build(ctor, *args):
        module = ctor(*args, dtype=dtype, device="meta")
        return load_state(module, random_state(module, seed), device).eval()

    return SimpleNamespace(
        unet=build(UNetPseudo3DConditionModel, unet_cfg),
        vae=build(AutoencoderKL, vae_cfg),
        text_encoder=build(CLIPTextModel, text_cfg),
        tokenizer=StubTokenizer(vocab_size=text_cfg.vocab_size),
        schedule=S.make_schedule(device=device),
    )
