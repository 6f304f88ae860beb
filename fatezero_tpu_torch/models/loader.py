"""Model bundles: checkpoints and deterministic random weights.

Counterpart of fatezero_tpu/models/loader.py. `load_models(path)` builds
(unet, vae, text_encoder, tokenizer, schedule) on `device` from

* a diffusers checkpoint folder (tokenizer/, text_encoder/, vae/, unet/,
  scheduler/): the 2-D Stable-Diffusion weights load by name, since the
  port's modules use diffusers/HF parameter names; the inflation-added
  parameters (`temporal` or `lora` in their name) take the random init.
  An SDXL folder (text_encoder_2/ and tokenizer_2/ besides) adds the second
  tower and its tokenizer (`text_encoder_2`, `tokenizer_2`), both towers
  read at their penultimate layer; the VAE's `scaling_factor` comes from its
  config;
* a flax-native checkpoint written by the JAX package
  (fatezero_tpu/common/checkpoint.py), converted with convert/from_flax.py;
* `random:tiny` / `random:sd` / `random:tiny-xl` / `random:sdxl`, or a path
  that does not exist (with a warning, as in JAX): deterministic random
  weights. `random:sdxl` has SDXL-base 1.0's published widths and
  `random:tiny-xl` its layout at a size the CPU tests hold (3 levels,
  per-level heads, depths (1, 2, 3), two tiny towers).

Random weights follow the rules of the JAX package's `_fast_init`: temporal
conv kernels get the dirac (identity) init, `attn_temporal.to_out` and the
LoRA up projections are zero, biases are zero, norm gains are one, and every
other weight is N(0, 0.02), drawn with numpy from `seed` in sorted key order
(another stream than JAX's, so only the zero and identity leaves agree).
The modules are built without storage (meta device), their weights made on
the host and moved to `device` once.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import warnings
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from fatezero_tpu_torch.common.checkpoint import (
    is_flax_checkpoint,
    load_component_config,
    load_component_params,
    read_safetensors,
)
from fatezero_tpu_torch.convert.from_flax import (
    clip_text_state_from_flax,
    unet_state_from_flax,
    vae_state_from_flax,
)
from fatezero_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from fatezero_tpu_torch.models.layers import FusedGroupNorm, FusedLayerNorm
from fatezero_tpu_torch.models.tokenizer import CLIPTokenizer, StubTokenizer
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

# SDXL-base 1.0 (stabilityai/stable-diffusion-xl-base-1.0: unet/, vae/,
# text_encoder/ and text_encoder_2/ configs)
SDXL_UNET = dict(
    sample_size=128,
    down_block_types=("DownBlockPseudo3D", "CrossAttnDownBlockPseudo3D", "CrossAttnDownBlockPseudo3D"),
    up_block_types=("CrossAttnUpBlockPseudo3D", "CrossAttnUpBlockPseudo3D", "UpBlockPseudo3D"),
    block_out_channels=(320, 640, 1280),
    attention_head_dim=(5, 10, 20),
    transformer_layers_per_block=(1, 2, 10),
    cross_attention_dim=2048,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,
)
SDXL_VAE = VAEConfig(scaling_factor=0.13025)
SDXL_TEXT = CLIPTextConfig(output_layer="penultimate")
SDXL_TEXT_2 = CLIPTextConfig(hidden_size=1280, intermediate_size=5120, num_layers=32, num_heads=20,
                             projection_dim=1280, hidden_act="gelu", output_layer="penultimate")
TINY_XL_UNET = dict(
    SDXL_UNET,
    block_out_channels=(32, 64, 128),
    attention_head_dim=(2, 4, 8),
    transformer_layers_per_block=(1, 2, 3),
    cross_attention_dim=32 + 128,
    norm_num_groups=8,
    addition_time_embed_dim=16,
    projection_class_embeddings_input_dim=40 + 6 * 16,
)
TINY_XL_VAE = dataclasses.replace(TINY_VAE, scaling_factor=0.13025)
TINY_XL_TEXT = dataclasses.replace(TINY_TEXT, output_layer="penultimate")
TINY_XL_TEXT_2 = CLIPTextConfig(hidden_size=128, intermediate_size=512, num_layers=32, num_heads=4, vocab_size=1000,
                                projection_dim=40, hidden_act="gelu", output_layer="penultimate")


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


def random_state(module: nn.Module, seed: int, names=None) -> dict:
    """Deterministic host weights for every parameter of `module` (numpy fp32),
    or only for those in `names` (the others are neither drawn nor returned)."""
    norm_params = {
        f"{name}.{p}"
        for name, m in module.named_modules()
        if isinstance(m, (FusedGroupNorm, FusedLayerNorm))
        for p in ("weight", "bias")
    }
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in sorted(module.state_dict().items()):
        if names is not None and name not in names:
            continue
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
        v = torch.from_numpy(np.ascontiguousarray(state[k]).reshape(np.shape(state[k])))  # 0-d stays 0-d
        if tuple(v.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(v.shape)} vs {tuple(ref.shape)}")
        # a copy, so that training in place never writes into the caller's arrays
        tensors[k] = v.to(device=device, dtype=ref.dtype, copy=True)
    module.load_state_dict(tensors, assign=True)
    return module


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _schedule_from_config(cfg: dict, device) -> S.DiffusionSchedule:
    return S.make_schedule(
        num_train_timesteps=cfg.get("num_train_timesteps", 1000),
        beta_start=cfg.get("beta_start", 0.00085),
        beta_end=cfg.get("beta_end", 0.012),
        beta_schedule=cfg.get("beta_schedule", "scaled_linear"),
        set_alpha_to_one=cfg.get("set_alpha_to_one", False),
        prediction_type=cfg.get("prediction_type", "epsilon"),
        clip_sample=cfg.get("clip_sample", False),
        device=device,
    )


def _schedule_at(path: str, device) -> S.DiffusionSchedule:
    sched_path = os.path.join(path, "scheduler", "scheduler_config.json")
    if os.path.exists(sched_path):
        return _schedule_from_config(_read_json(sched_path), device)
    return S.make_schedule(device=device)


def _build(ctor, cfg, dtype, device, state_fn) -> nn.Module:
    """`ctor(cfg)` without storage, then its weights from `state_fn(module)`
    on `device`; on the meta device no weights are made."""
    module = ctor(cfg, dtype=dtype, device="meta")
    if torch.device(device).type == "meta":
        return module.eval()
    return load_state(module, state_fn(module), device).eval()


def load_models(
    pretrained_model_path: str,
    model_config: Optional[dict] = None,
    dtype=torch.float32,
    seed: int = 0,
    device="cuda",
) -> SimpleNamespace:
    """Build (unet, vae, text_encoder, tokenizer, schedule) on `device` (the
    card unless the caller asks for the CPU): a directory loads as a
    checkpoint; `random:tiny` / `random:sd`, or any path that does not exist
    (with a warning), builds deterministic random weights."""
    model_config = dict(model_config or {})
    if os.path.isdir(pretrained_model_path):
        return _load_pretrained(pretrained_model_path, model_config, dtype, seed, device)
    is_random = pretrained_model_path.startswith("random")
    tag = pretrained_model_path.split(":", 1)[-1] if ":" in pretrained_model_path else "sd"
    if not is_random:
        warnings.warn(
            f"pretrained_model_path {pretrained_model_path!r} does not exist; "
            f"building randomly initialized '{tag}' architecture"
        )
    overrides = _unet_cfg_overrides(model_config)
    text_cfg_2 = None
    if tag == "tiny":
        unet_cfg = UNet3DConfig(**{**TINY_UNET, **overrides})
        vae_cfg, text_cfg = TINY_VAE, TINY_TEXT
    elif tag == "sd" or not is_random:
        unet_cfg = UNet3DConfig(**overrides)
        vae_cfg, text_cfg = VAEConfig(), CLIPTextConfig()
    elif tag == "tiny-xl":
        unet_cfg = UNet3DConfig(**{**TINY_XL_UNET, **overrides})
        vae_cfg, text_cfg, text_cfg_2 = TINY_XL_VAE, TINY_XL_TEXT, TINY_XL_TEXT_2
    elif tag == "sdxl":
        unet_cfg = UNet3DConfig(**{**SDXL_UNET, **overrides})
        vae_cfg, text_cfg, text_cfg_2 = SDXL_VAE, SDXL_TEXT, SDXL_TEXT_2
    else:
        raise ValueError(f"unknown random checkpoint {pretrained_model_path!r}")

    def draw(module):
        return random_state(module, seed)

    bundle = SimpleNamespace(
        unet=_build(UNetPseudo3DConditionModel, unet_cfg, dtype, device, draw),
        vae=_build(AutoencoderKL, vae_cfg, dtype, device, draw),
        text_encoder=_build(CLIPTextModel, text_cfg, dtype, device, draw),
        tokenizer=StubTokenizer(vocab_size=text_cfg.vocab_size),
        schedule=S.make_schedule(device=device),
        pretrained=False,
    )
    if text_cfg_2 is not None:
        bundle.text_encoder_2 = _build(CLIPTextModel, text_cfg_2, dtype, device, lambda m: random_state(m, seed + 1))
        bundle.tokenizer_2 = StubTokenizer(vocab_size=text_cfg_2.vocab_size)
    return bundle


# ------------------------------------------------------------- diffusers layout
def load_torch_state(model_dir: str) -> Dict[str, np.ndarray]:
    """A diffusers weight file as {key: numpy array}: the first *.safetensors,
    else the first *.bin (torch.load with weights_only)."""
    st = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if st:
        return read_safetensors(st[0])
    bins = sorted(glob.glob(os.path.join(model_dir, "*.bin")))
    if not bins:
        raise FileNotFoundError(f"no weight file under {model_dir}")
    sd = torch.load(bins[0], map_location="cpu", weights_only=True)
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in sd.items()}


def _unet_keys(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A diffusers UNet state_dict under the port's names: BatchNorm counters
    dropped, and the transformers' 1x1-conv proj_in/proj_out as linears."""
    out = {}
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith((".proj_in.weight", ".proj_out.weight")) and ".attentions." in k and v.ndim == 4:
            v = v[:, :, 0, 0]
        out[k] = v
    return out


def _text_keys(state: Dict[str, np.ndarray], projection: bool = False) -> Dict[str, np.ndarray]:
    """The text tower's keys of an HF CLIP state_dict (its position_ids buffer
    dropped), with `projection` also `text_projection.weight`
    (CLIPTextModelWithProjection)."""
    return {k: v for k, v in state.items()
            if (k.startswith("text_model.") or (projection and k == "text_projection.weight"))
            and "position_ids" not in k}


def text_config(text_json: dict, output_layer: str = "last", projection: bool = False) -> CLIPTextConfig:
    """An HF CLIP text config.json as the port's CLIPTextConfig."""
    return CLIPTextConfig(
        vocab_size=text_json.get("vocab_size", 49408),
        hidden_size=text_json.get("hidden_size", 768),
        intermediate_size=text_json.get("intermediate_size", 3072),
        num_layers=text_json.get("num_hidden_layers", 12),
        num_heads=text_json.get("num_attention_heads", 12),
        max_position_embeddings=text_json.get("max_position_embeddings", 77),
        layer_norm_eps=text_json.get("layer_norm_eps", 1e-5),
        hidden_act=text_json.get("hidden_act", "quick_gelu"),
        projection_dim=text_json.get("projection_dim", 768) if projection else None,
        output_layer=output_layer,
    )


def clip_model_state(model_dir: str) -> Dict[str, np.ndarray]:
    """An HF `CLIPModel` folder's weights under the port's CLIPModel names:
    the `position_ids` buffers dropped, and `pre_layernorm` (which some
    exports spell so) read as HF's own `pre_layrnorm`."""
    return {
        k.replace("vision_model.pre_layernorm.", "vision_model.pre_layrnorm."): v
        for k, v in load_torch_state(model_dir).items()
        if "position_ids" not in k
    }


def merge_checkpoint(module: nn.Module, ckpt: Dict[str, np.ndarray], seed: int, what: str) -> dict:
    """The module's state: `ckpt` over random_state for the parameters it lacks.
    As strict as the JAX package's merge_into_params with its converters'
    leftover checks: every checkpoint key must name a parameter of the same
    shape, and a parameter may be missing from the checkpoint only if it was
    added by the 2-D -> pseudo-3-D inflation (`temporal` or `lora` in its name)."""
    own = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    for k, v in ckpt.items():
        if k not in own:
            raise KeyError(f"{what} checkpoint key {k} not in model params")
        if tuple(v.shape) != own[k]:
            raise ValueError(f"shape mismatch at {what} {k}: ckpt {tuple(v.shape)} vs model {own[k]}")
    missing = [k for k in own if k not in ckpt]
    bad = [k for k in missing if "temporal" not in k and "lora" not in k]
    if bad:
        raise KeyError(f"{what} model param {bad[0]} missing from checkpoint ({len(bad)} in all)")
    return {**random_state(module, seed, names=set(missing)), **ckpt}


def _load_pretrained(path: str, model_config: dict, dtype, seed: int, device="cuda") -> SimpleNamespace:
    if is_flax_checkpoint(path):
        return _load_flax_native(path, model_config, dtype, device)
    tokenizer = CLIPTokenizer.from_pretrained(path)

    unet_json = _read_json(os.path.join(path, "unet", "config.json"))
    unet_cfg = UNet3DConfig.from_reference({**unet_json, **model_config})
    unet_ckpt = _unet_keys(load_torch_state(os.path.join(path, "unet")))
    unet = _build(UNetPseudo3DConditionModel, unet_cfg, dtype, device,
                  lambda m: merge_checkpoint(m, unet_ckpt, seed, "UNet"))

    vae_json = _read_json(os.path.join(path, "vae", "config.json"))
    vae_cfg = VAEConfig(
        block_out_channels=tuple(vae_json.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=vae_json.get("layers_per_block", 2),
        latent_channels=vae_json.get("latent_channels", 4),
        norm_num_groups=vae_json.get("norm_num_groups", 32),
        scaling_factor=vae_json.get("scaling_factor", 0.18215),
    )
    vae_ckpt = load_torch_state(os.path.join(path, "vae"))
    vae = _build(AutoencoderKL, vae_cfg, dtype, device, lambda m: merge_checkpoint(m, vae_ckpt, seed, "VAE"))

    # two towers (SDXL): both read at their penultimate layer, the second pooled and projected
    two = os.path.isdir(os.path.join(path, "text_encoder_2"))
    output_layer = "penultimate" if two else "last"
    text_json = _read_json(os.path.join(path, "text_encoder", "config.json"))
    text_cfg = text_config(text_json, output_layer)
    text_ckpt = _text_keys(load_torch_state(os.path.join(path, "text_encoder")))
    text_encoder = _build(CLIPTextModel, text_cfg, dtype, device,
                          lambda m: merge_checkpoint(m, text_ckpt, seed, "CLIP text"))
    bundle = SimpleNamespace(
        unet=unet, vae=vae, text_encoder=text_encoder, tokenizer=tokenizer,
        schedule=_schedule_at(path, device), pretrained=True,
    )
    if two:
        text_cfg_2 = text_config(_read_json(os.path.join(path, "text_encoder_2", "config.json")), output_layer, True)
        text_ckpt_2 = _text_keys(load_torch_state(os.path.join(path, "text_encoder_2")), projection=True)
        bundle.text_encoder_2 = _build(CLIPTextModel, text_cfg_2, dtype, device,
                                       lambda m: merge_checkpoint(m, text_ckpt_2, seed, "CLIP text 2"))
        bundle.tokenizer_2 = CLIPTokenizer.from_pretrained(path, subfolder="tokenizer_2")
    return bundle


# ----------------------------------------------------------- flax-native layout
def _cfg_from(saved: dict, cls, **extra):
    fields = {f.name for f in dataclasses.fields(cls)}
    clean = {k: tuple(v) if isinstance(v, list) else v for k, v in saved.items() if k in fields}
    clean.update(extra)
    return cls(**clean)


def _load_flax_native(path: str, model_config: dict, dtype, device="cuda") -> SimpleNamespace:
    """A checkpoint the JAX package saved (common/checkpoint.py: flax trees as
    safetensors, a config.json per component), converted by name."""
    unet_saved = load_component_config(os.path.join(path, "unet")) or {}
    # saved sparse indices may be ['-1', 'first'] after json default=str
    if "sparse_causal_indices" in unet_saved:
        unet_saved["sparse_causal_indices"] = [
            int(x) if isinstance(x, str) and x.lstrip("-").isdigit() else x
            for x in unet_saved["sparse_causal_indices"]
        ]
    if unet_saved.get("lora") in ("None", None):
        unet_saved["lora"] = None
    else:
        unet_saved["lora"] = int(unet_saved["lora"])
    unet_cfg = _cfg_from({**unet_saved, **_unet_cfg_overrides(model_config)}, UNet3DConfig)
    unet_params = load_component_params(os.path.join(path, "unet"))
    unet = _build(UNetPseudo3DConditionModel, unet_cfg, dtype, device, lambda m: unet_state_from_flax(unet_params))

    def opt_component(sub, cls, model_cls, convert):
        d = os.path.join(path, sub)
        if not os.path.exists(os.path.join(d, "flax_model.safetensors")):
            return None
        cfg = _cfg_from(load_component_config(d) or {}, cls)
        params = load_component_params(d)
        return _build(model_cls, cfg, dtype, device, lambda m: convert(params))

    vae = opt_component("vae", VAEConfig, AutoencoderKL, vae_state_from_flax)
    text_encoder = opt_component("text_encoder", CLIPTextConfig, CLIPTextModel, clip_text_state_from_flax)
    if os.path.exists(os.path.join(path, "tokenizer", "vocab.json")):
        tokenizer = CLIPTokenizer.from_pretrained(path)
    else:
        tokenizer = StubTokenizer(vocab_size=text_encoder.cfg.vocab_size if text_encoder else 49408)
    return SimpleNamespace(
        unet=unet, vae=vae, text_encoder=text_encoder, tokenizer=tokenizer,
        schedule=_schedule_at(path, device), pretrained=True,
    )
