"""Weight bridge: the JAX package's flax parameters -> the port's state_dicts.

The inverse of fatezero_tpu/convert/torch_to_flax.py (convert_unet_state,
convert_vae_state, convert_clip_text_state). Each function takes a flax
param tree as nested dicts of numpy arrays (with or without the "params"
root) and returns a {diffusers/HF key: numpy array} state_dict:

  Dense kernel [in, out]         -> Linear weight [out, in]
  Conv kernel [kh, kw, in, out]  -> Conv2d weight [out, in, kh, kw]
  temporal kernel [k, in, out]   -> Conv1d weight [out, in, k] (also the LoRA pair)
  norm scale                     -> weight
  Embed embedding                -> weight

Pure numpy: no jax and no torch needed.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _params(tree: Dict) -> Dict[str, np.ndarray]:
    return _flatten(tree["params"] if "params" in tree else tree)


def _leaf(module: str, leaf: str, value: np.ndarray):
    """(torch key, tensor) for one flax leaf of a Dense/Conv/norm/Embed module."""
    prefix = f"{module}." if module else ""
    if leaf == "kernel":
        if value.ndim == 2:
            return f"{prefix}weight", value.T
        if value.ndim == 4:
            return f"{prefix}weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {value.ndim} at {module}")
    if leaf in ("scale", "embedding"):
        return f"{prefix}weight", value
    if leaf == "bias":
        return f"{prefix}bias", value
    raise KeyError(f"unknown flax leaf {module}/{leaf}")


# flax module names `<name>_<i>` that are torch ModuleList entries `<name>.<i>`
_UNET_LISTS = re.compile(
    r"^(down_blocks|up_blocks|resnets|attentions|transformer_blocks|downsamplers|upsamplers|net)_(\d+)$"
)


def _unet_module(parts) -> str:
    out = []
    for p in parts:
        if p == "spatial":  # PseudoConv3d keeps its 2-D conv as its own weight
            continue
        m = _UNET_LISTS.match(p)
        out.append(f"{m.group(1)}.{m.group(2)}" if m else p)
        if p == "to_out":
            out.append("0")
    return ".".join(out)


def unet_state_from_flax(flax_params: Dict) -> Dict[str, np.ndarray]:
    """Flax UNetPseudo3DConditionModel params -> UNetPseudo3DConditionModel state_dict."""
    state = {}
    for path, value in _params(flax_params).items():
        *parts, leaf = path.split("/")
        module = _unet_module(parts)
        prefix = f"{module}." if module else ""
        if leaf == "conv_temporal_kernel":
            state[f"{prefix}conv_temporal.weight"] = value.transpose(2, 1, 0)
        elif leaf == "conv_temporal_bias":
            state[f"{prefix}conv_temporal.bias"] = value
        elif leaf in ("lora_temporal_down", "lora_temporal_up"):
            state[f"{prefix}conv_temporal.{leaf.rsplit('_', 1)[1]}.weight"] = value.transpose(2, 1, 0)
        else:
            key, v = _leaf(module, leaf, value)
            state[key] = v
    return state


_VAE_MODULE = [
    (re.compile(r"^(down_blocks|up_blocks)_(\d+)_resnets_(\d+)$"), r"\1.\2.resnets.\3"),
    (re.compile(r"^(down_blocks)_(\d+)_downsamplers_0_conv$"), r"\1.\2.downsamplers.0.conv"),
    (re.compile(r"^(up_blocks)_(\d+)_upsamplers_0_conv$"), r"\1.\2.upsamplers.0.conv"),
    (re.compile(r"^mid_block_resnets_(\d+)$"), r"mid_block.resnets.\1"),
    (re.compile(r"^mid_block_attentions_0$"), r"mid_block.attentions.0"),
]


def vae_state_from_flax(flax_params: Dict) -> Dict[str, np.ndarray]:
    """Flax AutoencoderKL params -> AutoencoderKL state_dict."""
    state = {}
    for path, value in _params(flax_params).items():
        *parts, leaf = path.split("/")
        out = []
        for p in parts:
            for rx, template in _VAE_MODULE:
                if rx.match(p):
                    p = rx.sub(template, p)
                    break
            out.append(p)
        key, v = _leaf(".".join(out), leaf, value)
        state[key] = v
    return state


def clip_text_state_from_flax(flax_params: Dict) -> Dict[str, np.ndarray]:
    """Flax CLIPTextModel params -> CLIPTextModel state_dict (HF names)."""
    state = {}
    for path, value in _params(flax_params).items():
        if path == "position_embedding":
            state["text_model.embeddings.position_embedding.weight"] = value
            continue
        *parts, leaf = path.split("/")
        if parts == ["token_embedding"]:
            module = "embeddings.token_embedding"
        elif parts == ["final_layer_norm"]:
            module = "final_layer_norm"
        else:
            m = re.match(r"^layers_(\d+)$", parts[0])
            if m is None:
                raise KeyError(f"unknown CLIP text param {path}")
            sub = parts[1:]
            if sub[0] in ("fc1", "fc2"):
                sub = ["mlp", *sub]
            module = ".".join(["encoder.layers", m.group(1), *sub])
        key, v = _leaf(f"text_model.{module}", leaf, value)
        state[key] = v
    return state
