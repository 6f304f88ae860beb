"""Weight bridge: the port's state_dicts -> the JAX package's flax parameters.

The exact inverse of convert/from_flax.py, with its own copy of the naming
rules. Each function takes a {diffusers/HF key: numpy array} state_dict and
returns the flax param tree (nested dicts of numpy arrays under "params")
that the JAX package's models hold:

  Linear weight [out, in]          -> Dense kernel [in, out]
  Conv2d weight [out, in, kh, kw]  -> Conv kernel [kh, kw, in, out]
                                      (a UNet conv's under `<name>/spatial`)
  Conv1d weight [out, in, k]       -> temporal kernel [k, in, out] (also the LoRA pair)
  1-D norm weight                  -> scale
  Embedding weight                 -> embedding

Pure numpy: no jax and no torch needed.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np

# torch ModuleList entries `<name>.<i>` that are flax modules `<name>_<i>`
_UNET_LISTS = {"down_blocks", "up_blocks", "resnets", "attentions", "transformer_blocks",
               "downsamplers", "upsamplers", "net"}


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def _leaf(prefix: str, leaf: str, value: np.ndarray, embedding: bool = False):
    """(flax path, array) for one torch leaf (`weight` or `bias`) of a
    Linear/Conv/norm/Embedding module whose flax path is `prefix`."""
    if leaf == "bias":
        return f"{prefix}/bias", value
    if leaf != "weight":
        raise KeyError(f"unknown torch leaf {prefix}.{leaf}")
    if embedding:
        return f"{prefix}/embedding", value
    if value.ndim == 1:
        return f"{prefix}/scale", value
    if value.ndim == 2:
        return f"{prefix}/kernel", value.T
    if value.ndim == 4:
        return f"{prefix}/kernel", value.transpose(2, 3, 1, 0)
    raise ValueError(f"unexpected weight rank {value.ndim} at {prefix}")


def _unet_module(parts) -> str:
    out, i = [], 0
    while i < len(parts):
        p = parts[i]
        if p in _UNET_LISTS and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{p}_{parts[i + 1]}")
            i += 2
            continue
        out.append(p)
        if p == "to_out":  # torch's to_out is a ModuleList whose entry 0 is the linear
            i += 1
        i += 1
    return "/".join(out)


def unet_state_to_flax(state: Dict[str, np.ndarray]) -> Dict:
    """UNetPseudo3DConditionModel state_dict -> flax UNetPseudo3DConditionModel params."""
    flat = {}
    for key, value in state.items():
        value = np.asarray(value)
        parts = key.split(".")
        if "conv_temporal" in parts:
            at = parts.index("conv_temporal")
            module = _unet_module(parts[:at])
            rest = parts[at + 1:]
            if rest == ["weight"]:
                flat[f"{module}/conv_temporal_kernel"] = value.transpose(2, 1, 0)
            elif rest == ["bias"]:
                flat[f"{module}/conv_temporal_bias"] = value
            elif rest in (["down", "weight"], ["up", "weight"]):
                flat[f"{module}/lora_temporal_{rest[0]}"] = value.transpose(2, 1, 0)
            else:
                raise KeyError(f"unknown temporal conv leaf {key}")
            continue
        *mod, leaf = parts
        module = _unet_module(mod)
        # a PseudoConv3d keeps its 2-D conv under `spatial` in flax
        weight = state.get(".".join(mod + ["weight"]))
        if weight is not None and np.ndim(weight) == 4:
            module = f"{module}/spatial"
        path, v = _leaf(module, leaf, value)
        flat[path] = v
    return {"params": _unflatten(flat)}


# torch module paths whose flax module is one name joined with underscores
_VAE_MODULE = [
    (re.compile(r"(^|\.)(down_blocks|up_blocks)\.(\d+)\.resnets\.(\d+)(?=\.|$)"), r"\1\2_\3_resnets_\4"),
    (re.compile(r"(^|\.)down_blocks\.(\d+)\.downsamplers\.0\.conv(?=\.|$)"), r"\1down_blocks_\2_downsamplers_0_conv"),
    (re.compile(r"(^|\.)up_blocks\.(\d+)\.upsamplers\.0\.conv(?=\.|$)"), r"\1up_blocks_\2_upsamplers_0_conv"),
    (re.compile(r"(^|\.)mid_block\.resnets\.(\d+)(?=\.|$)"), r"\1mid_block_resnets_\2"),
    (re.compile(r"(^|\.)mid_block\.attentions\.0(?=\.|$)"), r"\1mid_block_attentions_0"),
]


def vae_state_to_flax(state: Dict[str, np.ndarray]) -> Dict:
    """AutoencoderKL state_dict -> flax AutoencoderKL params."""
    flat = {}
    for key, value in state.items():
        *mod, leaf = key.split(".")
        dotted = ".".join(mod)
        for rx, template in _VAE_MODULE:
            dotted = rx.sub(template, dotted)
        path, v = _leaf(dotted.replace(".", "/"), leaf, np.asarray(value))
        flat[path] = v
    return {"params": _unflatten(flat)}


def clip_text_state_to_flax(state: Dict[str, np.ndarray]) -> Dict:
    """CLIPTextModel state_dict (HF names) -> flax CLIPTextModel params."""
    flat = {}
    for key, value in state.items():
        value = np.asarray(value)
        if key == "text_model.embeddings.position_embedding.weight":
            flat["position_embedding"] = value
            continue
        if not key.startswith("text_model."):
            raise KeyError(f"unknown CLIP text param {key}")
        *mod, leaf = key[len("text_model."):].split(".")
        if mod == ["embeddings", "token_embedding"]:
            path, v = _leaf("token_embedding", leaf, value, embedding=True)
        elif mod == ["final_layer_norm"]:
            path, v = _leaf("final_layer_norm", leaf, value)
        elif mod[:2] == ["encoder", "layers"]:
            sub = mod[3:]
            if sub[0] == "mlp":
                sub = sub[1:]
            path, v = _leaf("/".join([f"layers_{mod[2]}", *sub]), leaf, value)
        else:
            raise KeyError(f"unknown CLIP text param {key}")
        flat[path] = v
    return {"params": _unflatten(flat)}
