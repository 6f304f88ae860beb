"""Pipeline checkpoints: the flax-native layout and safetensors files.

Counterpart of fatezero_tpu/common/checkpoint.py. Both packages save a tuned
pipeline as

    <path>/unet/{config.json, flax_model.safetensors}
    <path>/vae/{config.json, flax_model.safetensors}            (optional)
    <path>/text_encoder/{config.json, flax_model.safetensors}   (optional)
    <path>/tokenizer/{vocab.json, merges.txt}                   (optional)
    <path>/scheduler/scheduler_config.json

with flax param trees flattened to '/'-joined keys and a config.json of the
config dataclass's fields (the two packages' dataclasses share their field
names). `convert/from_flax.py` turns those trees into the port's
state_dicts and `convert/to_flax.py` back. Files are read and written by a
small numpy codec of the safetensors format (an 8-byte little-endian header
length, a JSON header padded with spaces to 8 bytes, then the raw bytes), so
the `safetensors` package is not needed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
from typing import Any, Dict, Optional

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of a .safetensors file, in file order. BF16 tensors
    (which numpy has no type for) come back as their exact float32 values."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        raw = data[begin:end]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype=np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<"))
        out[name] = arr.reshape(shape).astype(arr.dtype.newbyteorder("="), copy=True)
    return out


_NAMES = {np.dtype(v).newbyteorder("<"): k for k, v in _DTYPES.items()}


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """The bfloat16 bit patterns (uint16) of float32 values, rounded to
    nearest even, as torch rounds; NaNs stay NaNs."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (bits + (0x7FFF + ((bits >> 16) & 1))) >> 16
    nan = np.isnan(x)
    return np.where(nan, (bits >> 16) | 0x40, rounded).astype(np.uint16)


def write_safetensors(path: str, tensors: Dict[str, np.ndarray], bf16=()) -> None:
    """Write {name: array} as a .safetensors file, tensors in sorted name
    order. The names in `bf16` hold uint16 bit patterns (`bf16_bits`) and are
    written as BF16."""
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name]).reshape(np.shape(tensors[name]))  # 0-d stays 0-d
        if name in bf16:
            if arr.dtype != np.uint16:
                raise TypeError(f"{name}: BF16 tensors are passed as their uint16 bits")
            dtype = "BF16"
        else:
            dtype = _NAMES[arr.dtype.newbyteorder("<")]
        raw = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": dtype, "shape": list(arr.shape), "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in chunks:
            f.write(raw)


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def load_component_params(dirpath: str) -> Dict:
    """The flax param tree a component folder holds (with its "params" root)."""
    return _unflatten(read_safetensors(os.path.join(dirpath, "flax_model.safetensors")))


def load_component_config(dirpath: str) -> Optional[dict]:
    p = os.path.join(dirpath, "config.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def save_component(dirpath: str, config: Any, params: Dict) -> None:
    """One component folder: config.json (the dataclass's fields; tuples as
    lists, anything else json cannot hold as its str, as the JAX package
    writes it) and flax_model.safetensors of the flax tree `params`."""
    os.makedirs(dirpath, exist_ok=True)
    if config is not None:
        cfg = dataclasses.asdict(config) if dataclasses.is_dataclass(config) else dict(config)
        with open(os.path.join(dirpath, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2, default=str)
    write_safetensors(os.path.join(dirpath, "flax_model.safetensors"), _flatten(params))


def save_pipeline_checkpoint(
    path: str,
    unet_cfg,
    unet_params,
    vae_cfg=None,
    vae_params=None,
    text_cfg=None,
    text_params=None,
    tokenizer_dir: Optional[str] = None,
    schedule_cfg: Optional[dict] = None,
) -> str:
    """Save a pipeline of flax trees (convert/to_flax.py makes them from the
    port's state_dicts); components with None params are skipped."""
    os.makedirs(path, exist_ok=True)
    save_component(os.path.join(path, "unet"), unet_cfg, unet_params)
    if vae_params is not None:
        save_component(os.path.join(path, "vae"), vae_cfg, vae_params)
    if text_params is not None:
        save_component(os.path.join(path, "text_encoder"), text_cfg, text_params)
    if tokenizer_dir is not None and os.path.isdir(tokenizer_dir):
        dst = os.path.join(path, "tokenizer")
        os.makedirs(dst, exist_ok=True)
        for name in ("vocab.json", "merges.txt"):
            src = os.path.join(tokenizer_dir, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(dst, name))
    sched = os.path.join(path, "scheduler")
    os.makedirs(sched, exist_ok=True)
    with open(os.path.join(sched, "scheduler_config.json"), "w") as f:
        json.dump(schedule_cfg or {}, f, indent=2)
    return path


def is_flax_checkpoint(path: str) -> bool:
    return os.path.exists(os.path.join(path, "unet", "flax_model.safetensors"))
