"""Pipeline checkpoints, read side: the flax-native layout and safetensors files.

Counterpart of the read half of fatezero_tpu/common/checkpoint.py. That
package saves a tuned pipeline as

    <path>/unet/{config.json, flax_model.safetensors}
    <path>/vae/{config.json, flax_model.safetensors}            (optional)
    <path>/text_encoder/{config.json, flax_model.safetensors}   (optional)
    <path>/tokenizer/{vocab.json, merges.txt}                   (optional)
    <path>/scheduler/scheduler_config.json

with flax param trees flattened to '/'-joined keys. `convert/from_flax.py`
turns those trees into the port's state_dicts. Files are read by a small
numpy reader of the safetensors format (an 8-byte little-endian header
length, a JSON header, then the raw bytes), so the `safetensors` package is
not needed. Writing checkpoints comes with the tuning CLI.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

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


def is_flax_checkpoint(path: str) -> bool:
    return os.path.exists(os.path.join(path, "unet", "flax_model.safetensors"))
