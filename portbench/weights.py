"""Random weights made on the device from the seed, and handed to both sides.

`make` draws every N(0, 0.02) leaf of a model in one call into one flat
buffer of the configuration's dtype and returns views into it, with the
zero, one and dirac leaves FateZero's init rules name (reference/sd.py's
specs). The same seed on the same device gives the same bits, so the
reference receives the weights the program ran by making them again.
`load_into` puts them into a module of the program built on the meta
device, by name, in each parameter's own dtype.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.sd import SPECS

STD = 0.02
SALT = {"unet": 1, "vae": 2, "text_encoder": 3}


def _generator(seed: int, part: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7919 + SALT[part]) % (2 ** 63))
    return g


def make(cfg: dict, part: str, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    spec = SPECS[part](cfg)
    normal = [(n, s) for n, s, rule in spec if rule == "normal"]
    total = sum(_numel(s) for _, s in normal)
    flat = torch.randn(total, generator=_generator(seed, part, device), device=device, dtype=dtype)
    flat.mul_(STD)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape in normal:
        k = _numel(shape)
        out[name] = flat[offset:offset + k].view(shape)
        offset += k
    for name, shape, rule in spec:
        if rule == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif rule == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        elif rule == "dirac":
            w = torch.zeros(shape, device=device, dtype=dtype)
            w[:, :, shape[2] // 2] = torch.eye(shape[0], shape[1], device=device, dtype=dtype)
            out[name] = w
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """Assign `weights` to a meta-built module by name, each cast to the dtype
    the module gave the parameter; every parameter must be named, and no more."""
    own = module.state_dict()
    if set(own) != set(weights):
        missing, extra = sorted(set(own) - set(weights)), sorted(set(weights) - set(own))
        raise KeyError(f"weights do not match the program's parameters: missing {missing[:5]}, extra {extra[:5]}")
    state = {}
    for name, ref in own.items():
        w = weights[name]
        if tuple(w.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: weights {tuple(w.shape)}, program {tuple(ref.shape)}")
        state[name] = w.to(ref.dtype)
    module.load_state_dict(state, assign=True)
    return module
