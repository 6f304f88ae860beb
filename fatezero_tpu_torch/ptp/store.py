"""Host-side attention store: the streaming capture of per-step attention maps.

Counterpart of fatezero_tpu/ptp/store.py. Each step's captured maps leave the
card as soon as the step is done (a plain `.cpu()` copy), so the card holds
at most one step's maps; the host keeps one copy per step, a running fp32 sum
per map for the average, and the latent trajectory. With `disk_store` each
step's maps are pickled to `store_dir` instead of being held in memory.

Contents per step: {key: [CPU tensors [1, f, heads, s, kv]]} for the six
down/mid/up x cross/self keys. `step_bytes` and `copy_seconds` record, per
step, the bytes copied off the card and the seconds the copy, the running
sums and the pickle took.

On a device mesh (`mesh`) each rank keeps a store of its own: its frames
(seq) and heads (tensor) of every map, 1/(seq*tensor) of the world of one's
bytes. A mesh of several processes keys the pickles by rank,
`{step:03d}.rank{rank}.pkl`, so that the ranks can share one folder, and
`get_average_attention(keys)` assembles the chosen maps whole.
"""
from __future__ import annotations

import math
import os
import pickle
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch

from fatezero_tpu_torch.ptp.context import STORE_KEYS

CROSS_KEYS = tuple(k for k in STORE_KEYS if k.endswith("cross"))  # the maps the cross-attention drawing reads


class AttentionStore:
    def __init__(self, disk_store: bool = False, store_dir: Optional[str] = None, mesh=None):
        self.disk_store = disk_store
        self.mesh = mesh if mesh is not None and math.prod(mesh.shape) > 1 else None
        if disk_store:
            self.store_dir = store_dir or tempfile.mkdtemp(prefix="attention_cache_")
            os.makedirs(self.store_dir, exist_ok=True)
        else:
            self.store_dir = None
        self.reset()

    def reset(self) -> None:
        self.attention_store_all_step: List = []  # per-step dicts (or their pickles' paths)
        self.attention_store: Dict[str, List[torch.Tensor]] = {}  # running fp32 sums
        self.latents_store: List[torch.Tensor] = []
        self.num_steps = 0
        self.step_bytes: List[int] = []
        self.copy_seconds: List[float] = []

    # -- capture -----------------------------------------------------------
    def append_step(self, captured: Dict[str, List[torch.Tensor]], latent: torch.Tensor) -> None:
        """Record one diffusion step's maps and latent (tensors on any device)."""
        t0 = time.perf_counter()
        step = {k: [m.detach().cpu() for m in captured.get(k, [])] for k in STORE_KEYS}
        if not self.attention_store:
            # copies: .float() of an fp32 map would alias the step's own map
            self.attention_store = {k: [m.to(torch.float32, copy=True) for m in v] for k, v in step.items()}
        else:
            for k, v in step.items():
                for i, m in enumerate(v):
                    self.attention_store[k][i] += m.float()
        if self.disk_store:
            tag = "" if self.mesh is None else f".rank{self.mesh.rank}"
            path = os.path.join(self.store_dir, f"{self.num_steps:03d}{tag}.pkl")
            with open(path, "wb") as f:
                pickle.dump(step, f)
            self.attention_store_all_step.append(path)
        else:
            self.attention_store_all_step.append(step)
        self.latents_store.append(latent.detach().float().cpu())
        self.step_bytes.append(sum(m.numel() * m.element_size() for v in step.values() for m in v))
        self.copy_seconds.append(time.perf_counter() - t0)
        self.num_steps += 1

    # -- consumption -------------------------------------------------------
    def step_maps(self, step_in_store: int) -> Dict[str, List[torch.Tensor]]:
        entry = self.attention_store_all_step[step_in_store]
        if isinstance(entry, str):
            with open(entry, "rb") as f:
                entry = pickle.load(f)
        return entry

    def get_average_attention(self, keys: Optional[Sequence[str]] = None) -> Dict[str, List[torch.Tensor]]:
        """Per-map mean over the stored steps, of the maps under `keys` (every
        key by default). On a mesh of several processes each is assembled
        whole, every rank's frames and heads, on every rank (a collective:
        every rank calls it with the same keys)."""
        keys = list(self.attention_store) if keys is None else keys
        avg = {k: [m / max(self.num_steps, 1) for m in self.attention_store[k]] for k in keys}
        mesh = self.mesh
        if mesh is None:
            return avg
        from fatezero_tpu_torch.parallel.sharding import tensor_gather

        def whole(m):  # [1, f, heads, s, kv]
            m = m.to(mesh.device)
            return tensor_gather(mesh.all_frames(m, 1), 2, mesh=mesh).cpu()

        return {k: [whole(m) for m in v] for k, v in avg.items()}
