"""What the port's CUDA graph captures share: the update's graph
(trainer/ddpm_trainer.py) and the UNet forward's pieces (models/unet_graph.py).

A capture launches nothing: the hand-written kernels' wrappers still count
each launch they record, and spans and counters still close. `CountedCapture`
brackets a capture so that neither is left behind: the recorder is left as it
was (`profiling.discarded`), each launch counter is set back, and `launched`
holds what the capture counted, which `replayed` adds once per replay.
"""
from __future__ import annotations

from typing import List

import torch

from fatezero_tpu_torch.common import profiling
from fatezero_tpu_torch.ops import flash_attention as FA
from fatezero_tpu_torch.ops.fused_norm import layer_norm_kernel

# the hand-written kernels' launch counters
LAUNCH_COUNTED = (FA.flash_forward, FA.flash_dq, FA.flash_dkv, layer_norm_kernel)


class CountedCapture:
    """Around a CUDA graph capture: spans, counters and launch counters as
    before it; `launched`, each counted kernel's launches in the graph."""

    def __enter__(self) -> "CountedCapture":
        self._before = [fn.launches for fn in LAUNCH_COUNTED]
        self._discarded = profiling.discarded()
        self._discarded.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        try:
            self._discarded.__exit__(*exc)
        finally:
            self.launched: List[int] = [fn.launches - n for fn, n in zip(LAUNCH_COUNTED, self._before)]
            for fn, n in zip(LAUNCH_COUNTED, self._before):
                fn.launches = n


def replayed(launched: List[int]) -> None:
    """Count one replay of a graph that launched `launched` (`CountedCapture.launched`)."""
    for fn, n in zip(LAUNCH_COUNTED, launched):
        fn.launches += n


def release_workspaces() -> None:
    """After a capture: cuBLAS keeps a workspace per stream, and the warm-up's
    or capture's side stream got its own, which no eager work uses again (the
    capture's stays in the graph's pool, as torch's own graph trees leave it)."""
    torch._C._cuda_clearCublasWorkspaces()
