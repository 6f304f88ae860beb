#!/usr/bin/env python3
"""Read the flash kernels' times in several trees of this repository, in turns, on one card.

    python3 scripts/ab_flash_kernels.py [--phases] [--backward] [--out FILE] TREE [TREE ...]

Each TREE is the root of a checkout (for example `.` and a parent commit
unpacked with `git archive`). For each, in the order given, a fresh process
builds that tree's kernels and runs `chip_smoke.py`'s kernel checks
(`check_edit_k1`, `check_training_kernels`, `check_layer_norm`, `check_k1b`,
`check_k1c`), then prints one line of totals: the bf16 ms summed over each
kernel's path shapes, as in the smoke's JSON line, and the SDPA backward's
sum read beside K2 and K3. `--backward` runs `check_training_kernels` alone
(K1 with its LSE, K2, K3 and the SDPA backward at the six tuning sites), the
quick way to A/B the backward kernels. With `--phases` it then
runs the smoke's full-width 10-step edit three times and four tuning steps
(`run_slice`, `tuning_setup`), whose `[phase]` lines give the seconds. Give a
tree twice (parent, change, change, parent) so that warm-up and clocks favour
neither. The card's name and power limit come first; with `--out FILE` the
totals and seconds are also written to FILE. Needs a CUDA device.
"""
from __future__ import annotations

import os
import subprocess
import sys

CHILD = """
import json, sys
sys.path.insert(0, '.')
import torch
import chip_smoke as C
from fatezero_tpu_torch import csrc
torch.backends.cuda.matmul.allow_tf32 = False
csrc.build_all(C.KERNEL_SOURCES)
t = [C.Totals() for _ in range(6)]
if BACKWARD:
    C.check_training_kernels(t[1], t[2])
    print('[totals] ' + json.dumps({'K2': t[1].ms, 'K3': t[2].ms, 'SDPA bwd': t[1].library_ms}), flush=True)
else:
    C.check_edit_k1(t[0]); C.check_training_kernels(t[1], t[2]); C.check_layer_norm(t[3])
    C.check_k1b(t[4]); C.check_k1c(t[5])
    print('[totals] ' + json.dumps(dict(zip(['K1', 'K2', 'K3', 'K4', 'K1b', 'K1c', 'SDPA bwd'],
                                            [x.ms for x in t] + [t[1].library_ms]))), flush=True)
if PHASES:
    from fatezero_tpu_torch.models.loader import load_models
    device = torch.device('cuda')
    sd = load_models('random:sd', C.TEASER, dtype=torch.bfloat16, seed=0, device=device)
    for i in range(3):
        _, times = C.run_slice(device, sd, f'edit run {i}', torch.bfloat16, C.FRAMES, C.RES, C.STEPS)
        print('[edit seconds] ' + json.dumps(times), flush=True)
    del sd
    torch.cuda.empty_cache()
    m, trainer, video, emb = C.tuning_setup(device, 'random:sd', C.JEEP, torch.bfloat16, C.FRAMES, C.RES, C.TUNE_SEED, C.TUNE_LR)
    state, gen = trainer.init_state(), torch.Generator().manual_seed(C.TUNE_SEED)
    for i in range(4):
        (state, _), dt = C.phase(f'tuning step {i}', lambda: trainer.step(state, video, emb, gen))
        print(f'[tuning seconds] step {i} {dt:.3f}', flush=True)
"""


def main(trees) -> int:
    phases, backward = "--phases" in trees, "--backward" in trees
    trees = [t for t in trees if t not in ("--phases", "--backward")]
    out = os.devnull
    if "--out" in trees:
        i = trees.index("--out")
        out = trees[i + 1]
        del trees[i:i + 2]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    # the summary lines also go to a file, for callers that see only the end of the output
    with open(out, "w") as summary:
        for tree in trees:
            print(f"==== {tree}", flush=True)
            summary.write(f"==== {tree}\n")
            child = subprocess.Popen([sys.executable, "-c", f"PHASES = {phases}\nBACKWARD = {backward}\n" + CHILD], cwd=tree,
                                     stdout=subprocess.PIPE, text=True)
            for line in child.stdout:
                print(line, end="", flush=True)
                if line.startswith(("[totals]", "[edit seconds]", "[tuning seconds]")):
                    summary.write(line)
                    summary.flush()
            if child.wait() != 0:
                return child.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
