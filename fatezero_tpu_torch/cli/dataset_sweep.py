"""Batch-dataset evaluation sweep: a dataset-of-videos YAML x a p2p-config grid.

    python3 -m fatezero_tpu_torch.cli.dataset_sweep --config config/dataset_sweep.yaml

Counterpart of the JAX package's root test_fatezero_dataset.py (reference
parity: the reference's test_fatezero_dataset.py:7-48). The config lists
videos under `datasets:`, each with its own dataset and editing block, and a
grid of p2p hyperparameter variants under `p2p_grid:`; every (video,
variant) pair runs one edit through fatezero_tpu_torch.cli.edit.test, on the
card unless the caller passes device="cpu" (`--device cpu`). Each run writes
its own result folder, result/<config stem>/<timestamp>[_<n>].
"""
from __future__ import annotations

from fatezero_tpu_torch.cli.edit import test
from fatezero_tpu_torch.common.config import load_config


def run(config: str, device="cuda"):
    """Run every (video, variant) edit of `config`; returns their (logdir, videos)."""
    cfg = load_config(config).to_dict()
    base = {k: v for k, v in cfg.items() if k not in ("datasets", "p2p_grid")}
    grid = cfg.get("p2p_grid") or [{}]
    results = []
    for ds in cfg.get("datasets", []):
        for variant in grid:
            sub = dict(base)
            sub["config"] = config
            sub["dataset_config"] = ds["dataset_config"]
            editing = dict(ds.get("editing_config", {}))
            editing["p2p_config"] = {
                k: {**dict(v), **variant} for k, v in dict(editing.get("p2p_config", {0: {}})).items()
            }
            sub["editing_config"] = editing
            sub["logdir"] = None
            results.append(test(**sub, device=device))
    return results


def main():
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda", help="torch device to run on (cuda or cpu)")
    args = parser.parse_args()
    run(args.config, device=args.device)


if __name__ == "__main__":
    main()
