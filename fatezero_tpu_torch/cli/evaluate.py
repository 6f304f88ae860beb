"""Benchmark evaluation entry: CLIP Frame-Acc / Tem-Con over result folders.

    python3 -m fatezero_tpu_torch.cli.evaluate --config config/bench_clean_prompt.yaml --results-root <dir>

Counterpart of fatezero_tpu/cli/evaluate.py (reference:
CLIP/frame_acc_tem_con.py:56-89 driven by CLIP/bench_clean_prompt.yaml).
Two bench YAML schemas are accepted:

1. the reference's own (CLIP/bench_clean_prompt.yaml, which
   config/bench_clean_prompt.yaml ships): a mapping of result-folder
   basenames to prompt pairs. The reference sweeps `results_root/*` and
   looks each folder's basename up in the YAML
   (frame_acc_tem_con.py:63-76); here every named entry under
   `results_root` is evaluated the same way:

    swan_cartoon:
      path: result/paper/...          # provenance only, not read
      source: a black swan ...
      target: cartoon photo of a black swan ...

2. an explicit item list:

    clip_checkpoint: null            # dir with HF CLIPModel weights (optional)
    results_root: results/
    items:
      - folder: jeep_watercolor/0_...
        source_prompt: a silver jeep ...
        target_prompt: watercolor painting of ...

Prints one JSON dict with dataset means and per-item metrics. It runs on the
card unless the caller passes device="cpu" (`--device cpu`).
"""
from __future__ import annotations

import json

from fatezero_tpu_torch.common.config import load_config
from fatezero_tpu_torch.eval.clip_metrics import load_evaluator

_META_KEYS = ("clip_checkpoint", "results_root")


def normalize_bench(cfg: dict) -> list:
    """Either bench schema -> list of {folder, source_prompt, target_prompt}.

    Reference-schema prompts are passed through verbatim (including the
    trailing commas present in CLIP/bench_clean_prompt.yaml — the reference
    tokenizes them as-is, frame_acc_tem_con.py:72)."""
    if "items" in cfg:
        return list(cfg["items"])
    items = []
    for name, v in cfg.items():
        if name in _META_KEYS or not isinstance(v, dict):
            continue
        if "source" in v and "target" in v:
            items.append({"folder": name, "source_prompt": v["source"], "target_prompt": v["target"]})
    if not items:
        raise ValueError(
            "bench config has neither an `items` list nor any "
            "`name: {source, target}` entries (reference schema)"
        )
    return items


def run(config, results_root: str = None, device="cuda"):
    """Evaluate a bench YAML (path or dict); prints and returns the JSON dict."""
    cfg = load_config(config).to_dict()
    ev = load_evaluator(cfg.get("clip_checkpoint"), device=device)
    out = ev.evaluate_benchmark(normalize_bench(cfg), results_root or cfg.get("results_root", "."))
    print(json.dumps(out, indent=2))
    return out


def main():
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--results-root", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda", help="torch device to run on (cuda or cpu)")
    args = parser.parse_args()
    run(args.config, args.results_root, device=args.device)


if __name__ == "__main__":
    main()
