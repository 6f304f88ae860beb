"""CLIP Frame-Accuracy and Temporal-Consistency on the card (torch ViT-B/32).

Counterpart of fatezero_tpu/eval/clip_metrics.py, the port of the reference
metric script (CLIP/frame_acc_tem_con.py):

  * Frame-Acc: per edited frame, softmax over CLIP logits of
    [source_prompt, target_prompt]; success when P(target) >= P(source)
    (frame_acc_tem_con.py:19-32).
  * Tem-Con: mean cosine similarity of L2-normalized CLIP image embeddings of
    adjacent frames (frame_acc_tem_con.py:45-54).

The dataset sweep mirrors folder_success over a bench YAML of
{video, source, target} triplets (frame_acc_tem_con.py:56-89,
CLIP/bench_clean_prompt.yaml). The towers run in fp32 on the evaluator's
device (the card unless the caller asks for the CPU); their attention and
the resize are plain PyTorch, as they are XLA in the JAX package.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_frames(video: np.ndarray, image_size: int = 224, device="cuda") -> torch.Tensor:
    """[f, h, w, 3] float in [0,1] (or uint8) -> CLIP-normalized [f, S, S, 3] on
    `device` (the card unless the caller asks for the CPU).

    Short side to `image_size` with an antialiased bicubic resize (what
    jax.image.resize's "bicubic" does), then a centre crop."""
    v = np.asarray(video)
    if v.dtype == np.uint8:
        v = v.astype(np.float32) / 255.0
    f, h, w, _ = v.shape
    scale = image_size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    x = torch.as_tensor(v, dtype=torch.float32, device=device).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(nh, nw), mode="bicubic", align_corners=False, antialias=True)
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    x = x[:, :, top : top + image_size, left : left + image_size].permute(0, 2, 3, 1)
    mean = torch.as_tensor(CLIP_MEAN, device=device)
    std = torch.as_tensor(CLIP_STD, device=device)
    return (x - mean) / std


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)


class CLIPEvaluator:
    """Holds the dual-tower model (on its device) and the tokenizer."""

    def __init__(self, model, tokenizer, random_weights: bool = False):
        self.model = model
        self.tokenizer = tokenizer
        self.device = model.logit_scale.device
        # True when no pretrained CLIP was loaded: metrics are mechanically
        # valid but semantically meaningless, and every report says so
        self.random_weights = random_weights

    @torch.inference_mode()
    def image_features(self, video: np.ndarray) -> torch.Tensor:
        """L2-normalized CLIP embeddings [f, d] of a [f,h,w,3] video in [0,1]."""
        return _unit(self.model.encode_image(preprocess_frames(video, device=self.device)))

    @torch.inference_mode()
    def text_features(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(self.tokenizer(list(prompts)).input_ids), device=self.device)
        return _unit(self.model.encode_text(ids.long()))

    # ------------------------------------------------------------- metrics
    def frame_accuracy(self, video: np.ndarray, source_prompt: str, target_prompt: str) -> float:
        """Fraction of frames classified closer to target than source
        (frame_acc_tem_con.py:19-32)."""
        img = self.image_features(video)  # [f, d]
        txt = self.text_features([source_prompt, target_prompt])  # [2, d]
        probs = torch.softmax(100.0 * img @ txt.t(), dim=-1)  # the reference's logit scale
        return float((probs[:, 1] >= probs[:, 0]).float().mean())

    def temporal_consistency(self, video: np.ndarray) -> float:
        """Mean cosine similarity of adjacent-frame embeddings
        (frame_acc_tem_con.py:45-54)."""
        img = self.image_features(video)
        return float((img[:-1] * img[1:]).sum(dim=-1).mean())

    def folder_success(self, folder: str, source_prompt: str, target_prompt: str) -> Tuple[float, float]:
        """(frame_acc, tem_con) over a result frame folder
        (frame_acc_tem_con.py:35-54)."""
        from fatezero_tpu_torch.common.image_util import load_image_folder

        frames = np.stack(load_image_folder(folder)).astype(np.float32) / 255.0
        return (
            self.frame_accuracy(frames, source_prompt, target_prompt),
            self.temporal_consistency(frames),
        )

    def evaluate_benchmark(self, bench: List[Dict], results_root: str) -> Dict[str, float]:
        """Sweep a bench list of {folder, source_prompt, target_prompt}
        (the bench_clean_prompt.yaml triplets); returns dataset means."""
        accs, cons = [], []
        per_item = {}
        missing = []
        for item in bench:
            folder = os.path.join(results_root, item["folder"])
            if not os.path.isdir(folder):
                missing.append(item["folder"])
                continue
            acc, con = self.folder_success(folder, item["source_prompt"], item["target_prompt"])
            per_item[item["folder"]] = {"frame_acc": acc, "tem_con": con}
            accs.append(acc)
            cons.append(con)
        if missing:
            warnings.warn(
                f"evaluate_benchmark: {len(missing)}/{len(bench)} bench folders "
                f"missing under {results_root!r} and skipped: {missing}",
                stacklevel=2,
            )
        return {
            "frame_acc": float(np.mean(accs)) if accs else float("nan"),
            "tem_con": float(np.mean(cons)) if cons else float("nan"),
            "n": len(accs),
            "missing": missing,
            "random_weights": self.random_weights,
            "per_item": per_item,
        }


def load_evaluator(checkpoint_path: Optional[str] = None, seed: int = 0, device="cuda") -> CLIPEvaluator:
    """Build a ViT-B/32 evaluator on `device` (the card unless the caller asks
    for the CPU): an HF `CLIPModel` folder loads strictly, with its
    vocab.json tokenizer when it has one; without a checkpoint the weights
    are random (mechanics-only mode for weightless environments)."""
    from fatezero_tpu_torch.models.clip import CLIPModel
    from fatezero_tpu_torch.models.loader import clip_model_state, load_state, random_state
    from fatezero_tpu_torch.models.tokenizer import CLIPTokenizer, StubTokenizer

    model = CLIPModel(device="meta")
    tokenizer = StubTokenizer(vocab_size=49408)
    if checkpoint_path and os.path.isdir(checkpoint_path):
        state = clip_model_state(checkpoint_path)
        if os.path.exists(os.path.join(checkpoint_path, "vocab.json")):
            tokenizer = CLIPTokenizer.from_pretrained(checkpoint_path, subfolder="")
        random_weights = False
    else:
        warnings.warn(
            "load_evaluator: no CLIP checkpoint"
            + (f" at {checkpoint_path!r}" if checkpoint_path else " given")
            + " — evaluator runs with RANDOM weights; Frame-Acc/Tem-Con values "
            "are mechanics-only and semantically meaningless",
            stacklevel=2,
        )
        state = random_state(model, seed)
        random_weights = True
    model = load_state(model, state, torch.device(device)).eval()
    return CLIPEvaluator(model, tokenizer, random_weights=random_weights)
