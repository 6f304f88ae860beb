"""Cross/self-attention visualization: per-token heatmap videos.

Port of the reference visualization module
(video_diffusion/prompt_attention/visualization.py:14-88): aggregate the
stored maps across layers at one resolution, render a word-annotated heatmap
per prompt token, save as gif; plus the self-attention SVD component view.

A copy of fatezero_tpu/ptp/visualization.py over the port's image_util:
numpy in and out, cv2 optional as there.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from fatezero_tpu_torch.common.image_util import save_gif_mp4_folder_type


def aggregate_attention(
    average_attention: Dict[str, List[np.ndarray]],
    res: int,
    from_where: Sequence[str] = ("up", "down"),
    is_cross: bool = True,
    select: int = 0,
) -> np.ndarray:
    """Mean over layers+heads of the maps at resolution `res`
    (visualization.py:14-32). Returns [f, res, res, kv]."""
    out = []
    num_pixels = res * res
    for place in from_where:
        key = f"{place}_{'cross' if is_cross else 'self'}"
        for m in average_attention.get(key, []):
            # [b, f, heads, s, kv]
            if m.shape[-2] == num_pixels:
                sel = m[select]  # [f, heads, s, kv]
                out.append(sel.reshape(sel.shape[0], sel.shape[1], res, res, -1))
    if not out:
        raise ValueError(f"no {'cross' if is_cross else 'self'} maps at {res}x{res}")
    stacked = np.concatenate(out, axis=1)  # [f, H*, res, res, kv]
    return stacked.mean(axis=1)


def _colorize(gray: np.ndarray) -> np.ndarray:
    """[h, w] in [0,1] -> RGB heatmap uint8 (JET-like via cv2 when present)."""
    g = (np.clip(gray, 0, 1) * 255).astype(np.uint8)
    try:
        import cv2

        return cv2.applyColorMap(g, cv2.COLORMAP_JET)[:, :, ::-1]
    except Exception:
        return np.stack([g, g, g], axis=-1)


def show_cross_attention(
    tokenizer,
    prompt: str,
    average_attention: Dict[str, List[np.ndarray]],
    res: int = 16,
    from_where: Sequence[str] = ("up", "down"),
    select: int = 0,
    save_path: Optional[str] = None,
    upscale: int = 8,
) -> np.ndarray:
    """Per-token heatmap video grid (visualization.py:35-72).

    Returns [f, res*u, (n_tokens*res)*u, 3] uint8 and optionally saves a gif.
    """
    tokens = tokenizer.encode(prompt)
    words = [tokenizer.decode([t]) for t in tokens]
    maps = aggregate_attention(average_attention, res, from_where, True, select)
    f = maps.shape[0]
    frames = []
    for fi in range(f):
        row = []
        for ti, word in enumerate(words[: maps.shape[-1]]):
            m = maps[fi, :, :, ti]
            m = m / (m.max() + 1e-12)
            img = _colorize(m)
            img = np.kron(img, np.ones((upscale, upscale, 1))).astype(np.uint8)
            img = _annotate(img, word)
            row.append(img)
        frames.append(np.concatenate(row, axis=1))
    video = np.stack(frames)
    if save_path is not None:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        save_gif_mp4_folder_type(video, save_path, save_gif=True)
    return video


def _annotate(img: np.ndarray, text: str) -> np.ndarray:
    try:
        import cv2

        pad = np.zeros((20, img.shape[1], 3), np.uint8)
        cv2.putText(
            pad, text[:12], (2, 14), cv2.FONT_HERSHEY_SIMPLEX, 0.35, (255, 255, 255), 1
        )
        return np.concatenate([img, pad], axis=0)
    except Exception:
        return img


def show_self_attention_comp(
    average_attention: Dict[str, List[np.ndarray]],
    res: int = 16,
    from_where: Sequence[str] = ("up", "down"),
    max_com: int = 10,
    select: int = 0,
    save_path: Optional[str] = None,
    upscale: int = 8,
) -> np.ndarray:
    """Top SVD components of the self-attention matrix (visualization.py:75-88).
    Returns [f, res*u, max_com*res*u, 3] uint8."""
    maps = aggregate_attention(average_attention, res, from_where, False, select)
    f, h, w, kv = maps.shape
    frames = []
    for fi in range(f):
        A = maps[fi].reshape(res * res, kv).astype(np.float64)
        u, s, vh = np.linalg.svd(A - A.mean(axis=1, keepdims=True), full_matrices=False)
        row = []
        for ci in range(min(max_com, vh.shape[0])):
            comp = vh[ci][: res * res].reshape(res, res)
            comp = (comp - comp.min()) / (comp.max() - comp.min() + 1e-12)
            img = _colorize(comp)
            row.append(np.kron(img, np.ones((upscale, upscale, 1))).astype(np.uint8))
        frames.append(np.concatenate(row, axis=1))
    video = np.stack(frames)
    if save_path is not None:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        save_gif_mp4_folder_type(video, save_path, save_gif=True)
    return video
