"""Video frame transforms (numpy; parity with reference data/transform.py:6-47).

A copy of fatezero_tpu/data/transform.py.
"""
from __future__ import annotations

import numpy as np
from PIL import Image


def short_size_scale(frames: np.ndarray, size: int) -> np.ndarray:
    """Resize so the short side == size (bilinear+antialias, like torchvision).

    frames: [f, h, w, c] uint8 or float.
    """
    f, h, w, c = frames.shape
    if h <= w:
        new_h, new_w = size, int(round(w * size / h))
    else:
        new_h, new_w = int(round(h * size / w)), size
    out = []
    for frame in frames:
        img = Image.fromarray(frame.astype(np.uint8)) if frame.dtype != np.uint8 else Image.fromarray(frame)
        out.append(np.asarray(img.resize((new_w, new_h), Image.BILINEAR)))
    return np.stack(out)


def offset_crop(
    frames: np.ndarray, left: int = 0, right: int = 0, top: int = 0, bottom: int = 0
) -> np.ndarray:
    """Crop margins off each side (reference offset_crop)."""
    f, h, w, c = frames.shape
    return frames[:, top : h - bottom if bottom else h, left : w - right if right else w]


def center_crop(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    f, h, w, c = frames.shape
    top = (h - height) // 2
    left = (w - width) // 2
    return frames[:, top : top + height, left : left + width]


def random_crop(frames: np.ndarray, height: int, width: int, rng: np.random.RandomState) -> np.ndarray:
    f, h, w, c = frames.shape
    top = rng.randint(0, h - height + 1)
    left = rng.randint(0, w - width + 1)
    return frames[:, top : top + height, left : left + width]


def to_tensor_range(frames: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1, 1]."""
    return frames.astype(np.float32) / 127.5 - 1.0
