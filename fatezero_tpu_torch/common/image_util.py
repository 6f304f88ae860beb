"""Image/video IO: gif, mp4, frame folders, grids, annotation.

Parity with the reference's common/image_util.py:76-192 (result-directory
layout documented in its README.md:159-172): every sampled video is saved as
gif + mp4 + a folder of PNG frames, plus a horizontally concatenated grid
across prompts.

A copy of fatezero_tpu/common/image_util.py; imageio, the mp4 writer's
fallback behind cv2, is imported only where it is used, since a machine may
lack it (the mp4 is best effort in both packages).
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
from PIL import Image, ImageDraw


def to_uint8(video: np.ndarray) -> np.ndarray:
    """[f, h, w, 3] float in [0,1] -> uint8."""
    if video.dtype == np.uint8:
        return video
    return (np.clip(video, 0.0, 1.0) * 255).round().astype(np.uint8)


def _save_mp4(video_u8: np.ndarray, path: str, fps: int) -> None:
    """cv2 VideoWriter primary (always present here), imageio-ffmpeg fallback."""
    try:
        import cv2

        h, w = video_u8.shape[1:3]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if writer.isOpened():
            for frame in video_u8:
                writer.write(frame[:, :, ::-1])  # RGB -> BGR
            writer.release()
            return
    except Exception:
        pass
    try:
        import imageio

        imageio.mimsave(path, video_u8, fps=fps)
    except Exception:
        pass  # no mp4 writer available; gif + frame folder remain


def save_gif_mp4_folder_type(
    video: np.ndarray, save_path: str, fps: int = 10, save_gif: bool = True
) -> None:
    """Save one video under save_path base name: .gif, .mp4 and frame folder
    (reference image_util.py:159-169)."""
    frames = [Image.fromarray(f) for f in to_uint8(video)]
    base, _ = os.path.splitext(save_path)
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    if save_gif:
        frames[0].save(
            base + ".gif",
            save_all=True,
            append_images=frames[1:],
            optimize=False,
            loop=0,
            duration=int(1000 / fps),
        )
    _save_mp4(to_uint8(video), base + ".mp4", fps)
    folder = base
    os.makedirs(folder, exist_ok=True)
    for i, frame in enumerate(frames):
        frame.save(os.path.join(folder, f"{i:05d}.png"))


def annotate_video(video: np.ndarray, text: str, font_size: int = 15) -> np.ndarray:
    """Draw the prompt under each frame (reference annotate_image,
    common/image_util.py:48-73 — without the font download)."""
    band = max(24, font_size + 9)
    out = []
    for frame in to_uint8(video):
        img = Image.fromarray(frame)
        w, h = img.size
        canvas = Image.new("RGB", (w, h + band), "white")
        canvas.paste(img, (0, 0))
        draw = ImageDraw.Draw(canvas)
        draw.text((4, h + 4), text[: w // 6], fill="black")
        out.append(np.asarray(canvas))
    return np.stack(out)


def concat_videos(videos: Sequence[np.ndarray], axis: int = 2) -> np.ndarray:
    """Side-by-side grid of equally sized videos (input | edits)."""
    return np.concatenate([to_uint8(v) for v in videos], axis=axis)


def load_image_folder(path: str) -> List[np.ndarray]:
    """Sorted image files -> list of [h, w, 3] uint8 arrays."""
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
    files = sorted(
        f for f in os.listdir(path) if os.path.splitext(f)[1].lower() in exts
    )
    return [np.asarray(Image.open(os.path.join(path, f)).convert("RGB")) for f in files]
