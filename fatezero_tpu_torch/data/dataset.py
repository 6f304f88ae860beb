"""ImageSequenceDataset: sorted image folder -> video clips.

Parity with the reference dataset (video_diffusion/data/dataset.py:15-146):
clips of `n_sample_frame` frames taken every `sampling_rate`, global `stride`
windows for long videos, offset crop -> short-side scale -> center/random
crop -> [-1, 1]. Outputs channels-last numpy [f, h, w, 3] (the framework's
native layout). The optional class-regularization image stream used by
prior-preservation tuning is included.

A copy of fatezero_tpu/data/dataset.py, with its C++ decode fast path
(fatezero_tpu_torch/native). In the auto mode (`native_loader=None`) that
path is taken only where its output equals the PIL path's, and the PIL path
where the library cannot be built; `native_loader=True` asks for the C++
resampling and raises where the library cannot be built (the JAX package
falls back to PIL there).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from fatezero_tpu_torch.data import transform as T


class ImageSequenceDataset:
    def __init__(
        self,
        path: str,
        prompt_ids=None,
        prompt: str = "",
        start_sample_frame: int = 0,
        n_sample_frame: int = 8,
        sampling_rate: int = 1,
        stride: Optional[int] = None,
        image_mode: str = "RGB",
        image_size: int = 512,
        crop: str = "center",
        offset: Optional[Dict[str, int]] = None,
        class_data_root: Optional[str] = None,
        class_prompt_ids=None,
        seed: int = 0,
        native_loader: Optional[bool] = None,  # None=auto (exact cases only)
        **kwargs,
    ):
        self.path = path
        self.images = self._get_image_list(path)
        self.n_images = len(self.images)
        self.offset = offset or {"left": 0, "right": 0, "top": 0, "bottom": 0}
        self.start_sample_frame = start_sample_frame or 0
        if n_sample_frame < 0:
            n_sample_frame = len(self.images)
        self.n_sample_frame = n_sample_frame
        self.sampling_rate = sampling_rate
        # clip span in source frames (dataset.py:41-58)
        self.sequence_length = (n_sample_frame - 1) * sampling_rate + 1
        if self.n_images < self.sequence_length:
            raise ValueError(
                f"self.n_images  {self.n_images} < self.sequence_length {self.sequence_length}: "
                "Required number of frames is larger than total frames in the folder"
            )
        # stride: sliding-window start spacing for long videos
        self.stride = stride if (stride is not None and stride > 0) else self.n_images + 1
        self.video_len = (self.n_images - self.sequence_length) // self.stride + 1

        self.image_size = image_size
        self.crop = crop
        self.prompt = prompt
        self.prompt_ids = prompt_ids
        self._rng = np.random.RandomState(seed)
        self.native_loader = native_loader
        self._short_side = None

        # class (regularization) images for prior-preservation tuning
        self.class_images_path: List[str] = []
        self.class_prompt_ids = class_prompt_ids
        if class_data_root is not None:
            self.class_images_path = [
                os.path.join(class_data_root, f) for f in sorted(os.listdir(class_data_root))
            ]

    @staticmethod
    def _get_image_list(path: str) -> List[str]:
        exts = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
        return sorted(
            f for f in os.listdir(path) if os.path.splitext(f)[1].lower() in exts
        )

    def __len__(self) -> int:
        if self.class_images_path:
            return max(self.video_len, len(self.class_images_path))
        return self.video_len

    def _frame_indices(self, index: int) -> List[int]:
        start = self.start_sample_frame + (index % self.video_len) * self.stride
        return [start + i * self.sampling_rate for i in range(self.n_sample_frame)]

    def _load_frames(self, indices: List[int]) -> np.ndarray:
        from PIL import Image

        frames = []
        for i in indices:
            img = Image.open(os.path.join(self.path, self.images[i])).convert("RGB")
            frames.append(np.asarray(img))
        return np.stack(frames)

    def transform(self, frames: np.ndarray) -> np.ndarray:
        """offset crop -> short-side scale -> crop -> [-1, 1] (dataset.py:109-119)."""
        frames = T.offset_crop(frames, **self.offset)
        frames = T.short_size_scale(frames, self.image_size)
        if self.crop == "random":
            frames = T.random_crop(frames, self.image_size, self.image_size, self._rng)
        else:
            frames = T.center_crop(frames, self.image_size, self.image_size)
        return T.to_tensor_range(frames)

    def scaled_frames(self, index: int = 0) -> np.ndarray:
        """The clip after every step-invariant transform (offset crop +
        short-side scale + [-1,1]) but BEFORE the final spatial crop.

        Feeds the fused tuning scan (trainer/ddpm_trainer.py::run_steps):
        the one-shot workload trains on one clip, so these pixels are
        uploaded to the device once and the per-step random crop runs inside
        the scan — the host touches nothing per step.
        """
        frames = self._load_frames(self._frame_indices(index % self.video_len))
        frames = T.offset_crop(frames, **self.offset)
        frames = T.short_size_scale(frames, self.image_size)
        return T.to_tensor_range(frames)

    def _native_fast_path(self, indices: List[int]):
        """Decode+resize+crop in C++ (fatezero_tpu_torch/native) when it is
        exactly equivalent to the Python path: no offset crop, center crop,
        and no resample (source short side == image_size). With resampling
        involved the filters differ slightly (area vs antialiased bilinear),
        so that only engages when the dataset was built with
        native_loader=True, which then raises if the library cannot be built."""
        if self.native_loader is False:
            return None
        if self.crop != "center" or any(self.offset.values()):
            return None
        if self.native_loader is not True:  # auto mode: exact cases only
            if self._source_short_side() != self.image_size:
                return None
        from fatezero_tpu_torch import native

        try:
            native.get_lib()
        except native.NativeLoaderUnavailable:
            if self.native_loader is True:
                raise
            return None
        paths = [os.path.join(self.path, self.images[i]) for i in indices]
        return native.load_batch(paths, self.image_size)

    def _source_short_side(self) -> int:
        if self._short_side is None:
            from PIL import Image

            with Image.open(os.path.join(self.path, self.images[0])) as im:
                self._short_side = min(im.size)
        return self._short_side

    def __getitem__(self, index: int) -> Dict:
        indices = self._frame_indices(index % self.video_len)
        images = self._native_fast_path(indices)
        if images is None:
            images = self.transform(self._load_frames(indices))
        sample = {
            "images": images,  # [f, h, w, 3] in [-1, 1]
            "prompt_ids": self.prompt_ids,
        }
        if self.class_images_path:
            from PIL import Image

            p = self.class_images_path[index % len(self.class_images_path)]
            img = np.asarray(Image.open(p).convert("RGB"))[None]
            img = T.short_size_scale(img, self.image_size)
            img = T.center_crop(img, self.image_size, self.image_size)
            sample["class_images"] = T.to_tensor_range(img)[0]
            sample["class_prompt_ids"] = self.class_prompt_ids
        return sample
