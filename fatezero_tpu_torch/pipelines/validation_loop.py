"""SampleLogger: the tuning run's validation sweep (prompts x seeds + grid).

Counterpart of fatezero_tpu/pipelines/validation_loop.py. Built from the
tuning config's `editing_config` block, it samples every editing prompt
under every sample seed with `pipeline.sample` (the plain CFG loop), saves
`step_{step}_{idx}_{seed}.gif` (+ mp4 + frame folder) per run and an
annotated square grid `step_{step}.gif`, and honours `strength`: with an
online inversion trajectory each run starts from `traj[n_used]` and denoises
only the last n_used = int(steps * strength) timesteps.

Without a trajectory (pure generation) each seed draws its starting noise
from a seeded host `torch.Generator` (the JAX package draws with
jax.random.normal), at the JAX package's latent shape [1, clip_length, 64,
64, 4] whatever the clip's resolution.

On a device mesh (a sharded pipeline) each rank samples its block of frames:
the generation noise is drawn whole and each rank keeps its frames, the
decoded videos are gathered over the frames, and only the `writer` (rank 0)
writes.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from fatezero_tpu_torch.common.image_util import annotate_video, concat_videos, save_gif_mp4_folder_type


def generation_noise(seed: int, shape) -> torch.Tensor:
    """The starting noise of one generation-mode sample (host, fp32)."""
    return torch.randn(tuple(shape), generator=torch.Generator().manual_seed(int(seed)))


class SampleLogger:
    def __init__(
        self,
        editing_prompts: List[str],
        clip_length: int,
        logdir: str,
        subdir: str = "sample",
        num_samples_per_prompt: int = 1,
        sample_seeds: Optional[Sequence[int]] = None,
        num_inference_steps: int = 20,
        guidance_scale: float = 7.0,
        strength: Optional[float] = None,
        annotate: bool = True,
        annotate_size: int = 15,
        make_grid: bool = True,
        grid_column_size: int = 2,
        writer: bool = True,
        **kwargs,
    ) -> None:
        self.editing_prompts = list(editing_prompts)
        self.clip_length = clip_length
        self.guidance_scale = float(guidance_scale)
        self.num_inference_steps = int(num_inference_steps)
        self.strength = 1.0 if strength is None else float(strength)
        if sample_seeds is None:
            rs = np.random.RandomState(0)
            sample_seeds = sorted(int(s) for s in rs.randint(0, int(1e5), int(num_samples_per_prompt)))
        self.sample_seeds = [int(s) for s in sample_seeds]
        self.logdir = os.path.join(logdir, subdir)
        self.writer = writer
        if writer:
            os.makedirs(self.logdir, exist_ok=True)
        self.annotate = annotate
        self.annotate_size = annotate_size
        self.make_grid = make_grid
        self.grid_column_size = grid_column_size

    def log_sample_images(
        self,
        pipeline,
        step: int,
        image: Optional[np.ndarray] = None,  # source video [f, h, w, 3] in [-1, 1]
        traj=None,  # invert_fast trajectory (online re-inversion), or None
    ) -> List[np.ndarray]:
        samples_all = []
        if image is not None:
            src = np.clip(np.asarray(image) / 2.0 + 0.5, 0.0, 1.0)
            samples_all.append(annotate_video(src, "input sequence", font_size=self.annotate_size)
                               if self.annotate else src)
        steps = self.num_inference_steps
        n_used = min(steps, int(steps * self.strength)) if self.strength < 1.0 else steps
        for idx, prompt in enumerate(self.editing_prompts):
            emb = pipeline.encode_prompt(str(prompt))
            for seed in self.sample_seeds:
                if traj is not None:
                    init = traj[n_used]
                else:  # pure generation: seeded noise at the latent shape, this rank's frames of it
                    init = generation_noise(seed, (1, self.clip_length, 64, 64, 4))
                    if getattr(pipeline, "mesh", None) is not None:
                        init = pipeline.mesh.local_frames(init)
                latent = pipeline.sample(
                    init,
                    emb,
                    num_inference_steps=steps,
                    guidance_scale=self.guidance_scale,
                    strength=self.strength if traj is not None else 1.0,
                )
                video = pipeline.gather_frames(pipeline.decode_latents(latent), 0)
                if self.writer:
                    save_gif_mp4_folder_type(video, os.path.join(self.logdir, f"step_{step}_{idx}_{seed}.gif"))
                if self.annotate:
                    video = annotate_video(video, str(prompt), font_size=self.annotate_size)
                if self.make_grid:
                    samples_all.append(video)
        if self.make_grid and samples_all and self.writer:
            # a square-ish grid, ceil(sqrt(n)) videos a row
            cols = int(np.ceil(np.sqrt(len(samples_all))))
            rows = []
            for r in range(0, len(samples_all), cols):
                row = samples_all[r : r + cols]
                row += [np.zeros_like(row[0])] * (cols - len(row))
                rows.append(concat_videos(row, axis=2))
            save_gif_mp4_folder_type(concat_videos(rows, axis=1), os.path.join(self.logdir, f"step_{step}.gif"))
        return samples_all
