"""P2pSampleLogger: drives one edit per editing prompt and logs artifacts.

Counterpart of fatezero_tpu/pipelines/p2p_validation_loop.py: per editing
prompt build the controller from its `p2p_config.<i>` block, run the edit,
write the blend masks' PNGs, save gif/mp4/frame-folder (annotated
optionally), then a side-by-side grid of all prompts and the attention grid.
The artifact names are the JAX package's. The edit is, as there:

* the fused path (default): `edit_fast` (stored, hybrid or replay, with
  strength and the cross-attention visualisation);
* the streaming path (`use_fused_path=False`: disk_store,
  save_attention_maps): `sample` with the controller against the inversion's
  AttentionStore;
* `use_inversion_attention: false` (the save/swap edit, also generation
  mode): the first prompt samples with an `edit_store` and captures its own
  attention, every later prompt edits against that store; a reconstruction
  prompt (the source prompt) samples without a controller.

On a device mesh every rank edits its block of frames, on either path; the
decoded videos, masks and attention maps are gathered over the frames, and
only the `writer` (rank 0) writes them (the controllers of the other ranks
get no save path, so their blenders record without writing).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from fatezero_tpu_torch.common.image_util import (
    annotate_video,
    concat_videos,
    save_gif_mp4_folder_type,
)
from fatezero_tpu_torch.ptp.controller import make_controller
from fatezero_tpu_torch.ptp.store import AttentionStore


class P2pSampleLogger:
    def __init__(
        self,
        editing_prompts: List[str],
        logdir: str,
        source_prompt: str = "",
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        sample_seeds: Sequence[int] = (0,),
        p2p_config: Optional[Dict] = None,
        use_inversion_attention: bool = True,
        strength: Optional[float] = None,
        annotate: bool = False,
        use_fused_path: bool = True,
        save_cross_attention: bool = True,
        writer: bool = True,
    ):
        self.editing_prompts = list(editing_prompts)
        self.logdir = logdir
        self.source_prompt = source_prompt
        self.num_inference_steps = num_inference_steps
        self.guidance_scale = guidance_scale
        self.sample_seeds = list(sample_seeds)
        self.p2p_config = p2p_config or {}
        self.use_inversion_attention = use_inversion_attention
        # img2img strength: None/1.0 runs the full grid; < 1 runs only the
        # last int(steps * strength) timesteps from the matching inversion state
        self.strength = 1.0 if strength is None else float(strength)
        self.annotate = annotate
        self.use_fused_path = use_fused_path
        # the per-edit cross-attention heatmap artifact (`...atten.gif`)
        self.save_cross_attention = save_cross_attention
        self.writer = writer
        if writer:
            os.makedirs(logdir, exist_ok=True)

    def _controller_for(self, pipeline, idx: int, target_prompt: str):
        cfg = dict(self.p2p_config.get(idx, self.p2p_config.get(str(idx), {})) or {})
        cross = cfg.get("cross_replace_steps", 0.8)
        if isinstance(cross, dict) and set(cross) == {"default_"}:
            cross = cross["default_"]
        return make_controller(
            pipeline.tokenizer,
            [self.source_prompt, target_prompt],
            num_steps=self.num_inference_steps,
            is_replace_controller=cfg.get("is_replace_controller", True),
            cross_replace_steps=cross,
            self_replace_steps=cfg.get("self_replace_steps", 0.0),
            blend_words=cfg.get("blend_words"),
            eq_params=cfg.get("eq_params"),
            blend_th=cfg.get("blend_th", (0.3, 0.3)),
            blend_latents=cfg.get("blend_latents", False),
            blend_self_attention=cfg.get("blend_self_attention", False),
            use_inversion_attention=cfg.get("use_inversion_attention", self.use_inversion_attention),
            save_self_attention=cfg.get("save_self_attention", True),
            save_path=os.path.join(self.logdir, f"prompt_{idx}") if self.writer else None,
        )

    def max_edit_window(self, pipeline) -> int:
        """Max EditController.edit_window over this run's editing prompts: the
        number of leading edit steps that read inversion attention. Drives the
        capture planner (FateZeroPipeline.plan_capture): payload rows past the
        widest window serve no prompt."""
        steps = self.num_inference_steps
        n_used = min(steps, int(steps * self.strength)) if self.strength < 1.0 else steps
        w = 0
        for idx, prompt in enumerate(self.editing_prompts):
            if prompt == self.source_prompt and not self.use_inversion_attention:
                continue
            w = max(w, self._controller_for(pipeline, idx, prompt).edit_window(n_used))
        return w

    def log_sample_images(
        self,
        pipeline,
        source_video: np.ndarray,
        traj=None,
        inv_store: Optional[AttentionStore] = None,
        inverted_latents=None,
        emb_source=None,
        stored=None,
        stored_row0: int = 0,
        step: int = 0,
    ) -> List[np.ndarray]:
        """Run every editing prompt; returns the list of decoded videos.

        Artifacts, as the JAX package names them: per prompt
        `step_{step}_{idx}_{seed}.gif` (+ mp4 + frame folder), its
        cross-attention heatmap sibling `step_{step}_{idx}_{seed}atten.gif`,
        the blend masks under `prompt_{idx}/{latent,attention}_blend_mask`,
        the all-prompt grid `step_{step}.gif` (also saved as `grid.gif`) and
        the vertically stacked attention grid `step_{step}atten.gif`. As in
        JAX the seed loop is collapsed to sample_seeds[0]: the edit is
        deterministic given the inversion trajectory (DDIM at eta 0).

        The fused path reads `traj`, the trajectory of invert_fast, and
        `stored`, its payload (invert_fast(capture=True), possibly for rows
        [stored_row0, ...)), or None to replay; the streaming path reads
        `inv_store` and `inverted_latents`, what `invert(store=...)` gave.
        """
        # when annotating, the source row needs the same text band or the
        # grid concat fails on mismatched heights
        videos = [annotate_video(source_video, self.source_prompt) if self.annotate else source_video]
        attn_videos: List[np.ndarray] = []
        if emb_source is None:
            emb_source = pipeline.encode_prompt(self.source_prompt)
        steps = self.num_inference_steps
        n_used = min(steps, int(steps * self.strength)) if self.strength < 1.0 else steps
        # trajectory entry n_used is the inversion state at the noise level of
        # the first timestep a strength-sliced run denoises
        init_latent = traj[n_used] if traj is not None else inverted_latents[n_used]
        run = dict(num_inference_steps=steps, guidance_scale=self.guidance_scale, strength=self.strength)
        save_store = None  # the save/swap edit: prompt 0's own maps
        for idx, prompt in enumerate(self.editing_prompts):
            edit_aux = None
            controller = None
            if prompt != self.source_prompt or self.use_inversion_attention:
                controller = self._controller_for(pipeline, idx, prompt)
            emb_tgt = pipeline.encode_prompt(prompt)
            if not self.use_inversion_attention:
                if idx == 0:
                    save_store = AttentionStore()
                    latent = pipeline.sample(init_latent, emb_tgt, edit_store=save_store, **run)
                else:
                    latent = pipeline.sample(
                        init_latent, emb_tgt, controller=controller, inv_store=save_store,
                        inverted_latents=[init_latent] + list(save_store.latents_store), **run,
                    )
            elif self.use_fused_path:
                if traj is None:
                    raise ValueError("the fused path needs the latent trajectory of invert_fast")
                if controller is not None:
                    latent, edit_aux = pipeline.edit_fast(
                        traj,
                        emb_source,
                        emb_tgt,
                        controller,
                        viz=self.save_cross_attention,
                        stored=stored,
                        stored_row0=stored_row0,
                        **run,
                    )
                else:
                    latent = pipeline.sample(init_latent, emb_tgt, **run)
            else:
                latent = pipeline.sample(
                    init_latent, emb_tgt, controller=controller, inv_store=inv_store,
                    inverted_latents=inverted_latents, **run,
                )
            # the fused edit returns the per-step blend masks (the streaming
            # one records them each step); write them as the JAX package
            # does, one PNG per (step, frame)
            for aux_key, blender in (
                ("attn_mask", None if controller is None else controller.attention_blend),
                ("latent_mask", None if controller is None else controller.latent_blend),
            ):
                if edit_aux is None or blender is None or aux_key not in edit_aux:
                    continue
                masks = pipeline.gather_frames(edit_aux[aux_key], 2)  # [steps, p, f, h, w]
                for step_mask in masks.float().cpu().numpy():
                    blender.counter += 1
                    blender.record(step_mask, f"step{blender.counter - 1:03d}")
            video = pipeline.gather_frames(pipeline.decode_latents(latent), 0)
            tag = f"step_{step}_{idx}_{self.sample_seeds[0]}"
            if self.writer:
                save_gif_mp4_folder_type(video, os.path.join(self.logdir, f"{tag}.gif"))
            if edit_aux is not None and "cross_avg" in edit_aux:
                # per-edit cross-attention heatmap gif, aggregated over
                # layers, heads and steps, saved as the `...atten.gif` sibling
                from fatezero_tpu_torch.ptp.visualization import show_cross_attention

                avg = pipeline.gather_frames(edit_aux["cross_avg"], 1).float().cpu().numpy()  # [1, f, s, 77]
                res = int(np.sqrt(avg.shape[2]))
                attn_video = show_cross_attention(
                    pipeline.tokenizer,
                    prompt,
                    {"up_cross": [avg[:, :, None]]},  # [1, f, 1, s, 77]
                    res=res,
                    save_path=os.path.join(self.logdir, f"{tag}atten.gif") if self.writer else None,
                )
                attn_videos.append(attn_video)
            if self.annotate:
                video = annotate_video(video, prompt)
            videos.append(video)
        if not self.writer:
            return videos[1:]
        grid = concat_videos(videos, axis=2)
        save_gif_mp4_folder_type(grid, os.path.join(self.logdir, f"step_{step}.gif"))
        save_gif_mp4_folder_type(grid, os.path.join(self.logdir, "grid.gif"))
        if attn_videos:
            # the attention grid, one prompt under the other; heatmap widths
            # differ per prompt (token count), so pad to the widest
            wmax = max(v.shape[2] for v in attn_videos)
            padded = [np.pad(v, ((0, 0), (0, 0), (0, wmax - v.shape[2]), (0, 0))) for v in attn_videos]
            save_gif_mp4_folder_type(
                concat_videos(padded, axis=1),
                os.path.join(self.logdir, f"step_{step}atten.gif"),
            )
        return videos[1:]
