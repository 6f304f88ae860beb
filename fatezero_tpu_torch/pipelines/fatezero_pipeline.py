"""FateZero pipeline: DDIM inversion with attention capture, then the P2P edit.

Counterpart of fatezero_tpu/pipelines/fatezero_pipeline.py, the zero-shot
edit:

1. ``encode_prompt``: CLIP text embeddings of the source and target prompts
   (with two towers, SDXL's, a ``PromptEmbeds``: the concatenated context and
   the second tower's pooled embeds, which every UNet call adds to the time
   embedding with the clip's text-time ids);
2. ``encode_video``: VAE encoding of the clip, scaled by the VAE config's
   ``scaling_factor``;
3. ``invert_fast``: the clean -> noisy DDIM inversion; with capture=True it
   also stores the controlled sites' payload (cross probabilities and self
   (q, k)) for every step, or for the rows ``capture_rows`` names
   (``plan_capture`` picks them for a memory budget);
4. ``edit_fast``: the CFG edit, in which ptp/context.EditContext fuses that
   payload into the live attention in value space. Without a payload it
   replays each inversion step's forward to capture the maps first (replay),
   or runs that replay as row 0 of one 3-row forward (inline); with a partial
   payload it runs a stored prefix, a replay middle and an identity-gated
   stored tail (hybrid). Spatial blends, strength < 1 and the attention
   visualisation work in every mode;
5. ``decode_latents``.

The streaming half: ``invert(store=...)`` copies every step's materialised
maps to a host AttentionStore (ptp/store.py, optionally pickled to disk),
and ``sample`` runs the plain CFG loop (``sample_fast``), the 'save' loop
that captures into an ``edit_store``, or the edit that reads the store one
host row per step (every controlled site materialised, as in JAX).

Each JAX `lax.scan` is a Python loop over steps here, and its per-step gates
are per-step tensors. The payload is kept in its logical layout.

``shard(mesh)`` puts the pipeline on a (data, seq, tensor) device mesh
(parallel/sharding.py; one process per device, as torchrun launches them):
the UNet keeps this rank's heads and feed-forward columns, and every method
runs under the mesh. `encode_video` keeps this rank's block of frames, and
the DDIM carry, the payload, the blend masks and `decode_latents` stay on
those frames; `gather_frames` assembles the whole clip on request. The
streaming half runs there too: each rank's AttentionStore holds its frames
and heads of every map, the host trajectory stays on its frames, and the
blenders record the whole clip's masks.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from fatezero_tpu_torch.common.profiling import span, spanned
from fatezero_tpu_torch.ops import schedule as S
from fatezero_tpu_torch.parallel.sharding import seq_mesh_scope, shard_unet_, tensor_size, tensor_sum
from fatezero_tpu_torch.ptp.context import EditContext, EditParams, InlineEditContext, StoreContext
from fatezero_tpu_torch.ptp.controller import EditController
from fatezero_tpu_torch.ptp.spatial_blend import apply_latent_blend, blend_mask
from fatezero_tpu_torch.ptp.store import AttentionStore


class PromptEmbeds:
    """A two-tower prompt encoding: `context` [B, 77, C1 + C2] (each tower's
    penultimate hidden states side by side) and `pooled` [B, P] (the second
    tower's projected EOS state), row for row. Rows slice and concatenate
    together, so the pipeline's methods take it where they take a context."""

    def __init__(self, context: torch.Tensor, pooled: torch.Tensor):
        self.context, self.pooled = context, pooled

    def __getitem__(self, rows) -> "PromptEmbeds":
        return PromptEmbeds(self.context[rows], self.pooled[rows])

    def float(self) -> "PromptEmbeds":
        return PromptEmbeds(self.context.float(), self.pooled.float())

    def cpu(self) -> "PromptEmbeds":
        return PromptEmbeds(self.context.cpu(), self.pooled.cpu())

    @staticmethod
    def cat(parts) -> "PromptEmbeds":
        return PromptEmbeds(torch.cat([p.context for p in parts]), torch.cat([p.pooled for p in parts]))


def _cat_embeds(parts):
    """Row-concatenate contexts, or PromptEmbeds."""
    return PromptEmbeds.cat(parts) if isinstance(parts[0], PromptEmbeds) else torch.cat(parts, dim=0)


def _stack_steps(per_step):
    """[{probs: {key: [t]}, qk: {key: [(q, k)]}}] per step -> the same tree with
    every leaf stacked over steps on a new leading axis."""
    first = per_step[0]
    return {
        "probs": {
            key: [torch.stack([s["probs"][key][i] for s in per_step]) for i in range(len(lst))]
            for key, lst in first["probs"].items()
        },
        "qk": {
            key: [
                tuple(torch.stack([s["qk"][key][i][j] for s in per_step]) for j in range(2))
                for i in range(len(lst))
            ]
            for key, lst in first["qk"].items()
        },
    }


def _payload_rows(stored) -> int:
    for lst in stored["probs"].values():
        if lst:
            return int(lst[0].shape[0])
    for lst in stored["qk"].values():
        if lst:
            return int(lst[0][0].shape[0])
    raise ValueError("empty stored payload")


def _payload_leaves(payload):
    """Every tensor of a payload tree ({probs: {key: [t]}, qk: {key: [(q, k)]}})."""
    for lst in payload["probs"].values():
        yield from lst
    for lst in payload["qk"].values():
        for pair in lst:
            yield from pair


def _blend_maps_16(captured: Dict[str, List], latent_hw: int) -> List:
    """The mid-resolution cross maps the blenders aggregate: the down and up
    cross maps with (latent/4)^2 queries (the five 16x16 maps of SD-1.4 at
    512^2), chosen by resolution so that every UNet geometry works."""
    s_target = (latent_hw // 4) ** 2
    maps = [m for m in captured["down_cross"] if m.shape[-2] == s_target]
    maps += [m for m in captured["up_cross"] if m.shape[-2] == s_target]
    return maps


def _build_self_masks(injected: Dict[str, List], attn_alpha, attn_th, latent_hw: int, self_sizes):
    """Binary masks for the self swap at each self-site size, from the
    inversion step's mid-resolution cross maps, source prompt only.
    Returns ({s_tokens: [f, 1, s, 1]}, the largest as [1, f, r, r])."""
    maps16 = [m.float() for m in _blend_maps_16(injected, latent_hw)]
    f = maps16[0].shape[1]
    self_masks = {}
    s_set = sorted(self_sizes)
    for s in s_set:
        r = int(np.sqrt(s))
        mask = blend_mask(maps16, attn_alpha, (r, r), attn_th)
        self_masks[s] = mask[0].reshape(f, 1, s, 1)
    r_max = int(np.sqrt(max(s_set)))
    return self_masks, self_masks[max(s_set)].reshape(1, f, r_max, r_max)


def _on_mesh(method):
    """Run a pipeline method under the pipeline's mesh (None: one device)."""

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with seq_mesh_scope(self.mesh):
            return method(self, *args, **kwargs)

    return wrapped


class FateZeroPipeline:
    """Bundles the models and the schedule on one device, or on this rank's
    place on a device mesh (`shard`); exposes the edit slice."""

    def __init__(
        self,
        unet,
        vae,
        text_encoder,
        tokenizer,
        schedule: Optional[S.DiffusionSchedule] = None,
        store_dtype=torch.bfloat16,
        device="cuda",
        text_encoder_2=None,
        tokenizer_2=None,
    ):
        self.device = torch.device(device)
        self.unet = unet
        self.vae = vae
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer
        self.text_encoder_2 = text_encoder_2
        self.tokenizer_2 = tokenizer_2
        self._time_ids: Dict = {}
        self.schedule = schedule if schedule is not None else S.make_schedule(device=self.device)
        self.store_dtype = store_dtype
        self.mesh = None

    # ------------------------------------------------------------------ mesh
    def shard(self, mesh) -> "FateZeroPipeline":
        """Put the pipeline on `mesh` (parallel/sharding.Mesh): the UNet keeps
        this rank's tensor-parallel weights (shard_unet_); the VAE and the
        text encoder stay whole. From here on the video tensors the methods
        take and return hold this rank's block of frames."""
        shard_unet_(self.unet, mesh)
        self.mesh = mesh
        return self

    def gather_frames(self, x, axis: int = 1):
        """The whole clip of a frame-sharded tensor or numpy array, on every
        rank (x itself without a mesh)."""
        if self.mesh is None or self.mesh.seq == 1:
            return x
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            return self.mesh.all_frames(t, axis).cpu().numpy()
        return self.mesh.all_frames(x.to(self.device), axis)

    # ------------------------------------------------------------------ text
    @spanned("fz.pipeline.encode_prompt")
    @torch.inference_mode()
    def encode_prompt(self, prompt: str, negative_prompt: str = ""):
        """[2, 77, C] (uncond, cond) text embeddings; with a second tower a
        PromptEmbeds of both towers, whose uncond row is zeros for an empty
        negative prompt (SDXL's published `force_zeros_for_empty_prompt`)."""

        def ids_of(tokenizer):
            ids = tokenizer([negative_prompt, prompt]).input_ids
            return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)

        if self.text_encoder_2 is None:
            return self.text_encoder(ids_of(self.tokenizer))
        ids_2 = ids_of(self.tokenizer_2)
        ctx_2, pooled = self.text_encoder_2(ids_2, pool=True, eos_token_id=self.tokenizer_2.eos_token_id)
        context = torch.cat([self.text_encoder(ids_of(self.tokenizer)), ctx_2], dim=-1)
        if not negative_prompt:
            context = torch.cat([torch.zeros_like(context[:1]), context[1:]])
            pooled = torch.cat([torch.zeros_like(pooled[:1]), pooled[1:]])
        return PromptEmbeds(context, pooled)

    def _unet(self, sample, t, embeds, unet=None, **kwargs):
        """One UNet call under a context or a PromptEmbeds: the latter's pooled
        embeds and the clip's text-time ids (original size, crop corner
        (0, 0), target size: the frames' pixel size, as SDXL's pipeline
        conditions a full uncropped image) go in as the added conditions."""
        unet = self.unet if unet is None else unet
        if not isinstance(embeds, PromptEmbeds):
            return unet(sample, t, embeds, **kwargs)
        key = (self._pixel_size(sample), sample.device)
        time_ids = self._time_ids.get(key)
        if time_ids is None:  # made once per size: no host-to-device copy per call
            (h, w), dev = key
            time_ids = self._time_ids[key] = torch.tensor([[h, w, 0, 0, h, w]], dtype=torch.float32, device=dev)
        added = {"text_embeds": embeds.pooled, "time_ids": time_ids.expand(embeds.pooled.shape[0], 6)}
        return unet(sample, t, embeds.context, added_cond=added, **kwargs)

    def _pixel_size(self, latents):
        """The frames' pixel (height, width) of [.., h, w, 4] latents (the
        whole frame's on a mesh, which splits frames, not space)."""
        f = 2 ** (len(self.vae.cfg.block_out_channels) - 1) if self.vae is not None else 8
        return int(latents.shape[-3]) * f, int(latents.shape[-2]) * f

    @property
    def latent_scale(self) -> float:
        return float(self.vae.cfg.scaling_factor)

    # ------------------------------------------------------------------- vae
    @spanned("fz.pipeline.encode_video")
    @torch.inference_mode()
    def encode_video(self, images: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images [f, h, w, 3] in [-1, 1] -> fp32 latents [1, f, h/8, w/8, 4] (scaled);
        on a mesh, of this rank's block of the frames.

        With a `generator` the posterior is sampled (the clip's noise, drawn
        whole); without, its mean is used."""
        frames = images.shape[0]
        if self.mesh is not None:
            images = self.mesh.local_frames(images, axis=0)
        mean, logvar = self.vae.encode(images.to(self.device))
        z = mean.float()
        if generator is not None:
            noise = torch.randn((frames, *mean.shape[1:]), generator=generator, device=generator.device)
            if self.mesh is not None:
                noise = self.mesh.local_frames(noise, axis=0)
            z = z + torch.exp(0.5 * logvar.float()) * noise.to(z.device)
        return (z * self.latent_scale)[None]

    @spanned("fz.pipeline.decode_latents")
    @torch.inference_mode()
    def decode_latents(self, latents: torch.Tensor, chunk: int = 16) -> np.ndarray:
        """latents [1, f, h, w, 4] -> video [f, 8h, 8w, 3] in [0, 1] (numpy fp32),
        decoded in frame chunks."""
        frames = latents[0] / self.latent_scale
        outs = []
        for i in range(0, frames.shape[0], chunk):
            outs.append(self.vae.decode(frames[i : i + chunk]).float().cpu().numpy())
        video = np.concatenate(outs, axis=0)
        return np.clip(video / 2.0 + 0.5, 0.0, 1.0)

    # ------------------------------------------------------------- streaming
    @_on_mesh
    @torch.inference_mode()
    def invert(
        self,
        latents: torch.Tensor,
        cond_embeddings: torch.Tensor,
        num_inference_steps: int = 50,
        store: Optional[AttentionStore] = None,
        save_self_attention: bool = True,
    ) -> List[torch.Tensor]:
        """Clean -> noisy DDIM inversion with the streaming store: with a
        `store`, every controlled site materialises its probabilities and each
        step's cond-row maps and latent are copied to the host store. Only the
        cond embedding is used (no CFG). Returns the host trajectory
        [clean, ... steps x noisier] (fp32 CPU tensors [1, f, h, w, 4])."""
        steps = num_inference_steps
        timesteps = S.ddim_timesteps(self.schedule, steps)
        cond = cond_embeddings[-1:]
        lat = latents.float().to(self.device)
        all_latents = [lat.cpu()]
        for i in range(steps):
            t = int(timesteps[steps - i - 1])
            ctx = None
            if store is not None:
                ctx = StoreContext(save_self_attention=save_self_attention, store_dtype=self.store_dtype)
            eps = self._unet(lat, t, cond, attn_ctx=ctx)
            lat = S.ddim_invert_step(self.schedule, eps, t, lat, steps)
            if store is not None:
                store.append_step(ctx.captured, lat)
            all_latents.append(lat.cpu())
        return all_latents

    @_on_mesh
    @torch.inference_mode()
    def sample_fast(
        self,
        latents: torch.Tensor,
        text_embeddings: torch.Tensor,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        strength: float = 1.0,
    ) -> torch.Tensor:
        """The plain CFG DDIM loop (no store, no edit). strength < 1 runs only
        the last int(steps * strength) timesteps."""
        steps = num_inference_steps
        ts = S.ddim_timesteps(self.schedule, steps)
        n_used = min(steps, int(steps * strength))
        lat = latents.float().to(self.device)
        for t in ts[steps - n_used:]:
            t = int(t)
            eps = self._unet(torch.cat([lat, lat]), t, text_embeddings)
            eps = S.classifier_free_guidance(eps[:1], eps[1:], guidance_scale)
            lat = S.ddim_denoise_step(self.schedule, eps, t, lat, steps)
        return lat

    @_on_mesh
    @torch.inference_mode()
    def sample(
        self,
        latents: torch.Tensor,
        text_embeddings: torch.Tensor,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        controller: Optional[EditController] = None,
        inv_store: Optional[AttentionStore] = None,
        edit_store: Optional[AttentionStore] = None,
        inverted_latents: Optional[List[torch.Tensor]] = None,
        strength: float = 1.0,
    ) -> torch.Tensor:
        """Noisy -> clean CFG denoising on the streaming store.

        controller=None: the plain loop (`sample_fast`), or with `edit_store`
        the 'save' loop, which captures every step's maps into it. With an
        EditController: the prompt-to-prompt edit against `inv_store`, one
        host row per step, every controlled site materialised; the latent
        blend reads `inverted_latents` (the [clean, ...] trajectory) and the
        blenders record their masks each step. strength < 1 skips the
        earliest timesteps; an inversion store is read at each step's noise
        level, a 'save' store (captured on the same sliced grid) by step.
        """
        steps = num_inference_steps
        dev = self.device
        timesteps = S.ddim_timesteps(self.schedule, steps)
        n_used, t_start = steps, 0
        if strength < 1.0:
            n_used = min(steps, int(steps * strength))
            t_start = steps - n_used
            timesteps = timesteps[t_start:]
        latent = latents.float().to(dev)

        if controller is None:
            if edit_store is None:
                return self.sample_fast(latents, text_embeddings, steps, guidance_scale, strength=strength)
            for t in timesteps:
                latent, captured = self._save_step(latent, int(t), text_embeddings, guidance_scale, steps)
                edit_store.append_step(captured, latent)
            return latent

        if inv_store is None:
            raise ValueError("editing requires the inversion attention store")
        num_stored = len(inv_store.attention_store_all_step)

        def on_dev(a, dtype=torch.float32):
            return None if a is None else torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        mapper = on_dev(controller.mapper)
        refine_mapper = on_dev(controller.refine_mapper, torch.long)
        refine_alphas = on_dev(controller.refine_alphas)
        equalizer = on_dev(controller.equalizer)
        attn_blend, latent_blend = controller.attention_blend, controller.latent_blend
        attn_alpha = on_dev(attn_blend.alpha_layers[:1]) if attn_blend is not None else None
        latent_alpha = on_dev(latent_blend.alpha_layers) if latent_blend is not None else None
        latent_hw = int(latents.shape[2])
        blend_sums = None  # running sums of the live blend maps, on the card
        for i in range(n_used):
            t = int(timesteps[i])
            store_step = t_start + i if controller.use_inversion_attention else i
            idx = controller.step_in_store(store_step, num_stored)
            injected = {k: [m.to(dev) for m in v] for k, v in inv_store.step_maps(idx).items()}
            inv_latent = None
            if latent_blend is not None:
                lat_idx = (
                    len(inverted_latents) - 1 - (t_start + i) if controller.use_inversion_attention else i + 1
                )
                inv_latent = inverted_latents[lat_idx].float().to(dev)
                if blend_sums is None:
                    blend_sums = [torch.zeros(m.shape, device=dev) for m in _blend_maps_16(injected, latent_hw)]
            params = EditParams(
                cross_edit_kind=controller.cross_edit_kind,
                mapper=mapper,
                refine_mapper=refine_mapper,
                refine_alphas=refine_alphas,
                equalizer=equalizer,
                self_replace_active=controller.self_replace_active(i),
                save_self_attention=controller.save_self_attention,
            )
            latent, captured, blend_sums, masks = self._edit_step(
                latent, t, text_embeddings, guidance_scale, steps, controller, params,
                injected, on_dev(controller.alpha_time_words[i, 0]), blend_sums, inv_latent,
                attn_alpha, latent_alpha, blend_now=latent_blend is not None and latent_blend.latent_blend_active(i),
            )
            if edit_store is not None:
                edit_store.append_step(captured, latent)
            for blender, key in ((attn_blend, "attention_blend"), (latent_blend, "latent_blend")):
                if blender is not None and masks[key] is not None:
                    blender.counter += 1
                    blender.record(self.gather_frames(masks[key]).float().cpu().numpy(), f"step{i:03d}")
        return latent

    def _save_step(self, latent, t, text_embeddings, guidance_scale, steps):
        """One CFG step that captures the cond row's maps ('save')."""
        ctx = StoreContext(store_dtype=self.store_dtype)
        eps = self._unet(torch.cat([latent, latent]), t, text_embeddings, attn_ctx=ctx)
        eps = S.classifier_free_guidance(eps[:1], eps[1:], guidance_scale)
        return S.ddim_denoise_step(self.schedule, eps, t, latent, steps), ctx.captured

    def _edit_step(self, latent, t, text_embeddings, guidance_scale, steps, controller, params, injected,
                   alpha_words, blend_sums, inv_latent, attn_alpha, latent_alpha, blend_now):
        """One streaming edit step over one host row of the inversion store:
        (new latent, the pre-edit cond-row maps, the blend sums, the masks)."""
        latent_hw = int(latent.shape[2])
        mask_viz = None
        if controller.attention_blend is not None:
            sizes = {int(m.shape[-2]) for k in ("down_self", "mid_self", "up_self") for m in injected.get(k, [])}
            params.self_masks, mask_viz = _build_self_masks(
                injected, attn_alpha, controller.attention_blend.th[0], latent_hw, sizes
            )
        ctx = EditContext(
            injected=injected, params=params, alpha_words=alpha_words, store_dtype=self.store_dtype,
            value_space_cross=False,
        )
        eps = self._unet(torch.cat([latent, latent]), t, text_embeddings, attn_ctx=ctx)
        eps = S.classifier_free_guidance(eps[:1], eps[1:], guidance_scale)
        new_latent = S.ddim_denoise_step(self.schedule, eps, t, latent, steps)
        masks = {"attention_blend": mask_viz, "latent_blend": None}
        if controller.latent_blend is not None:
            live16 = [m.float() for m in _blend_maps_16(ctx.captured, latent_hw)]
            blend_sums = [a + m for a, m in zip(blend_sums, live16)]
            # two rows per map: the inversion step's map and the edit's running sum
            pair = [torch.cat([im.float(), a], dim=0) for im, a in zip(_blend_maps_16(injected, latent_hw), blend_sums)]
            lmask = blend_mask(pair, latent_alpha, tuple(new_latent.shape[2:4]), controller.latent_blend.th[0])
            lmask = torch.maximum(lmask[:1], lmask)  # the union ('both')
            masks["latent_blend"] = lmask
            if blend_now:
                new_latent = apply_latent_blend(new_latent, inv_latent, lmask)
        return new_latent, ctx.captured, blend_sums, masks

    @spanned("fz.pipeline.invert_fast")
    @_on_mesh
    @torch.inference_mode()
    def invert_fast(
        self,
        latents: torch.Tensor,
        cond_embeddings: torch.Tensor,
        num_inference_steps: int = 50,
        capture: bool = False,
        capture_rows=None,
    ):
        """Clean -> noisy DDIM inversion; returns the latent trajectory
        [steps+1, 1, f, h, w, 4] (fp32), and with capture=True also the stored
        payload: cross probabilities `stored['probs'][key][i]`
        [rows, 1, f, heads, s, 77] and self (q, k) `stored['qk'][key][i]`
        ([rows, 1, f, s, h*d], [rows, 1, n_ref, s, h*d]), in store_dtype.
        capture_rows=(row0, count) captures only inversion steps
        [row0, row0 + count) (rows = count; pass stored_row0=row0 to
        edit_fast); the default captures every step. Only the cond embedding
        (cond_embeddings[-1:]) is used: no CFG here.
        """
        steps = num_inference_steps
        row0, count = (0, steps) if capture_rows is None else (int(capture_rows[0]), int(capture_rows[1]))
        ts_up = S.ddim_timesteps(self.schedule, steps)[::-1]
        cond = cond_embeddings[-1:]
        lat = latents.float().to(self.device)
        traj = [lat]
        per_step = []
        for i, t in enumerate(ts_up):
            t = int(t)
            if capture and row0 <= i < row0 + count:
                with span("fz.ptp.step"):
                    sctx = StoreContext(save_self_attention=False, store_dtype=self.store_dtype, self_qk=True)
                eps = self._unet(lat, t, cond, attn_ctx=sctx)
                per_step.append({"probs": sctx.captured, "qk": sctx.captured_qk})
            else:
                eps = self._unet(lat, t, cond)
            lat = S.ddim_invert_step(self.schedule, eps, t, lat, steps)
            traj.append(lat)
        traj = torch.stack(traj)
        if not capture:
            return traj
        return traj, (_stack_steps(per_step) if per_step else None)

    @_on_mesh
    def capture_payload_bytes(self, latents: torch.Tensor, num_inference_steps: int = 50) -> int:
        """Predict the payload of `invert_fast(capture=True)` in bytes without
        running the model: one forward of a storage-free copy of the UNet
        (meta device) on the latents' shape records the payload's shapes.

        Logical bytes, with the stored layouts: per step and controlled site,
        cross probabilities [1, f, heads, s, 77] and self (q, k) as
        [1, f, s, heads*d] and [1, n_ref, s, heads*d] (n_ref, the frames
        the sparse-causal attention reads), each in store_dtype. On a mesh,
        what this rank holds: its frames (`latents` are its block) and its
        heads, and of the referenced K frames those in its block; the copy is
        sharded alike and traced under the mesh, whose collectives return a
        meta tensor unchanged.
        """
        from fatezero_tpu_torch.models.unet3d import UNetPseudo3DConditionModel

        meta = UNetPseudo3DConditionModel(self.unet.cfg, dtype=self.unet.dtype, device="meta")
        if self.mesh is not None:
            shard_unet_(meta, self.mesh)
        sctx = StoreContext(save_self_attention=False, store_dtype=self.store_dtype, self_qk=True)
        lat = torch.empty(tuple(latents.shape), dtype=torch.float32, device="meta")
        with torch.inference_mode():
            self._unet(lat, 0, self._meta_cond(), unet=meta, attn_ctx=sctx)
        leaves = _payload_leaves({"probs": sctx.captured, "qk": sctx.captured_qk})
        per_step = sum(t.numel() * t.element_size() for t in leaves)
        return per_step * num_inference_steps

    @_on_mesh
    def store_step_bytes(self, latents: torch.Tensor, save_self_attention: bool = True) -> int:
        """Predict the bytes one step of `invert(store=...)` copies to the host
        store, without running the model: a meta-device forward with the
        inversion's StoreContext records every stored map's shape. On a mesh,
        what this rank stores: its frames and heads."""
        from fatezero_tpu_torch.models.unet3d import UNetPseudo3DConditionModel

        meta = UNetPseudo3DConditionModel(self.unet.cfg, dtype=self.unet.dtype, device="meta")
        if self.mesh is not None:
            shard_unet_(meta, self.mesh)
        ctx = StoreContext(save_self_attention=save_self_attention, store_dtype=self.store_dtype)
        lat = torch.empty(tuple(latents.shape), dtype=torch.float32, device="meta")
        with torch.inference_mode():
            self._unet(lat, 0, self._meta_cond(), unet=meta, attn_ctx=ctx)
        return sum(m.numel() * m.element_size() for v in ctx.captured.values() for m in v)

    def _meta_cond(self):
        """A storage-free one-row context (and pooled embeds, for a text-time UNet)."""
        cfg = self.unet.cfg
        cond = torch.empty((1, 77, cfg.cross_attention_dim), dtype=torch.float32, device="meta")
        if self.unet.add_embedding is None:
            return cond
        pooled_dim = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        return PromptEmbeds(cond, torch.empty((1, pooled_dim), dtype=torch.float32, device="meta"))

    @spanned("fz.pipeline.plan_capture")
    def plan_capture(
        self,
        latents: torch.Tensor,
        num_inference_steps: int,
        window: int,
        budget_bytes: float,
        strength: float = 1.0,
        use_inversion_attention: bool = True,
    ):
        """The inversion rows worth capturing under a payload budget: (row0, count) or None.

        `window` is the number of leading edit steps that read the payload
        (EditController.edit_window). Returns (0, steps) when every step
        fits, (row0, k) for a partial capture that serves edit steps [0, k)
        (the rest of the edit replays, or runs identity-gated stored steps),
        or None when not even one step fits: then the caller edits by replay.
        On a mesh the budget is per rank, against the most any rank holds, so
        that every rank plans alike.
        """
        steps = num_inference_steps
        strength = 1.0 if strength is None else float(strength)
        n_used = min(steps, int(steps * strength)) if strength < 1.0 else steps
        per_step = self.capture_payload_bytes(latents, 1)
        if self.mesh is not None:
            per_step = self.mesh.max_over_ranks(per_step)
        budget_steps = int(budget_bytes // max(1, per_step))
        if budget_steps >= steps:
            return (0, steps)
        k = max(0, min(n_used, int(window), budget_steps))
        if k == 0:
            return None
        row0 = (n_used - k) if use_inversion_attention else 0
        return (row0, k)

    # ------------------------------------------------------------------ edit
    @spanned("fz.pipeline.edit_fast")
    @_on_mesh
    @torch.inference_mode()
    def edit_fast(
        self,
        traj: torch.Tensor,
        cond_embeddings: torch.Tensor,
        text_embeddings: torch.Tensor,
        controller: EditController,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        strength: float = 1.0,
        viz: bool = False,
        stored=None,
        stored_row0: int = 0,
    ):
        """Prompt-to-prompt edit from the trajectory of `invert_fast`.

        Modes, as in the JAX package:
        * stored (`stored` holds every row): each step runs the 2-row CFG
          forward with an EditContext over that step's payload row;
        * replay (stored=None): each step first runs the matching inversion
          forward as a capture-only forward (rows dropped once no controlled
          site is left), then the CFG forward over what it captured;
        * inline (stored=None with use_inversion_attention and no attention
          blend): one 3-row forward, [replay, uncond, cond], per step;
        * hybrid (a partial payload from invert_fast(capture_rows=(row0, k)),
          stored_row0=row0): the steps the payload serves run stored, the
          other steps inside the controller's edit window replay, and the
          identity steps after it run stored against payload row 0, whose
          values the zero alpha and self gates multiply away.
        strength < 1 runs only the last int(steps * strength) timesteps, each
        reading the inversion state at its own noise level.

        `cond_embeddings` is the source pair (its cond row drives the replay),
        `text_embeddings` the target pair. Returns (edited latent
        [1, f, h, w, 4] fp32, aux): aux holds per step the attention-blend
        mask `attn_mask` [n_used, 1, f, r, r] and the latent-blend mask
        `latent_mask` [n_used, 2, f, h, w] when those blends are on, and with
        `viz` `cross_avg` [1, f, (h/4)^2, 77], the live cond row's cross maps
        at that resolution averaged over sites, heads and steps.
        """
        steps = num_inference_steps
        dev = self.device
        use_stored = stored is not None
        use_attn_blend = controller.attention_blend is not None
        use_latent_blend = controller.latent_blend is not None
        any_self = any(controller.self_replace_active(i) for i in range(steps))
        save_self = any_self or use_attn_blend  # what a replay must capture
        inline = controller.use_inversion_attention and not use_attn_blend and not use_stored

        n_used = min(steps, int(steps * strength)) if strength < 1.0 else steps
        t_start = steps - n_used
        timesteps = np.asarray(S.ddim_timesteps(self.schedule, steps), np.int64)
        idx = np.arange(n_used)
        grid = t_start + idx
        if controller.use_inversion_attention:
            replay_idx = steps - 1 - grid
            blend_idx = steps - grid
            replay_ts = timesteps[grid]
        else:
            replay_idx = idx
            blend_idx = idx + 1
            replay_ts = timesteps[::-1][idx]

        # which steps read the payload, and which row: a stored prefix of
        # n_stored steps, then replay up to the edit window, then the
        # identity-gated tail, which reads row 0 (any finite row would do)
        seg_stored = np.zeros(n_used, bool)
        replay_pos = np.zeros(n_used, np.int64)
        if use_stored:
            k_rows = _payload_rows(stored)
            served = (replay_idx >= stored_row0) & (replay_idx < stored_row0 + k_rows)
            n_stored = int(served.argmin()) if not served.all() else n_used
            if not (served[:n_stored].all() and not served[n_stored:].any()):
                raise ValueError(
                    f"stored payload rows [{stored_row0}, {stored_row0 + k_rows}) must serve a contiguous "
                    f"prefix of the edit steps (replay indices {replay_idx.tolist()})"
                )
            w_id = n_used if n_stored == n_used else max(controller.edit_window(n_used), n_stored)
            seg_stored[:n_stored] = True
            seg_stored[w_id:] = True
            replay_pos[:n_stored] = replay_idx[:n_stored] - stored_row0

        def on_dev(a, dtype=torch.float32):
            return None if a is None else torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        mapper = on_dev(controller.mapper)
        refine_mapper = on_dev(controller.refine_mapper, torch.long)
        refine_alphas = on_dev(controller.refine_alphas)
        equalizer = on_dev(controller.equalizer)
        alpha_words = on_dev(controller.alpha_time_words[:n_used, 0])  # [n_used, 1, 1, 77]
        self_gate = on_dev([1.0 if controller.self_replace_active(i) else 0.0 for i in range(n_used)])
        attn_alpha = on_dev(controller.attention_blend.alpha_layers[:1]) if use_attn_blend else None
        latent_alpha = on_dev(controller.latent_blend.alpha_layers) if use_latent_blend else None
        blend_gate = (
            on_dev([1.0 if controller.latent_blend.latent_blend_active(i) else 0.0 for i in range(n_used)])
            if use_latent_blend
            else None
        )

        latent_hw = int(traj.shape[-3])
        s16 = (latent_hw // 4) ** 2
        cond_src = cond_embeddings[-1:]
        text3 = _cat_embeds([cond_src, text_embeddings])

        def params_at(i, self_masks=None):
            return EditParams(
                cross_edit_kind=controller.cross_edit_kind,
                mapper=mapper,
                refine_mapper=refine_mapper,
                refine_alphas=refine_alphas,
                equalizer=equalizer,
                self_replace_active=False,
                self_gate=self_gate[i] if any_self else None,
                self_masks=self_masks,
                save_self_attention=False,
            )

        def capture(lat, t):
            """A capture-only forward of the inversion step: (cross maps, self (q, k))."""
            sctx = StoreContext(save_self_attention=False, store_dtype=self.store_dtype, self_qk=save_self)
            self._unet(lat, t, cond_src, attn_ctx=sctx, drop_replay_rows=lat.shape[0])
            return sctx.captured, sctx.captured_qk

        def viz16(ctx_maps):
            """The live cond row's mid-resolution cross maps, mean over sites and
            heads (every rank's heads, on a mesh that splits them)."""
            maps16 = _blend_maps_16(ctx_maps, latent_hw)
            tot = tensor_sum(sum(m.float().sum(dim=2) for m in maps16))
            return tot / (sum(int(m.shape[2]) for m in maps16) * tensor_size())

        latent = traj[steps - t_start].float()
        sums: Optional[List[torch.Tensor]] = None  # running sums of the live blend maps
        vsum = None
        outs: Dict[str, List[torch.Tensor]] = {"attn_mask": [], "latent_mask": []}
        for i in range(n_used):
            t = int(timesteps[grid[i]])
            rep_lat = traj[int(replay_idx[i])]
            if inline:
                with span("fz.ptp.step"):
                    ctx = InlineEditContext(
                        params_at(i), alpha_words[i], store_dtype=self.store_dtype,
                        capture_for_blend=use_latent_blend, viz_size=s16 if viz else None,
                    )
                eps = self._unet(torch.cat([rep_lat, latent, latent]), t, text3, attn_ctx=ctx, drop_replay_rows=1)
                if eps.shape[0] == 3:  # low resolution: nothing was dropped
                    eps = eps[1:]
                live_maps, inv_maps = ctx.captured, ctx.captured_inv
            else:
                # a replay's capture forward runs inside: its UNet spans are this one's children
                with span("fz.ptp.step"):
                    if seg_stored[i]:
                        pos = int(replay_pos[i])
                        injected = {k: [a[pos] for a in lst] for k, lst in stored["probs"].items()}
                        injected_qk = {k: [(q[pos], kk[pos]) for q, kk in lst] for k, lst in stored["qk"].items()}
                    else:
                        injected, injected_qk = capture(rep_lat, int(replay_ts[i]))
                    self_masks = None
                    if use_attn_blend:
                        sizes = {int(q.shape[-2]) for lst in injected_qk.values() for q, _ in lst}
                        self_masks, mask_viz = _build_self_masks(
                            injected, attn_alpha, controller.attention_blend.th[0], latent_hw, sizes
                        )
                        outs["attn_mask"].append(mask_viz)
                    ctx = EditContext(
                        injected=injected,
                        params=params_at(i, self_masks),
                        alpha_words=alpha_words[i],
                        store_dtype=self.store_dtype,
                        injected_qk=injected_qk,
                        materialize_cross_size=s16 if (use_latent_blend or viz) else None,
                    )
                eps = self._unet(torch.cat([latent, latent]), t, text_embeddings, attn_ctx=ctx)
                live_maps, inv_maps = ctx.captured, injected
            eps = S.classifier_free_guidance(eps[:1], eps[1:], guidance_scale)
            new_latent = S.ddim_denoise_step(self.schedule, eps, t, latent, steps)

            if use_latent_blend:
                live16 = [m.float() for m in _blend_maps_16(live_maps, latent_hw)]
                sums = live16 if sums is None else [a + m for a, m in zip(sums, live16)]
                pair = [torch.cat([im.float(), a], dim=0) for im, a in zip(_blend_maps_16(inv_maps, latent_hw), sums)]
                lmask = blend_mask(pair, latent_alpha, tuple(new_latent.shape[2:4]), controller.latent_blend.th[0])
                lmask = torch.maximum(lmask[:1], lmask)  # the union ('both')
                blended = apply_latent_blend(new_latent, traj[int(blend_idx[i])], lmask)
                bg = blend_gate[i]
                new_latent = bg * blended + (1.0 - bg) * new_latent
                outs["latent_mask"].append(lmask)
            if viz:
                v = viz16(live_maps)
                vsum = v if vsum is None else vsum + v
            latent = new_latent

        aux: Dict = {key: torch.stack(lst) for key, lst in outs.items() if lst}
        if viz:
            aux["cross_avg"] = vsum / n_used
        return latent, aux
