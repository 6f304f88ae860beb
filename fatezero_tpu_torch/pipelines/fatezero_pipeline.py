"""FateZero pipeline: DDIM inversion with attention capture, then the P2P edit.

Counterpart of fatezero_tpu/pipelines/fatezero_pipeline.py, the zero-shot
edit:

1. ``encode_prompt``: CLIP text embeddings of the source and target prompts;
2. ``encode_video``: VAE encoding of the clip;
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

Each JAX `lax.scan` is a Python loop over steps here, and its per-step gates
are per-step tensors. The payload is kept in its logical layout. The
streaming store (``invert``, ``sample``) waits for a later slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from fatezero_tpu_torch.models.vae import VAE_SCALE
from fatezero_tpu_torch.ops import schedule as S
from fatezero_tpu_torch.ptp.context import EditContext, EditParams, InlineEditContext, StoreContext
from fatezero_tpu_torch.ptp.controller import EditController
from fatezero_tpu_torch.ptp.spatial_blend import apply_latent_blend, blend_mask


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


class FateZeroPipeline:
    """Bundles the models and the schedule on one device; exposes the edit slice."""

    def __init__(
        self,
        unet,
        vae,
        text_encoder,
        tokenizer,
        schedule: Optional[S.DiffusionSchedule] = None,
        store_dtype=torch.bfloat16,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.unet = unet
        self.vae = vae
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer
        self.schedule = schedule if schedule is not None else S.make_schedule(device=self.device)
        self.store_dtype = store_dtype

    # ------------------------------------------------------------------ text
    @torch.inference_mode()
    def encode_prompt(self, prompt: str, negative_prompt: str = "") -> torch.Tensor:
        """[2, 77, C] (uncond, cond) text embeddings."""
        ids = self.tokenizer([negative_prompt, prompt]).input_ids
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)
        return self.text_encoder(ids)

    # ------------------------------------------------------------------- vae
    @torch.inference_mode()
    def encode_video(self, images: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images [f, h, w, 3] in [-1, 1] -> fp32 latents [1, f, h/8, w/8, 4] (scaled).

        With a `generator` the posterior is sampled; without, its mean is used."""
        mean, logvar = self.vae.encode(images.to(self.device))
        z = mean.float()
        if generator is not None:
            noise = torch.randn(mean.shape, generator=generator, device=generator.device)
            z = z + torch.exp(0.5 * logvar.float()) * noise.to(z.device)
        return (z * VAE_SCALE)[None]

    @torch.inference_mode()
    def decode_latents(self, latents: torch.Tensor, chunk: int = 16) -> np.ndarray:
        """latents [1, f, h, w, 4] -> video [f, 8h, 8w, 3] in [0, 1] (numpy fp32),
        decoded in frame chunks."""
        frames = latents[0] / VAE_SCALE
        outs = []
        for i in range(0, frames.shape[0], chunk):
            outs.append(self.vae.decode(frames[i : i + chunk]).float().cpu().numpy())
        video = np.concatenate(outs, axis=0)
        return np.clip(video / 2.0 + 0.5, 0.0, 1.0)

    # ------------------------------------------------------------- inversion
    def invert(self, *args, **kwargs):
        """The streaming-store inversion (maps copied to a host AttentionStore)."""
        raise NotImplementedError("the streaming store is not ported yet: use invert_fast(capture=True)")

    def sample(self, *args, **kwargs):
        """The streaming-store edit and plain sampling."""
        raise NotImplementedError("the streaming store is not ported yet: use edit_fast(stored=...)")

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
                sctx = StoreContext(save_self_attention=False, store_dtype=self.store_dtype, self_qk=True)
                eps = self.unet(lat, t, cond, attn_ctx=sctx)
                per_step.append({"probs": sctx.captured, "qk": sctx.captured_qk})
            else:
                eps = self.unet(lat, t, cond)
            lat = S.ddim_invert_step(self.schedule, eps, t, lat, steps)
            traj.append(lat)
        traj = torch.stack(traj)
        if not capture:
            return traj
        return traj, (_stack_steps(per_step) if per_step else None)

    def capture_payload_bytes(self, latents: torch.Tensor, num_inference_steps: int = 50) -> int:
        """Predict the payload of `invert_fast(capture=True)` in bytes without
        running the model: one forward of a storage-free copy of the UNet
        (meta device) on the latents' shape records the payload's shapes.

        Logical bytes, with the stored layouts: per step and controlled site,
        cross probabilities [1, f, heads, s, 77] and self (q, k) as
        [1, f, s, heads*d] and [1, n_ref, s, heads*d] (n_ref, the frames
        the sparse-causal attention reads), each in store_dtype.
        """
        from fatezero_tpu_torch.models.unet3d import UNetPseudo3DConditionModel

        meta = UNetPseudo3DConditionModel(self.unet.cfg, dtype=self.unet.dtype, device="meta")
        sctx = StoreContext(save_self_attention=False, store_dtype=self.store_dtype, self_qk=True)
        lat = torch.empty(tuple(latents.shape), dtype=torch.float32, device="meta")
        cond = torch.empty((1, 77, self.unet.cfg.cross_attention_dim), dtype=torch.float32, device="meta")
        with torch.inference_mode():
            meta(lat, 0, cond, attn_ctx=sctx)
        leaves = _payload_leaves({"probs": sctx.captured, "qk": sctx.captured_qk})
        per_step = sum(t.numel() * t.element_size() for t in leaves)
        return per_step * num_inference_steps

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
        """
        steps = num_inference_steps
        strength = 1.0 if strength is None else float(strength)
        n_used = min(steps, int(steps * strength)) if strength < 1.0 else steps
        per_step = self.capture_payload_bytes(latents, 1)
        budget_steps = int(budget_bytes // max(1, per_step))
        if budget_steps >= steps:
            return (0, steps)
        k = max(0, min(n_used, int(window), budget_steps))
        if k == 0:
            return None
        row0 = (n_used - k) if use_inversion_attention else 0
        return (row0, k)

    # ------------------------------------------------------------------ edit
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
        text3 = torch.cat([cond_src, text_embeddings], dim=0)

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
            self.unet(lat, t, cond_src, attn_ctx=sctx, drop_replay_rows=lat.shape[0])
            return sctx.captured, sctx.captured_qk

        def viz16(ctx_maps):
            """The live cond row's mid-resolution cross maps, mean over sites and heads."""
            maps16 = _blend_maps_16(ctx_maps, latent_hw)
            tot = sum(m.float().sum(dim=2) for m in maps16)
            return tot / sum(int(m.shape[2]) for m in maps16)

        latent = traj[steps - t_start].float()
        sums: Optional[List[torch.Tensor]] = None  # running sums of the live blend maps
        vsum = None
        outs: Dict[str, List[torch.Tensor]] = {"attn_mask": [], "latent_mask": []}
        for i in range(n_used):
            t = int(timesteps[grid[i]])
            rep_lat = traj[int(replay_idx[i])]
            if inline:
                ctx = InlineEditContext(
                    params_at(i), alpha_words[i], store_dtype=self.store_dtype,
                    capture_for_blend=use_latent_blend, viz_size=s16 if viz else None,
                )
                eps = self.unet(torch.cat([rep_lat, latent, latent]), t, text3, attn_ctx=ctx, drop_replay_rows=1)
                if eps.shape[0] == 3:  # low resolution: nothing was dropped
                    eps = eps[1:]
                live_maps, inv_maps = ctx.captured, ctx.captured_inv
            else:
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
                eps = self.unet(torch.cat([latent, latent]), t, text_embeddings, attn_ctx=ctx)
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
