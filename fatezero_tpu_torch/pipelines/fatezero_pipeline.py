"""FateZero pipeline: DDIM inversion with attention capture, then the P2P edit.

Counterpart of fatezero_tpu/pipelines/fatezero_pipeline.py, the slice the
zero-shot edit runs:

1. ``encode_prompt``: CLIP text embeddings of the source and target prompts;
2. ``encode_video``: VAE encoding of the clip;
3. ``invert_fast(capture=True)``: the clean -> noisy DDIM inversion, which
   also stores every controlled site's payload (cross probabilities and
   self (q, k)) for every step;
4. ``edit_fast(stored=...)``: the CFG edit, in which ptp/context.EditContext
   fuses that payload into the live attention in value space;
5. ``decode_latents``.

Each JAX `lax.scan` is a Python loop over steps here, and its per-step gates
are per-step tensors. The payload is kept in its logical layout. The replay,
inline and hybrid edit modes, attention visualisation, strength < 1, blends
and the streaming store wait for later slices and raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from fatezero_tpu_torch.models.vae import VAE_SCALE
from fatezero_tpu_torch.ops import schedule as S
from fatezero_tpu_torch.ptp.context import EditContext, EditParams, StoreContext
from fatezero_tpu_torch.ptp.controller import EditController


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
        [steps, 1, f, heads, s, 77] and self (q, k) `stored['qk'][key][i]`
        ([steps, 1, f, s, h*d], [steps, 1, n_ref, s, h*d]), in store_dtype.
        Only the cond embedding (cond_embeddings[-1:]) is used: no CFG here.
        """
        steps = num_inference_steps
        if capture_rows is not None and tuple(capture_rows) != (0, steps):
            raise NotImplementedError("partial capture (hybrid edit) is not ported yet")
        ts_up = S.ddim_timesteps(self.schedule, steps)[::-1]
        cond = cond_embeddings[-1:]
        lat = latents.float().to(self.device)
        traj = [lat]
        per_step = []
        for t in ts_up:
            t = int(t)
            if capture:
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
        return traj, _stack_steps(per_step)

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
        """Prompt-to-prompt edit consuming the payload of invert_fast(capture=True).

        Each step runs the 2-row CFG forward with an EditContext over that
        step's payload row (no replay forward). Returns (edited latent
        [1, f, h, w, 4] fp32, aux dict; aux is empty without blends or viz).
        `cond_embeddings` (the source pair) serves only the replay modes.
        """
        steps = num_inference_steps
        if stored is None:
            raise NotImplementedError("the replay and inline edit modes are not ported yet: pass stored=")
        if viz:
            raise NotImplementedError("edit-pass attention visualisation (viz) is not ported yet")
        if strength < 1.0:
            raise NotImplementedError("strength < 1 is not ported yet")
        if stored_row0 != 0 or _payload_rows(stored) != steps:
            raise NotImplementedError("a partial payload (hybrid edit) is not ported yet")

        dev = self.device
        timesteps = S.ddim_timesteps(self.schedule, steps)
        idx = np.arange(steps)
        replay_idx = steps - 1 - idx if controller.use_inversion_attention else idx
        any_self = any(controller.self_replace_active(i) for i in range(steps))

        def on_dev(a, dtype=torch.float32):
            return None if a is None else torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        mapper = on_dev(controller.mapper)
        refine_mapper = on_dev(controller.refine_mapper, torch.long)
        refine_alphas = on_dev(controller.refine_alphas)
        equalizer = on_dev(controller.equalizer)
        alpha_words = on_dev(controller.alpha_time_words[:steps, 0])  # [steps, 1, 1, 77]
        self_gate = on_dev([1.0 if controller.self_replace_active(i) else 0.0 for i in range(steps)])

        latent = traj[steps].float()
        for i in range(steps):
            t = int(timesteps[i])
            pos = int(replay_idx[i])
            injected = {k: [a[pos] for a in lst] for k, lst in stored["probs"].items()}
            injected_qk = {k: [(q[pos], kk[pos]) for q, kk in lst] for k, lst in stored["qk"].items()}
            params = EditParams(
                cross_edit_kind=controller.cross_edit_kind,
                mapper=mapper,
                refine_mapper=refine_mapper,
                refine_alphas=refine_alphas,
                equalizer=equalizer,
                self_replace_active=False,
                self_gate=self_gate[i] if any_self else None,
                self_masks=None,
                save_self_attention=False,
            )
            ectx = EditContext(
                injected=injected,
                params=params,
                alpha_words=alpha_words[i],
                store_dtype=self.store_dtype,
                injected_qk=injected_qk,
            )
            eps = self.unet(torch.cat([latent, latent]), t, text_embeddings, attn_ctx=ectx)
            eps = S.classifier_free_guidance(eps[:1], eps[1:], guidance_scale)
            latent = S.ddim_denoise_step(self.schedule, eps, t, latent, steps)
        aux: Dict = {}
        return latent, aux
