"""The tuning driver: one update of one-shot tuning per unit of work.

Set-up builds the program's UNet and VAE from the generated weights and one
`DDPMTrainer` with its state, encodes the clip's prompt (and the class
prompt), and drives that trainer through its first three updates with
`DDPMTrainer.step`, the call the window makes, reading on the way what the
check compares: each update's loss, the first gradient as the optimizer
holds it (AdamW's first moment after one update, over 1 - beta1), each
trained tensor's change after the third update, and the VAE's posterior
moments of each update (a forward hook on `quant_conv`). The reference
trains from those moments, the program's encoding (at the smallest
timesteps the noised latent is nearly the clean one, so bf16's encoding
would otherwise set the gradients' gap), and checks the encoding by itself. The same trainer and state
then run the window, update after update, on the same clip with new draws
from the host generator, as `cli.train`'s per-step path runs them.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import work
from portbench.drivers import common as C
from portbench.reference import numerics
from portbench.reference.tune import TuneReference, draw, leaf_gap

CHECKED_UPDATES = 3


class Driver:
    unit_name = "update"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = torch.device(device)
        self.frames, self.res = int(mix["frames"]), int(mix["resolution"])
        self.classes = int(mix.get("class_images", 0))
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}

    def setup(self) -> None:
        from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
        from fatezero_tpu_torch.trainer.ddpm_trainer import DDPMTrainer

        if self.device.type == "cuda":
            from fatezero_tpu_torch import csrc

            csrc.build_all(tuple(self.mix["kernels"]))
        m = C.build_program(self.cfg, self.seed, self.device)
        pipe = FateZeroPipeline(m.unet, m.vae, m.text_encoder, m.tokenizer, schedule=m.schedule, device=self.device)
        self.ids = C.token_ids(m.tokenizer, [self.mix["prompt"], self.mix.get("class_prompt", "")])
        # the cond rows, cloned out of inference mode so that autograd may save them
        self.emb = pipe.encode_prompt(self.mix["prompt"])[-1:].clone()
        self.class_emb = pipe.encode_prompt(self.mix.get("class_prompt", ""))[-1:].clone() if self.classes else None
        tr = self.cfg["train"]
        self.trainer = DDPMTrainer(
            m.unet, m.vae, schedule=m.schedule, learning_rate=float(tr["learning_rate"]),
            lr_scheduler=tr["lr_scheduler"], train_steps=int(tr["train_steps"]),
            max_grad_norm=float(tr["max_grad_norm"]), train_temporal_conv=bool(tr["train_temporal_conv"]),
            optimizer=tr["optimizer"], prior_preservation=tr.get("prior_preservation"),
            weight_decay=float(tr["weight_decay"]),
        )
        self.unet = m.unet
        self.state = self.trainer.init_state()
        self.gen = torch.Generator().manual_seed(self.seed)
        self.images = C.clip(self.seed, 0, self.frames, self.res, self.device)
        init = {n: p.detach().clone() for n, p in self.trainer.trainable.items()}
        # the VAE's posterior moments of each checked update: the reference trains
        # from the program's encoding and checks the encoding by itself
        self.moments: List[torch.Tensor] = []
        hook = m.vae.quant_conv.register_forward_hook(
            lambda mod, args, out: self.moments.append(out.detach().float().clone()))
        self.losses, times = [], []
        for k in range(CHECKED_UPDATES):
            t0 = time.perf_counter()
            self.losses.append(self.unit(k))
            times.append(time.perf_counter() - t0)
            if k == 0:
                opt = self.state["optimizer"]
                beta1 = opt.param_groups[0]["betas"][0]
                # an optimizer that holds no moment has taken no gradient: 0
                self.grad_norms = {n: float(opt.state[m_].get("exp_avg", torch.zeros(())).norm()) / (1 - beta1)
                                   for n, m_ in self.state["master"].items()}
        hook.remove()
        self.change_norms = {n: float((m_.detach().float() - init[n].float()).norm())
                             for n, m_ in self.state["master"].items()}
        del init
        self.warm_s = float(np.mean(times[1:]))

    def unit(self, index: int, timed_spans: bool = False) -> float:
        class_images = None
        if self.classes:
            class_images = C.clip(self.seed, 1000 + self.state["step"], self.classes, self.res, self.device)
        self.state, loss = self.trainer.step(self.state, self.images, self.emb, self.gen, class_images,
                                             self.class_emb)
        return float(loss)  # the loss a tuning run logs every update: the update ends on the host

    def trace_data(self) -> Dict:
        b, f, h = 1, self.frames, self.res // 8
        fwd = work.unet_ops(self.cfg, b, f, h, h, bool(self.cfg["train"]["train_temporal_conv"]))
        model = (work.flops(work.vae_encode_ops(self.cfg, f, self.res, self.res))
                 + work.flops(fwd) + work.backward_flops(fwd))
        return {"flops_per_unit": model}

    def attention_hooks(self):
        return None

    k1_launches = staticmethod(C.k1_launches)

    def frozen_changed(self) -> int:
        """How many frozen tensors of the UNet differ from the weights they were given."""
        dtype = C.dtype_of(self.cfg, self.device)
        from portbench import weights as PW

        given = PW.make(self.cfg, "unet", self.seed, self.device, dtype)
        trained = set(self.trainer.trainable)
        return sum(int(not torch.equal(p.detach(), given[n].to(p.dtype)))
                   for n, p in self.unet.named_parameters() if n not in trained)

    def release(self) -> None:
        self.frozen = self.frozen_changed()
        self.trainer = self.state = self.unet = None

    def check(self, control=None) -> Dict[str, Dict[str, float]]:
        numerics.strict_fp32()
        dev = self.device
        W = C.reference_weights(self.cfg, self.seed, dev)
        from portbench.reference.sd import VAE, TextEncoder

        ids = torch.as_tensor(self.ids["padded"][0], device=dev)
        text = TextEncoder(W["text_encoder"], numerics.FP32(), self.cfg)
        emb_ref = text.forward(ids)[-1:]
        class_emb_ref = text.forward(torch.as_tensor(self.ids["padded"][1], device=dev))[-1:]
        sides = {"ref": numerics.FP32()}
        if control is not None:
            sides["control"] = control
        images = C.clip(self.seed, 0, self.frames, self.res, dev).float()
        per_update = len(self.moments) // CHECKED_UPDATES  # VAE encodes an update (2 with a class term)
        moments = self.moments[::per_update]
        ref_moments = torch.cat(VAE(W["vae"], numerics.FP32(), self.cfg).encode(images), dim=-1)
        readings = {}
        for side, P in sides.items():
            r = TuneReference(W, self.cfg, P, dev, C.dtype_of(self.cfg, dev))
            gen = torch.Generator().manual_seed(self.seed)
            init = {n: r.params[n].detach().clone() for n in r.names}
            losses, first = [], None
            for k in range(CHECKED_UPDATES):
                d = draw(gen, self.frames, self.res, self.res, self.classes)
                class_images = None
                if self.classes:
                    class_images = C.clip(self.seed, 1000 + k, self.classes, self.res, dev).float()
                loss, grads = r.update(images, emb_ref, d, class_images, class_emb_ref, moments=moments[k])
                losses.append(loss)
                if k == 0:
                    first = {n: float(g.norm()) for n, g in grads.items()}
            change = {n: float((r.params[n].detach() - init[n]).norm()) for n in r.names}
            enc = torch.cat(VAE(W["vae"], P, self.cfg).encode(images), dim=-1)
            readings[side] = {"losses": losses, "grads": first, "change": change,
                              "encode": float((enc - ref_moments).norm() / ref_moments.norm())}
            del r
        ref = readings["ref"]
        med = sorted(ref["grads"].values())[len(ref["grads"]) // 2]
        moved = [n for n, g in ref["grads"].items() if g >= 1e-3 * med]

        def numbers(side):
            return {
                "loss": max(abs(a - b) / abs(b) for a, b in zip(side["losses"], ref["losses"])),
                "first_grad": leaf_gap(side["grads"], ref["grads"]),
                "change": leaf_gap(side["change"], ref["change"], moved),
            }

        prog = {"losses": self.losses, "grads": self.grad_norms, "change": self.change_norms}
        out = {"program": {"text": float((self.emb.float() - emb_ref).norm() / emb_ref.norm()),
                           "encode": float((moments[0] - ref_moments).norm() / ref_moments.norm()),
                           **numbers(prog), "frozen_changed": float(self.frozen)}}
        if control is not None:
            text_c = TextEncoder(W["text_encoder"], control, self.cfg).forward(ids)[-1:]
            out["control"] = {"text": float((text_c - emb_ref).norm() / emb_ref.norm()),
                              "encode": readings["control"]["encode"], **numbers(readings["control"])}
        return out
