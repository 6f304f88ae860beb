"""The edit driver: one FateZero edit of a clip per unit of work.

A unit encodes the two prompts, VAE-encodes the clip, plans the capture
under the mix's payload budget (`mode: stored`) or captures nothing
(`mode: replay`), inverts, edits and decodes to host frames, through the
program's `FateZeroPipeline`; it ends in a device synchronise. Every unit
edits a clip of its own, drawn from the seed and the unit's index.

The check follows the program step by step from its own state: a forward
pre-hook on the UNet keeps the latent of every edit step (the last row of
each forward's input), and `invert_fast` returns the inversion's trajectory.
The reference then takes, at steps drawn from the seed, the program's latent
and computes that one step, and holds the text embeddings, the VAE encoding
and the decoded frames to its own from the same ids, frames and latents.

Attention control is also checked site by site, since with random weights
the attention is nearly uniform and its edits move a whole step by less than
rounding. In set-up's warm edit (the pipeline and calls the window drives),
forward hooks on the UNet's spatial attention modules keep, at one edit step
drawn from the seed inside the controller's window, each controlled site's
inputs and output, and the source row's inputs at the inversion forward of
the same timestep (what the stored capture or the inline replay is made
from). The reference computes each site, fusion included, from those inputs.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import trace as T
from portbench import work
from portbench.drivers import common as C
from portbench.reference.diffusion import P2P
from portbench.reference.edit import EditReference, PooledEpsGap, rel, sample_steps
from portbench.reference.sd import MAX_CONTROLLED


class Driver:
    unit_name = "edit"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = torch.device(device)
        self.steps = int(mix["steps"])
        self.frames, self.res = int(mix["frames"]), int(mix["resolution"])
        self.records: List[Dict] = []
        self.recording: Optional[List[torch.Tensor]] = None
        self.spans: Dict[str, List[float]] = {"invert_fast": [], "edit_fast": []}
        self.counters: Dict[str, float] = {}

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline

        if self.device.type == "cuda":
            from fatezero_tpu_torch import csrc

            csrc.build_all(tuple(self.mix["kernels"]))
        m = C.build_program(self.cfg, self.seed, self.device)
        self.tok = m.tokenizer
        self.pipe = FateZeroPipeline(m.unet, m.vae, m.text_encoder, m.tokenizer, schedule=m.schedule,
                                     store_dtype=m.dtype, device=self.device)
        self.ids = C.token_ids(self.tok, [self.mix["source"], self.mix["target"]])
        self.pipe.unet.register_forward_pre_hook(self._record, with_kwargs=True)
        tok = {"ids": self.ids["ids"], "spans": self.ids["spans"]}
        p2p = P2P([self.mix["source"], self.mix["target"]], tok, self.mix["p2p"], self.steps, "cpu")
        edited = [i for i in range(self.steps) if p2p.self_gate(i) and float(p2p.alpha_words[i].max()) > 0]
        self.site_step = int(np.random.default_rng([self.seed, 11]).choice(edited or list(range(self.steps))))
        from fatezero_tpu_torch.ops import schedule as S

        self.sites = SiteRecorder(self.pipe.unet, int(S.ddim_timesteps(m.schedule, self.steps)[self.site_step]))
        t0 = time.perf_counter()
        self.unit(-1)  # the warm edit: every shape and kernel of the window
        self.warm_s = time.perf_counter() - t0
        self.sites.remove()
        self.records.clear()

    def _record(self, module, args, kwargs):
        x = args[0]
        if self.recording is not None and kwargs.get("drop_replay_rows", 0) < x.shape[0]:
            self.recording.append(x[-1:].detach().clone())

    def _controller(self):
        from fatezero_tpu_torch.ptp.controller import make_controller

        p = self.mix["p2p"]
        return make_controller(
            self.tok, [self.mix["source"], self.mix["target"]], num_steps=self.steps,
            is_replace_controller=p.get("is_replace_controller", True),
            cross_replace_steps=p.get("cross_replace_steps", 0.8),
            self_replace_steps=p.get("self_replace_steps", 0.0), eq_params=p.get("eq_params"),
        )

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # --------------------------------------------------------------- a unit
    def unit(self, index: int, timed_spans: bool = False) -> None:
        pipe, steps = self.pipe, self.steps
        frames = C.clip(self.seed, index, self.frames, self.res, self.device)
        phases = {}

        def phase(name, fn):
            with T.span(name):
                t0 = time.perf_counter()
                out = fn()
                if timed_spans:
                    self._sync()
                    phases[name] = time.perf_counter() - t0
            return out

        emb_src = phase("encode_prompt", lambda: pipe.encode_prompt(self.mix["source"]))
        emb_tgt = phase("encode_prompt", lambda: pipe.encode_prompt(self.mix["target"]))
        lat = phase("encode_video", lambda: pipe.encode_video(frames))
        ctl = self._controller()
        rows = None
        if self.mix["mode"] == "stored":
            rows = phase("plan_capture", lambda: pipe.plan_capture(
                lat, steps, window=ctl.edit_window(steps), budget_bytes=float(self.mix["payload_budget_gb"]) * 1e9))
        sites = self.sites if index < 0 else None
        if sites:
            sites.phase = "invert"
        if rows is None:
            traj, stored = phase("invert_fast", lambda: pipe.invert_fast(lat, emb_src, steps)), None
        else:
            traj, stored = phase("invert_fast", lambda: pipe.invert_fast(
                lat, emb_src, steps, capture=True, capture_rows=rows))
        self.counters["payload_bytes"] = 0 if stored is None else sum(
            t.numel() * t.element_size() for t in _leaves(stored))
        self.recording = []
        if sites:
            sites.phase = "edit"
        latent, _ = phase("edit_fast", lambda: pipe.edit_fast(
            traj, emb_src, emb_tgt, ctl, steps, float(self.mix["guidance_scale"]), stored=stored,
            stored_row0=rows[0] if rows else 0))
        lats, self.recording = self.recording, None
        if sites:
            sites.phase = None
        del stored
        video = phase("decode_latents", lambda: pipe.decode_latents(latent))
        self._sync()
        for name in ("invert_fast", "edit_fast"):
            if name in phases:
                self.spans[name].append(phases[name])
        self.records.append({
            "index": index, "emb": (emb_src.float().cpu(), emb_tgt.float().cpu()), "lat": lat.float().cpu(),
            "traj": traj.cpu(), "lats": [x.cpu() for x in lats] + [latent.float().cpu()], "video": video,
        })

    # ----------------------------------------------------------- trace data
    def trace_data(self) -> Dict:
        """What the per-layer readers of an edit need besides the trace."""
        b, f, h = 1, self.frames, self.res // 8
        inv, edit = work.unet_ops(self.cfg, b, f, h, h), work.unet_ops(self.cfg, 2, f, h, h)
        model = (2 * work.flops(work.text_ops(self.cfg, 2)) + work.flops(work.vae_encode_ops(self.cfg, f, self.res, self.res))
                 + self.steps * (work.flops(inv) + work.flops(edit)) + work.flops(work.vae_decode_ops(self.cfg, f, h, h)))
        attn = [(o.flops, o.nbytes) for o in inv + edit if o.attn]
        from portbench.roofline import total_bound_s

        return {"flops_per_unit": model, "attn_bound_s": self.steps * total_bound_s(attn)}

    def attention_hooks(self):
        """Spans around every call of the UNet's attention modules."""
        from fatezero_tpu_torch.models.attention import Attention, TemporalAttention

        return T.AttentionSpans(self.pipe.unet, (Attention, TemporalAttention))

    k1_launches = staticmethod(C.k1_launches)

    # ---------------------------------------------------------------- check
    def release(self) -> None:
        """Drop the program, so that the reference runs on a free card."""
        self.pipe = None

    def check(self, control=None) -> Dict[str, Dict[str, float]]:
        """The numbers compared, each the worst of its samples: {"program": {...}}
        and, with a control policy, {"control": {...}} read at the same inputs."""
        from portbench.reference import numerics

        numerics.strict_fp32()
        dev = self.device
        W = C.reference_weights(self.cfg, self.seed, dev)
        tok = {"ids": self.ids["ids"], "spans": self.ids["spans"]}
        ref = EditReference(W, self.cfg, numerics.FP32(), self.mix, tok, dev)
        ctl = None if control is None else EditReference(W, self.cfg, control, self.mix, tok, dev)
        out = {"program": {}} if ctl is None else {"program": {}, "control": {}}

        def note(side, key, value):
            out[side][key] = max(out[side].get(key, 0.0), value)

        emb_ref = [ref.encode_prompt(p).float() for p in self.ids["padded"]]
        for i, e in enumerate(self.records[0]["emb"]):
            note("program", "text", rel(e.to(dev), emb_ref[i]))
            if ctl is not None:
                note("control", "text", rel(ctl.encode_prompt(self.ids["padded"][i]), emb_ref[i]))
        rng = np.random.default_rng([self.seed, 7])
        n = len(self.records)
        for rec in self.records:
            frames = C.clip(self.seed, rec["index"], self.frames, self.res, dev).float()
            z = ref.encode_video(frames)
            note("program", "encode", rel(rec["lat"].to(dev), z))
            if ctl is not None:
                note("control", "encode", rel(ctl.encode_video(frames), z))
            v = ref.decode(rec["lats"][-1].to(dev))
            note("program", "decode", rel(torch.as_tensor(rec["video"], device=dev), v))
            if ctl is not None:
                note("control", "decode", rel(ctl.decode(rec["lats"][-1].to(dev)), v))
        chk = self.mix["check"]
        gaps = {(side, key): PooledEpsGap() for side in out for key in ("invert_step", "edit_step")}
        for u, s in sample_steps(rng, n, self.steps, int(chk["invert_steps"])):
            traj = self.records[u]["traj"]
            x = traj[s].to(dev)
            r, eps, c = ref.invert_step(x, s, emb_ref[0])
            gaps["program", "invert_step"].add(traj[s + 1].to(dev), r, eps, c)
            if ctl is not None:
                gaps["control", "invert_step"].add(ctl.invert_step(x, s, emb_ref[0])[0], r, eps, c)
        for u, s in sample_steps(rng, n, self.steps, int(chk["edit_steps"])):
            rec = self.records[u]
            x, src = rec["lats"][s].to(dev), rec["traj"][self.steps - 1 - s].to(dev)
            r, eps, c = ref.edit_step(x, s, src, emb_ref[0], emb_ref[1])
            gaps["program", "edit_step"].add(rec["lats"][s + 1].to(dev), r, eps, c)
            if ctl is not None:
                gaps["control", "edit_step"].add(ctl.edit_step(x, s, src, emb_ref[0], emb_ref[1])[0], r, eps, c)
        for (side, key), g in gaps.items():
            out[side][key] = g.value()
            print(f"portbench: {side} {key} per sampled step " + " ".join(f"{v:.4g}" for v in g.steps),
                  file=sys.stderr)
        # attention control, site by site, at the warm edit's drawn step
        site_gaps = {(side, key): PooledEpsGap() for side in out for key in ("self_sites", "cross_sites")}
        inv, edit = self.sites.kept["invert"], self.sites.kept["edit"]
        for name in sorted(edit):
            x_e, c_e, o_e = edit[name]
            x_s, c_s, _ = inv[name]
            x3 = torch.cat([x_s[-1:], x_e[-2:]]).to(dev).float()
            c3 = None if c_e is None else torch.cat([c_s[-1:], c_e[-2:]]).to(dev).float()
            key = "self_sites" if c3 is None else "cross_sites"
            r = ref.site(name, x3, c3, self.site_step)[-1:]
            site_gaps["program", key].add(o_e[-1:].to(dev), r, r, 1.0)
            if ctl is not None:
                site_gaps["control", key].add(ctl.site(name, x3, c3, self.site_step)[-1:], r, r, 1.0)
        for (side, key), g in site_gaps.items():
            if g.den:
                out[side][key] = g.value()
        print(f"portbench: sites at edit step {self.site_step}: {len(edit)}", file=sys.stderr)
        return out


class SiteRecorder:
    """Forward hooks on a UNet's spatial attention modules (`attn1`, `attn2`):
    in the phase set ("invert" or "edit"), at the first UNet forward of
    timestep `t`, each controlled site's input rows, context and output are
    kept on the host, by the module's name."""

    def __init__(self, unet: torch.nn.Module, t: int):
        from fatezero_tpu_torch.models.attention import Attention

        self.t, self.phase, self.current = t, None, False
        self.kept: Dict[str, Dict[str, tuple]] = {"invert": {}, "edit": {}}
        self.handles = [unet.register_forward_pre_hook(self._forward)]
        for name, m in unet.named_modules():
            if isinstance(m, Attention) and name.rsplit(".", 1)[-1] in ("attn1", "attn2"):
                self.handles.append(m.register_forward_hook(
                    lambda mod, args, kwargs, out, name=name: self._keep(name, args, kwargs, out), with_kwargs=True))

    def _forward(self, module, args):
        # the first forward of the drawn timestep in each phase: the inversion's, then the edit's
        self.current = (self.phase is not None and not self.kept[self.phase]
                        and int(torch.as_tensor(args[1]).reshape(-1)[0]) == self.t)

    def _keep(self, name, args, kwargs, out):
        x = args[0]
        if not self.current or x.shape[-2] > MAX_CONTROLLED:
            return
        ctx = args[1] if len(args) > 1 else kwargs.get("context")
        self.kept[self.phase][name] = (x.detach().cpu(), None if ctx is None else ctx.detach().cpu(),
                                       out.detach()[-1:].cpu())

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def _leaves(stored) -> List[torch.Tensor]:
    out = []
    for group in stored.values():
        for lst in group.values():
            for item in lst:
                out.extend(item if isinstance(item, (tuple, list)) else [item])
    return out
