"""SDXL's edit for the benchmark: drivers/edit.py's unit of work, check and
per-site check, with SDXL's program and reference.

The program is the port's SDXL (per-level heads and transformer stacks, the
text-time add embedding, two text towers, the VAE's own scaling factor),
built on the meta device and given weights made on the card from the seed
by FateZero's init rules (`reference/sdxl.py`'s specs), a salt for each of
the four parts. `FateZeroPipeline.encode_prompt` returns both towers'
`PromptEmbeds`, which the pipeline passes, with the clip's time ids, to
every UNet call. The check holds the program to `reference/sdxl.py`: the
text number is the worst of the two towers' contexts' and the pooled
embeds' gaps.

A configuration with one text tower (no `text_encoder_2`) runs as
drivers/edit.py runs it.
"""
from __future__ import annotations

import sys
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from portbench import weights as PW
from portbench import work, work_xl
from portbench.drivers import common as C
from portbench.drivers import edit as E
from portbench.reference.edit import PooledEpsGap, rel, sample_steps
from portbench.reference.sdxl import SPECS, EditReferenceXL

SALT = {"unet": 1, "vae": 2, "text_encoder": 3, "text_encoder_2": 4}
PARTS = tuple(SALT)


def make(cfg: dict, part: str, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """weights.make's rules over reference/sdxl.py's specs: every N(0, 0.02)
    leaf of a part from one draw into one flat buffer, then its zero, one and
    dirac leaves."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7919 + SALT[part]) % (2 ** 63))
    spec = SPECS[part](cfg)
    normal = [(n, s) for n, s, rule in spec if rule == "normal"]
    flat = torch.randn(sum(PW._numel(s) for _, s in normal), generator=g, device=device, dtype=dtype)
    flat.mul_(PW.STD)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape in normal:
        k = PW._numel(shape)
        out[name] = flat[offset:offset + k].view(shape)
        offset += k
    for name, shape, rule in spec:
        if rule == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif rule == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        elif rule == "dirac":
            w = torch.zeros(shape, device=device, dtype=dtype)
            w[:, :, shape[2] // 2] = torch.eye(shape[0], shape[1], device=device, dtype=dtype)
            out[name] = w
    return out


def build_program(cfg: dict, seed: int, device) -> SimpleNamespace:
    """The program's SDXL modules, built without storage and given the weights `make` draws."""
    from fatezero_tpu_torch.models.clip import CLIPTextModel
    from fatezero_tpu_torch.models.loader import text_config
    from fatezero_tpu_torch.models.tokenizer import StubTokenizer
    from fatezero_tpu_torch.models.unet3d import UNet3DConfig, UNetPseudo3DConditionModel
    from fatezero_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from fatezero_tpu_torch.ops import schedule as S

    dtype = C.dtype_of(cfg, device)
    v = cfg["vae"]
    ctors = {
        "unet": lambda: UNetPseudo3DConditionModel(
            UNet3DConfig.from_reference({**cfg["unet"], **cfg.get("model_config", {})}), dtype=dtype, device="meta"),
        "vae": lambda: AutoencoderKL(VAEConfig(
            in_channels=v["in_channels"], out_channels=v["out_channels"], latent_channels=v["latent_channels"],
            block_out_channels=tuple(v["block_out_channels"]), layers_per_block=v["layers_per_block"],
            norm_num_groups=v["norm_num_groups"], scaling_factor=v["scaling_factor"]), dtype=dtype, device="meta"),
        # both towers read at their penultimate layer, the second pooled and projected (SDXL's rule)
        "text_encoder": lambda: CLIPTextModel(text_config(cfg["text_encoder"], "penultimate"), dtype=dtype,
                                              device="meta"),
        "text_encoder_2": lambda: CLIPTextModel(text_config(cfg["text_encoder_2"], "penultimate", True),
                                                dtype=dtype, device="meta"),
    }
    out = SimpleNamespace(dtype=dtype, tokenizer=StubTokenizer(vocab_size=cfg["text_encoder"]["vocab_size"]),
                          tokenizer_2=StubTokenizer(vocab_size=cfg["text_encoder_2"]["vocab_size"]),
                          schedule=S.make_schedule(device=device))
    for part in PARTS:
        module = ctors[part]()
        PW.load_into(module, make(cfg, part, seed, device, dtype))
        setattr(out, part, module.eval())
    return out


class Driver(E.Driver):
    def __new__(cls, cfg: dict, mix: dict, seed: int, device):
        if "text_encoder_2" not in cfg:
            return E.Driver(cfg, mix, seed, device)
        return super().__new__(cls)

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        from fatezero_tpu_torch.ops import schedule as S
        from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline

        m = build_program(self.cfg, self.seed, self.device)  # first: a program without SDXL fails here, at once
        if self.device.type == "cuda":
            from fatezero_tpu_torch import csrc

            csrc.build_all(tuple(self.mix["kernels"]))
        self.tok = m.tokenizer
        self.pipe = FateZeroPipeline(m.unet, m.vae, m.text_encoder, m.tokenizer, schedule=m.schedule,
                                     store_dtype=m.dtype, device=self.device, text_encoder_2=m.text_encoder_2,
                                     tokenizer_2=m.tokenizer_2)
        self.ids = C.token_ids(self.tok, [self.mix["source"], self.mix["target"]])
        self.ids_2 = C.token_ids(m.tokenizer_2, [self.mix["source"], self.mix["target"]])
        self.eos = m.tokenizer_2.eos_token_id
        self.pipe.unet.register_forward_pre_hook(self._record, with_kwargs=True)
        tok = {"ids": self.ids["ids"], "spans": self.ids["spans"]}
        p2p = E.P2P([self.mix["source"], self.mix["target"]], tok, self.mix["p2p"], self.steps, "cpu")
        edited = [i for i in range(self.steps) if p2p.self_gate(i) and float(p2p.alpha_words[i].max()) > 0]
        self.site_step = int(np.random.default_rng([self.seed, 11]).choice(edited or list(range(self.steps))))
        self.sites = E.SiteRecorder(self.pipe.unet, int(S.ddim_timesteps(m.schedule, self.steps)[self.site_step]))
        import time

        t0 = time.perf_counter()
        self.unit(-1)  # the warm edit: every shape and kernel of the window
        self.warm_s = time.perf_counter() - t0
        self.sites.remove()
        self.records.clear()

    # ----------------------------------------------------------- trace data
    def trace_data(self) -> Dict:
        """What the per-layer readers of an edit need besides the trace: one
        inversion row and two edit rows a step, as drivers/edit.py counts."""
        b, f, h = 1, self.frames, self.res // 8
        inv, edit = work_xl.unet_ops(self.cfg, b, f, h, h), work_xl.unet_ops(self.cfg, 2, f, h, h)
        model = (2 * work.flops(work_xl.text_ops(self.cfg, 2))
                 + work.flops(work.vae_encode_ops(self.cfg, f, self.res, self.res))
                 + self.steps * (work.flops(inv) + work.flops(edit)) + work.flops(work.vae_decode_ops(self.cfg, f, h, h)))
        attn = [(o.flops, o.nbytes) for o in inv + edit if o.attn]
        from portbench.roofline import total_bound_s

        return {"flops_per_unit": model, "attn_bound_s": self.steps * total_bound_s(attn)}

    # ---------------------------------------------------------------- check
    def check(self, control=None) -> Dict[str, Dict[str, float]]:
        """drivers/edit.py's check against reference/sdxl.py."""
        from portbench.reference import numerics

        numerics.strict_fp32()
        dev = self.device
        dtype = C.dtype_of(self.cfg, dev)
        W = {p: {k: w.float() for k, w in make(self.cfg, p, self.seed, dev, dtype).items()} for p in PARTS}
        tok = {"ids": self.ids["ids"], "spans": self.ids["spans"]}
        ref = EditReferenceXL(W, self.cfg, numerics.FP32(), self.mix, tok, dev, self.eos)
        ctl = None if control is None else EditReferenceXL(W, self.cfg, control, self.mix, tok, dev, self.eos)
        out = {"program": {}} if ctl is None else {"program": {}, "control": {}}

        def note(side, key, value):
            out[side][key] = max(out[side].get(key, 0.0), value)

        c1 = self.cfg["text_encoder"]["hidden_size"]

        def text_gap(got, want):
            """The worst of each tower's context and the pooled embeds, each held on its own."""
            return max(rel(got[0][..., :c1], want[0][..., :c1]), rel(got[0][..., c1:], want[0][..., c1:]),
                       rel(got[1], want[1]))

        prompts = list(zip(self.ids["padded"], self.ids_2["padded"]))
        emb_ref = [ref.encode_prompt(a, b) for a, b in prompts]
        for i, e in enumerate(self.records[0]["emb"]):
            note("program", "text", text_gap((e.context.to(dev), e.pooled.to(dev)), emb_ref[i]))
            if ctl is not None:
                note("control", "text", text_gap(ctl.encode_prompt(*prompts[i]), emb_ref[i]))
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
