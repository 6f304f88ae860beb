"""SDXL in the port against portbench/reference/sdxl.py, on the CPU in fp32.

The port's SDXL (per-level heads and stack depths, the text-time embedding,
two text towers read at their penultimate layer, the VAE's own scaling
factor) at the random:tiny-xl widths (portbench/tests/tiny_xl.json), every
weight drawn from a seed with fan-in scaling, so that no path is an identity
(FateZero's init zeroes the temporal outputs and the LoRA up projections).
The reference is plain float32 torch written from the published description;
the two differ only in the order of their float32 operations:

* a UNet forward, plain, capturing and editing: 1e-4 relative (the
  port's value-space edit reorders the fused sums; one fp32 forward
  through ~60 products drifts by ~1e-6);
* each tower's context and pooled output: 1e-5 relative (a few layers of
  fp32 products);
* a 2-frame, 2-step replay edit end to end: 1e-3 relative on the decoded
  frames (the guidance scale amplifies each step's epsilon gap by 7.5, and
  the inversion's and the edit's steps compound it through the VAE).
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from fatezero_tpu_torch.models import loader as L
from fatezero_tpu_torch.models.clip import CLIPTextModel
from fatezero_tpu_torch.models.unet3d import REFUSED, UNet3DConfig, UNetPseudo3DConditionModel
from fatezero_tpu_torch.models.vae import AutoencoderKL
from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline, PromptEmbeds
from fatezero_tpu_torch.ptp.context import StoreContext
from fatezero_tpu_torch.ptp.controller import make_controller
from portbench.drivers import common as C
from portbench.reference import sdxl as R
from portbench.reference.edit import rel
from portbench.reference.numerics import FP32

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "portbench", "tests", "tiny_xl.json")) as f:
    CFG = json.load(f)
with open(os.path.join(REPO, "portbench", "configs", "sdxl-teaser.json")) as f:
    SDXL = json.load(f)
MC = CFG["model_config"]
FORWARD_TOL = 1e-4
TOWER_TOL = 1e-5
EDIT_TOL = 1e-3
SRC = "a silver jeep driving down a curvy road"
TGT = "watercolor painting of a silver jeep driving down a curvy road"
P2P = {"is_replace_controller": False, "cross_replace_steps": {"default_": 0.8}, "self_replace_steps": 0.8,
       "eq_params": {"words": ["watercolor"], "values": [10]}}


def _draw(module, seed):
    """Every parameter from N(0, 1/fan_in) (norm gains 1 + N(0, 0.1), biases N(0, 0.02))."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in sorted(module.state_dict().items()):
        shape = tuple(p.shape)
        x = rng.standard_normal(shape).astype(np.float32)
        if len(shape) == 1:
            scale = 0.1 if name.endswith("weight") else 0.02
            out[name] = (1.0 if name.endswith("weight") and "norm" in name else 0.0) + np.float32(scale) * x
        else:
            out[name] = x / np.float32(np.sqrt(np.prod(shape[1:]) if "embedding" not in name else 50.0))
    return out


@pytest.fixture(scope="module")
def xl():
    m = L.load_models("random:tiny-xl", MC, device="cpu")
    W = {}
    for part in ("unet", "vae", "text_encoder", "text_encoder_2"):
        state = _draw(getattr(m, part), seed=len(W) + 3)
        L.load_state(getattr(m, part), state, "cpu")
        W[part] = {k: torch.from_numpy(v) for k, v in state.items()}
    pipe = FateZeroPipeline(m.unet, m.vae, m.text_encoder, m.tokenizer, m.schedule, store_dtype=torch.float32,
                            device="cpu", text_encoder_2=m.text_encoder_2, tokenizer_2=m.tokenizer_2)
    return m, pipe, W


def _reference(xl, steps, p2p=P2P):
    m, _, W = xl
    tok = C.token_ids(m.tokenizer, [SRC, TGT])
    mix = {"steps": steps, "guidance_scale": 7.5, "source": SRC, "target": TGT, "p2p": p2p}
    ref = R.EditReferenceXL(W, CFG, FP32(), mix, {"ids": tok["ids"], "spans": tok["spans"]}, "cpu",
                            m.tokenizer.eos_token_id)
    return ref, tok


def _controller(xl, steps, p2p=P2P):
    return make_controller(xl[0].tokenizer, [SRC, TGT], num_steps=steps,
                           is_replace_controller=p2p["is_replace_controller"],
                           cross_replace_steps=p2p["cross_replace_steps"],
                           self_replace_steps=p2p["self_replace_steps"], eq_params=p2p["eq_params"])


def test_tiny_xl_is_the_reference_configuration():
    got = L.load_models("random:tiny-xl", MC, device="meta")
    assert got.unet.cfg == UNet3DConfig.from_reference({**CFG["unet"], **MC})
    spec = {n: tuple(s) for n, s, _ in R.unet_spec(CFG)}
    assert {k: tuple(v.shape) for k, v in got.unet.state_dict().items()} == spec


@pytest.mark.parametrize("mode", ["plain", "capture", "edit"])
def test_unet_forward_matches_reference(xl, mode):
    m, pipe, _ = xl
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 2, 8, 8, 4, generator=g)
    if mode != "edit":
        ref, _ = _reference(xl, 1)
        ctx, pooled = torch.randn(1, 77, 160, generator=g), torch.randn(1, 40, generator=g)
        time_ids = torch.tensor([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]])
        attn_ctx = StoreContext(save_self_attention=False, store_dtype=torch.float32, self_qk=True) if mode == "capture" else None
        with torch.no_grad():
            got = m.unet(x, 500, ctx, attn_ctx=attn_ctx, added_cond={"text_embeds": pooled, "time_ids": time_ids})
            want = ref.unet.forward(x, 500, ctx, pooled, time_ids)
        if mode == "capture":
            assert len(attn_ctx.captured["mid_cross"]) == 3 and len(attn_ctx.captured_qk["up_self"]) == 3 * 3 + 2 * 3
        assert rel(got, want) <= FORWARD_TOL
        return
    # one edit step: the 3-row forward with every controlled site edited against the source row
    p2p = dict(P2P, cross_replace_steps={"default_": 1.0}, self_replace_steps=1.0)
    ref, tok = _reference(xl, 1, p2p)
    emb = [ref.encode_prompt(ids) for ids in tok["padded"]]
    traj = torch.stack([x, torch.randn(1, 2, 8, 8, 4, generator=g)])
    got, _ = pipe.edit_fast(traj, PromptEmbeds(*emb[0]), PromptEmbeds(*emb[1]), _controller(xl, 1, p2p), 1, 7.5)
    want, eps, c = ref.edit_step(traj[1], 0, traj[0], emb[0], emb[1])
    assert float((got - want).norm()) / abs(c) / float(eps.norm()) <= FORWARD_TOL
    # the control changed the answer by far more than the tolerance
    plain, _, _ = _reference(xl, 1, dict(p2p, cross_replace_steps={"default_": 0.0}, self_replace_steps=0.0))[0].edit_step(
        traj[1], 0, traj[0], emb[0], emb[1])
    assert float((plain - want).norm()) / abs(c) / float(eps.norm()) > 100 * FORWARD_TOL


@pytest.mark.parametrize("tower", ["text_encoder", "text_encoder_2"])
def test_towers_match_reference(xl, tower):
    m, _, W = xl
    ids = torch.as_tensor(np.asarray(m.tokenizer(["", TGT]).input_ids))
    eos = m.tokenizer.eos_token_id
    with torch.no_grad():
        ctx, pooled = getattr(m, tower)(ids, pool=True, eos_token_id=eos)
        ref_ctx, ref_pooled = R.TextTower(W[tower], FP32(), CFG[tower]).forward(ids, eos)
    assert getattr(m, tower).cfg.output_layer == "penultimate"
    assert rel(ctx, ref_ctx) <= TOWER_TOL
    assert rel(pooled, ref_pooled) <= TOWER_TOL


def test_replay_edit_end_to_end_matches_reference(xl):
    _, pipe, _ = xl
    steps = 2
    ref, tok = _reference(xl, steps)
    frames = C.clip(5, 0, 2, 64, "cpu")
    emb_src, emb_tgt = pipe.encode_prompt(SRC), pipe.encode_prompt(TGT)
    ref_src, ref_tgt = (ref.encode_prompt(ids) for ids in tok["padded"])
    assert rel(emb_tgt.context, ref_tgt[0]) <= TOWER_TOL and rel(emb_tgt.pooled, ref_tgt[1]) <= TOWER_TOL
    assert float(emb_src.context[0].abs().max()) == 0.0 and float(emb_src.pooled[0].abs().max()) == 0.0
    lat = pipe.encode_video(frames)
    traj = pipe.invert_fast(lat, emb_src, steps)
    latent, _ = pipe.edit_fast(traj, emb_src, emb_tgt, _controller(xl, steps), steps, 7.5)
    video = pipe.decode_latents(latent)

    x = ref.encode_video(frames)
    assert rel(lat, x) <= FORWARD_TOL
    ref_traj = [x]
    for i in range(steps):
        x = ref.invert_step(x, i, ref_src)[0]
        ref_traj.append(x)
    for i in range(steps):
        x = ref.edit_step(x, i, ref_traj[steps - 1 - i], ref_src, ref_tgt)[0]
    assert rel(traj[-1], ref_traj[-1]) <= EDIT_TOL
    assert rel(latent, x) <= EDIT_TOL
    assert rel(torch.from_numpy(video), ref.decode(x)) <= EDIT_TOL


def test_from_reference_builds_published_sdxl():
    cfg = UNet3DConfig.from_reference({**SDXL["unet"], **SDXL["model_config"]})
    assert cfg.attention_head_dim == (5, 10, 20) and cfg.transformer_layers_per_block == (1, 2, 10)
    unet = UNetPseudo3DConditionModel(cfg, dtype=torch.bfloat16, device="meta")
    depths = [len(unet.down_blocks[i].attentions[0].transformer_blocks) for i in (1, 2)]
    assert depths == [2, 10] and len(unet.mid_block.attentions[0].transformer_blocks) == 10
    heads = [unet.down_blocks[i].attentions[0].transformer_blocks[0].attn1.heads for i in (1, 2)]
    assert heads == [10, 20] and unet.up_blocks[0].attentions[0].transformer_blocks[9].attn2.dim_head == 64
    assert {k: tuple(v.shape) for k, v in unet.state_dict().items()} == {n: tuple(s) for n, s, _ in R.unet_spec(SDXL)}
    for tower, spec in (("text_encoder", R.tower_spec(SDXL["text_encoder"], False)),
                        ("text_encoder_2", R.tower_spec(SDXL["text_encoder_2"], True))):
        model = CLIPTextModel(L.SDXL_TEXT if tower == "text_encoder" else L.SDXL_TEXT_2, device="meta")
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {n: tuple(s) for n, s, _ in spec}
    vae = AutoencoderKL(L.SDXL_VAE, device="meta")
    assert {k: tuple(v.shape) for k, v in vae.state_dict().items()} == {n: tuple(s) for n, s, _ in R.SPECS["vae"](SDXL)}
    assert L.SDXL_VAE.scaling_factor == SDXL["vae"]["scaling_factor"]


SD14_UNET = {"sample_size": 64, "in_channels": 4, "out_channels": 4, "layers_per_block": 2,
             "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
             "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3,
             "block_out_channels": [320, 640, 1280, 1280], "attention_head_dim": 8, "cross_attention_dim": 768,
             "norm_num_groups": 32, "norm_eps": 1e-05, "act_fn": "silu", "center_input_sample": False,
             "downsample_padding": 1, "flip_sin_to_cos": True, "freq_shift": 0, "mid_block_scale_factor": 1}


def test_from_reference_builds_sd1_as_before():
    assert UNet3DConfig.from_reference(SD14_UNET) == UNet3DConfig()


@pytest.mark.parametrize("key,value", [
    ("class_embed_type", "timestep"), ("upcast_attention", True), ("only_cross_attention", True),
    ("only_cross_attention", [False, True, False]), ("dual_cross_attention", True),
    ("resnet_time_scale_shift", "scale_shift"), ("num_attention_heads", 8), ("addition_embed_type", "text"),
    ("addition_embed_type", "image"),
])
def test_from_reference_refuses(key, value):
    assert key in REFUSED
    with pytest.raises(ValueError, match=key):
        UNet3DConfig.from_reference({**SDXL["unet"], key: value})


def _write_tokenizer(path):
    from fatezero_tpu_torch.models.tokenizer import bytes_to_unicode

    os.makedirs(path, exist_ok=True)
    chars = list(bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars] + ["je", "jee", "jeep</w>", "<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\nj e\nje e\njee p</w>\n")


def test_diffusers_folder_with_two_towers_loads_by_name(xl, tmp_path):
    from safetensors.numpy import save_file

    m = xl[0]
    states = {part: {k: v.numpy().copy() for k, v in getattr(m, part).state_dict().items()}
              for part in ("unet", "vae", "text_encoder", "text_encoder_2")}
    states["unet"] = {k: v for k, v in states["unet"].items() if "temporal" not in k and "lora" not in k}
    for part in ("text_encoder", "text_encoder_2"):
        states[part]["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    files = {"unet": "diffusion_pytorch_model", "vae": "diffusion_pytorch_model", "text_encoder": "model",
             "text_encoder_2": "model"}
    for part, state in states.items():
        os.makedirs(tmp_path / part)
        with open(tmp_path / part / "config.json", "w") as f:
            json.dump(CFG[part], f)
        save_file(state, str(tmp_path / part / f"{files[part]}.safetensors"))
    for sub in ("tokenizer", "tokenizer_2"):
        _write_tokenizer(str(tmp_path / sub))

    got = L.load_models(str(tmp_path), MC, device="cpu")
    assert got.text_encoder_2.cfg.hidden_act == "gelu" and got.text_encoder_2.cfg.projection_dim == 40
    assert got.text_encoder.cfg.output_layer == got.text_encoder_2.cfg.output_layer == "penultimate"
    assert got.vae.cfg.scaling_factor == 0.13025
    assert got.tokenizer_2.encode("jeep")[1] == got.tokenizer_2.encoder["jeep</w>"]
    for part, state in states.items():
        own = getattr(got, part).state_dict()
        for k, v in state.items():
            if "position_ids" not in k:
                assert torch.equal(own[k], torch.from_numpy(v)), (part, k)


def test_edit_cli_runs_tiny_xl(tmp_path):
    from fatezero_tpu_torch.cli import edit as cli
    from fatezero_tpu_torch.common.config import load_config

    frames = tmp_path / "frames"
    os.makedirs(frames)
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (80, 96, 3), dtype=np.uint8)).save(str(frames / f"{i:05d}.png"))
    d = load_config(os.path.join(REPO, "config", "demo_tiny.yaml")).to_dict()
    d["dataset_config"].update(path=str(frames), n_sample_frame=2, sampling_rate=1, image_size=64)
    d["editing_config"].update(num_inference_steps=2, clip_length=2)
    d.update(config="demo_tiny_xl.yaml", pretrained_model_path="random:tiny-xl", logdir=str(tmp_path / "out"))
    logdir, videos = cli.test(**d, device="cpu")
    assert len(videos) >= 2 and all(np.isfinite(v).all() and v.shape[-3:] == (64, 64, 3) for v in videos)
    assert os.path.exists(os.path.join(logdir, "phase_timings.json"))
