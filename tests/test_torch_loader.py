"""The port's checkpoint loading against the JAX package's, at tiny width.

Both packages load the same files from tmp_path:

* a diffusers-layout checkpoint: the 2-D Stable-Diffusion keys of the tiny
  model (weights from the JAX package's random:tiny, renamed by
  convert/from_flax.py), as .safetensors and again as .bin, with the
  transformers' proj_in/proj_out as 1x1 convs and the text tower's
  position_ids buffer as SD-1.4 ships them, plus config.json files, a small
  BPE vocab and a scheduler config. The port's state_dicts must equal
  from_flax of the JAX package's params on every key not added by the
  inflation (`temporal`/`lora`; those are random in both, from other
  streams, and only their zero and identity leaves agree), and the UNet's
  output must match JAX's on the same input (5e-5, as tests/test_torch_unet.py:
  the inflation's random leaves feed zero projections);
* keys the JAX package rejects raise in both;
* a flax-native checkpoint written by the JAX package's save_pipeline_checkpoint
  loads with every leaf, inflated ones included, equal to JAX's.

Also the safetensors reader against the safetensors package,
UNet3DConfig.from_reference against JAX's, and a missing path, which warns
and builds random:sd (on the meta device: shapes only).
"""
import dataclasses
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fatezero_tpu.common.checkpoint import save_pipeline_checkpoint
from fatezero_tpu.models.loader import load_models as jload_models
from fatezero_tpu.models.unet3d import UNet3DConfig as JConfig
from fatezero_tpu_torch.common.checkpoint import read_safetensors
from fatezero_tpu_torch.convert.from_flax import clip_text_state_from_flax, unet_state_from_flax, vae_state_from_flax
from fatezero_tpu_torch.models.loader import load_models
from fatezero_tpu_torch.models.tokenizer import bytes_to_unicode
from fatezero_tpu_torch.models.unet3d import UNet3DConfig

torch.set_num_threads(1)
MODEL_CONFIG = {"lora": 16}
SD_UNET_JSON = {
    "_class_name": "UNet2DConditionModel",
    "act_fn": "silu",
    "attention_head_dim": 4,
    "block_out_channels": [32, 64, 128, 128],
    "center_input_sample": False,
    "cross_attention_dim": 32,
    "down_block_types": ["CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"],
    "downsample_padding": 1,
    "flip_sin_to_cos": True,
    "freq_shift": 0,
    "in_channels": 4,
    "layers_per_block": 2,
    "mid_block_scale_factor": 1,
    "norm_eps": 1e-05,
    "norm_num_groups": 8,
    "out_channels": 4,
    "sample_size": 8,
    "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"],
}
VAE_JSON = {"block_out_channels": [16, 32, 32, 32], "latent_channels": 4, "layers_per_block": 2,
            "norm_num_groups": 8, "scaling_factor": 0.18215}
TEXT_JSON = {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
             "vocab_size": 1000, "max_position_embeddings": 77}
SCHEDULER_JSON = {"num_train_timesteps": 1000, "beta_start": 0.001, "beta_end": 0.02,
                  "beta_schedule": "scaled_linear", "set_alpha_to_one": False, "clip_sample": False}
PROMPT = "a jeep on a road"


def _inflated(key):
    return "temporal" in key or "lora" in key


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX package's random:tiny params (lora on) as numpy trees."""
    b = jload_models("random:tiny", MODEL_CONFIG, seed=3)
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return b, host(b.unet_params), host(b.vae_params), host(b.text_params)


def _write_tokenizer(path):
    os.makedirs(path, exist_ok=True)
    chars = list(bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars] + ["je", "jee", "jeep</w>", "<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\nj e\nje e\njee p</w>\n")


def _same_unet_cfg(port_cfg, jax_cfg):
    """The port's UNet config against JAX's: every field of JAX's is the port's,
    with the same value; the port's SDXL-only fields (per-level heads and
    depths, linear projections, the text-time embedding) hold their SD-1
    defaults."""
    port = {f.name: f for f in dataclasses.fields(port_cfg)}
    jax_fields = {f.name for f in dataclasses.fields(jax_cfg)}
    assert jax_fields <= set(port)
    for name, f in port.items():
        want = getattr(jax_cfg, name) if name in jax_fields else f.default
        assert getattr(port_cfg, name) == want, name


def _diffusers_states(jax_tiny):
    """{component: state_dict} with the 2-D keys only, as a diffusers SD checkpoint holds them."""
    _, unet_p, vae_p, text_p = jax_tiny
    unet = {k: v for k, v in unet_state_from_flax(unet_p).items() if not _inflated(k)}
    for k in list(unet):
        if k.endswith((".proj_in.weight", ".proj_out.weight")):
            unet[k] = unet[k][:, :, None, None]  # SD-1.4's 1x1 convs
    text = dict(clip_text_state_from_flax(text_p))
    text["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    return {"unet": unet, "vae": dict(vae_state_from_flax(vae_p)), "text_encoder": text}


WEIGHT_FILE = {
    ("safetensors", "unet"): "diffusion_pytorch_model.safetensors",
    ("safetensors", "vae"): "diffusion_pytorch_model.safetensors",
    ("safetensors", "text_encoder"): "model.safetensors",
    ("bin", "unet"): "diffusion_pytorch_model.bin",
    ("bin", "vae"): "diffusion_pytorch_model.bin",
    ("bin", "text_encoder"): "pytorch_model.bin",
}


def _write_diffusers(path, states, fmt):
    from safetensors.numpy import save_file

    for comp, cfg in (("unet", SD_UNET_JSON), ("vae", VAE_JSON), ("text_encoder", TEXT_JSON)):
        d = os.path.join(path, comp)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cfg, f)
        file = os.path.join(d, WEIGHT_FILE[fmt, comp])
        state = {k: np.ascontiguousarray(v) for k, v in states[comp].items()}
        if fmt == "safetensors":
            save_file(state, file)
        else:
            torch.save({k: torch.from_numpy(v) for k, v in state.items()}, file)
    _write_tokenizer(os.path.join(path, "tokenizer"))
    os.makedirs(os.path.join(path, "scheduler"), exist_ok=True)
    with open(os.path.join(path, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(SCHEDULER_JSON, f)
    return str(path)


def _hold_states(port, jax_bundle):
    """The port's state_dicts against from_flax of the JAX bundle's params:
    every key equal but the inflation's random ones; those share only their zero leaves."""
    pairs = [
        (port.unet, unet_state_from_flax(jax.tree.map(np.asarray, jax_bundle.unet_params))),
        (port.vae, vae_state_from_flax(jax.tree.map(np.asarray, jax_bundle.vae_params))),
        (port.text_encoder, clip_text_state_from_flax(jax.tree.map(np.asarray, jax_bundle.text_params))),
    ]
    n = 0
    for module, ref in pairs:
        own = module.state_dict()
        assert set(own) == set(ref)
        for k, v in own.items():
            if _inflated(k) and ref[k].any():
                continue
            np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
            n += 1
    return n


def _hold_unet_output(port_unet, jax_bundle):
    rng = np.random.RandomState(4)
    x = rng.randn(1, 2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(1, 77, 32).astype(np.float32)
    ref = jax.jit(jax_bundle.unet.apply)(jax_bundle.unet_params, jnp.asarray(x), jnp.int32(500), jnp.asarray(ctx))
    with torch.no_grad():
        out = port_unet(torch.from_numpy(x), 500, torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_diffusers_checkpoint_matches_jax(fmt, jax_tiny, tmp_path):
    path = _write_diffusers(tmp_path, _diffusers_states(jax_tiny), fmt)
    if fmt == "bin":  # JAX reads .bin through torch as well; the port must not need .safetensors
        assert not any(f.endswith(".safetensors") for _, _, fs in os.walk(path) for f in fs)
    jb = jload_models(path, MODEL_CONFIG)
    tb = load_models(path, MODEL_CONFIG, device="cpu")
    assert tb.pretrained and jb.pretrained
    assert _hold_states(tb, jb) > 300
    _same_unet_cfg(tb.unet.cfg, jb.unet.cfg)
    assert tb.unet.cfg.lora == 16 and tb.unet.cfg.sample_size == 8
    np.testing.assert_array_equal(tb.tokenizer(PROMPT).input_ids, jb.tokenizer(PROMPT).input_ids)
    # bos, the merged word, eos: the merges were read
    assert tb.tokenizer.encode("jeep") == jb.tokenizer.encode("jeep") and len(tb.tokenizer.encode("jeep")) == 3
    for field in ("betas", "alphas_cumprod", "final_alpha_cumprod"):
        np.testing.assert_allclose(getattr(tb.schedule, field).numpy(), np.asarray(getattr(jb.schedule, field)),
                                   rtol=1e-6)
    if fmt == "safetensors":  # the same weights load from either file
        _hold_unet_output(tb.unet, jb)


def _new_format_vae(states):
    vae = states["vae"]
    for leaf in ("weight", "bias"):
        vae[f"encoder.mid_block.attentions.0.to_out.0.{leaf}"] = vae.pop(f"encoder.mid_block.attentions.0.proj_attn.{leaf}")


def _missing_2d_key(states):
    del states["unet"]["conv_in.weight"]


def _wrong_shape(states):
    w = states["text_encoder"]["text_model.final_layer_norm.weight"]
    states["text_encoder"]["text_model.final_layer_norm.weight"] = np.concatenate([w, w])


@pytest.mark.parametrize(
    "edit,error",
    [(_new_format_vae, KeyError), (_missing_2d_key, KeyError), (_wrong_shape, ValueError)],
    ids=["vae-to_out.0", "missing-unet-conv_in", "text-shape"],
)
def test_diffusers_strictness_matches_jax(edit, error, jax_tiny, tmp_path):
    """A checkpoint key the model lacks, a 2-D key the checkpoint lacks, or a
    shape mismatch raises in both packages."""
    states = _diffusers_states(jax_tiny)
    edit(states)
    path = _write_diffusers(tmp_path, states, "safetensors")
    with pytest.raises(error):
        jload_models(path, MODEL_CONFIG)
    with pytest.raises(error):
        load_models(path, MODEL_CONFIG, device="cpu")


def test_flax_native_checkpoint_round_trip(jax_tiny, tmp_path):
    """A checkpoint the JAX package writes (tuned-model layout) loads in the
    port with every leaf, inflated ones included, as JAX loads it."""
    b = jax_tiny[0]
    tok = tmp_path / "tok"
    _write_tokenizer(tok / "tokenizer")
    path = save_pipeline_checkpoint(
        str(tmp_path / "ckpt"), b.unet.cfg, b.unet_params, b.vae.cfg, b.vae_params,
        b.text_encoder.cfg, b.text_params, tokenizer_dir=str(tok / "tokenizer"), schedule_cfg=SCHEDULER_JSON,
    )
    jb = jload_models(path, {})
    tb = load_models(path, {}, device="cpu")
    assert tb.pretrained
    for module, ref in ((tb.unet, unet_state_from_flax(jb.unet_params)), (tb.vae, vae_state_from_flax(jb.vae_params)),
                        (tb.text_encoder, clip_text_state_from_flax(jb.text_params))):
        own = module.state_dict()
        assert set(own) == set(ref)
        for k, v in own.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)
    _same_unet_cfg(tb.unet.cfg, jb.unet.cfg)
    np.testing.assert_array_equal(tb.tokenizer(PROMPT).input_ids, jb.tokenizer(PROMPT).input_ids)
    np.testing.assert_allclose(tb.schedule.alphas_cumprod.numpy(), np.asarray(jb.schedule.alphas_cumprod), rtol=1e-6)


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(0)
    arrays = {
        "unet/conv_in/kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
        "half": rng.standard_normal((5, 2)).astype(np.float16),
        "f64": rng.standard_normal(7),
        "ids": rng.integers(-9, 9, (2, 3)).astype(np.int64),
        "i32": rng.integers(-9, 9, (4,)).astype(np.int32),
        "u8": rng.integers(0, 255, (3,)).astype(np.uint8),
        "flags": rng.random(4) > 0.5,
        "scalar": np.array(2.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }
    path = str(tmp_path / "x.safetensors")
    save_file(arrays, path, metadata={"format": "np"})
    got, ref = read_safetensors(path), load_file(path)
    assert set(got) == set(ref) == set(arrays)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)
    # bf16, which numpy cannot hold, reads as its exact fp32 values
    from safetensors.torch import save_file as save_torch

    t = torch.randn(3, 5).to(torch.bfloat16)
    save_torch({"w": t}, path)
    assert torch.equal(torch.from_numpy(read_safetensors(path)["w"]), t.float())


@pytest.mark.parametrize("model_config", [{}, {"lora": 160, "SparseCausalAttention_index": ["mid"],
                                               "least_sc_channel": 640, "temporal_downsample": True}],
                         ids=["sd", "teaser"])
def test_from_reference_matches_jax(model_config):
    cfg = {**SD_UNET_JSON, "block_out_channels": [320, 640, 1280, 1280], "attention_head_dim": 8,
           "cross_attention_dim": 768, "norm_num_groups": 32, "sample_size": 64, **model_config}
    _same_unet_cfg(UNet3DConfig.from_reference(cfg), JConfig.from_reference(cfg))


def test_missing_path_warns_and_builds_random_sd():
    with pytest.warns(UserWarning, match="does not exist"):
        missing = load_models("./ckpt/stable-diffusion-v1-4", {"lora": 160}, device="meta")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sd = load_models("random:sd", {"lora": 160}, device="meta")
    for name in ("unet", "vae", "text_encoder"):
        a, b = getattr(missing, name).state_dict(), getattr(sd, name).state_dict()
        assert {k: tuple(v.shape) for k, v in a.items()} == {k: tuple(v.shape) for k, v in b.items()}, name
        assert all(v.is_meta for v in a.values())
    assert missing.unet.cfg == sd.unet.cfg and missing.unet.cfg.block_out_channels == (320, 640, 1280, 1280)
    assert not missing.pretrained
