"""The write side of the port's checkpoints: convert/to_flax.py and the numpy safetensors writer.

* `from_flax(to_flax(state))` is the identity, bit for bit, on the port's
  random:tiny state_dicts: the UNet with the tuning switches (LoRA temporal
  convs), with the teaser's (LoRA, ['mid'] sparse-causal) and without LoRA
  (plain temporal convs), the VAE and the CLIP text tower; and
  `to_flax(from_flax(tree))` gives back the JAX package's own random:tiny
  trees, every path and every value.
* `write_safetensors` files read bit for bit with `safetensors.numpy.load_file`
  (fp32, fp16, int64 and bf16 written from its uint16 bits, NaN and inf
  included) and with the port's own reader.
* A pipeline checkpoint the port writes loads in the JAX package:
  `load_component_params` gives each component's tree with the JAX model's
  paths and shapes, and `load_models` builds it from the config.json files.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from fatezero_tpu_torch.common.checkpoint import (
    bf16_bits,
    read_safetensors,
    save_pipeline_checkpoint,
    write_safetensors,
)
from fatezero_tpu_torch.convert.from_flax import clip_text_state_from_flax, unet_state_from_flax, vae_state_from_flax
from fatezero_tpu_torch.convert.to_flax import clip_text_state_to_flax, unet_state_to_flax, vae_state_to_flax
from fatezero_tpu_torch.models.loader import load_models, random_state

MODEL_CONFIGS = {
    "tune": {"lora": 160, "gradient_checkpointing": True},
    "teaser": {"lora": 160, "SparseCausalAttention_index": ["mid"], "least_sc_channel": 64},
    "no_lora": {},
}
PAIRS = {
    "unet": (unet_state_to_flax, unet_state_from_flax),
    "vae": (vae_state_to_flax, vae_state_from_flax),
    "text_encoder": (clip_text_state_to_flax, clip_text_state_from_flax),
}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flatten(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


@pytest.mark.parametrize("name", list(MODEL_CONFIGS))
def test_round_trip_is_exact(name):
    m = load_models("random:tiny", MODEL_CONFIGS[name], device="meta")
    for comp, module in (("unet", m.unet), ("vae", m.vae), ("text_encoder", m.text_encoder)):
        to, back = PAIRS[comp]
        state = random_state(module, seed=1)
        tree = to(state)
        assert set(tree) == {"params"}
        again = back(tree)
        assert set(again) == set(state), comp
        for k, v in state.items():
            assert again[k].dtype == v.dtype and np.array_equal(again[k], v), f"{comp} {k}"


@pytest.mark.parametrize("name", ["teaser", "no_lora"])
def test_jax_trees_round_trip(name):
    from fatezero_tpu.models.loader import load_models as jload_models

    b = jload_models("random:tiny", MODEL_CONFIGS[name], seed=0)
    for comp, tree in (("unet", b.unet_params), ("vae", b.vae_params), ("text_encoder", b.text_params)):
        to, back = PAIRS[comp]
        ref = _flatten(jax.tree.map(np.asarray, tree))
        got = _flatten(to(back(jax.tree.map(np.asarray, tree))))
        assert set(got) == set(ref), (comp, sorted(set(ref) ^ set(got))[:5])
        for k, v in ref.items():
            assert np.array_equal(got[k], v), f"{comp} {k}"


def test_writer_reads_bit_for_bit(tmp_path):
    from safetensors.numpy import load_file

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 7)).astype(np.float32)
    x[0, 0, :3] = [np.nan, np.inf, -0.0]
    tensors = {"b/bf16": bf16_bits(x), "f32": x, "f16": x.astype(np.float16), "i64": np.arange(7, dtype=np.int64)}
    path = str(tmp_path / "t.safetensors")
    write_safetensors(path, tensors, bf16={"b/bf16"})
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        assert n % 8 == 0
        header = json.loads(f.read(n))
    assert header["b/bf16"]["dtype"] == "BF16" and header["f32"]["dtype"] == "F32"
    lib = load_file(path)
    assert set(lib) == set(tensors)
    assert np.array_equal(lib["b/bf16"].view(np.uint16), tensors["b/bf16"])
    for k in ("f32", "f16", "i64"):
        assert lib[k].dtype == tensors[k].dtype and lib[k].shape == tensors[k].shape
        assert np.array_equal(lib[k].view(np.uint8), np.ascontiguousarray(tensors[k]).view(np.uint8)), k
    # bf16 bits round to nearest even, as torch rounds
    ref = torch.from_numpy(x).bfloat16().view(torch.int16).numpy().view(np.uint16)
    finite = ~np.isnan(x)
    assert np.array_equal(tensors["b/bf16"][finite], ref[finite])
    ours = read_safetensors(path)
    assert np.array_equal(ours["b/bf16"].view(np.uint32) >> 16, tensors["b/bf16"].astype(np.uint32))
    assert np.array_equal(ours["f32"].view(np.uint32), x.view(np.uint32))


def test_writer_and_loader_keep_0d_tensors(tmp_path):
    """A 0-d tensor (CLIP's logit_scale) keeps its shape through the writer,
    the reader and load_state (np.ascontiguousarray alone makes it 1-d)."""
    from safetensors.numpy import load_file

    from fatezero_tpu_torch.models.loader import load_state

    path = str(tmp_path / "s.safetensors")
    write_safetensors(path, {"logit_scale": np.asarray(2.5, np.float32)})
    assert load_file(path)["logit_scale"].shape == () and read_safetensors(path)["logit_scale"].shape == ()
    module = torch.nn.Module()
    module.logit_scale = torch.nn.Parameter(torch.zeros(()))
    load_state(module, read_safetensors(path), "cpu")
    assert module.logit_scale.shape == () and module.logit_scale.item() == 2.5


def test_jax_reads_the_ports_checkpoint(tmp_path):
    from fatezero_tpu.common.checkpoint import load_component_params
    from fatezero_tpu.models.loader import load_models as jload_models

    model_config = MODEL_CONFIGS["tune"]
    m = load_models("random:tiny", model_config, device="cpu")

    def host(module):
        return {k: v.detach().float().numpy() for k, v in module.state_dict().items()}

    path = save_pipeline_checkpoint(
        str(tmp_path / "ckpt"), m.unet.cfg, unet_state_to_flax(host(m.unet)), m.vae.cfg,
        vae_state_to_flax(host(m.vae)), m.text_encoder.cfg, clip_text_state_to_flax(host(m.text_encoder)),
    )
    assert sorted(os.listdir(path)) == ["scheduler", "text_encoder", "unet", "vae"]
    with open(os.path.join(path, "unet", "config.json")) as f:
        assert json.load(f)["lora"] == 160
    ref = jload_models("random:tiny", model_config, seed=0)
    for comp, tree in (("unet", ref.unet_params), ("vae", ref.vae_params), ("text_encoder", ref.text_params)):
        want = {k: v.shape for k, v in _flatten(jax.tree.map(np.asarray, tree)).items()}
        got = {k: v.shape for k, v in _flatten(load_component_params(os.path.join(path, comp))).items()}
        assert got == want, comp
    b = jload_models(path, {}, seed=0)
    assert dataclasses.asdict(b.unet.cfg) == dataclasses.asdict(ref.unet.cfg)
    got = _flatten(jax.tree.map(np.asarray, b.unet_params))
    for k, v in _flatten(unet_state_to_flax(host(m.unet))).items():
        assert np.array_equal(got[k], v), k
