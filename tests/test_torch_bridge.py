"""The weight bridge and the port's packaging.

* flax -> convert/from_flax.py -> the JAX package's torch_to_flax converters
  -> flax gives back the original tree exactly (UNet with and without the
  teaser switches, VAE, CLIP text), and each state_dict loads strictly into
  the port's module.
* `import fatezero_tpu_torch` (every module) succeeds with jax unavailable.
* the random:tiny builder follows the JAX package's init rules.
"""
import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fatezero_tpu.convert import torch_to_flax as T2F
from fatezero_tpu.models.clip import CLIPTextConfig as JTextConfig
from fatezero_tpu.models.clip import CLIPTextModel as JText
from fatezero_tpu.models.unet3d import UNet3DConfig as JConfig
from fatezero_tpu.models.unet3d import UNetPseudo3DConditionModel as JUNet
from fatezero_tpu.models.vae import AutoencoderKL as JVAE
from fatezero_tpu.models.vae import VAEConfig as JVAEConfig
from fatezero_tpu_torch.convert import from_flax as FF
from fatezero_tpu_torch.models.clip import CLIPTextModel
from fatezero_tpu_torch.models.loader import TINY_TEXT, TINY_VAE, load_models, load_state
from fatezero_tpu_torch.models.unet3d import UNet3DConfig, UNetPseudo3DConditionModel
from fatezero_tpu_torch.models.vae import AutoencoderKL

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(block_out_channels=(32, 64, 128, 128), attention_head_dim=4, cross_attention_dim=16, norm_num_groups=8)


def _random_flax(model, *args):
    """A flax param tree (numpy leaves, distinct values) for `model`."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(0)
    return jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


def _assert_same_tree(a, b, path=""):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b))[:5])
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=f"{path}/{k}")


@pytest.mark.parametrize(
    "switches", [{}, dict(lora=160, sparse_causal_indices=("mid",), least_sc_channel=64)], ids=["tiny", "teaser"]
)
def test_unet_round_trip(switches):
    cfg = {**TINY, **switches}
    params = _random_flax(JUNet(cfg=JConfig(**cfg)), jnp.zeros((1, 2, 16, 16, 4)), jnp.int32(1), jnp.zeros((1, 77, 16)))
    state = FF.unet_state_from_flax(params)
    _assert_same_tree(params["params"], T2F.convert_unet_state(state))
    load_state(UNetPseudo3DConditionModel(UNet3DConfig(**cfg), device="meta"), state, "cpu")


def test_vae_round_trip():
    jcfg = JVAEConfig(block_out_channels=TINY_VAE.block_out_channels, norm_num_groups=8)
    params = _random_flax(JVAE(cfg=jcfg), jnp.zeros((1, 32, 32, 3)))
    state = FF.vae_state_from_flax(params)
    _assert_same_tree(params["params"], T2F.convert_vae_state(state))
    load_state(AutoencoderKL(TINY_VAE, device="meta"), state, "cpu")


def test_clip_text_round_trip():
    jcfg = JTextConfig(**{k: getattr(TINY_TEXT, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads")})
    params = _random_flax(JText(cfg=jcfg), jnp.zeros((1, 77), jnp.int32))
    state = FF.clip_text_state_from_flax(params)
    _assert_same_tree(params["params"], T2F.convert_clip_text_state(state))
    load_state(CLIPTextModel(TINY_TEXT, device="meta"), state, "cpu")


def test_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
        "import pkgutil, importlib, fatezero_tpu_torch\n"
        "for m in pkgutil.walk_packages(fatezero_tpu_torch.__path__, 'fatezero_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'fatezero_tpu.')) for k in sys.modules if sys.modules[k] is not None)\n"
        "assert {'fatezero_tpu_torch.ops.flash_variants', 'fatezero_tpu_torch.scripts.bench_flash_variants',\n"
        "        'fatezero_tpu_torch.scripts.bench_kernel_boundary', 'fatezero_tpu_torch.ptp.spatial_blend',\n"
        "        'fatezero_tpu_torch.cli.edit', 'fatezero_tpu_torch.pipelines.p2p_validation_loop',\n"
        "        'fatezero_tpu_torch.common.config', 'fatezero_tpu_torch.common.checkpoint',\n"
        "        'fatezero_tpu_torch.cli.train', 'fatezero_tpu_torch.pipelines.validation_loop',\n"
        "        'fatezero_tpu_torch.ptp.store', 'fatezero_tpu_torch.convert.to_flax',\n"
        "        'fatezero_tpu_torch.trainer.adafactor', 'fatezero_tpu_torch.eval.clip_metrics',\n"
        "        'fatezero_tpu_torch.cli.evaluate', 'fatezero_tpu_torch.cli.dataset_sweep',\n"
        "        'fatezero_tpu_torch.native', 'fatezero_tpu_torch.parallel.sharding',\n"
        "        'fatezero_tpu_torch.scripts.dryrun_mesh', 'fatezero_tpu_torch.scripts.check_install',\n"
        "        'fatezero_tpu_torch.common.logdir', 'fatezero_tpu_torch.trainer.ddpm_trainer',\n"
        "        'fatezero_tpu_torch.ops.video_ops', 'fatezero_tpu_torch.models.attention',\n"
        "        'fatezero_tpu_torch.models.layers', 'fatezero_tpu_torch.models.unet3d',\n"
        "        'fatezero_tpu_torch.scripts.bench'} <= set(sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_import_of_jax_anywhere_in_the_port():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX
    package, inside a function either (the import check above sees only what
    runs at import time)."""
    paths = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "scripts", "ab_flash_kernels.py")]
    for root, _, files in os.walk(os.path.join(REPO, "fatezero_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    bad = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [(path, n) for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "fatezero_tpu")]
    assert os.path.join(REPO, "fatezero_tpu_torch", "parallel", "sharding.py") in paths
    assert os.path.join(REPO, "fatezero_tpu_torch", "scripts", "bench.py") in paths
    assert len(paths) > 30 and not bad, bad


def test_random_tiny_follows_init_rules():
    m = load_models("random:tiny", {"lora": 160, "SparseCausalAttention_index": ["mid"]}, seed=0, device="cpu")
    again = load_models("random:tiny", {"lora": 160, "SparseCausalAttention_index": ["mid"]}, seed=0, device="cpu")
    state, state2 = m.unet.state_dict(), again.unet.state_dict()
    for k, v in state.items():
        torch.testing.assert_close(v, state2[k], atol=0, rtol=0)
        if "attn_temporal.to_out" in k or k.endswith("conv_temporal.up.weight") or k.endswith("bias"):
            assert not v.any(), k
        elif k.endswith(("norm1.weight", "norm2.weight", "norm3.weight", "norm_temporal.weight", "conv_norm_out.weight")):
            assert torch.all(v == 1), k
    assert state["conv_in.conv_temporal.down.weight"].std() == pytest.approx(0.02, rel=0.2)
    assert m.unet.cfg.sparse_causal_indices == ("mid",) and m.unet.cfg.lora == 160
    full = load_models("random:tiny", {}, seed=0, device="cpu").unet.state_dict()["conv_in.conv_temporal.weight"]
    eye = torch.eye(full.shape[0])
    torch.testing.assert_close(full[:, :, 1], eye, atol=0, rtol=0)
    assert not full[:, :, 0].any() and not full[:, :, 2].any()


def test_entry_points_default_to_cuda():
    """The port runs on the card unless the caller asks for the CPU."""
    import inspect

    from fatezero_tpu_torch.cli.edit import test as edit_test
    from fatezero_tpu_torch.cli.train import train
    from fatezero_tpu_torch.models.loader import _load_flax_native, _load_pretrained
    from fatezero_tpu_torch.ops.schedule import make_schedule
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
    from fatezero_tpu_torch.scripts import bench

    for fn in (load_models, FateZeroPipeline.__init__, make_schedule, edit_test, train, _load_pretrained,
               _load_flax_native, bench.main, bench.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__


def test_load_state_copies():
    """Training updates parameters in place: the loaded module must not share
    storage with the caller's arrays."""
    model = torch.nn.Linear(3, 2)
    state = {k: np.zeros(tuple(v.shape), np.float32) for k, v in model.state_dict().items()}
    load_state(model, state, "cpu")
    with torch.no_grad():
        model.weight.add_(1.0)
    assert not state["weight"].any()
