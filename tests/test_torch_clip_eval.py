"""The port's evaluation path (models/clip.py's dual tower, eval/clip_metrics.py,
cli/evaluate.py) against the JAX package's, on the CPU.

The packages draw random weights from different streams, so every parity
case carries the JAX params across with convert/from_flax.py's
clip_full_state_from_flax:

* CLIPModel logits at a tiny config (hidden 32, 2 layers, image 32, patch
  16, projection 16) within ATOL_LOGITS (PARITY.md's CLIP tolerance);
* clip_full_state_from_flax is the exact inverse of convert_clip_full_state;
* preprocess_frames (antialiased bicubic) within ATOL_PIXELS at 512²->224,
  64²->224 and 512x640, float and uint8;
* the full ViT-B/32 evaluator (JAX's load_evaluator(None, seed=0), carried
  across): image and text features within ATOL_FEATURES, Tem-Con within
  ATOL_TEMCON, and Frame-Acc per frame wherever the frame's logit gap
  (target minus source, at the reference's scale of 100) clears BAND;
* folder_success, evaluate.run on the shipped reference-schema bench,
  normalize_bench on both schemas, and an HF-named checkpoint folder (the
  port's safetensors writer, HF's position_ids buffers, a vocab.json
  tokenizer) loaded strictly by load_evaluator.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fatezero_tpu.cli import evaluate as jevaluate
from fatezero_tpu.convert.torch_to_flax import convert_clip_full_state
from fatezero_tpu.eval import clip_metrics as JM
from fatezero_tpu.models.clip import CLIPModel as JCLIPModel
from fatezero_tpu.models.clip import CLIPTextConfig as JTextConfig
from fatezero_tpu.models.clip import CLIPVisionConfig as JVisionConfig
from fatezero_tpu_torch.cli import evaluate
from fatezero_tpu_torch.common.checkpoint import write_safetensors
from fatezero_tpu_torch.convert.from_flax import clip_full_state_from_flax
from fatezero_tpu_torch.eval import clip_metrics as M
from fatezero_tpu_torch.models.clip import (
    CLIPModel,
    CLIPTextConfig,
    CLIPTextModel,
    CLIPVisionConfig,
    CLIPVisionModel,
)
from fatezero_tpu_torch.models.loader import clip_model_state, load_state

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "config", "bench_clean_prompt.yaml")
# fp32 on both sides; sums in other orders through two 2-layer towers
ATOL_LOGITS = 2e-4
# one antialiased bicubic resize in fp32, then a division by CLIP_STD (~0.27):
# the filter sums' rounding, ~2e-6 at 512² and ~1e-5 at the 64² upsampling
ATOL_PIXELS = 1e-5
# unit-norm 512-d embeddings (entries ~0.04) after 12 fp32 layers: they
# differ by ~2e-7 here
ATOL_FEATURES = 1e-5
ATOL_TEMCON = 1e-5
# a gap of logits at scale 100 moves by at most 200x the features' error
# (|dot(a+da, b+db) - dot(a, b)| <= |da| + |db| for unit vectors, over 512
# entries of <= ATOL_FEATURES each); frames closer than that to the tie are
# not compared
BAND = 200 * 2 * 512**0.5 * ATOL_FEATURES
SOURCE = "a silver jeep driving down a curvy road in the countryside"
TARGET = "watercolor painting of a silver jeep driving down a curvy road in the countryside"

TINY_TEXT = dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, projection_dim=16)
TINY_VISION = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, image_size=32, patch_size=16,
                   projection_dim=16)


def _tiny_flax():
    """A flax param tree for the tiny JAX CLIPModel: N(0, 0.1) everywhere,
    norm gains around one, the logit scale at its init log(1/0.07)."""
    import jax

    model = JCLIPModel(text_cfg=JTextConfig(**TINY_TEXT), vision_cfg=JVisionConfig(**TINY_VISION))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 6), jnp.int32))
    rng = np.random.RandomState(0)

    def fill(path, s):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith("logit_scale"):
            return np.asarray(np.log(1 / 0.07), np.float32)
        base = 1.0 if ("norm" in name and name.endswith("scale")) else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def _frames(n, h, w, seed):
    return np.random.default_rng(seed).random((n, h, w, 3), dtype=np.float32)


def _assert_same_tree(a, b, path=""):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b))[:5])
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=f"{path}/{k}")


def test_clip_model_logits_match_jax():
    jmodel, params = _tiny_flax()
    model = load_state(CLIPModel(CLIPTextConfig(**TINY_TEXT), CLIPVisionConfig(**TINY_VISION), device="meta"),
                       clip_full_state_from_flax(params), "cpu")
    pixels = _frames(2, 32, 32, 1) * 2 - 1
    ids = np.array([[5, 17, 99, 3, 0, 0], [8, 2, 99, 0, 0, 0]], np.int32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(pixels), jnp.asarray(ids)))
    with torch.no_grad():
        got = model(torch.from_numpy(pixels), torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_LOGITS, rtol=ATOL_LOGITS)
    # the towers alone, each against its JAX method
    with torch.no_grad():
        txt = model.encode_text(torch.from_numpy(ids).long()).numpy()
        img = model.encode_image(torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(txt, np.asarray(jmodel.apply(params, jnp.asarray(ids), method="encode_text")),
                               atol=ATOL_LOGITS)
    np.testing.assert_allclose(img, np.asarray(jmodel.apply(params, jnp.asarray(pixels), method="encode_image")),
                               atol=ATOL_LOGITS)
    # the single towers, CLIPVisionModel and the projected CLIPTextModel, on
    # their share of the same state_dict
    state = clip_full_state_from_flax(params)
    vision = load_state(CLIPVisionModel(CLIPVisionConfig(**TINY_VISION), device="meta"),
                        {k: v for k, v in state.items() if k.startswith(("vision_model.", "visual_projection."))}, "cpu")
    text = load_state(CLIPTextModel(CLIPTextConfig(**TINY_TEXT), device="meta"),
                      {k: v for k, v in state.items() if k.startswith(("text_model.", "text_projection."))}, "cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(vision(torch.from_numpy(pixels)).numpy(), img)
        hidden, pooled = text(torch.from_numpy(ids).long(), pool=True)
    np.testing.assert_array_equal(pooled.numpy(), txt)
    assert hidden.shape == (2, 6, 32)


def test_clip_full_round_trip():
    _, params = _tiny_flax()
    state = clip_full_state_from_flax(params)
    _assert_same_tree(params["params"], convert_clip_full_state(state))
    own = CLIPModel(CLIPTextConfig(**TINY_TEXT), CLIPVisionConfig(**TINY_VISION), device="meta").state_dict()
    assert set(state) == set(own)


def test_hf_clip_state_loads_strictly_and_matches_hf(tmp_path):
    """A transformers CLIPModel's own state_dict, written with the port's
    safetensors writer (HF names, position_ids buffers and all), loads into
    the port's CLIPModel strictly and gives HF's logits."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPConfig(
        text_config_dict=dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=2, max_position_embeddings=77, eos_token_id=99),
        vision_config_dict=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
                                image_size=32, patch_size=16),
        projection_dim=16,
    )
    torch.manual_seed(0)
    hf = transformers.CLIPModel(cfg).eval()
    write_safetensors(str(tmp_path / "model.safetensors"), {k: v.numpy() for k, v in hf.state_dict().items()})
    model = load_state(CLIPModel(CLIPTextConfig(**TINY_TEXT), CLIPVisionConfig(**TINY_VISION), device="meta"),
                       clip_model_state(str(tmp_path)), "cpu")
    pixels = _frames(2, 32, 32, 2)
    ids = np.array([[5, 17, 99, 3, 0, 0], [8, 2, 99, 0, 0, 0]], np.int64)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), pixel_values=torch.from_numpy(pixels).permute(0, 3, 1, 2))
        got = model(torch.from_numpy(pixels), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want.logits_per_image.numpy(), atol=ATOL_LOGITS, rtol=ATOL_LOGITS)


@pytest.mark.parametrize("hw", [(512, 512), (64, 64), (512, 640)], ids=["512", "64", "512x640"])
@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_preprocess_frames_matches_jax(hw, kind):
    video = _frames(2, *hw, seed=3)
    if kind == "uint8":
        video = (video * 255).astype(np.uint8)
    want = np.asarray(JM.preprocess_frames(video))
    got = M.preprocess_frames(video, device="cpu").numpy()
    assert got.shape == want.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=ATOL_PIXELS)


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory):
    """JAX's random ViT-B/32 evaluator and the port's with the same weights,
    both with one BPE tokenizer (a vocab.json and merges.txt for the tests'
    prompts): the default StubTokenizer's ids follow Python's salted `hash`,
    so its logit gaps, and whether they clear BAND, would move from process
    to process; with real CLIP tokens the EOT id is the highest and pools."""
    from chip_smoke import write_tokenizer
    from fatezero_tpu.models.tokenizer import CLIPTokenizer as JCLIPTokenizer
    from fatezero_tpu_torch.models.tokenizer import CLIPTokenizer

    with pytest.warns(UserWarning, match="RANDOM weights"):
        jev = JM.load_evaluator(None, seed=0)
    tokdir = str(tmp_path_factory.mktemp("tokenizer"))
    write_tokenizer(tokdir, f"{SOURCE} {TARGET} a cat a dog")
    jev.tokenizer = JCLIPTokenizer.from_pretrained(tokdir, subfolder="")
    state = clip_full_state_from_flax(jev.params)
    model = load_state(CLIPModel(device="meta"), state, "cpu").eval()
    ev = M.CLIPEvaluator(model, CLIPTokenizer.from_pretrained(tokdir, subfolder=""), random_weights=True)
    return jev, ev, state


def _gaps(img, txt):
    """Per-frame logit gap, target minus source, at the reference's scale."""
    logits = 100.0 * np.asarray(img) @ np.asarray(txt).T
    return logits[:, 1] - logits[:, 0]


def test_vit_b32_evaluator_matches_jax(evaluators):
    jev, ev, _ = evaluators
    video = _frames(6, 64, 80, seed=4)
    jimg, img = np.asarray(jev.image_features(video)), ev.image_features(video).numpy()
    np.testing.assert_allclose(img, jimg, atol=ATOL_FEATURES)
    jtxt, txt = np.asarray(jev.text_features([SOURCE, TARGET])), ev.text_features([SOURCE, TARGET]).numpy()
    np.testing.assert_allclose(txt, jtxt, atol=ATOL_FEATURES)
    assert jev.temporal_consistency(video) == pytest.approx(ev.temporal_consistency(video), abs=ATOL_TEMCON)

    jgap, gap = _gaps(jimg, jtxt), _gaps(img, txt)
    clear = np.abs(jgap) > BAND
    assert clear.sum() >= 1, f"every frame lies within {BAND} of the tie: {jgap}"
    np.testing.assert_array_equal(gap[clear] >= 0, jgap[clear] >= 0)
    # frame_accuracy is the share of frames whose gap is >= 0, in each package
    acc, jacc = ev.frame_accuracy(video, SOURCE, TARGET), jev.frame_accuracy(video, SOURCE, TARGET)
    assert acc == pytest.approx(float(np.mean(gap >= 0))) and jacc == pytest.approx(float(np.mean(jgap >= 0)))
    if clear.all():
        assert acc == jacc


def _write_folder(d, n, hw, seed):
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(d / f"{i:05d}.png")
    return d


def test_folder_success_matches_jax(evaluators, tmp_path):
    jev, ev, _ = evaluators
    d = _write_folder(tmp_path / "frames", 3, (48, 64), seed=5)
    acc, con = ev.folder_success(str(d), "a cat", "a dog")
    jacc, jcon = jev.folder_success(str(d), "a cat", "a dog")
    assert con == pytest.approx(jcon, abs=ATOL_TEMCON)
    frames = np.stack([np.asarray(Image.open(d / f)) for f in sorted(os.listdir(d))]).astype(np.float32) / 255.0
    jgap = _gaps(jev.image_features(frames), jev.text_features(["a cat", "a dog"]))
    assert (np.abs(jgap) > BAND).all(), f"a frame lies within {BAND} of the tie: {jgap}"
    assert acc == jacc
    assert 0.0 <= acc <= 1.0 and -1.0 <= con <= 1.0


def test_evaluate_run_reference_schema(tmp_path):
    """evaluate.run consumes the shipped bench_clean_prompt.yaml (the
    reference's {name: {path, source, target}} schema) against a results
    tree keyed by name, as the JAX CLI's own test does."""
    for i, name in enumerate(("swan_cartoon", "car_watercolor")):
        _write_folder(tmp_path / name, 3, (48, 48), seed=i)
    with pytest.warns(UserWarning):  # random CLIP + missing folders, loudly
        out = evaluate.run(BENCH, results_root=str(tmp_path), device="cpu")
    names = [it["folder"] for it in jevaluate.normalize_bench(jevaluate.load_config(BENCH).to_dict())]
    assert out["n"] == 2
    assert set(out["per_item"]) == {"swan_cartoon", "car_watercolor"}
    assert out["missing"] == [n for n in names if n not in ("swan_cartoon", "car_watercolor")]
    assert np.isfinite(out["frame_acc"]) and np.isfinite(out["tem_con"])
    assert out["random_weights"] is True


def test_normalize_bench_both_schemas():
    items = evaluate.normalize_bench({"items": [{"folder": "a", "source_prompt": "s", "target_prompt": "t"}]})
    assert items[0]["folder"] == "a"
    items = evaluate.normalize_bench({"results_root": "r", "vid": {"path": "x", "source": "s", "target": "t,"}})
    assert items == [{"folder": "vid", "source_prompt": "s", "target_prompt": "t,"}]
    with pytest.raises(ValueError):
        evaluate.normalize_bench({"results_root": "r"})
    # the shipped bench, trailing commas verbatim, as the JAX CLI reads it
    cfg = evaluate.load_config(BENCH).to_dict()
    assert evaluate.normalize_bench(cfg) == jevaluate.normalize_bench(jevaluate.load_config(BENCH).to_dict())
    assert any(it["target_prompt"].endswith(",") for it in evaluate.normalize_bench(cfg))


def test_load_evaluator_from_hf_folder(evaluators, tmp_path):
    """An HF CLIPModel folder (HF names with the position_ids buffers, a
    vocab.json tokenizer) loads strictly; the weights are exactly the ones
    written, and the folder's tokenizer is used."""
    from chip_smoke import write_tokenizer

    _, ev, state = evaluators
    hf = dict(state)
    hf["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    hf["vision_model.embeddings.position_ids"] = np.arange(50, dtype=np.int64)[None]
    write_safetensors(str(tmp_path / "model.safetensors"), hf)
    write_tokenizer(str(tmp_path), f"{SOURCE} {TARGET}")
    loaded = M.load_evaluator(str(tmp_path), device="cpu")
    assert loaded.random_weights is False
    assert type(loaded.tokenizer).__name__ == "CLIPTokenizer"
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, ev.model.state_dict()[k]), k
    # a key the port's CLIPModel does not have is refused (strict)
    hf["vision_model.extra.weight"] = np.zeros(3, np.float32)
    write_safetensors(str(tmp_path / "model.safetensors"), hf)
    with pytest.raises(KeyError, match="unexpected"):
        M.load_evaluator(str(tmp_path), device="cpu")
