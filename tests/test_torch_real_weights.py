"""The port's real-checkpoint gate: runs only when SD-1.4 weights exist on disk.

Counterpart of tests/test_real_weights.py, with its four gates and
thresholds, through fatezero_tpu_torch on the card:

    FZ_WEIGHTS=/path/to/sd-1.4 python -m pytest tests/test_torch_real_weights.py -v

where the directory is the diffusers save_pretrained layout (tokenizer/
text_encoder/ vae/ unet/ scheduler/), read by the port's `load_models`.
Optionally FZ_CLIP_WEIGHTS=/path/to/clip-vit-base-patch32 (an HF CLIPModel
folder) for Frame-Acc and Tem-Con with the port's CLIPEvaluator. The frames
are the car-turn clip the JAX gate reads. FZ_REAL_STEPS, FZ_REAL_FRAMES and
FZ_REAL_SIZE cut the run as they do there.

The reconstruction gate is the reference's own correctness check: the first
editing prompt equals the source prompt, so a correct edit path reproduces
the input video (config/teaser/jeep_watercolor.yaml:22-24).
"""
import os

import numpy as np
import pytest
import torch

from test_real_weights import CAR_TURN  # the JAX gate's frames

WEIGHTS = os.environ.get("FZ_WEIGHTS")
CLIP_WEIGHTS = os.environ.get("FZ_CLIP_WEIGHTS")

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        not (WEIGHTS and os.path.isdir(WEIGHTS)),
        reason="FZ_WEIGHTS not set / not a directory (no SD-1.4 weights in the repository)",
    ),
]

SOURCE_PROMPT = "a silver jeep driving down a curvy road in the countryside"
EDIT_PROMPT = "watercolor painting of a silver jeep driving down a curvy road in the countryside"
STEPS = int(os.environ.get("FZ_REAL_STEPS", "50"))
FRAMES = int(os.environ.get("FZ_REAL_FRAMES", "8"))
SIZE = int(os.environ.get("FZ_REAL_SIZE", "512"))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """Peak signal-to-noise ratio in dB over [0, 1] videos."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


@pytest.fixture(scope="module")
def video():
    from fatezero_tpu_torch.data.dataset import ImageSequenceDataset

    ds = ImageSequenceDataset(path=CAR_TURN, prompt=SOURCE_PROMPT, n_sample_frame=FRAMES, sampling_rate=1,
                              image_size=SIZE)
    return np.asarray(ds[0]["images"])  # [f, h, w, 3] in [-1, 1]


@pytest.fixture(scope="module")
def pipe():
    from fatezero_tpu_torch.models.loader import load_models
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline

    if not torch.cuda.is_available():
        pytest.skip("the port's gate runs on a CUDA card")
    # the teaser model config (config/teaser/jeep_watercolor.yaml)
    m = load_models(WEIGHTS, {"SparseCausalAttention_index": ["mid"], "least_sc_channel": 640},
                    dtype=torch.bfloat16, seed=0, device="cuda")
    return FateZeroPipeline(m.unet, m.vae, m.text_encoder, m.tokenizer, m.schedule, device="cuda")


@pytest.fixture(scope="module")
def trajectory(pipe, video):
    emb_src = pipe.encode_prompt(SOURCE_PROMPT)
    latents = pipe.encode_video(torch.from_numpy(video))
    return pipe.invert_fast(latents, emb_src, STEPS), emb_src


def test_vae_roundtrip_psnr(pipe, video):
    """encode->decode alone must be near-lossless (>= ~30 dB for SD's VAE)."""
    recon = pipe.decode_latents(pipe.encode_video(torch.from_numpy(video)))
    val = psnr(recon, video / 2 + 0.5)
    assert val >= 28.0, f"VAE round-trip PSNR {val:.2f} dB < 28"


def test_reconstruction_psnr(pipe, video, trajectory):
    """Invert with the source prompt, re-denoise with the same prompt: the
    output must reconstruct the input video (prompt-0 pattern)."""
    traj, emb_src = trajectory
    latent = pipe.sample(traj[-1], emb_src, num_inference_steps=STEPS, guidance_scale=7.5)
    val = psnr(pipe.decode_latents(latent), video / 2 + 0.5)
    assert val >= 25.0, f"DDIM reconstruction PSNR {val:.2f} dB < 25"


def test_style_edit(pipe, video, trajectory, tmp_path_factory):
    """One watercolor style edit through the fused controller path; output
    finite and of the clip's frames."""
    from fatezero_tpu_torch.common.image_util import save_gif_mp4_folder_type
    from fatezero_tpu_torch.ptp.controller import make_controller

    traj, emb_src = trajectory
    controller = make_controller(
        pipe.tokenizer, [SOURCE_PROMPT, EDIT_PROMPT], num_steps=STEPS, is_replace_controller=False,
        cross_replace_steps=0.8, self_replace_steps=0.8, eq_params={"words": ["watercolor"], "values": [10]},
    )
    latent, _ = pipe.edit_fast(traj, emb_src, pipe.encode_prompt(EDIT_PROMPT), controller, num_inference_steps=STEPS)
    edited = pipe.decode_latents(latent)
    assert np.isfinite(edited).all()
    assert edited.shape[0] == FRAMES
    save_gif_mp4_folder_type(edited, os.path.join(str(tmp_path_factory.mktemp("real_edit")), "edit.gif"))
    test_style_edit.edited = edited  # for the CLIP metric test


def test_clip_metrics(video):
    """Frame-Acc / Tem-Con with the real ViT-B/32 evaluator on the edit."""
    if not (CLIP_WEIGHTS and os.path.isdir(CLIP_WEIGHTS)):
        pytest.skip("FZ_CLIP_WEIGHTS not set (no CLIP ViT-B/32 weights)")
    edited = getattr(test_style_edit, "edited", None)
    if edited is None:
        pytest.skip("style edit did not run")
    from fatezero_tpu_torch.eval.clip_metrics import load_evaluator

    ev = load_evaluator(CLIP_WEIGHTS, device="cuda")
    acc = ev.frame_accuracy(edited, SOURCE_PROMPT, EDIT_PROMPT)
    con = ev.temporal_consistency(edited)
    # the paper's teaser edits land near-1.0 Frame-Acc and >0.9 Tem-Con;
    # a sanity floor, not a benchmark claim
    assert acc >= 0.5, f"Frame-Acc {acc:.3f} < 0.5"
    assert con >= 0.8, f"Tem-Con {con:.3f} < 0.8"
