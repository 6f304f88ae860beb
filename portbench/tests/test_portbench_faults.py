"""The check fails a broken program: the harness runs whole at the tiny size on the
CPU (no look for a chip), with the timed path broken underneath, under each
cell's own limits. The float8 control, judged in the program's place by the
same comparison, fails them too."""
import pytest
import torch

from portbench import run as R
from portbench.reference.numerics import FP8
from portbench.tests import tiny as T

EDIT_CELLS = ["teaser-stored", "teaser-replay"]


def _run(tiny, cell, control=None):
    return R.run(cell, T.SEED + 1, 0.2, False, device="cpu", limits=T.limits(cell), control=control, **tiny)


def _step_unchanged(monkeypatch):
    from fatezero_tpu_torch.ops import schedule as S

    monkeypatch.setattr(S, "ddim_denoise_step", lambda schedule, eps, t, sample, steps: sample)


def _half_the_frames(monkeypatch):
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline

    encode = FateZeroPipeline.encode_video

    def half(self, images, generator=None):
        n = images.shape[0] // 2
        return encode(self, torch.cat([images[:n], images[:n]]), generator)

    monkeypatch.setattr(FateZeroPipeline, "encode_video", half)


def _answer_altered(monkeypatch):
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline

    decode = FateZeroPipeline.decode_latents

    def altered(self, latents, chunk=16):
        video = decode(self, latents, chunk)
        video[0] = 1.0 - video[0]
        return video

    monkeypatch.setattr(FateZeroPipeline, "decode_latents", altered)


def _payload_shifted(monkeypatch):
    """Attention control's capture: each edit step served the stored row of its neighbour."""
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline

    invert = FateZeroPipeline.invert_fast

    def shifted(self, *args, **kwargs):
        out = invert(self, *args, **kwargs)
        if not kwargs.get("capture"):
            return out
        traj, stored = out
        return traj, {"probs": {k: [a.roll(1, 0) for a in lst] for k, lst in stored["probs"].items()},
                      "qk": {k: [(q.roll(1, 0), kk.roll(1, 0)) for q, kk in lst] for k, lst in stored["qk"].items()}}

    monkeypatch.setattr(FateZeroPipeline, "invert_fast", shifted)


def _self_gate_off(monkeypatch):
    """Attention control's fusion: the self-attention replacement never on."""
    from fatezero_tpu_torch.ptp.controller import EditController

    monkeypatch.setattr(EditController, "self_replace_active", lambda self, step: False)


def _reweight_dropped(monkeypatch):
    """Attention control's fusion: the reweighting of "watercolor" left out."""
    from fatezero_tpu_torch.ptp import controller as PC

    make = PC.make_controller
    monkeypatch.setattr(PC, "make_controller", lambda *a, **k: make(*a, **{**k, "eq_params": None}))




EDIT_FAULTS = [(c, f) for c in EDIT_CELLS for f in (_step_unchanged, _half_the_frames, _answer_altered,
                                                    _self_gate_off, _reweight_dropped)]


@pytest.mark.parametrize("cell,fault", EDIT_FAULTS + [("teaser-stored", _payload_shifted)])
def test_edit_faults_come_out_incorrect(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    assert _run(tiny, cell)["correct"] is False


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_the_batch(monkeypatch):
    from fatezero_tpu_torch.trainer.ddpm_trainer import DDPMTrainer

    loss = DDPMTrainer._loss

    def half(self, latents, text_emb, noise, t):
        n = max(latents.shape[1] // 2, 1)
        return loss(self, latents[:, :n], text_emb, noise[:, :n], t)

    monkeypatch.setattr(DDPMTrainer, "_loss", half)


def _gradient_altered(monkeypatch):
    step = torch.optim.AdamW.step

    def altered(self, closure=None):
        p = max(self.param_groups[0]["params"], key=lambda q: float(q.grad.norm()))
        p.grad = p.grad * 2.0
        return step(self, closure)

    monkeypatch.setattr(torch.optim.AdamW, "step", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _gradient_altered])
def test_tune_faults_come_out_incorrect(tiny, monkeypatch, fault):
    fault(monkeypatch)
    assert _run(tiny, "jeep-tune")["correct"] is False


@pytest.mark.parametrize("cell", sorted(T.CELLS))
def test_float8_control_comes_out_incorrect(tiny, cell):
    result = _run(tiny, cell, control=FP8())
    assert result["correct"] is True, result["compared"]
    assert result["control"]["correct"] is False, result["control"]["compared"]
