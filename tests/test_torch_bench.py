"""The port's headline bench, fatezero_tpu_torch/scripts/bench.py, on the CPU.

The bench at random:tiny (2 frames, 128x128 so 16x16 latents whose top
level has 256 queries and runs FlashAttention's plain versions, 2 DDIM steps,
fp32), one run per mode shared by the module:

* every mode returns the root bench.py's keys (viz on in the fused run);
  `stored_rows` is `plan_capture`'s answer: every row under the default
  budget, a hybrid's rows under a budget of one and a half rows, none for
  replay and stream;
* in fp32 the stored, hybrid, replay and streaming edits of the same
  latents agree (EDIT_TOL);
* the flash-gradient probe passes on the plain versions and raises on a
  backward that doubles dq;
* a device out-of-memory error in the capture or the stored edit falls back
  to replay (the replay run's edit exactly), any other error propagates;
* the default device is the card: with no card it raises;
* `python -m fatezero_tpu_torch.scripts.bench` re-executes itself under
  PYTHONHASHSEED=0 and prints one JSON line.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from fatezero_tpu_torch.ops import flash_attention as FA
from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
from fatezero_tpu_torch.scripts import bench as B

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2
TINY = {"BENCH_STEPS": str(STEPS), "BENCH_FRAMES": "2", "BENCH_RES": "128"}
KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL_KEYS = {"invert_s", "edit_s", "edit_viz_s", "flash_grad_err", "backend", "mode", "stored_payload",
               "stored_rows", "model_config"}
# fp32 sums in other orders: the capturing inversion materialises the
# controlled cross sites where the plain one runs FlashAttention's plain
# version, and the streaming edit materialises every controlled site; 2+2
# passes of the tiny UNet part them by ~8e-6 of the largest value
EDIT_TOL = 1e-4


def _per_step_bytes() -> int:
    b = B.setup(B.Settings.from_env(TINY), "cpu", "random:tiny")
    return b.pipe.capture_payload_bytes(b.latents, 1)


@pytest.fixture(scope="module")
def runs():
    """Each mode's (result, edited latents) and the plan plan_capture gives it."""
    hybrid = {"FZ_PAYLOAD_BUDGET_GB": repr(1.5 * _per_step_bytes() / 1e9)}
    no_viz = {"BENCH_VIZ": "0"}
    modes = {"fused": {}, "hybrid": {**hybrid, **no_viz}, "replay": {"BENCH_REPLAY": "1", **no_viz},
             "stream": {"BENCH_MODE": "stream"}}
    out = {}
    for name, over in modes.items():
        cfg = B.Settings.from_env({**TINY, **over})
        b = B.setup(cfg, "cpu", "random:tiny")
        plan = None
        if name in ("fused", "hybrid"):
            plan = b.pipe.plan_capture(b.latents, cfg.steps, b.controller().edit_window(cfg.steps),
                                       cfg.budget_gb * 1e9)
        out[name] = (*B.run(cfg, "cpu", "random:tiny"), plan)
    return out


@pytest.mark.parametrize("mode", ["fused", "hybrid", "replay", "stream"])
def test_keys_and_plan(runs, mode):
    result, edited, plan = runs[mode]
    assert set(result) == KEYS and set(result["detail"]) == DETAIL_KEYS
    d = result["detail"]
    assert result["unit"] == "s" and result["metric"] == f"car-turn 2f 128^2 {STEPS}-step inversion+edit wall-clock"
    assert d["backend"] == "cpu" and d["mode"] == ("stream" if mode == "stream" else "fused")
    assert d["model_config"].startswith("teaser-exact")
    assert result["value"] == pytest.approx(d["invert_s"] + d["edit_s"], abs=0.011)
    assert result["vs_baseline"] > 0 and d["flash_grad_err"] < B.PROBE_TOL
    if mode == "fused":
        assert plan == (0, STEPS)
    if mode == "hybrid":
        assert plan is not None and 0 < plan[1] < STEPS
    assert d["stored_rows"] == (list(plan) if plan else None)
    assert d["stored_payload"] is (plan is not None)
    assert (d["edit_viz_s"] is None) is (mode != "fused")  # viz on in the fused run only
    assert tuple(edited.shape) == (1, 2, 16, 16, 4) and bool(torch.isfinite(edited).all())


@pytest.mark.parametrize("mode", ["hybrid", "replay", "stream"])
def test_modes_agree_in_fp32(runs, mode):
    ref = runs["fused"][1]
    err = (runs[mode][1] - ref).abs().max().item()
    assert err <= EDIT_TOL * ref.abs().max().item(), (mode, err)


def test_probe_passes_on_the_plain_versions():
    err, launches = B.flash_grad_probe("cpu")
    assert err < 1e-5 and launches == (0, 0, 0)  # no kernel on the CPU


def test_probe_raises_on_a_wrong_backward(monkeypatch):
    reference = FA.flash_bwd_reference

    def doubled_dq(*args):
        dq, dk, dv = reference(*args)
        return 2 * dq, dk, dv

    monkeypatch.setattr(FA, "flash_bwd_reference", doubled_dq)
    with pytest.raises(AssertionError, match="deviates from reference grad"):
        B.flash_grad_probe("cpu")


def _fail_once(monkeypatch, method, when, exc):
    """Make FateZeroPipeline.<method> raise `exc` on its first call that `when` picks."""
    original = getattr(FateZeroPipeline, method)
    calls = []

    def failing(self, *args, **kwargs):
        if when(kwargs) and not calls:
            calls.append(1)
            raise exc
        return original(self, *args, **kwargs)

    monkeypatch.setattr(FateZeroPipeline, method, failing)
    return calls


@pytest.mark.parametrize("method,when", [
    ("invert_fast", lambda kw: kw.get("capture")),
    ("edit_fast", lambda kw: kw.get("stored") is not None),
], ids=["capture", "stored_edit"])
def test_out_of_memory_falls_back_to_replay(runs, monkeypatch, capsys, method, when):
    calls = _fail_once(monkeypatch, method, when, torch.cuda.OutOfMemoryError("out of memory (planted)"))
    result, edited = B.run(B.Settings.from_env({**TINY, "BENCH_VIZ": "0"}), "cpu", "random:tiny")
    assert calls and result["detail"]["stored_payload"] is False and result["detail"]["stored_rows"] is None
    assert "hit device OOM; falling back to replay" in capsys.readouterr().err
    ref = runs["replay"][1] if method == "invert_fast" else None
    if ref is not None:  # the capture failed: every pass is the replay run's
        assert torch.equal(edited, ref)
    else:  # the stored edit failed: the replay edit on the capturing inversion's trajectory
        assert (edited - runs["fused"][1]).abs().max() <= EDIT_TOL * runs["fused"][1].abs().max()


def test_other_errors_propagate(monkeypatch):
    _fail_once(monkeypatch, "invert_fast", lambda kw: kw.get("capture"), RuntimeError("not a memory error"))
    with pytest.raises(RuntimeError, match="not a memory error"):
        B.run(B.Settings.from_env(TINY), "cpu", "random:tiny")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs there")
    with pytest.raises(RuntimeError, match="CUDA card"):
        B.main(env=TINY)


def test_module_reexecutes_with_a_fixed_hash_seed():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONHASHSEED"}
    # one thread, as in this process: the tier-1 run's workers share the host
    env.update(TINY, BENCH_VIZ="0", BENCH_MODE="stream", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "fatezero_tpu_torch.scripts.bench", "--device", "cpu",
                          "--model", "random:tiny"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    result = json.loads(lines[0])
    assert set(result) == KEYS and result["detail"]["mode"] == "stream"
    seeded = subprocess.run(
        [sys.executable, "-c", "from fatezero_tpu_torch.models.tokenizer import StubTokenizer; "
         f"print(StubTokenizer().tokenize_ids({B.TARGET!r}))"],
        cwd=REPO, env={**env, "PYTHONHASHSEED": "0"}, capture_output=True, text=True, timeout=120)
    assert f"[bench] target token ids: {seeded.stdout.strip()}" in out.stderr
