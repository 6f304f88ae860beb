"""The port's dataset x p2p-grid sweep (fatezero_tpu_torch/cli/dataset_sweep.py)
against the JAX package's root test_fatezero_dataset.py, on the CPU.

* Composition, without running an edit: `test` is replaced by a recorder in
  both modules, and both sweeps of the shipped config/dataset_sweep.yaml
  must hand it the same per-run configs.
* One real sweep of the port at random:tiny (1 video of 2 synthetic 64²
  frames, 2 DDIM steps, the grid's 2 variants) with the clock frozen, so
  both runs start "in the same second": the JAX CLI names both runs' folders
  alike (its second run would overwrite the first's artifacts), the port
  gives each run its own folder with all of its artifacts.
"""
import os
import time

import numpy as np
import yaml
from PIL import Image

import test_fatezero_dataset as jsweep
from fatezero_tpu.cli import edit as jedit
from fatezero_tpu_torch.cli import dataset_sweep
from fatezero_tpu_torch.common.logdir import logdir_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = os.path.join(REPO, "config", "dataset_sweep.yaml")
STAMP = "2026-01-01T00-00-00"
_strftime = time.strftime


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, **kwargs):
        self.calls.append(kwargs)
        return kwargs.get("logdir"), []


def test_sweep_composes_the_same_runs_as_jax(monkeypatch):
    jrec, rec = _Recorder(), _Recorder()
    monkeypatch.setattr(jsweep, "test", jrec)
    monkeypatch.setattr(dataset_sweep, "test", rec)
    jsweep.run(SWEEP)
    dataset_sweep.run(SWEEP, device="cpu")
    assert len(rec.calls) == len(jrec.calls) == 2
    assert [c.pop("device") for c in rec.calls] == ["cpu", "cpu"]
    assert rec.calls == jrec.calls
    steps = [c["editing_config"]["p2p_config"][0]["self_replace_steps"] for c in rec.calls]
    assert steps == [0.5, 0.9]
    assert all(c["logdir"] is None and c["editing_config"]["p2p_config"][0]["cross_replace_steps"] == 0.8
               for c in rec.calls)


def _frozen(fmt, *args):
    return STAMP if fmt == "%Y-%m-%dT%H-%M-%S" else _strftime(fmt, *args)


def test_logdir_in_the_same_second(tmp_path, monkeypatch):
    """The reference names two runs of one second alike; the port does not,
    and creates each folder as it names it."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(time, "strftime", _frozen)
    assert jedit._logdir_for("a/sweep.yaml", None) == jedit._logdir_for("a/sweep.yaml", None)
    first, second, third = (logdir_for("a/sweep.yaml", None) for _ in range(3))
    base = os.path.join("result", "sweep", STAMP)
    assert (first, second, third) == (base, f"{base}_1", f"{base}_2")
    assert all(os.path.isdir(p) for p in (first, second, third))
    assert logdir_for("a/sweep.yaml", "given") == "given"


def test_sweep_runs_each_edit_into_its_own_folder(tmp_path, monkeypatch):
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(frames / f"{i:05d}.png")
    with open(SWEEP) as f:
        cfg = yaml.safe_load(f)
    ds = cfg["datasets"][0]
    ds["dataset_config"].update(path=str(frames), n_sample_frame=2, sampling_rate=1, image_size=64)
    ds["editing_config"]["num_inference_steps"] = 2
    config = tmp_path / "sweep.yaml"
    config.write_text(yaml.safe_dump(cfg))

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(time, "strftime", _frozen)
    runs = dataset_sweep.run(str(config), device="cpu")
    logdirs = [r[0] for r in runs]
    base = os.path.join("result", "sweep", STAMP)
    assert logdirs == [base, f"{base}_1"]
    for logdir, videos in runs:
        assert len(videos) == 1 and videos[0].shape == (2, 64, 64, 3) and np.isfinite(videos[0]).all()
        names = set(os.listdir(logdir))
        assert {"log.log", "input.gif", "phase_timings.json", "config.yml"} <= names
        with open(os.path.join(logdir, "config.yml")) as f:
            assert yaml.safe_load(f)["logdir"] == logdir
