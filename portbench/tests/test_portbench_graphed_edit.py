"""The reader of the program's graphed-forward counter, on a hand-made recorder."""
import pytest

from fatezero_tpu_torch.common import profiling
from portbench import run as R

FORWARDS = {"fz.unet.forward": {"calls": 100, "total_s": 9.0, "self_s": 1.5}}


def _read(monkeypatch, recorded, unit="edit"):
    monkeypatch.setattr(profiling, "recorded", lambda: recorded)
    return R.load_module("metrics", "graphed.edit").read({"unit_name": unit})


@pytest.mark.parametrize("graphed, share", [(100, 100.0), (96, 96.0)])
def test_reads_the_share_of_forwards_replayed(monkeypatch, graphed, share):
    assert _read(monkeypatch, {"spans": FORWARDS, "counters": {"unet.graphed": graphed}}) == pytest.approx(share)


def test_reads_nothing_without_the_counter_or_the_forwards(monkeypatch):
    assert _read(monkeypatch, {"spans": FORWARDS, "counters": {"ptp.materialised": 5}}) is None  # never graphs
    assert _read(monkeypatch, {"spans": {}, "counters": {"unet.graphed": 3}}) is None
    assert _read(monkeypatch, {"spans": FORWARDS, "counters": {"unet.graphed": 100}}, unit="update") is None


def test_reads_nothing_of_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    assert R.load_module("metrics", "graphed.edit").read({"unit_name": "edit"}) is None
