"""The reader of the program's graphed-update counter, on a hand-made recorder."""
import pytest

from fatezero_tpu_torch.common import profiling
from portbench import run as R

STEPS = {"fz.trainer.step": {"calls": 10, "total_s": 4.0, "self_s": 0.2}}


def _read(monkeypatch, recorded, unit="update"):
    monkeypatch.setattr(profiling, "recorded", lambda: recorded)
    return R.load_module("metrics", "graphed.tune").read({"unit_name": unit})


@pytest.mark.parametrize("graphed, share", [(10, 100.0), (7, 70.0)])
def test_reads_the_share_of_updates_replayed(monkeypatch, graphed, share):
    assert _read(monkeypatch, {"spans": STEPS, "counters": {"trainer.graphed": graphed}}) == pytest.approx(share)


def test_reads_nothing_without_the_counter_or_the_updates(monkeypatch):
    assert _read(monkeypatch, {"spans": STEPS, "counters": {}}) is None  # a program that never graphs
    assert _read(monkeypatch, {"spans": {}, "counters": {"trainer.graphed": 3}}) is None
    assert _read(monkeypatch, {"spans": STEPS, "counters": {"trainer.graphed": 10}}, unit="edit") is None


def test_reads_nothing_of_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    assert R.load_module("metrics", "graphed.tune").read({"unit_name": "update"}) is None
