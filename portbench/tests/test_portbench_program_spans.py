"""The readers of the program's spans and counters, on a hand-made recorder."""
import pytest

from fatezero_tpu_torch.common import profiling
from portbench import run as R


def _span(calls, total_s, self_s=None):
    return {"calls": calls, "total_s": total_s, "self_s": total_s if self_s is None else self_s}


EDIT = {
    "spans": {
        "fz.pipeline.edit_fast": _span(2, 8.0, 1.0),
        "fz.pipeline.plan_capture": _span(2, 1.2, 0.2),
        "fz.ptp.step": _span(200, 0.4, 0.3),
        "fz.ptp.site": _span(4400, 2.0, 1.1),
        "fz.unet.forward": _span(200, 9.0, 1.0),
        "fz.unet.resnet": _span(4400, 3.0, 2.0),
        "fz.unet.group_norm": _span(9000, 1.0),
        "fz.pipeline.invert_fast": _span(2, 6.0, 0.5),
    },
    "counters": {"ptp.materialised": 1122},
}
UPDATE = {
    "spans": {
        "fz.trainer.step": _span(10, 10.0, 0.1),
        "fz.trainer.draw": _span(10, 0.2),
        "fz.trainer.forward": _span(10, 3.0, 0.5),
        "fz.trainer.backward": _span(10, 5.0, 1.0),
        "fz.trainer.optimizer": _span(10, 1.5),
    },
    "counters": {},
}
READINGS = [
    ("plan_host_s.edit", "edit", EDIT, 0.6),
    ("control_host_s.edit", "edit", EDIT, (0.3 + 1.1) / 2),
    ("unet_host_s.edit", "edit", EDIT, (1.0 + 2.0 + 1.0) / 2),
    ("materialised.edit", "edit", EDIT, 561.0),
    ("fwd_bwd_host_s.tune", "update", UPDATE, 0.8),
    ("optim_host_s.tune", "update", UPDATE, 0.15),
]


@pytest.mark.parametrize("name, unit, recorded, value", READINGS)
def test_reads_the_recorder_per_unit(monkeypatch, name, unit, recorded, value):
    monkeypatch.setattr(profiling, "recorded", lambda: recorded)
    assert R.load_module("metrics", name).read({"unit_name": unit}) == pytest.approx(value)


@pytest.mark.parametrize("name, unit, recorded, value", READINGS)
def test_reads_nothing_of_another_unit_or_an_empty_recorder(monkeypatch, name, unit, recorded, value):
    reader = R.load_module("metrics", name)
    monkeypatch.setattr(profiling, "recorded", lambda: recorded)
    assert reader.read({"unit_name": "update" if unit == "edit" else "edit"}) is None
    monkeypatch.setattr(profiling, "recorded", lambda: {"spans": {}, "counters": {}})
    assert reader.read({"unit_name": unit}) is None


@pytest.mark.parametrize("name, unit, recorded, value", READINGS)
def test_reads_nothing_of_a_program_without_spans(monkeypatch, name, unit, recorded, value):
    monkeypatch.delattr(profiling, "recorded")  # the program before it had spans
    assert R.load_module("metrics", name).read({"unit_name": unit}) is None


def test_no_materialised_site_reads_zero(monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: {"spans": EDIT["spans"], "counters": {}})
    assert R.load_module("metrics", "materialised.edit").read({"unit_name": "edit"}) == 0
