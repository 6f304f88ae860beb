"""The device trace's arithmetic: intervals' union, idle gaps, attribution to the attention spans."""
import types

import torch

from portbench import trace as T


def test_union_counts_overlaps_once():
    assert T.union_length([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert T.union_length([(3, 4), (0, 10)]) == 10
    assert T.union_length([]) == 0


def test_gaps_are_what_no_interval_covers():
    assert T.gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [(0, 2), (6, 8), (9, 10)]
    assert T.gaps([(0, 10)], 0, 10) == []


def _ev(name, start, dur, dev, act, corr=0):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur, correlation_id=lambda: corr,
        device_type=lambda: dev, is_user_annotation=lambda: act == "user_annotation")


def test_reduce_events_attributes_kernels_and_idle():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _ev(T.UNIT, 0, 100, cpu, "user_annotation"),
        _ev(T.ATTN, 10, 20, cpu, "user_annotation"),
        _ev("portbench.edit_fast", 0, 90, cpu, "user_annotation"),
        _ev("cudaLaunchKernel", 12, 1, cpu, "cuda_runtime", corr=1),
        _ev("cudaLaunchKernel", 40, 1, cpu, "cuda_runtime", corr=2),
        _ev("aten::mm", 38, 5, cpu, "cpu_op"),
        _ev("portbench.attn", 20, 30, cuda, "user_annotation"),
        _ev("k_attn", 20, 30, cuda, "kernel", corr=1),
        _ev("k_other", 45, 20, cuda, "kernel", corr=2),
        _ev("k_other", 60, 15, cuda, "kernel", corr=3),
    ]
    t = T.reduce_events(events)
    assert abs(t.span_s - 100e-9) < 1e-15
    assert abs(t.busy_s - 55e-9) < 1e-15  # [20, 75)
    assert abs(t.attn_device_s - 30e-9) < 1e-15
    assert abs(t.idle_pct - 45.0) < 1e-9
    assert t.device_ops[0][0] == "k_other"
    assert abs(sum(s for _, s in t.idle_gaps) - 45e-9) < 1e-15
    assert any(name.startswith("edit_fast") for name, _ in t.idle_gaps)


def test_reduce_events_without_device_work_is_none():
    cpu = torch.autograd.DeviceType.CPU
    assert T.reduce_events([_ev(T.UNIT, 0, 100, cpu, "user_annotation")]) is None
