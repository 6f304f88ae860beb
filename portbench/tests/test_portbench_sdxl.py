"""sdxl-replay10 rehearsed on the CPU at the tiny-xl size (tiny_xl.json: SDXL's
layout, two towers, 2 frames at 64^2, 3 steps), under the cell's own limits;
and planted faults in the SDXL-only parts of the program, each of which must
come out not correct.

The tiny widths are 10x narrower than SDXL's, so the weights are drawn at
`TINY_STD` in place of the configuration's 0.02: a product over a tiny fan-in
then gives the activations the scale SDXL's widths give them at 0.02
(0.02 * sqrt(1280 / 128)); at 0.02 the transformer blocks and the towers'
MLPs would add next to nothing at this size, and no fault in them could
show."""
import dataclasses
import json
import os

import pytest
import torch

from portbench import run as R
from portbench import work_xl
from portbench.reference.numerics import FP8
from portbench.tests import tiny as T

CELL = "sdxl-replay10"
TINY_STD = 0.063


@pytest.fixture
def tiny_xl(tmp_path, monkeypatch):
    from portbench import weights

    monkeypatch.setattr(weights, "STD", TINY_STD)
    paths = T.write_bench(str(tmp_path))
    with open(os.path.join(str(tmp_path), "sdxl-teaser.json"), "w") as f:
        json.dump(T.load(os.path.join(T.HERE, "tiny_xl.json")), f)
    return paths


def _run(tiny_xl, trace=False, control=None):
    return R.run(CELL, T.SEED + 3, 0.2, trace, device="cpu", limits=T.limits(CELL), control=control, **tiny_xl)


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_is_correct(tiny_xl, trace):
    result = _run(tiny_xl, trace)
    assert result["correct"] is True, result["compared"]
    assert set(result["compared"]) == {"text", "encode", "decode", "invert_step", "edit_step", "self_sites",
                                       "cross_sites"}
    if trace:
        m = result["metrics"]
        cfg = T.load(os.path.join(T.HERE, "tiny_xl.json"))
        # every controlled block's two sites, in each of the edit's 3 steps' forwards
        assert m["sites.edit"]["value"] == 3 * 2 * work_xl.controlled_blocks(cfg, 8, 8)
        assert m["stack_host_s.edit"]["value"] > 0 and m["mfu.edit"]["value"] > 0


def test_float8_control_comes_out_incorrect(tiny_xl):
    result = _run(tiny_xl, control=FP8())
    assert result["correct"] is True, result["compared"]
    assert result["control"]["correct"] is False, result["control"]["compared"]


def _add_embedding_dropped(monkeypatch):
    from fatezero_tpu_torch.models import layers

    forward = layers.TimestepEmbedding.forward

    def dropped(self, sample):
        out = forward(self, sample)
        is_add = self.linear_1.in_features * 4 != self.linear_1.out_features  # the time embedding's is 4x
        return torch.zeros_like(out) if is_add else out

    monkeypatch.setattr(layers.TimestepEmbedding, "forward", dropped)


def _quick_gelu_in_the_second_tower(monkeypatch):
    from fatezero_tpu_torch.models import clip

    monkeypatch.setitem(clip.ACTIVATIONS, "gelu", clip.quick_gelu)


def _last_layer_for_penultimate(monkeypatch):
    from fatezero_tpu_torch.models import clip

    monkeypatch.setattr(clip.CLIPTextTransformer, "hidden_pair", lambda self, ids: (self(ids), self(ids)))


def _deepest_stacks_cut_to_one_block(monkeypatch):
    from fatezero_tpu_torch.models import attention

    forward = attention.SpatioTemporalTransformerModel.forward

    def cut(self, x, context, attn_ctx=None, place=None):
        blocks = self.transformer_blocks
        if len(blocks) < 3:
            return forward(self, x, context, attn_ctx=attn_ctx, place=place)
        self.transformer_blocks = blocks[:1]
        try:
            return forward(self, x, context, attn_ctx=attn_ctx, place=place)
        finally:
            self.transformer_blocks = blocks

    monkeypatch.setattr(attention.SpatioTemporalTransformerModel, "forward", cut)


def _reweight_skipped_on_one_site(monkeypatch):
    """The first mid-block cross site of every edit forward runs without the equalizer."""
    from fatezero_tpu_torch.ptp import context

    attend = context.InlineEditContext.value_space_attention

    def skipped(self, qh, kh, vh, scale, place, is_cross, video_shape, **info):
        if not (is_cross and place == "mid") or getattr(self, "_skipped", False):
            return attend(self, qh, kh, vh, scale, place, is_cross, video_shape, **info)
        self._skipped, params = True, self.params
        self.params = dataclasses.replace(params, equalizer=None)
        try:
            return attend(self, qh, kh, vh, scale, place, is_cross, video_shape, **info)
        finally:
            self.params = params

    monkeypatch.setattr(context.InlineEditContext, "value_space_attention", skipped)


@pytest.mark.parametrize("fault", [_add_embedding_dropped, _last_layer_for_penultimate, _deepest_stacks_cut_to_one_block,
                                   _reweight_skipped_on_one_site])
def test_sdxl_faults_come_out_incorrect(tiny_xl, monkeypatch, fault):
    fault(monkeypatch)
    assert _run(tiny_xl)["correct"] is False


def test_quick_gelu_in_the_second_tower_moves_text(tiny_xl, monkeypatch):
    """quick_gelu and gelu differ by ~1-2 % over the tower's activations: at the
    cell's size on the card the fault reads `text` 0.0215-0.0246 against the
    limit 0.019 (the bf16 program's rounding, ~0.014, adds to it), but an fp32 tiny
    tower reads the fault's own share alone, below the card's limit. Here the
    check must see it: far above the sound program's reading."""
    sound = _run(tiny_xl)["compared"]["text"]["value"]
    _quick_gelu_in_the_second_tower(monkeypatch)
    assert _run(tiny_xl)["compared"]["text"]["value"] > 0.01 > 1000 * sound
