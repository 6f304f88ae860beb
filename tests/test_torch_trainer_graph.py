"""The trainer's CUDA-graphed update (trainer/ddpm_trainer.py, through the
CUDA-graph layer ops/graph_capture.py).

On the CPU: the rule that engages the graph (`DDPMTrainer._graphed`), the
static key (`static_key` over the update's inputs) and when the trainer drops
its graph, on the random:tiny geometry; the graph itself never engages
there. Also that a saved state holds each learning rate as a number.

On the card (gpu): two trainers from identical weights, state and generator
seed, one forced eager through `_update`, one through `step` (one eager
update on a side stream, then a capture and replays), run 6 updates with
gradient checkpointing, the temporal convs trained, prior preservation, a
warm-up learning rate, `run_steps` with a random crop, and a
`save_training_state` / `load_training_state` after 3 (which drops the graph:
the second half warms up and captures again). Each half holds one replay with
inputs and a learning rate other than the capture's. The two are held to each
other's losses and masters. On the H100 the two came out identical in both
dtypes (the same kernels in the same order); they are held to rounding: in
fp32 the loss to 1e-5 relative and every master coordinate to 1e-3 of the
learning rate; in bf16, where a rounding flip of an activation would move a
gradient by bf16's step and AdamW's normalised step can turn a gradient near
zero into a whole step of either sign, the loss to 1e-3 and 99% of the
coordinates to 0.01 of the learning rate. A replay that misses a fresh
learning rate or fresh noise reads far outside them (measured on the card:
a stale learning rate put the loss 5.0e-4 off in fp32 and the 99th
percentile coordinate 1.76 learning rates off in bf16; stale noise put the
loss 0.037 off in both).
"""
import numpy as np
import pytest
import torch

from fatezero_tpu_torch.models.loader import load_models
from fatezero_tpu_torch.ops import flash_attention as FA
from fatezero_tpu_torch.ops import graph_capture as GC
from fatezero_tpu_torch.parallel.sharding import Mesh
from fatezero_tpu_torch.trainer import ddpm_trainer as T

F, RES, CROP, LR = 2, 160, (128, 128), 1e-3
TUNE = {"gradient_checkpointing": True, "lora": 160}


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    return load_models("random:tiny", TUNE, seed=0, device="cpu")


def _trainer(m, **kw):
    return T.DDPMTrainer(m.unet, m.vae, schedule=m.schedule, learning_rate=LR, train_temporal_conv=True, **kw)


# ----------------------------------------------------------------------- CPU


CUDA = torch.device("cuda")


@pytest.mark.parametrize("case, engages", [
    ("cuda", True), ("cpu", False), ("mesh", False), ("adamw8bit", False), ("adafactor", False),
    ("forward_hook", False), ("forward_pre_hook", False), ("backward_hook", False), ("no_grad", False),
    ("global_hook", False), ("capturing", False), ("global_backward_hook", False),
])
def test_rule_engages_on_a_card_alone_with_adamw_no_mesh_no_hook(tiny, monkeypatch, case, engages):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: case == "capturing")
    device = torch.device("cpu") if case == "cpu" else CUDA
    mesh = Mesh((1, 1, 1), "cpu") if case == "mesh" else None
    optimizer = case if case in ("adamw8bit", "adafactor") else "adamw"
    trainer = _trainer(tiny, optimizer=optimizer, mesh=mesh)
    site = tiny.unet.down_blocks[0].resnets[0]
    module = torch.nn.modules.module
    handle = {
        "forward_hook": lambda: site.register_forward_hook(lambda *a: None),
        "forward_pre_hook": lambda: site.register_forward_pre_hook(lambda *a: None),
        "backward_hook": lambda: site.register_full_backward_hook(lambda *a: None),
        "global_hook": lambda: module.register_module_forward_hook(lambda *a: None),
        "global_backward_hook": lambda: module.register_module_full_backward_hook(lambda *a: None),
    }.get(case, lambda: None)()
    try:
        with torch.set_grad_enabled(case != "no_grad"):
            assert trainer._graphed(device) is engages
    finally:
        if handle is not None:
            handle.remove()
    assert not GC.hooked(tiny.unet.modules()) and not trainer._graphs.entries


def _key(frames, width, emb, optimizer, classes=None, prediction="epsilon"):
    """The update's static key, as `DDPMTrainer.step` forms it."""
    inputs = dict(images=torch.zeros(frames, 64, width, 3), text_emb=emb, **(classes or {}))
    return GC.static_key(inputs, prediction, optimizer)


def test_key_follows_shapes_dtypes_class_term_and_prediction():
    emb, opt = torch.zeros(1, 77, 32), object()
    classes = dict(class_images=torch.zeros(1, 64, 64, 3), class_text_emb=torch.zeros(1, 77, 32))
    key = _key(2, 64, emb, opt)
    ones = GC.static_key(dict(images=torch.ones(2, 64, 64, 3), text_emb=emb), "epsilon", opt)
    assert ones == key  # values are copied in
    others = [
        _key(3, 64, emb, opt),  # frames
        _key(2, 96, emb, opt),  # crop
        GC.static_key(dict(images=torch.zeros(2, 64, 64, 3).double(), text_emb=emb), "epsilon", opt),  # dtype
        _key(2, 64, torch.zeros(1, 77, 64), opt),  # text width
        _key(2, 64, emb, opt, classes),  # class term
        _key(2, 64, emb, opt, prediction="v_prediction"),
        _key(2, 64, emb, object()),  # another optimizer
    ]
    assert key not in others and len(set(others)) == len(others)


def test_cpu_step_stays_eager(tiny):
    trainer = _trainer(tiny)
    state = trainer.init_state()
    gen = torch.Generator().manual_seed(0)
    state, loss = trainer.step(state, torch.rand(F, 64, 64, 3) * 2 - 1, torch.randn(1, 77, 32), gen)
    assert not trainer._graphs.entries and state["step"] == 1 and torch.isfinite(loss)


def test_graph_dropped_on_new_key_state_init_and_load(tiny, tmp_path):
    trainer = _trainer(tiny)
    graphs, state = trainer._graphs, trainer.init_state()
    emb = torch.zeros(1, 77, 32)
    key = _key(F, 64, emb, state["optimizer"])
    graph = graphs.entry(key)
    assert graphs.entry(key) is graph and graph.warm == 0
    other = _key(F, 96, emb, state["optimizer"])
    assert graphs.entry(other) is not graph and list(graphs.entries) == [other]
    graph = graphs.entries[other]
    fresh = torch.optim.AdamW(list(state["master"].values()), lr=LR)
    assert graphs.entry(_key(F, 96, emb, fresh)) is not graph
    state = trainer.init_state()
    assert not graphs.entries
    graphs.entry(_key(F, 64, emb, state["optimizer"]))
    T.save_training_state(str(tmp_path), state)
    T.load_training_state(str(tmp_path), trainer, state)
    assert not graphs.entries


def test_saved_learning_rate_is_a_number(tiny, tmp_path):
    """A graphed update leaves each group's learning rate as the device
    scalar its graph reads; the saved state holds a number all the same."""
    trainer = _trainer(tiny)
    state = trainer.init_state()
    state["optimizer"].param_groups[0]["lr"] = torch.tensor(LR)
    T.save_training_state(str(tmp_path), state)
    saved = torch.load(tmp_path / T.STATE_FILE, map_location="cpu", weights_only=True)
    lrs = [g["lr"] for g in saved["optimizer"]["param_groups"]]
    assert all(type(lr) is float for lr in lrs) and lrs[0] == float(torch.tensor(LR))


def test_load_keeps_this_optimizers_step_counts(tiny, tmp_path):
    """A state saved by a capturable AdamW (device-side step counts, on the
    card) resumes in a CPU trainer, whose AdamW keeps them on the host."""
    trainer = _trainer(tiny)
    state = trainer.init_state()
    gen = torch.Generator().manual_seed(1)
    frames, emb = torch.rand(F, 64, 64, 3) * 2 - 1, torch.randn(1, 77, 32)
    state, _ = trainer.step(state, frames, emb, gen)
    for group in state["optimizer"].param_groups:
        group["capturable"] = True  # as the card's optimizer saves its groups
    T.save_training_state(str(tmp_path), state)
    state = T.load_training_state(str(tmp_path), trainer, trainer.init_state())
    assert not any(g["capturable"] for g in state["optimizer"].param_groups)
    state, loss = trainer.step(state, frames, emb, gen)
    assert state["step"] == 2 and torch.isfinite(loss)


# ---------------------------------------------------------------------- card

LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
MASTER_TOL = {"float32": 1e-3, "bfloat16": 0.01}  # in learning rates; bf16: 99% of coordinates


def _eager_step(trainer):
    """`trainer.step` through `_update` alone, with the same draws."""
    def step(state, images, text_emb, generator, class_images=None, class_text_emb=None):
        draws = trainer.draw(generator, images.shape, None if class_images is None else class_images.shape)
        return state, trainer._update(state, images, text_emb, draws.to(images.device), class_images, class_text_emb)
    return step


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_updates_match_eager_ones_on_the_card(tmp_path, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the update's CUDA graph and the flash kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    frames = (torch.rand(F, RES, RES, 3, generator=g, device="cuda") * 2 - 1).to(dt)
    class_images = (torch.rand(1, *CROP, 3, generator=g, device="cuda") * 2 - 1).to(dt)
    emb, class_emb = (torch.randn(1, 77, 32, generator=g, device="cuda").to(dt) for _ in range(2))
    kw = dict(lr_scheduler="constant_with_warmup", lr_warmup_steps=6, train_steps=6, prior_preservation=1.0)
    runs = {}
    for name in ("eager", "graphed"):
        m = load_models("random:tiny", TUNE, dtype=dt, seed=0, device="cuda")
        trainer = _trainer(m, **kw)
        if name == "eager":
            trainer.step = _eager_step(trainer)
        gen = torch.Generator().manual_seed(7)
        launched = FA.flash_dkv.launches
        state = trainer.init_state()
        state, first = trainer.run_steps(state, frames, emb, gen, 3, crop=CROP, class_images=class_images,
                                         class_text_emb=class_emb)
        captured = any(e.schedule is not None for e in trainer._graphs.entries.values())
        T.save_training_state(str(tmp_path / name), state)
        state = T.load_training_state(str(tmp_path / name), trainer, trainer.init_state())
        assert not trainer._graphs.entries
        state, second = trainer.run_steps(state, frames, emb, gen, 3, crop=CROP, class_images=class_images,
                                          class_text_emb=class_emb)
        torch.cuda.synchronize()
        runs[name] = dict(losses=torch.cat([first, second]).float().cpu(), captured=captured,
                          masters={n: t.detach().float().cpu() for n, t in state["master"].items()},
                          k3=FA.flash_dkv.launches - launched, step=state["step"])
    eager, graphed = runs["eager"], runs["graphed"]
    assert graphed["captured"] and not eager["captured"]
    assert graphed["step"] == eager["step"] == 6 and graphed["k3"] == eager["k3"] > 0
    loss_gap = float(((graphed["losses"] - eager["losses"]).abs() / eager["losses"].abs()).max())
    gaps = torch.cat([(graphed["masters"][n] - t).abs().flatten() for n, t in eager["masters"].items()]) / LR
    q = np.quantile(gaps.numpy(), [0.5, 0.99, 0.999, 1.0])
    print(f"[graph-test] {dtype}: loss gap {loss_gap:.3e}, master gap / lr at 50/99/99.9/100 % {q}")
    assert torch.isfinite(graphed["losses"]).all()
    assert loss_gap <= LOSS_TOL[dtype]
    assert (q[3] if dtype == "float32" else q[1]) <= MASTER_TOL[dtype]
