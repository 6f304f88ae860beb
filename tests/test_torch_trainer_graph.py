"""The trainer's CUDA-graphed update (trainer/ddpm_trainer.py).

On the CPU: the rule that engages the graph (`graph_engages`), the static key
(`graph_key`) and when the trainer drops its graph, on the random:tiny
geometry; the graph itself never engages there.

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
])
def test_rule_engages_on_a_card_alone_with_adamw_no_mesh_no_hook(tiny, case, engages):
    device = torch.device("cpu") if case == "cpu" else CUDA
    mesh = Mesh((1, 1, 1), "cpu") if case == "mesh" else None
    optimizer = case if case in ("adamw8bit", "adafactor") else "adamw"
    site = tiny.unet.down_blocks[0].resnets[0]
    handle = {
        "forward_hook": lambda: site.register_forward_hook(lambda *a: None),
        "forward_pre_hook": lambda: site.register_forward_pre_hook(lambda *a: None),
        "backward_hook": lambda: site.register_full_backward_hook(lambda *a: None),
    }.get(case, lambda: None)()
    try:
        with torch.set_grad_enabled(case != "no_grad"):
            assert T.graph_engages(device, tiny.unet, mesh, optimizer) is engages
    finally:
        if handle is not None:
            handle.remove()
    assert not T.hooked(tiny.unet)


def test_key_follows_shapes_dtypes_class_term_and_prediction():
    clip, emb = torch.zeros(2, 64, 64, 3), torch.zeros(1, 77, 32)
    cls, cemb = torch.zeros(1, 64, 64, 3), torch.zeros(1, 77, 32)
    key = T.graph_key((clip, emb, None, None), "epsilon")
    assert T.graph_key((torch.ones(2, 64, 64, 3), emb, None, None), "epsilon") == key  # values are copied in
    others = [
        ((torch.zeros(3, 64, 64, 3), emb, None, None), "epsilon"),  # frames
        ((torch.zeros(2, 64, 96, 3), emb, None, None), "epsilon"),  # crop
        ((clip.double(), emb, None, None), "epsilon"),  # dtype
        ((clip, torch.zeros(1, 77, 64), None, None), "epsilon"),  # text width
        ((clip, emb, cls, cemb), "epsilon"),  # class term
        ((clip, emb, None, None), "v_prediction"),
    ]
    keys = [T.graph_key(*o) for o in others]
    assert key not in keys and len(set(keys)) == len(keys)


def test_cpu_step_stays_eager(tiny):
    trainer = _trainer(tiny)
    state = trainer.init_state()
    gen = torch.Generator().manual_seed(0)
    state, loss = trainer.step(state, torch.rand(F, 64, 64, 3) * 2 - 1, torch.randn(1, 77, 32), gen)
    assert trainer._graph is None and state["step"] == 1 and torch.isfinite(loss)


def test_graph_dropped_on_new_key_state_init_and_load(tiny, tmp_path):
    trainer = _trainer(tiny)
    state = trainer.init_state()
    key = T.graph_key((torch.zeros(F, 64, 64, 3), torch.zeros(1, 77, 32), None, None), "epsilon")
    graph = trainer._graph_for(state, key)
    assert trainer._graph_for(state, key) is graph and graph.warm == 0
    other = T.graph_key((torch.zeros(F, 64, 96, 3), torch.zeros(1, 77, 32), None, None), "epsilon")
    assert trainer._graph_for(state, other) is not graph and trainer._graph.key == other
    graph = trainer._graph
    fresh = {**state, "optimizer": torch.optim.AdamW(list(state["master"].values()), lr=LR)}
    assert trainer._graph_for(fresh, other) is not graph
    state = trainer.init_state()
    assert trainer._graph is None
    trainer._graph_for(state, key)
    T.save_training_state(str(tmp_path), state)
    T.load_training_state(str(tmp_path), trainer, state)
    assert trainer._graph is None


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
        captured = trainer._graph is not None and trainer._graph.graph is not None
        T.save_training_state(str(tmp_path / name), state)
        state = T.load_training_state(str(tmp_path / name), trainer, trainer.init_state())
        assert trainer._graph is None
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
