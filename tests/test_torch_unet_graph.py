"""The UNet's piecewise CUDA graphs (models/unet_graph.py, through the
CUDA-graph layer ops/graph_capture.py).

On the CPU: the rule that engages them (`graph_engages`), the static key
(`static_key` over the forward's inputs), when the graphs are dropped (a swapped parameter or module)
and released (a forward with grad on, a trainer's update, a key past
`MAX_KEYS`; never while a stream captures), that only an `EagerModule` runs
between the pieces, and that a CPU forward is the eager one; the graphs
themselves never engage there.

On the card (gpu): one pipeline and UNet at random:tiny and random:tiny-xl
(SDXL's text-time conditions), bf16, 64² latents over 2 frames (so the 64²
up blocks are past the controlled size and replay rows are dropped), run
each edit twice: eager (a no-op hook on `conv_in` keeps the rule off) and
graphed (each key's first forward eager, the second captured, the rest
replayed). Modes: the capture inversion and a stored edit with viz (the
materialised path), the 3-row inline edit, the replay edit, whose
capture-only forwards return None, and the stored edit with LayerNorms
through K4 (FZ_PALLAS_LN=1). The two are held to each other's trajectory,
payload and edited latent (bit for bit, or 1e-6 relative where cuBLAS would
choose otherwise), K1's and K4's launches, K4's kernels in the device trace
and those launched inside UNet forwards (a replay launches them inside its
pieces, where the wrapper that counts them does not run), the latter also to
the forwards times the UNet's LayerNorms, the calls of `fz.ptp.site`, the
`ptp.materialised` count and the calls of forward hooks on `attn1` and
`attn2`. Then a parameter swapped after the captures, and one changed in
place, must show in the graphed forward as in the eager one; a forward with
grad on then releases the graphs and their reserved memory.
"""
import dataclasses
import os

import pytest
import torch

from fatezero_tpu_torch.common import profiling
from fatezero_tpu_torch.models import unet_graph as G
from fatezero_tpu_torch.models.layers import FusedLayerNorm, layer_norm_takes_k4
from fatezero_tpu_torch.models.loader import load_models
from fatezero_tpu_torch.ops import flash_attention as FA
from fatezero_tpu_torch.ops import graph_capture as GC
from fatezero_tpu_torch.ops.fused_norm import layer_norm_kernel
from fatezero_tpu_torch.parallel.sharding import Mesh, seq_mesh_scope
from fatezero_tpu_torch.trainer.ddpm_trainer import DDPMTrainer

CUDA = torch.device("cuda")


@pytest.fixture(scope="module")
def tiny_models():
    return load_models("random:tiny", seed=0, device="cpu")


@pytest.fixture(scope="module")
def tiny(tiny_models):
    return tiny_models.unet


# ----------------------------------------------------------------------- CPU


@pytest.mark.parametrize("case, engages", [
    ("cuda", True), ("cpu", False), ("mesh", False), ("grad", False), ("capturing", False),
    ("resnet_hook", False), ("group_norm_pre_hook", False), ("transformer_hook", False), ("global_hook", False),
    ("temporal_downsample", False), ("unet_hook", True), ("attn1_hook", True), ("attn_temporal_pre_hook", True),
    ("resnet_backward_hook", False),
])
def test_rule_engages_on_a_card_without_mesh_grad_capture_or_hook_inside_a_piece(tiny, monkeypatch, case, engages):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: case == "capturing")
    if case == "temporal_downsample":
        monkeypatch.setattr(tiny, "cfg", dataclasses.replace(tiny.cfg, temporal_downsample_time=2))
    block = tiny.down_blocks[0].attentions[0].transformer_blocks[0]
    handle = {
        "resnet_hook": lambda: tiny.down_blocks[0].resnets[0].register_forward_hook(lambda *a: None),
        "resnet_backward_hook": lambda: tiny.down_blocks[0].resnets[0].register_full_backward_hook(lambda *a: None),
        "group_norm_pre_hook": lambda: tiny.mid_block.resnets[1].norm2.register_forward_pre_hook(lambda *a: None),
        "transformer_hook": lambda: tiny.up_blocks[1].attentions[0].register_forward_hook(lambda *a: None),
        "global_hook": lambda: torch.nn.modules.module.register_module_forward_hook(lambda *a: None),
        "unet_hook": lambda: tiny.register_forward_pre_hook(lambda *a: None),
        "attn1_hook": lambda: block.attn1.register_forward_hook(lambda *a: None),
        "attn_temporal_pre_hook": lambda: block.attn_temporal.register_forward_pre_hook(lambda *a: None),
    }.get(case, lambda: None)()
    mesh = seq_mesh_scope(Mesh((1, 1, 1), "cpu") if case == "mesh" else None)
    try:
        with mesh, torch.set_grad_enabled(case == "grad"):
            assert G.graph_engages(tiny, torch.device("cpu") if case == "cpu" else CUDA) is engages
    finally:
        if handle is not None:
            handle.remove()
    assert not tiny._graphs.entries


def _key(sample, timesteps, context, added, drop):
    """A forward's static key, as `PiecewiseGraphs.forward` forms it."""
    inputs = dict(sample=sample, t=timesteps, context=context, added=added)
    return GC.static_key(inputs, drop, layer_norm_takes_k4())


def test_key_follows_shapes_dtypes_rows_dropped_and_the_layernorm_kernel(monkeypatch):
    monkeypatch.delenv("FZ_PALLAS_LN", raising=False)
    x, ctx = torch.zeros(2, 2, 8, 8, 4), torch.zeros(2, 77, 32)
    added = {"text_embeds": torch.zeros(2, 40), "time_ids": torch.zeros(2, 6)}
    key = _key(x, 7, ctx, None, 0)
    assert _key(torch.ones(2, 2, 8, 8, 4), 981, ctx.clone(), None, 0) == key  # values are copied in
    others = [
        (torch.zeros(3, 2, 8, 8, 4), 7, torch.zeros(3, 77, 32), None, 0),  # rows
        (torch.zeros(2, 2, 16, 16, 4), 7, ctx, None, 0),  # latent size
        (x.double(), 7, ctx, None, 0),  # dtype
        (x, 7, ctx.bfloat16(), None, 0),
        (x, torch.tensor(7), ctx, None, 0),  # a device timestep
        (x, 7, ctx, added, 0),  # text-time conditions
        (x, 7, ctx, {**added, "time_ids": torch.zeros(2, 6, dtype=torch.float64)}, 0),
        (x, 7, ctx, None, 1),  # a replay row dropped
        (x, 7, ctx, None, 2),  # capture-only: every row a replay row
    ]
    keys = [_key(*o) for o in others]
    monkeypatch.setenv("FZ_PALLAS_LN", "1")
    keys.append(_key(x, 7, ctx, None, 0))
    assert key not in keys and len(set(keys)) == len(keys)


def test_graphs_dropped_when_a_parameter_or_submodule_is_swapped(tiny):
    graphs = tiny._graphs
    conv = tiny.conv_out

    def dropped(change):
        graphs.entries["a key"] = GC.Entry()
        assert not GC.hooked(graphs.piece_modules(tiny)) and "a key" in graphs.entries
        change()
        graphs.piece_modules(tiny)
        return "a key" not in graphs.entries

    weight = conv.weight
    try:
        with torch.no_grad():
            assert not dropped(lambda: conv.weight.mul_(1.0))  # in place: the graphs read the new values
            assert not dropped(lambda: tiny.load_state_dict(tiny.state_dict()))
            assert dropped(lambda: setattr(conv, "weight", torch.nn.Parameter(weight.clone())))
            assert dropped(lambda: setattr(conv.weight, "data", weight.detach().clone()))
            assert dropped(lambda: setattr(tiny, "conv_out", conv.__class__(conv.in_channels, conv.out_channels, 3)))
    finally:
        tiny.conv_out = conv
        conv.weight = weight
        graphs.entries.clear()


@pytest.mark.parametrize("case", ["grad_forward", "trainer_step", "key_past_the_bound", "capturing"])
def test_graphs_released_by_training_and_past_the_key_bound(tiny_models, monkeypatch, case):
    unet, graphs = tiny_models.unet, tiny_models.unet._graphs
    emptied = []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: case == "capturing")
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(1))
    g = torch.Generator().manual_seed(0)
    x, ctx = torch.randn(1, 2, 16, 16, 4, generator=g), torch.randn(1, 77, 32, generator=g)
    try:
        graphs.entries.update({("a key", n): GC.Entry() for n in range(G.MAX_KEYS)})
        graphs.pool, graphs.staging = "a pool", torch.empty(8, dtype=torch.uint8)
        with torch.no_grad():
            unet(x, 981, ctx)  # inference on the CPU: the graphs are left as they are
        assert len(graphs.entries) == G.MAX_KEYS and graphs.pool is not None and not emptied
        if case == "grad_forward":
            unet(x, 981, ctx)
        elif case == "trainer_step":
            trainer = DDPMTrainer(unet, tiny_models.vae, schedule=tiny_models.schedule, learning_rate=1e-5)
            trainer.step(trainer.init_state(), torch.rand(2, 64, 64, 3) * 2 - 1, ctx, g)
        else:  # a new static key past the bound (its warm-up forward runs eagerly), or a capture under way
            with torch.no_grad():
                graphs.forward(unet, x, 981, ctx, None, 0, None)
        if case == "capturing":
            assert len(graphs.entries) == G.MAX_KEYS + 1 and graphs.pool is not None and not emptied
        else:
            assert graphs.pool is None and graphs.staging is None and emptied == [1]
            assert len(graphs.entries) == (1 if case == "key_past_the_bound" else 0)
    finally:
        graphs.entries.clear()
        graphs.pool = graphs.staging = None


def test_only_an_eager_module_runs_between_the_pieces(tiny):
    block = tiny.down_blocks[0].attentions[0].transformer_blocks[0]
    assert all(isinstance(m, G.EagerModule) for m in (block.attn1, block.attn2, block.attn_temporal))
    x = torch.randn(1, 2, 4, block.norm1.weight.shape[0])
    with torch.no_grad():
        assert torch.equal(G.run_eager(block.attn_temporal, x), block.attn_temporal(x))
    with pytest.raises(TypeError, match="EagerModule"):
        G.run_eager(block.ff, x)
    layout = G._Layout(tiny)
    assert block.ff in layout.piece_modules and block.norm1 in layout.piece_modules
    assert not any(isinstance(m, G.EagerModule) or m is tiny for m in layout.piece_modules)
    assert block.attn1.to_q not in layout.piece_modules


def test_cpu_forward_is_the_eager_one(tiny):
    g = torch.Generator().manual_seed(0)
    x, ctx = torch.randn(2, 2, 16, 16, 4, generator=g), torch.randn(2, 77, 32, generator=g)
    calls = []
    handle = tiny.down_blocks[0].attentions[0].transformer_blocks[0].attn2.register_forward_hook(
        lambda *a: calls.append(1))
    try:
        with torch.inference_mode():
            out = tiny(x, 981, ctx)
            ref = tiny._forward(x, torch.as_tensor(981), ctx, None, 0, None)
    finally:
        handle.remove()
    assert torch.equal(out, ref) and len(calls) == 2
    assert not tiny._graphs.entries and tiny._graphs.pool is None and tiny._graphs.staging is None


# ---------------------------------------------------------------------- card

SRC = "a silver jeep driving down a curvy road"
TGT = "watercolor painting of a silver jeep driving down a curvy road"
STEPS, FRAMES, LATENT = 4, 2, 64


def _edit(pipe, tok, mode, graphed: bool):
    """One edit of `mode` with spans collected: what the two runs compare."""
    from fatezero_tpu_torch.ptp.controller import make_controller

    mode, k4 = mode.split("-")[0], mode.endswith("-k4")
    unet = pipe.unet
    off = None if graphed else unet.conv_in.register_forward_hook(lambda *a: None)
    hooked = []
    handles = [m.register_forward_hook(lambda *a: hooked.append(1))
               for n, m in unet.named_modules() if n.rsplit(".", 1)[-1] in ("attn1", "attn2")]
    g = torch.Generator(device="cuda").manual_seed(3)
    lat = torch.randn(1, FRAMES, LATENT, LATENT, 4, generator=g, device="cuda")
    ctl = make_controller(tok, [SRC, TGT], num_steps=STEPS, is_replace_controller=False, cross_replace_steps=0.8,
                          self_replace_steps=0.8, use_inversion_attention=mode != "replay")
    launched, k4_launched = FA.flash_forward.launches, layer_norm_kernel.launches
    profiling.reset()
    if k4:
        os.environ["FZ_PALLAS_LN"] = "1"
    try:
        acts = [torch.profiler.ProfilerActivity.CPU] + [torch.profiler.ProfilerActivity.CUDA] * k4
        with torch.profiler.profile(activities=acts) as prof:
            emb_src, emb_tgt = pipe.encode_prompt(SRC), pipe.encode_prompt(TGT)
            if mode == "stored":
                traj, stored = pipe.invert_fast(lat, emb_src, STEPS, capture=True)
            else:
                traj, stored = pipe.invert_fast(lat, emb_src, STEPS), None
            latent, _ = pipe.edit_fast(traj, emb_src, emb_tgt, ctl, STEPS, 7.5, stored=stored, viz=mode == "stored")
            torch.cuda.synchronize()
    finally:
        os.environ.pop("FZ_PALLAS_LN", None)
        for h in handles + ([off] if off is not None else []):
            h.remove()
    seen = profiling.recorded()
    k4_traced = k4_in_forwards = 0
    if k4:  # K4's kernels on the device, and those launched inside a UNet forward (eagerly or by a replay)
        launched_at, forwards, kernels = {}, [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if "layer_norm_kernel" in e.name() and "native" not in e.name():
                    kernels.append(e.correlation_id())
            elif e.name() == "fz.unet.forward":
                forwards.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            elif e.name().startswith("cu"):
                launched_at[e.correlation_id()] = e.start_ns()
        k4_traced = len(kernels)
        k4_in_forwards = sum(any(s <= launched_at.get(c, -1) < e for s, e in forwards) for c in kernels)
    payload = [] if stored is None else [
        t.float().cpu() for grp in stored.values() for lst in grp.values()
        for item in lst for t in (item if isinstance(item, (tuple, list)) else [item])]
    return dict(traj=traj.float().cpu(), latent=latent.float().cpu(), payload=payload,
                k1=FA.flash_forward.launches - launched, hooks=len(hooked),
                k4=layer_norm_kernel.launches - k4_launched, k4_traced=k4_traced, k4_in_forwards=k4_in_forwards,
                sites=seen["spans"].get("fz.ptp.site", {}).get("calls", 0),
                materialised=seen["counters"].get("ptp.materialised", 0),
                graphed=seen["counters"].get("unet.graphed", 0), forwards=seen["spans"]["fz.unet.forward"]["calls"])


def _close(a, b):
    return torch.equal(a, b) or float((a - b).norm() / b.norm().clamp_min(1e-30)) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["random:tiny", "random:tiny-xl"])
def test_piecewise_edits_match_eager_ones_on_the_card(model):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the flash kernels have no CPU mode)")
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline, PromptEmbeds

    m = load_models(model, dtype=torch.bfloat16, seed=0, device="cuda")
    xl = {n: getattr(m, n, None) for n in ("text_encoder_2", "tokenizer_2")}
    pipe = FateZeroPipeline(m.unet, m.vae, m.text_encoder, m.tokenizer, schedule=m.schedule,
                            store_dtype=torch.bfloat16, device="cuda", **xl)
    for mode in ("stored", "inline", "replay", "stored-k4"):
        eager, graphed = _edit(pipe, m.tokenizer, mode, False), _edit(pipe, m.tokenizer, mode, True)
        stored = mode.startswith("stored")
        print(f"[unet-graph] {model} {mode}: forwards {graphed['forwards']}, graphed {graphed['graphed']}, "
              f"K1 {graphed['k1']}, K4 {graphed['k4']} ({graphed['k4_traced']} traced, {graphed['k4_in_forwards']} "
              f"in UNet forwards), sites {graphed['sites']}, "
              f"materialised {graphed['materialised']}, "
              f"latent gap {float((graphed['latent'] - eager['latent']).abs().max()):.3e}")
        assert eager["graphed"] == 0 and graphed["graphed"] >= graphed["forwards"] - 4  # a warm-up a key
        assert _close(graphed["traj"], eager["traj"]) and _close(graphed["latent"], eager["latent"])
        assert len(graphed["payload"]) == len(eager["payload"]) == (len(eager["payload"]) if stored else 0)
        assert all(_close(a, b) for a, b in zip(graphed["payload"], eager["payload"]))
        for n in ("k1", "k4", "k4_traced", "k4_in_forwards", "sites", "materialised", "hooks", "forwards"):
            assert graphed[n] == eager[n], n
        assert eager["k1"] > 0 and eager["sites"] > 0 and eager["hooks"] > 0
        # every forward runs each of the UNet's LayerNorms once (a stored edit drops no rows)
        layer_norms = sum(isinstance(x, FusedLayerNorm) for x in m.unet.modules())
        assert graphed["k4_in_forwards"] == (graphed["forwards"] * layer_norms if mode.endswith("-k4") else 0)
        assert (graphed["k4"] > graphed["k4_in_forwards"]) if mode.endswith("-k4") else graphed["k4"] == 0
        if stored:
            assert eager["payload"] and eager["materialised"] > 0
    # weights changed after the captures: swapped for new objects, then in place
    conv = m.unet.conv_out
    for change in (lambda: setattr(conv, "weight", torch.nn.Parameter(conv.weight.detach() * 1.5)),
                   lambda: conv.weight.data.mul_(0.5)):
        with torch.no_grad():
            change()
        eager, graphed = _edit(pipe, m.tokenizer, "inline", False), _edit(pipe, m.tokenizer, "inline", True)
        assert graphed["graphed"] > 0 and _close(graphed["latent"], eager["latent"])
    # training: a forward with grad on releases every graph and the memory the pool reserved
    graphs = m.unet._graphs
    assert graphs.pool is not None and 0 < len(graphs.entries) <= G.MAX_KEYS
    reserved = torch.cuda.memory_reserved()
    emb = pipe.encode_prompt(SRC)[-1:]  # an inference tensor: cloned, so that autograd may keep it
    emb = PromptEmbeds(emb.context.clone(), emb.pooled.clone()) if isinstance(emb, PromptEmbeds) else emb.clone()
    with torch.enable_grad():
        pipe._unet(torch.randn(1, FRAMES, 8, 8, 4, device="cuda", dtype=torch.bfloat16), 981, emb)
    torch.cuda.synchronize()
    print(f"[unet-graph] {model}: reserved {reserved / 2**30:.3f} GiB with the graphs, "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB after a grad forward released them")
    assert graphs.pool is None and not graphs.entries and torch.cuda.memory_reserved() < reserved
