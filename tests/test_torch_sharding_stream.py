"""The streaming store on a device mesh (ptp/store.py, FateZeroPipeline.invert/sample) against one process, on the CPU.

Ranks are gloo processes spawned by fatezero_tpu_torch/scripts/dryrun_mesh.py
(`launch`), one launch per mesh shared by the file's tests through a module
fixture; the world of one runs in the test process on a one-process
`Mesh((1,1,1))`. fp32, the random:tiny geometry with the teaser's switches
(LoRA 160, ['mid'], least_sc_channel 64), every UNet weight redrawn with
fan-in scaling (as tests/test_torch_sharding.py), 4 frames of 128^2 (16^2
unit-normal latents), 2 DDIM steps, the cross attention's q and k drawn 3x
larger (as tests/test_torch_streaming.py), so that the blend masks vary, and
the embeddings drawn from numpy (the stub tokenizer's ids follow each
process's hash seed).

Tolerances: the streaming edit's own sensitivity is the yardstick. One fp32
ulp added to the latents moves a world of one's edit by 5e-6 to 2e-5 of its
largest value on these weights (the sharpened cross attention amplifies it),
and the sums over ranks, or the two packages' sums, move it as much; so
trajectories, edits and maps are held to TOL = 1e-4 of their largest value,
as tests/test_torch_streaming.py holds trajectories.

* `stream_job` on (1,2,2): `invert(store=...)`, then `sample` with the
  teaser's refine + reweight controller and with a replace controller with
  both blends, against the world of one: trajectory, edit and the average
  cross attention gathered whole within TOL, the blenders' masks exactly
  (each normalised map of the world of one keeps clear of its threshold by
  BAND, so no pixel could flip); each rank's bytes a step as `store_step_bytes` predicts, to
  the byte, and the four ranks' sum the world of one's; the disk store's
  pickles, one per rank and step, distinct, and its edit the memory store's
  bit for bit.
* A store filled on (1,2,2) with each rank's frames and heads of known maps:
  `get_average_attention(CROSS_KEYS)` returns the cross maps' average whole,
  exactly, and no self map crosses the ranks.
* The JAX package's pipeline sharded over (1,2,2) of the 8 virtual XLA
  devices: its streaming `invert(store=...)` and `sample` with the teaser's
  controller, on the same weights, latents and embeddings, against the
  port's ranks within TOL.
* The edit CLI's four streaming branches (disk_store, save_attention_maps,
  the save/swap edit, generation mode) on config/demo_tiny.yaml cut to 2
  frames of 64^2 and 2 steps, on a (1,2,2) mesh: both ranks agree on rank
  0's folder, which alone exists and holds the world of one's artifact names
  (the disk store's pickles keyed by rank), and every rank's videos are
  those of a world of one (spawned under the ranks' hash seed) within TOL.
"""
import os

import numpy as np
import pytest
import torch

from fatezero_tpu_torch.convert.to_flax import unet_state_to_flax
from fatezero_tpu_torch.parallel.sharding import Mesh, tensor_block
from fatezero_tpu_torch.ptp.context import STORE_KEYS
from fatezero_tpu_torch.ptp.store import CROSS_KEYS, AttentionStore
from fatezero_tpu_torch.scripts import dryrun_mesh as D
from fatezero_tpu_torch.pipelines import fatezero_pipeline as FP
from test_torch_sharding import TEASER, _cli_config, _fan_in_state

torch.set_num_threads(1)
# The JAX package is imported inside the tests that run it: the spawned ranks
# import this module for their functions and need only the port.
FRAMES, RES, STEPS = 4, 128, 2
EDITS = {
    "teaser": dict(TEASER, mode="stored"),
    "replace_blends": dict(is_replace_controller=True, cross_replace_steps=0.5, self_replace_steps=0.5,
                           blend_words=[["jeep"], ["jeep"]], blend_latents=True, blend_self_attention=True,
                           mode="stored"),
}
BRANCHES = {
    "disk_store": {"disk_store": True},
    "save_attention_maps": {"editing_config": {"save_attention_maps": True}},
    "save_swap": {"editing_config": {"use_inversion_attention": False}},
    "generation": {"editing_config": {"use_invertion_latents": False, "use_inversion_attention": False}},
}
TOL = 1e-4  # of the largest value: 5x the edit's largest one-ulp sensitivity
BAND = 1e-4


def _branch_config(cfg, over, logdir=None):
    d = dict(cfg, editing_config={**cfg["editing_config"], **over.get("editing_config", {})})
    d.update({k: v for k, v in over.items() if k != "editing_config"})
    if logdir is not None:
        d["logdir"] = logdir
    return d


# ------------------------------------------------------------ rank functions
def _probe_maps(steps=2, frames=4, heads=4, s=6):
    """Known whole maps [1, f, heads, s, kv] per step and key (kv 5 for the
    cross maps, s for the self maps), from numpy."""
    rng = np.random.default_rng(3)
    return [{k: torch.from_numpy(rng.standard_normal(
        (1, frames, heads, s, 5 if k in CROSS_KEYS else s)).astype(np.float32)) for k in STORE_KEYS}
        for _ in range(steps)]


def _average_probe(mesh):
    """A store on the mesh fed this rank's frames and heads of `_probe_maps`:
    the cross average it assembles, and the shapes of the buffers summed
    across ranks meanwhile."""
    store = AttentionStore(mesh=mesh)
    for maps in _probe_maps():
        store.append_step({k: [tensor_block(mesh.local_frames(m), 2, mesh=mesh)] for k, m in maps.items()},
                          torch.zeros(1))
    summed, plain_sum = [], mesh._sum
    mesh._sum = lambda buf, axis: (summed.append(tuple(buf.shape)), plain_sum(buf, axis))[1]
    try:
        avg = store.get_average_attention(CROSS_KEYS)
    finally:
        del mesh._sum
    return dict(average=avg, summed=summed)


def _rank(mesh, path, disk_dir, cli_args):
    from fatezero_tpu_torch.cli import edit as cli

    out = {name: D.stream_job(mesh, path, edit=name)["float32"] for name in EDITS}
    out["probe"] = _average_probe(mesh)
    out["disk"] = D.stream_job(mesh, path, edit="teaser", disk_dir=disk_dir)["float32"]
    cfg, cwd = cli_args
    os.chdir(cwd)
    out["cli"] = {}
    for name, over in BRANCHES.items():
        d = _branch_config(cfg, over)
        d["config"] = f"{name}.yaml"
        logdir, videos = cli.run(d, mesh=",".join(map(str, mesh.shape)), device="cpu")
        out["cli"][name] = dict(logdir=logdir, videos=videos)
    return out


def _single_cli(mesh, cfg, root):
    """In a spawned world of one (the ranks' hash seed: the stub tokenizer's
    ids follow it), each branch through the CLI without a mesh."""
    from fatezero_tpu_torch.cli import edit as cli

    return {name: cli.test(**_branch_config(cfg, over, os.path.join(root, name)), device="cpu")
            for name, over in BRANCHES.items()}


# ------------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream")
    path = D.prepare(str(tmp / "inputs.pt"), frames=FRAMES, res=RES, steps=STEPS, edits=EDITS)
    data = torch.load(path, weights_only=False)
    # the cross attention's q and k 3x larger (as tests/test_torch_streaming.py), so that the blend masks vary
    data["unet"] = {k: 3.0 * v if ".attn2.to_q." in k or ".attn2.to_k." in k else v
                    for k, v in _fan_in_state(data["unet"]).items()}
    # embeddings from numpy: the stub tokenizer's would follow this process's hash seed
    rng = np.random.default_rng(7)
    for key in ("emb_src", "emb_tgt"):
        data[key] = torch.from_numpy(rng.standard_normal(tuple(data[key].shape)).astype(np.float32))
    torch.save(data, path)
    cfg = _cli_config(tmp)
    (tmp / "work").mkdir()
    ranks = D.launch(_rank, (1, 2, 2), "cpu", args=(path, str(tmp / "disk"), (cfg, str(tmp / "work"))),
                     workdir=str(tmp))
    one = Mesh((1, 1, 1), "cpu")
    from test_torch_edit_modes import _Thresholds  # imports the JAX package, which the ranks need not

    thresholds, original = _Thresholds(), FP.blend_mask
    FP.blend_mask = thresholds
    try:
        single = {name: D.stream_job(one, path, edit=name)["float32"] for name in EDITS}
    finally:
        FP.blend_mask = original
    single["margin"] = thresholds.margin()
    single["cli"] = D.launch(_single_cli, (1, 1, 1), "cpu", args=(cfg, str(tmp / "single")), workdir=str(tmp))[0]
    return dict(path=path, ranks=ranks, single=single, work=tmp / "work", disk=tmp / "disk")


def _close(got, ref):
    torch.testing.assert_close(got, ref, atol=TOL * float(ref.abs().max()), rtol=0)


# --------------------------------------------------------------------- tests
@pytest.mark.parametrize("edit", list(EDITS))
def test_streaming_edit_matches_one_process(run, edit):
    ref = run["single"][edit]
    assert tuple(ref["edited"].shape) == (1, FRAMES, RES // 8, RES // 8, 4) and bool(torch.isfinite(ref["edited"]).all())
    assert tuple(ref["traj"].shape) == (STEPS + 1, 1, FRAMES, RES // 8, RES // 8, 4)
    for rank in run["ranks"]:
        got = rank[edit]
        assert got["local_frames"] == FRAMES // 2
        _close(got["traj"], ref["traj"])
        _close(got["edited"], ref["edited"])
        for key, maps in ref["average"].items():
            assert len(got["average"][key]) == len(maps)
            for a, b in zip(got["average"][key], maps):
                assert a.shape == b.shape
                _close(a, b)


def test_blend_masks_record_the_whole_clip(run):
    """The streaming edit's blenders record every step's mask of every frame,
    on every rank, as the world of one's. Each mask thresholds m / max(m):
    every normalised map of the world of one keeps clear of its threshold by
    BAND, far beyond the ranks' rounding, so no pixel could flip."""
    ref = run["single"]["replace_blends"]["masks"]
    assert set(ref) == {"attention_blend", "latent_blend"}
    assert 0.0 < np.mean(ref["latent_blend"]) < 1.0, "the masks must vary for this test to see them"
    assert run["single"]["margin"] > BAND
    for rank in run["ranks"]:
        got = rank["replace_blends"]["masks"]
        for key, masks in ref.items():
            assert len(got[key]) == len(masks) == STEPS
            for x, y in zip(got[key], masks):
                assert x.shape == y.shape and x.shape[-3] == FRAMES
                np.testing.assert_array_equal(x, y)


def test_store_bytes_per_rank(run):
    """Each rank stores its frames and heads of every map, as predicted to the
    byte; the four ranks' bytes sum to the world of one's."""
    ranks, single = run["ranks"], run["single"]["teaser"]
    assert len(set(single["step_bytes"])) == 1 and single["step_bytes"][0] == single["step_bytes_predicted"]
    for rank in ranks:
        got = rank["teaser"]
        assert got["step_bytes"] == [got["step_bytes_predicted"]] * STEPS
    assert sum(r["teaser"]["step_bytes"][0] for r in ranks) == single["step_bytes"][0]
    assert all(r["teaser"]["step_bytes"][0] == single["step_bytes"][0] // 4 for r in ranks)


def test_average_gathers_only_the_chosen_maps(run):
    """`get_average_attention(CROSS_KEYS)` on a mesh: the cross maps' average
    whole on every rank, exactly (a sum over zero-padded slots), and only
    cross-sized buffers summed across ranks: the self maps stay on their
    rank."""
    steps = _probe_maps()
    whole = {k: sum(step[k] for step in steps) / len(steps) for k in CROSS_KEYS}
    for rank in run["ranks"]:
        got = rank["probe"]
        assert set(got["average"]) == set(CROSS_KEYS)
        for k, ref in whole.items():
            assert len(got["average"][k]) == 1
            torch.testing.assert_close(got["average"][k][0], ref, atol=0, rtol=0)
        assert got["summed"], "the cross maps must cross the ranks"
        assert all(shape[-1] == 5 for shape in got["summed"]), got["summed"]


def test_disk_store_pickles_per_rank(run):
    ranks = run["ranks"]
    names = [r["disk"]["pickles"] for r in ranks]
    assert [n for rank in names for n in rank] == [f"{s:03d}.rank{r}.pkl" for r in range(4) for s in range(STEPS)]
    assert sorted(os.listdir(run["disk"])) == sorted(n for rank in names for n in rank)
    for rank in ranks:
        assert torch.equal(rank["disk"]["edited"], rank["teaser"]["edited"])


def test_streaming_edit_matches_jax_sharded(run):
    """The JAX package's pipeline sharded over (1,2,2) of the 8 virtual XLA
    devices: the streaming inversion into its store, then the teaser's edit
    against it, on the port's weights, latents and embeddings."""
    import jax
    import jax.numpy as jnp

    from fatezero_tpu.models.tokenizer import StubTokenizer as JStubTokenizer
    from fatezero_tpu.models.unet3d import UNet3DConfig as JConfig
    from fatezero_tpu.models.unet3d import UNetPseudo3DConditionModel as JUNet
    from fatezero_tpu.parallel.sharding import make_mesh as jmake_mesh
    from fatezero_tpu.pipelines.fatezero_pipeline import FateZeroPipeline as JPipeline
    from fatezero_tpu.ptp.controller import make_controller as jmake_controller
    from fatezero_tpu.ptp.store import AttentionStore as JStore

    data = torch.load(run["path"], weights_only=False)
    cfg = data["unet_cfg"]
    jcfg = JConfig(block_out_channels=cfg.block_out_channels, attention_head_dim=cfg.attention_head_dim,
                   cross_attention_dim=cfg.cross_attention_dim, norm_num_groups=cfg.norm_num_groups,
                   lora=cfg.lora, sparse_causal_indices=cfg.sparse_causal_indices,
                   least_sc_channel=cfg.least_sc_channel)
    params = unet_state_to_flax({k: v.numpy() for k, v in data["unet"].items()})
    tok = JStubTokenizer(vocab_size=1000)
    kw = {k: v for k, v in EDITS["teaser"].items() if k != "mode"}
    jctl = jmake_controller(tok, [D.SOURCE, D.TARGET], num_steps=STEPS, **kw)
    mesh = jmake_mesh(jax.devices()[:4], (1, 2, 2))
    jpipe = JPipeline(JUNet(cfg=jcfg), params, None, None, None, None, tok, store_dtype=jnp.float32).shard(mesh)
    lat = jnp.asarray(data["latents"].numpy())
    emb_src, emb_tgt = (jnp.asarray(data[k].numpy()) for k in ("emb_src", "emb_tgt"))
    jstore = JStore()
    jtraj = jpipe.invert(lat, emb_src, STEPS, store=jstore)
    jout = np.asarray(jpipe.sample(jtraj[-1], emb_tgt, STEPS, controller=jctl, inv_store=jstore,
                                   inverted_latents=jtraj))
    jtraj = np.stack([np.asarray(t) for t in jtraj])
    for rank in run["ranks"]:
        np.testing.assert_allclose(rank["teaser"]["traj"].numpy(), jtraj, atol=TOL * np.abs(jtraj).max(), rtol=0)
        np.testing.assert_allclose(rank["teaser"]["edited"].numpy(), jout, atol=TOL * np.abs(jout).max(), rtol=0)


def _names(root):
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_edit_cli_streaming_branch_on_a_mesh(run, branch):
    """`cli.edit.run(..., mesh='1,2,2')`: every rank agrees on rank 0's
    folder, which alone exists and holds the world of one's artifacts (the
    disk store's pickles, one per rank and step, keyed by rank); every rank's
    videos are the world of one's."""
    logdirs = [r["cli"][branch]["logdir"] for r in run["ranks"]]
    assert len(set(logdirs)) == 1
    assert os.listdir(run["work"] / "result" / branch) == [os.path.basename(logdirs[0])]
    single_dir, single_videos = run["single"]["cli"][branch]
    names = _names(os.path.join(run["work"], logdirs[0]))
    ref = _names(single_dir)
    if branch == "disk_store":
        pickles = [n for n in ref if n.endswith(".pkl")]
        assert pickles == ["000.pkl", "001.pkl"]
        assert [n for n in names if n.endswith(".pkl")] == sorted(
            f"{n[:-4]}.rank{r}.pkl" for n in pickles for r in range(4))
        names = [n for n in names if not n.endswith(".pkl")]
        ref = [n for n in ref if not n.endswith(".pkl")]
    assert names == ref
    for rank in run["ranks"]:
        videos = rank["cli"][branch]["videos"]
        assert len(videos) == len(single_videos) > 0
        for a, b in zip(videos, single_videos):
            assert a.shape == b.shape and np.isfinite(a).all()
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
