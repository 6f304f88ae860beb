"""The edit on a device mesh (fatezero_tpu_torch/parallel/sharding.py) against one process, on the CPU.

Ranks are gloo processes spawned by fatezero_tpu_torch/scripts/dryrun_mesh.py
(`launch`: the spawn start method, a file:// store under a tmp dir, so xdist
workers never share a port), one launch per mesh shared by the file's tests
through module fixtures. fp32, the random:tiny geometry with the teaser's
switches (LoRA, ['mid'], least_sc_channel 64), 4 frames of 128^2 (16^2
unit-normal latents, as bench.py draws them), 2 DDIM steps. The parent draws the weights and builds the embeddings and
controllers once (dryrun_mesh.prepare), so every rank and the one-process
reference read the same inputs whatever their hash seeds.

* (1,2,1) and (1,4,1): the halo gather of the sparse-causal KV against the
  dense gather, and the re-gather of a stored K, bit for bit, for the specs
  [-1, 'first'], ['mid'], [-2, 'last'] and [1], and a hop past the
  neighbour (the gather of every frame); on (1,2,1) also the edit CLI under
  `--mesh`, whose rank 0 alone writes the run's folder.
* (1,2,2): the temporal conv (stride 1 and 2), the frame resamplers, the
  GroupNorm over frames, the head-split attention (sparse-causal self and
  cross), the temporal attention and the GEGLU feed-forward against one
  process within 1e-5; one UNet forward, `invert_fast(capture=True)` and
  `edit_fast` stored, replay, hybrid and inline, with both blends and viz,
  within 1e-5 of the largest magnitude; the stored edit against the JAX
  package's `FateZeroPipeline.shard(make_mesh(shape=(1,2,2)))` within the
  tolerances of tests/test_torch_pipeline.py; each rank's
  `capture_payload_bytes` against the bytes it holds, to the byte; and the
  guards: a frame count the mesh does not divide, a head count it does not
  divide, a UNet run on a mesh it was not split for, a collective on a torn
  down group, a mesh larger than the processes without a process group.
* The install check (scripts/check_install.py) runs its main here, the
  training collectives' backward in its gloo world of one included.

Every sum over ranks runs in another order than the one process's sums, so
the module and edit outputs agree to rounding (measured ~1e-6 relative),
not bit for bit; data movement (the gathers) is exact.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fatezero_tpu.models.tokenizer import StubTokenizer as JStubTokenizer
from fatezero_tpu.models.unet3d import UNet3DConfig as JConfig
from fatezero_tpu.models.unet3d import UNetPseudo3DConditionModel as JUNet
from fatezero_tpu.parallel.sharding import make_mesh as jmake_mesh
from fatezero_tpu.pipelines.fatezero_pipeline import FateZeroPipeline as JPipeline
from fatezero_tpu.ptp.controller import make_controller as jmake_controller
from fatezero_tpu_torch.convert.to_flax import unet_state_to_flax
from fatezero_tpu_torch.models.attention import Attention, TemporalAttention
from fatezero_tpu_torch.models.layers import FeedForward, FusedGroupNorm
from fatezero_tpu_torch.ops import video_ops as V
from fatezero_tpu_torch.parallel.sharding import (
    Mesh,
    make_mesh,
    mesh_from_config,
    seq_mesh_scope,
    shard_unet_,
)
from fatezero_tpu_torch.scripts import dryrun_mesh as D

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, RES, STEPS = 4, 128, 2
SPECS = {"prev_first": [-1, "first"], "mid": ["mid"], "prev2_last": [-2, "last"], "next": [1]}
TEASER = dict(is_replace_controller=False, cross_replace_steps=0.8, self_replace_steps=0.8,
              eq_params={"words": ["watercolor"], "values": [10]})
BLENDS = dict(TEASER, blend_words=[["jeep"], ["jeep"]], blend_latents=True, blend_self_attention=True)
EDITS = {
    "stored": dict(TEASER, mode="stored"),
    "stored_blends": dict(BLENDS, mode="stored", viz=True),
    "replay_blends": dict(BLENDS, mode="replay"),
    "hybrid_blends": dict(BLENDS, mode="hybrid"),
    "inline_latent_blend": dict(TEASER, blend_words=[["jeep"], ["jeep"]], blend_latents=True, mode="inline"),
}
TOL = 1e-5


def _draw(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# ------------------------------------------------------------ rank functions
def _halo_rank(mesh, frames, cli_args=None):
    """In a rank: each spec's halo gather and stored-K re-gather (gathered over
    'seq') beside the dense forms of one process; then, given `cli_args`, the
    edit CLI on this mesh."""
    rng = np.random.default_rng(7)
    kv = _draw(rng, 2, frames, 3, 4)
    out = {}
    specs = dict(SPECS, hop=[-(frames // mesh.seq) - 1, "first"])
    for name, spec in specs.items():
        dense = V.gather_sparse_kv(kv, spec, frames)
        refs = V.referenced_frames(frames, spec)
        sel = kv[:, refs].reshape(2, len(refs), 3, 2, 2).transpose(2, 3)  # head-split [b, n_ref, h, s, d]
        dense_re = V.regather_headsplit_kv(sel, spec, frames, 2)
        with seq_mesh_scope(mesh):
            local = mesh.local_frames(kv)
            halo = mesh.all_frames(V.gather_sparse_kv(local, spec, frames))
            mine = V.local_referenced_frames(frames, spec)
            sel_local = local[:, mine].reshape(2, len(mine), 3, 2, 2).transpose(2, 3)
            regathered = mesh.all_frames(V.regather_headsplit_kv(sel_local, spec, frames, 2))
        out[name] = dict(dense=dense, halo=halo, dense_re=dense_re, regathered=regathered, stored=len(mine))
    if cli_args is not None:
        from fatezero_tpu_torch.cli import edit as cli

        cfg, cwd = cli_args
        os.chdir(cwd)
        logdir, videos = cli.run(cfg, mesh=",".join(map(str, mesh.shape)), device="cpu")
        out["cli"] = dict(logdir=logdir, videos=videos)
    return out


def _module_cases(mesh, rng):
    """(name, one-process module call, sharded module call, input) of each module held here."""
    x5 = _draw(rng, 2, FRAMES, 3, 3, 8)
    w, b = _draw(rng, 3, 8, 6), _draw(rng, 6)
    cases = [
        ("temporal_conv", lambda x: V.temporal_conv(x, w, b), None, x5),
        ("temporal_conv_stride2", lambda x: V.temporal_conv(x, w, b, stride=2), None, x5),
        ("temporal_avgpool", V.temporal_avgpool, None, x5),
        ("temporal_upsample", V.temporal_linear_upsample_2x, None, x5),
    ]
    gn = FusedGroupNorm(4, 8, batch_dims=1)
    with torch.no_grad():
        gn.weight.copy_(1.0 + 0.1 * _draw(rng, 8))
        gn.bias.copy_(0.1 * _draw(rng, 8))
    cases.append(("group_norm_over_frames", gn, None, 2.0 * x5 + 1.0))
    torch.manual_seed(3)
    attn = Attention(16, 4, 4)
    cross = Attention(16, 4, 4, cross_attention_dim=12)
    temporal = TemporalAttention(16, 4, 4)
    torch.nn.init.normal_(temporal.to_out[0].weight, std=0.2)
    torch.nn.init.normal_(temporal.to_out[0].bias, std=0.2)
    ff = FeedForward(16)
    x4 = _draw(rng, 2, FRAMES, 6, 16)
    ctx = _draw(rng, 2, 5, 12)
    for module, name, call in (
        (attn, "attention_prev_first", lambda m, x: m(x, sparse_indices=[-1, "first"])),
        (attn, "attention_mid", lambda m, x: m(x, sparse_indices=["mid"])),
        (cross, "cross_attention", lambda m, x: m(x, ctx)),
        (temporal, "temporal_attention", lambda m, x: m(x)),
        (ff, "geglu_feed_forward", lambda m, x: m(x)),
    ):
        sharded = shard_unet_(copy.deepcopy(module), mesh)
        cases.append((name, lambda x, m=module, c=call: c(m, x), lambda x, m=sharded, c=call: c(m, x), x4))
    return cases


def _mesh_rank(mesh, path):
    """In a rank of (1,2,2): the module cases, the guards, then the dry run's edits."""
    from fatezero_tpu_torch.models.loader import load_models

    out = {"modules": {}, "guards": {}}
    with torch.inference_mode():
        for name, single, sharded, x in _module_cases(mesh, np.random.default_rng(11)):
            ref = single(x)
            with seq_mesh_scope(mesh):
                got = mesh.all_frames((sharded or single)(mesh.local_frames(x)))
            out["modules"][name] = (got, ref)

    def guard(name, fn):
        try:
            fn()
            out["guards"][name] = None
        except Exception as e:  # noqa: BLE001 - the test reads the type and message
            out["guards"][name] = (type(e).__name__, str(e))

    guard("frames", lambda: mesh.local_frames(torch.zeros(1, 3, 2)))
    guard("heads", lambda: shard_unet_(Attention(16, 3, 4), mesh))
    tiny = load_models("random:tiny", D.TEASER, device="cpu").unet

    def unsplit_unet():
        with seq_mesh_scope(mesh), torch.inference_mode():
            tiny(torch.zeros(1, 2, 8, 8, 4), 1, torch.zeros(1, 77, 32))

    guard("unsplit_unet", unsplit_unet)
    out["edit"] = D.edit_job(mesh, path, unet_pass=True)["float32"]

    def torn_down():
        torch.distributed.destroy_process_group()
        mesh.seq_sum(torch.ones(2))

    guard("collective", torn_down)
    return out


# ------------------------------------------------------------------ fixtures
def _cli_config(tmp_path):
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(frames / f"{i:05d}.png")
    from fatezero_tpu_torch.common.config import load_config

    d = load_config(os.path.join(REPO, "config", "demo_tiny.yaml")).to_dict()
    d["dataset_config"].update(path=str(frames), n_sample_frame=2, sampling_rate=1, image_size=64)
    d["editing_config"].update(num_inference_steps=2, clip_length=2)
    d["config"] = "demo_tiny.yaml"
    return d


@pytest.fixture(scope="module")
def halo2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("halo2")
    cfg = _cli_config(tmp)
    (tmp / "work").mkdir()
    ranks = D.launch(_halo_rank, (1, 2, 1), "cpu", args=(FRAMES, (cfg, str(tmp / "work"))), workdir=str(tmp))
    from fatezero_tpu_torch.cli import edit as cli

    single, _ = cli.test(**dict(cfg, logdir=str(tmp / "single")), device="cpu")
    return dict(ranks=ranks, work=tmp / "work", single=single)


@pytest.fixture(scope="module")
def halo4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("halo4")
    return D.launch(_halo_rank, (1, 4, 1), "cpu", args=(FRAMES,), workdir=str(tmp))


def _fan_in_state(state, seed=3):
    """Every UNet weight drawn from numpy as tests/test_torch_pipeline.py draws
    its flax leaves: kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.01),
    biases N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sorted(state.items()):
        if k.endswith("bias"):
            w = 0.1 * rng.standard_normal(tuple(v.shape))
        elif v.dim() == 1:
            w = 1.0 + 0.1 * rng.standard_normal(tuple(v.shape))
        else:
            w = rng.standard_normal(tuple(v.shape)) / np.sqrt(np.prod(v.shape[1:]))
        out[k] = torch.from_numpy(w.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def mesh122(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh122")
    path = D.prepare(str(tmp / "inputs.pt"), frames=FRAMES, res=RES, steps=STEPS, edits=EDITS)
    data = torch.load(path, weights_only=False)
    data["unet"] = _fan_in_state(data["unet"])
    torch.save(data, path)
    ranks = D.launch(_mesh_rank, (1, 2, 2), "cpu", args=(path,), workdir=str(tmp))
    single = D.edit_job(Mesh((1, 1, 1), "cpu"), path, unet_pass=True)["float32"]
    return dict(ranks=ranks, single=single, path=path)


# --------------------------------------------------------------------- tests
@pytest.mark.parametrize("spec", list(SPECS) + ["hop"])
@pytest.mark.parametrize("mesh", ["halo2", "halo4"])
def test_halo_gather_matches_dense(mesh, spec, request):
    for rank in request.getfixturevalue(mesh)["ranks"] if mesh == "halo2" else request.getfixturevalue(mesh):
        case = rank[spec]
        assert torch.equal(case["halo"], case["dense"])
        assert torch.equal(case["regathered"], case["dense_re"])


def test_stored_k_is_split_by_owner(halo4):
    """Each referenced frame is stored once, by the rank that holds it:
    ['mid'] leaves three of four ranks none, and [-1, 'first'] the last (no
    frame reads the clip's last frame)."""
    assert [r["mid"]["stored"] for r in halo4] == [0, 1, 0, 0]
    assert [r["prev_first"]["stored"] for r in halo4] == [1, 1, 1, 0]


def test_edit_cli_on_a_mesh_writes_once(halo2):
    """`cli.edit.run(..., mesh='1,2,1')` in two gloo ranks: both ranks agree on
    rank 0's folder, which alone exists and holds the artifacts of a
    one-process run; every rank gets the whole clip's videos."""
    logdirs = [r["cli"]["logdir"] for r in halo2["ranks"]]
    assert logdirs[0] == logdirs[1]
    assert os.listdir(halo2["work"] / "result") == ["demo_tiny"]
    assert os.listdir(halo2["work"] / "result" / "demo_tiny") == [os.path.basename(logdirs[0])]

    def names(root):
        return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)

    assert names(os.path.join(halo2["work"], logdirs[0])) == names(halo2["single"])
    for rank in halo2["ranks"]:
        videos = rank["cli"]["videos"]
        assert len(videos) == 2 and all(v.shape == (2, 64, 64, 3) and np.isfinite(v).all() for v in videos)
    for a, b in zip(*(r["cli"]["videos"] for r in halo2["ranks"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["temporal_conv", "temporal_conv_stride2", "temporal_avgpool", "temporal_upsample",
                                  "group_norm_over_frames", "attention_prev_first", "attention_mid",
                                  "cross_attention", "temporal_attention", "geglu_feed_forward"])
def test_module_matches_one_process(mesh122, name):
    for rank in mesh122["ranks"]:
        got, ref = rank["modules"][name]
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, atol=TOL, rtol=TOL)


def _close(got, ref):
    torch.testing.assert_close(got, ref, atol=TOL * float(ref.abs().max()), rtol=0)


def test_unet_forward_matches_one_process(mesh122):
    for rank in mesh122["ranks"]:
        _close(rank["edit"]["eps"], mesh122["single"]["eps"])


def test_encode_video_matches_one_process(mesh122):
    """Each rank encodes its block of the clip's frames."""
    for rank in mesh122["ranks"]:
        _close(rank["edit"]["encoded"], mesh122["single"]["encoded"])


def test_inversion_matches_one_process(mesh122):
    single = mesh122["single"]["traj"]
    assert tuple(single.shape) == (STEPS + 1, 1, FRAMES, RES // 8, RES // 8, 4)
    for rank in mesh122["ranks"]:
        assert rank["edit"]["local_frames"] == FRAMES // 2
        _close(rank["edit"]["traj"], single)


@pytest.mark.parametrize("edit", list(EDITS))
def test_edit_matches_one_process(mesh122, edit):
    ref = mesh122["single"]["edited"][edit]
    assert bool(torch.isfinite(ref).all()) and tuple(ref.shape) == (1, FRAMES, RES // 8, RES // 8, 4)
    for rank in mesh122["ranks"]:
        _close(rank["edit"]["edited"][edit], ref)
        if edit in mesh122["single"]["viz"]:
            _close(rank["edit"]["viz"][edit], mesh122["single"]["viz"][edit])


def test_payload_bytes_per_rank(mesh122):
    """Each rank predicts the bytes it holds, to the byte: 1/(seq*tensor) of
    the cross maps and q, and of the ['mid'] K only the owner's frame."""
    ranks = mesh122["ranks"]
    for rank in ranks:
        assert rank["edit"]["payload_predicted"] == rank["edit"]["payload_held"] > 0
    single = mesh122["single"]["payload_held"]
    held = [r["edit"]["payload_held"] for r in ranks]
    assert sum(held) == single  # the K dedup stores each referenced frame once
    assert max(held) < single / 2


def test_guards_raise(mesh122):
    for rank in mesh122["ranks"]:
        g = rank["guards"]
        assert g["frames"][0] == "ValueError" and "do not split over seq = 2" in g["frames"][1]
        assert g["heads"][0] == "ValueError" and "attention heads do not split over tensor = 2" in g["heads"][1]
        assert g["unsplit_unet"][0] == "RuntimeError" and "split for tensor = 1" in g["unsplit_unet"][1]
        assert g["collective"] is not None
    with pytest.raises(RuntimeError, match="needs a process group"):
        make_mesh((1, 2, 1), "cpu")
    with pytest.raises(RuntimeError, match="needs a process group"):
        mesh_from_config("1,2,2", "cpu")
    assert mesh_from_config("auto", "cpu").shape == (1, 1, 1)


def test_stored_edit_matches_jax_sharded(mesh122):
    """The JAX package's pipeline sharded over (1,2,2) of the 8 virtual XLA
    devices, on the same weights (convert/to_flax.py), latents, embeddings
    and controller, against the port's (1,2,2) ranks."""
    data = torch.load(mesh122["path"], weights_only=False)
    cfg = data["unet_cfg"]
    jcfg = JConfig(block_out_channels=cfg.block_out_channels, attention_head_dim=cfg.attention_head_dim,
                   cross_attention_dim=cfg.cross_attention_dim, norm_num_groups=cfg.norm_num_groups,
                   lora=cfg.lora, sparse_causal_indices=cfg.sparse_causal_indices,
                   least_sc_channel=cfg.least_sc_channel)
    params = unet_state_to_flax({k: v.numpy() for k, v in data["unet"].items()})
    tok = JStubTokenizer(vocab_size=1000)
    jctl = jmake_controller(tok, [D.SOURCE, D.TARGET], num_steps=STEPS, **TEASER)
    mesh = jmake_mesh(jax.devices()[:4], (1, 2, 2))
    jpipe = JPipeline(JUNet(cfg=jcfg), params, None, None, None, None, tok, store_dtype=jnp.float32).shard(mesh)
    lat = jnp.asarray(data["latents"].numpy())
    emb_src, emb_tgt = (jnp.asarray(data[k].numpy()) for k in ("emb_src", "emb_tgt"))
    jtraj, jstored = jpipe.invert_fast(lat, emb_src, STEPS, capture=True)
    jout, _ = jpipe.edit_fast(jtraj, emb_src, emb_tgt, jctl, STEPS, stored=jstored)
    jtraj, jout = np.asarray(jtraj), np.asarray(jout)
    for rank in mesh122["ranks"]:
        np.testing.assert_allclose(rank["edit"]["traj"].numpy(), jtraj, atol=2e-5, rtol=0)
        np.testing.assert_allclose(rank["edit"]["edited"]["stored"].numpy(), jout,
                                   atol=1e-5 * np.abs(jout).max(), rtol=0)


def test_install_check_runs_on_the_cpu(capsys):
    """fatezero_tpu_torch/scripts/check_install.py on this CPU-only host: it
    names what is missing (the card, nvcc, NCCL), brings up a gloo world of
    one, and exits 0."""
    from fatezero_tpu_torch.scripts import check_install

    assert check_install.main() == 0
    out = capsys.readouterr().out
    assert "card: missing" in out and "K1, K2, K3 vs plain: missing (no card)" in out
    assert "gloo process group: ok" in out and "native frame loader:" in out
    assert "backward through _SeqSum and f/g" in out
