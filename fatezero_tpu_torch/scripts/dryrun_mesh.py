"""The edit on a device mesh against a world of one: a multi-process dry run.

    python3 -m fatezero_tpu_torch.scripts.dryrun_mesh [--mesh 1,2,2] [--device cuda] [--backend gloo]

The inference half of the JAX package's `__graft_entry__.dryrun_multichip`.
It spawns one process per mesh device (torch.multiprocessing, the spawn start
method; they meet through a file:// store) and runs a tiny edit on the mesh:
`encode_video`, `invert_fast(capture=True)` and `edit_fast` in the stored and
hybrid modes. Then it runs the same in a world of one, spawned the same way,
and prints each output's max_abs_diff. The parent draws the weights, encodes
the prompts and builds the controllers once and hands them to every rank, so
the stub tokenizer's per-process hash cannot make the runs differ.

`launch(fn, shape, ...)` runs `fn(mesh, *args)` in each rank, every rank under
one PYTHONHASHSEED, and returns each rank's result; `edit_job` is the dry run's rank function, which the tests and
the smoke also drive. On "cuda" every rank takes the card `rank % count`
(the smoke's gloo ranks share one card); the backend follows the device
unless `backend` is given.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

SOURCE = "a silver jeep driving down a curvy road in the countryside"
TARGET = "watercolor painting of a silver jeep driving down a curvy road in the countryside"
TEASER = {"lora": 160, "SparseCausalAttention_index": ["mid"], "least_sc_channel": 64}


def _rank_main(rank, fn, shape, device, backend, workdir, args):
    from fatezero_tpu_torch.parallel.sharding import make_mesh, maybe_initialize_distributed

    n = math.prod(shape)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank))
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        # fp32 means fp32: TF32 convolutions would round each rank's frames
        # differently from the world of one's
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    maybe_initialize_distributed(device, backend=backend, init_method="file://" + os.path.join(workdir, "store"))
    try:
        out = fn(make_mesh(shape, device), *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def launch(fn, shape: Sequence[int], device="cpu", backend: Optional[str] = None, args=(),
           workdir: Optional[str] = None) -> List:
    """Run `fn(mesh, *args)` in one spawned process per device of a `shape`
    mesh; returns each rank's return value (saved with torch.save), in rank
    order. `fn` must be importable by name (a module-level function)."""
    shape = tuple(int(s) for s in shape)
    hash_seed = os.environ.get("PYTHONHASHSEED")
    # one hash seed for every rank: the stub tokenizer's ids follow `hash`
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            torch.multiprocessing.start_processes(
                _rank_main, args=(fn, shape, str(device), backend, tmp, tuple(args)),
                nprocs=math.prod(shape), join=True, start_method="spawn",
            )
            return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                    for r in range(math.prod(shape))]
    finally:
        if hash_seed is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = hash_seed


# ---------------------------------------------------------------- the edit
def prepare(path: str, pretrained: str = "random:tiny", model_config=None, frames: int = 4, res: int = 128,
            steps: int = 2, seed: int = 0, edits: Optional[Dict[str, dict]] = None) -> str:
    """Write what every rank reads to `path` (a torch.save file) and return it:
    the UNet's and the VAE's configs and fp32 weights, a seeded clip
    [frames, res, res, 3] in [-1, 1] and unit-normal latents of its shape
    (bench.py's random latents: the random VAE's own are ~1e-2, far from the
    unit scale of a trained one), the prompts' embeddings and, per edit,
    its controller and mode. `edits` maps a name to make_controller's keyword
    arguments plus `mode` ('stored', 'replay', 'inline' or 'hybrid') and,
    optionally, `viz`; the default is the teaser's controller, stored and
    hybrid."""
    from fatezero_tpu_torch.models.loader import load_models
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
    from fatezero_tpu_torch.ptp.controller import make_controller

    teaser = dict(is_replace_controller=False, cross_replace_steps=0.8, self_replace_steps=0.8,
                  eq_params={"words": ["watercolor"], "values": [10]})
    edits = edits if edits is not None else {"stored": dict(teaser, mode="stored"),
                                             "hybrid": dict(teaser, mode="hybrid")}
    m = load_models(pretrained, TEASER if model_config is None else model_config, torch.float32, seed=seed,
                    device="cpu")
    pipe = FateZeroPipeline(m.unet, m.vae, m.text_encoder, m.tokenizer, m.schedule, device="cpu")
    controllers = {}
    for name, kw in edits.items():
        kw = dict(kw)
        mode, viz = kw.pop("mode"), kw.pop("viz", False)
        controllers[name] = (mode, viz, make_controller(m.tokenizer, [SOURCE, TARGET], steps, **kw))
    rng = np.random.default_rng(seed)
    torch.save(dict(
        unet_cfg=m.unet.cfg, vae_cfg=m.vae.cfg,
        unet={k: v.float() for k, v in m.unet.state_dict().items()},
        vae={k: v.float() for k, v in m.vae.state_dict().items()},
        video=rng.uniform(-1.0, 1.0, (frames, res, res, 3)).astype(np.float32),
        latents=torch.from_numpy(rng.standard_normal((1, frames, res // 8, res // 8, 4)).astype(np.float32)),
        emb_src=pipe.encode_prompt(SOURCE), emb_tgt=pipe.encode_prompt(TARGET),
        steps=steps, controllers=controllers,
    ), path)
    return path


def _payload_bytes(stored) -> int:
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import _payload_leaves

    return sum(t.numel() * t.element_size() for t in _payload_leaves(stored))


def edit_job(mesh, path: str, dtypes=("float32",), unet_pass: bool = False):
    """A rank of the dry run: the edits of `prepare`'s file on `mesh`, once per
    model dtype (the payload stored in it): the clip through `encode_video`, then the inversion of the
    file's latents (this rank's frames) and the edits. Returns, per dtype, the
    whole clip's encoded video, trajectory and edited latents (gathered over
    'seq'; rank 0's copy), the rank's K1 launches (of the inversion, and of
    each edit with what it inverts itself),
    payload bytes predicted (`capture_payload_bytes`) and held, peak device
    memory and seconds, and the edits' attention maps where `viz` asks; with
    `unet_pass` also one UNet forward's eps."""
    from fatezero_tpu_torch.models.loader import _build
    from fatezero_tpu_torch.models.unet3d import UNetPseudo3DConditionModel
    from fatezero_tpu_torch.models.vae import AutoencoderKL
    from fatezero_tpu_torch.ops import flash_attention as FA
    from fatezero_tpu_torch.ops import schedule as S
    from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
    from fatezero_tpu_torch.parallel.sharding import seq_mesh_scope

    data = torch.load(path, weights_only=False, mmap=True)
    dev = mesh.device
    on_card = dev.type == "cuda"
    steps = data["steps"]
    results = {}
    for name in dtypes:
        dtype = getattr(torch, name)
        unet = _build(UNetPseudo3DConditionModel, data["unet_cfg"], dtype, dev, lambda m: _numpy(data["unet"]))
        vae = _build(AutoencoderKL, data["vae_cfg"], dtype, dev, lambda m: _numpy(data["vae"]))
        pipe = FateZeroPipeline(unet, vae, None, None, S.make_schedule(device=dev), device=dev,
                                store_dtype=dtype).shard(mesh)
        emb_src, emb_tgt = data["emb_src"].to(dev), data["emb_tgt"].to(dev)
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        encoded = pipe.encode_video(torch.from_numpy(data["video"]))
        latents = mesh.local_frames(data["latents"]).to(dev)
        out = dict(rank=mesh.rank, coords=dict(mesh.coords), local_frames=int(latents.shape[1]),
                   encoded=pipe.gather_frames(encoded).cpu())
        if unet_pass:
            with seq_mesh_scope(mesh), torch.inference_mode():
                out["eps"] = pipe.gather_frames(unet(latents, 500, emb_src[-1:])).cpu()
        FA.flash_forward.launches = 0
        traj, stored = pipe.invert_fast(latents, emb_src, steps, capture=True)
        out["k1_launches"] = {"invert": FA.flash_forward.launches}
        out["payload_predicted"] = pipe.capture_payload_bytes(latents, steps)
        out["payload_held"] = _payload_bytes(stored)
        out["traj"] = pipe.gather_frames(traj, 2).cpu()
        out["edited"], out["viz"] = {}, {}
        for edit, (mode, viz, ctl) in data["controllers"].items():
            kw = {}
            FA.flash_forward.launches = 0
            if mode == "stored":
                kw = dict(stored=stored)
            elif mode == "hybrid":  # the payload of the last k inversion rows serves the first k edit steps
                k = max(1, steps // 2)
                _, part = pipe.invert_fast(latents, emb_src, steps, capture=True, capture_rows=(steps - k, k))
                kw = dict(stored=part, stored_row0=steps - k)
            latent, aux = pipe.edit_fast(traj, emb_src, emb_tgt, ctl, steps, viz=viz, **kw)
            out["k1_launches"][edit] = FA.flash_forward.launches
            out["edited"][edit] = pipe.gather_frames(latent).cpu()
            if viz:
                out["viz"][edit] = pipe.gather_frames(aux["cross_avg"]).cpu()
        if on_card:
            torch.cuda.synchronize(dev)
            out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["seconds"] = time.perf_counter() - t0
        results[name] = out
        del pipe, unet, vae, traj, stored
        if on_card:
            torch.cuda.empty_cache()
    return results


def _numpy(state):
    return {k: v.numpy() for k, v in state.items()}


def max_abs_diffs(sharded: dict, single: dict) -> Dict[str, float]:
    """max |sharded - single| of the trajectory and each edit (one dtype's results)."""
    out = {"traj": float((sharded["traj"] - single["traj"]).abs().max())}
    for name, v in single["edited"].items():
        out[name] = float((sharded["edited"][name] - v).abs().max())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mesh", default="1,2,2", help="data,seq,tensor")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    parser.add_argument("--backend", default=None, help="gloo or nccl (default: the device's)")
    args = parser.parse_args(argv)
    shape = tuple(int(x) for x in args.mesh.split(","))
    with tempfile.TemporaryDirectory() as tmp:
        path = prepare(os.path.join(tmp, "inputs.pt"), frames=max(4, 2 * shape[1]))
        sharded = launch(edit_job, shape, args.device, args.backend, args=(path,), workdir=tmp)[0]["float32"]
        single = launch(edit_job, (1, 1, 1), args.device, args.backend, args=(path,), workdir=tmp)[0]["float32"]
    diffs = max_abs_diffs(sharded, single)
    print(json.dumps({"mesh": dict(zip(("data", "seq", "tensor"), shape)), "device": args.device,
                      "max_abs_diff": diffs}))
    return 0 if all(np.isfinite(list(diffs.values()))) and max(diffs.values()) <= 1e-4 else 1


if __name__ == "__main__":
    raise SystemExit(main())
