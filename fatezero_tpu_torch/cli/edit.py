"""Zero-shot video-edit entry point of the port.

    python3 -m fatezero_tpu_torch.cli.edit --config config/teaser/jeep_watercolor.yaml

Counterpart of fatezero_tpu/cli/edit.py: the same YAML schema
(dataset_config / editing_config with `use_invertion_latents` [sic] and
per-prompt `p2p_config.<i>` blocks / model_config / seed), the same guards
and flow, and the same result layout in a timestamped logdir: log.log,
input.gif, the per-prompt gif + mp4 + frame folder with its attention gif,
the blend masks' PNGs, the grids, phase_timings.json and config.yml.

The edit runs on the fused path by default: `invert_fast` with the attention
payload captured (all rows, or the rows a payload budget allows:
FZ_PAYLOAD_BUDGET_GB, 8 by default), then `edit_fast` per prompt. With
`disk_store` or `save_attention_maps` it runs on the streaming store
instead: `invert` copies every step's maps to a host AttentionStore (pickled
into the logdir with `disk_store`), its average cross attention is drawn to
cross_attention/attn.gif, and each prompt's edit reads the store step by
step (`sample`). `use_inversion_attention: false` runs the save/swap edit
(the first prompt captures its own attention, the others edit against it),
and generation mode (`use_invertion_latents: false`) does so from seeded
noise, once per sample seed. It runs on the card unless the caller of `test`
passes device="cpu".

On several devices, one process per device:

    torchrun --nproc-per-node 4 -m fatezero_tpu_torch.cli.edit --config <yaml> --mesh 1,2,2

`--mesh` (or the YAML's `sharding: {mesh: [data, seq, tensor]}`, which it
overrides) puts the edit on that mesh (parallel/sharding.py): each rank runs
on `cuda:LOCAL_RANK` with its block of frames (seq) and of heads (tensor);
`data` replicates. Every rank agrees on rank 0's log folder, and only rank 0
writes there, but for the streaming store's pickles: with `disk_store` each
rank pickles its own maps, `{step:03d}.rank{rank}.pkl`. The streaming
branches run there as on one device. A mesh larger than the launched
processes, and a frame or head count the mesh does not divide, raise.
"""
from __future__ import annotations

import gc
import logging
import os
from typing import Optional

import numpy as np
import torch

from fatezero_tpu_torch.common.config import instantiate_from_config, load_config, save_config
from fatezero_tpu_torch.common.image_util import save_gif_mp4_folder_type
from fatezero_tpu_torch.common.logdir import logdir_for
from fatezero_tpu_torch.common.profiling import PhaseTimer, trace
from fatezero_tpu_torch.data.dataset import ImageSequenceDataset
from fatezero_tpu_torch.models.loader import load_models
from fatezero_tpu_torch.parallel.sharding import mesh_from_config
from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
from fatezero_tpu_torch.pipelines.p2p_validation_loop import P2pSampleLogger
from fatezero_tpu_torch.pipelines.validation_loop import generation_noise
from fatezero_tpu_torch.ptp.store import CROSS_KEYS, AttentionStore


def test(
    config: str = "config.yaml",
    pretrained_model_path: str = "random:sd",
    dataset_config: Optional[dict] = None,
    editing_config: Optional[dict] = None,
    model_config: Optional[dict] = None,
    test_pipeline_config: Optional[dict] = None,
    seed: int = 0,
    mixed_precision: str = "bf16",
    logdir: Optional[str] = None,
    disk_store: bool = False,
    profile: bool = False,
    sharding: Optional[dict] = None,
    device="cuda",
    **kwargs,
):
    """Run one editing workload; returns (logdir, decoded videos)."""
    dataset_config = dict(dataset_config or {})
    editing_config = dict(editing_config or {})
    if not editing_config.get("use_invertion_latents", True) and editing_config.get(
        "use_inversion_attention", True
    ):
        # generation mode has no inversion trajectory: replaying the
        # fabricated clean-latent "trajectory" as inversion attention would
        # silently produce garbage, so this combination is a config error
        raise ValueError(
            "editing_config: use_invertion_latents: false (generation mode) "
            "requires use_inversion_attention: false — there is no inversion "
            "attention to fuse. Set use_inversion_attention: false for "
            "save/swap-style generation editing."
        )
    mesh = None
    if sharding:
        mesh = mesh_from_config(sharding, device)
        device = mesh.device
    writer = mesh is None or mesh.rank == 0  # only rank 0 writes the run's folder
    if writer:
        logdir = logdir_for(config, logdir)
        os.makedirs(logdir, exist_ok=True)
    if mesh is not None:
        logdir = mesh.broadcast_object(logdir)
    # every run logs to logdir/log.log
    logging.basicConfig(
        level=logging.INFO,
        handlers=[logging.StreamHandler()] + ([logging.FileHandler(os.path.join(logdir, "log.log"))] if writer else []),
        force=True,
    )
    log = logging.getLogger("fatezero_tpu_torch.edit")
    log.info("editing run: config=%s logdir=%s device=%s mesh=%s", config, logdir, device, mesh)
    device = torch.device(device)
    timer = PhaseTimer(device)

    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if (mixed_precision in ("fp16", "bf16") and on_card) else torch.float32

    with timer.phase("load_models", sync=False):
        bundle = load_models(pretrained_model_path, model_config, dtype=dtype, seed=seed, device=device)
    # `test_pipeline_config.target` selects the pipeline class (a target
    # under fatezero_tpu. resolves to the port's module of that name); the
    # model bundle is passed as the constructor kwargs
    pipeline_kwargs = dict(
        unet=bundle.unet,
        vae=bundle.vae,
        text_encoder=bundle.text_encoder,
        tokenizer=bundle.tokenizer,
        schedule=bundle.schedule,
        device=device,
    )
    # a second text tower (SDXL) and its tokenizer, where the bundle has them
    pipeline_kwargs.update({k: getattr(bundle, k) for k in ("text_encoder_2", "tokenizer_2") if hasattr(bundle, k)})
    if test_pipeline_config and test_pipeline_config.get("target"):
        pipe = instantiate_from_config(test_pipeline_config, **pipeline_kwargs)
    else:
        pipe = FateZeroPipeline(**pipeline_kwargs)
    if mesh is not None:
        pipe.shard(mesh)

    dataset = ImageSequenceDataset(**dataset_config)
    video = dataset[0]["images"]  # [f, h, w, 3] in [-1, 1], numpy
    source_video = video / 2 + 0.5
    if writer:
        save_gif_mp4_folder_type(source_video, os.path.join(logdir, "input.gif"))

    source_prompt = editing_config.get("source_prompt", dataset_config.get("prompt", ""))
    num_steps = int(editing_config.get("num_inference_steps", 50))
    # `profile: true`: the run from the prompts' encoding to the last edit under
    # the profiler, its phases and the program's spans inside it
    with trace(os.path.join(logdir, "trace") if profile and writer else None):
        emb_src = pipe.encode_prompt(source_prompt)
        with timer.phase("vae_encode"):
            latents = pipe.encode_video(torch.from_numpy(np.ascontiguousarray(video)).to(device))

        sample_seeds = [int(s) for s in editing_config.get("sample_seeds", [seed])]
        use_fused = not disk_store and not editing_config.get("save_attention_maps", False)

        def make_logger(subdir: str = "") -> P2pSampleLogger:
            return P2pSampleLogger(
                editing_prompts=editing_config.get("editing_prompts", [source_prompt]),
                logdir=os.path.join(logdir, subdir) if subdir else logdir,
                source_prompt=source_prompt,
                num_inference_steps=num_steps,
                guidance_scale=float(editing_config.get("guidance_scale", 7.5)),
                sample_seeds=sample_seeds,
                p2p_config=editing_config.get("p2p_config", {}),
                use_inversion_attention=bool(editing_config.get("use_inversion_attention", True)),
                strength=editing_config.get("strength"),
                annotate=bool(editing_config.get("annotate", False)),
                use_fused_path=use_fused,
                writer=writer,
            )

        # capture the controlled sites' payloads during the inversion itself
        # (cross probabilities + self (q, k), on the device), so that the edits
        # run the bare 2-row CFG forward; `stored_attention: false` replays
        # instead, for workloads whose payload exceeds the device. The save/swap
        # edit (`use_inversion_attention: false`) reads only the trajectory, so
        # it captures nothing.
        use_stored = bool(editing_config.get("stored_attention", True)) and bool(
            editing_config.get("use_inversion_attention", True)
        )
        traj = stored = capture_rows = inv_store = traj_host = None
        if editing_config.get("use_invertion_latents", True):
            if use_fused:
                traj, stored, capture_rows = _fused_inversion(pipe, make_logger(), latents, emb_src, num_steps,
                                                              use_stored, timer, log, on_card)
            else:
                inv_store = AttentionStore(disk_store=disk_store, store_dir=logdir, mesh=mesh)
                with timer.phase("inversion"):
                    traj_host = pipe.invert(latents, emb_src, num_steps, store=inv_store)
                log.info(
                    "streaming store: %d steps, %d bytes a step, %.3f s of copies a step",
                    inv_store.num_steps, max(inv_store.step_bytes, default=0),
                    float(np.mean(inv_store.copy_seconds)) if inv_store.copy_seconds else 0.0,
                )
                # the inversion's average cross attention, drawn per token
                from fatezero_tpu_torch.ptp.visualization import show_cross_attention

                average = inv_store.get_average_attention(CROSS_KEYS)  # every rank's frames and heads
                if writer:
                    show_cross_attention(
                        pipe.tokenizer,
                        source_prompt,
                        {k: [m.numpy() for m in v] for k, v in average.items()},
                        res=int(latents.shape[2]) // 4,
                        save_path=os.path.join(logdir, "cross_attention", "attn.gif"),
                    )

        with timer.phase("editing"):
            if traj is None and inv_store is None:
                # generation mode: one run per sample seed from its seeded noise
                videos = []
                frames = int(video.shape[0])
                for s in sample_seeds:
                    # the whole clip's noise, then this rank's frames
                    noise = generation_noise(s, (1, frames, *latents.shape[2:]))
                    noise = (noise if mesh is None else mesh.local_frames(noise)).to(device)
                    seed_traj = torch.stack([latents] * num_steps + [noise])
                    sub = f"seed_{s}" if len(sample_seeds) > 1 else ""
                    videos += make_logger(sub).log_sample_images(pipe, source_video, traj=seed_traj, emb_source=emb_src)
            else:
                videos = make_logger().log_sample_images(
                    pipe,
                    source_video,
                    traj=traj,
                    inv_store=inv_store,
                    inverted_latents=traj_host,
                    emb_source=emb_src,
                    stored=stored,
                    stored_row0=capture_rows[0] if (capture_rows and stored is not None) else 0,
                )
    log.info("%s", timer)
    if not writer:
        return logdir, videos
    timer.save(os.path.join(logdir, "phase_timings.json"))
    save_config(
        {
            "config": config,
            "pretrained_model_path": pretrained_model_path,
            "dataset_config": dataset_config,
            "editing_config": {k: v for k, v in editing_config.items() if k != "p2p_config"},
            "seed": seed,
            "logdir": logdir,
        },
        os.path.join(logdir, "config.yml"),
    )
    return logdir, videos


def _fused_inversion(pipe, logger, latents, emb_src, num_steps, use_stored, timer, log, on_card):
    """invert_fast with the payload the budget allows: (traj, stored, capture_rows)."""
    stored = capture_rows = traj = None
    if use_stored:
        # a failed capture costs a whole inversion, so trim it beforehand to
        # the rows the budget holds (a meta-device trace, no device work):
        # full capture when every step fits, a hybrid (stored prefix, replay
        # middle, identity-gated tail) otherwise, full replay when not one
        # row fits. FZ_PAYLOAD_BUDGET_GB overrides the 8 GB default.
        budget = float(os.environ.get("FZ_PAYLOAD_BUDGET_GB", 8)) * 1e9
        capture_rows = pipe.plan_capture(
            latents,
            num_steps,
            window=logger.max_edit_window(pipe),
            budget_bytes=budget,
            strength=logger.strength,
            use_inversion_attention=logger.use_inversion_attention,
        )
        if capture_rows is None:
            log.warning(
                "predicted attention payload %.1f GB exceeds the %.1f GB budget at "
                "every trim; using replay rematerialization (stored_attention: "
                "false). Raise FZ_PAYLOAD_BUDGET_GB to force capture.",
                pipe.capture_payload_bytes(latents, num_steps) / 1e9,
                budget / 1e9,
            )
            use_stored = False
        elif capture_rows[1] < num_steps:
            log.info(
                "trimmed attention capture to inversion rows [%d, %d) to fit the %.1f GB payload budget",
                capture_rows[0],
                capture_rows[0] + capture_rows[1],
                budget / 1e9,
            )
    with timer.phase("inversion"):
        if use_stored:
            try:
                traj, stored = pipe.invert_fast(latents, emb_src, num_steps, capture=True, capture_rows=capture_rows)
            except torch.cuda.OutOfMemoryError:
                if pipe.mesh is not None:
                    raise  # the other ranks wait in the capture's collectives
                log.warning(
                    "attention payload exceeds device memory at this workload; falling "
                    "back to replay rematerialization (stored_attention: false)"
                )
                traj = stored = None
        if traj is None:
            # the failed attempt's tensors can sit in reference cycles of the
            # dropped exception's frames: collect them before the replay
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            traj = pipe.invert_fast(latents, emb_src, num_steps)
    return traj, stored, capture_rows


def run(config, mesh: Optional[str] = None, **overrides):
    """Load a YAML config (or take a dict) and run it; keyword overrides
    replace top-level keys (e.g. logdir=..., device="cpu"), and `mesh`
    (data,seq,tensor or 'auto') the `sharding:` block's mesh. A tuned model's
    folder of checkpoint_* subdirectories runs once per checkpoint
    (filtered by pretrained_epoch_list)."""
    d = load_config(config).to_dict()
    d.setdefault("config", config if isinstance(config, str) else "config.yaml")
    d.update(overrides)
    if mesh:
        d["sharding"] = {**(d.get("sharding") or {}), "mesh": mesh}
    pmp = d.get("pretrained_model_path", "random:sd")
    if os.path.isdir(pmp):
        ckpts = sorted(
            p
            for p in os.listdir(pmp)
            if p.startswith("checkpoint_") and os.path.isdir(os.path.join(pmp, p))
        )
        epoch_list = d.get("pretrained_epoch_list")
        if ckpts:
            outs = []
            for ck in ckpts:
                epoch = int(ck.split("_")[-1])
                if epoch_list is not None and epoch not in epoch_list:
                    continue
                sub = dict(d)
                sub["pretrained_model_path"] = os.path.join(pmp, ck)
                outs.append(test(**sub))
            return outs
    return test(**d)


def main():
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", type=str, default="config/demo.yaml")
    parser.add_argument("--mesh", type=str, default=None,
                        help="device mesh data,seq,tensor or 'auto', one torchrun process per device")
    parser.add_argument("--device", type=str, default="cuda", help="torch device to run on (cuda or cpu)")
    args = parser.parse_args()
    run(args.config, mesh=args.mesh, device=args.device)


if __name__ == "__main__":
    main()
