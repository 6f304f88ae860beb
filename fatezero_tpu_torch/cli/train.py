"""One-shot Tune-A-Video tuning entry point of the port.

    python3 -m fatezero_tpu_torch.cli.train --config config/tune/jeep.yaml [--device cpu]

Counterpart of fatezero_tpu/cli/train.py: the same YAML schema and flow.
Everything but the temporal attention and the to_q projections (and, with
`train_temporal_conv`, the temporal convs) is frozen; the trainer
(trainer/ddpm_trainer.py, or the class `trainer_pipeline_config.target`
names) trains on the clip of `dataset_config`; every `validation_steps` the
current UNet re-inverts the clip and SampleLogger samples every editing
prompt from it (pipelines/validation_loop.py); every `checkpointing_steps` a
`checkpoint_{step}` folder is written in the flax-native layout the JAX
package writes (common/checkpoint.py, convert/to_flax.py) with the optimizer
state beside it, which both packages' loaders and the edit CLIs read. The
logdir also gets log.log, phase_timings.json and config.yml (with
`final_loss`).

A clip of one window without class images trains in chunks of `run_steps`
that end at every validation and checkpoint step, with the random crop taken
on the card; otherwise each step takes the next dataset item (and its class
image). The pipeline shares the trainer's UNet module, so validation samples
with the weights just trained. Runs on the card unless `device="cpu"`;
`fp16`/`bf16` mean a bf16 model on the card and fp32 on the CPU.

On several devices, one process per device:

    torchrun --nproc-per-node 4 -m fatezero_tpu_torch.cli.train --config <yaml> --mesh 1,2,2

`--mesh` (or the YAML's `sharding:` block, as the edit CLI takes it) puts the
pipeline and the trainer on that mesh (parallel/sharding.py,
trainer/ddpm_trainer.py): each rank trains on its frames and heads, and
validation samples on them. Every rank agrees on rank 0's run folder, and
only rank 0 writes there; checkpoints hold the whole UNet (unshard_state)
and the world of one's optimizer state, so a mesh run and a one-device run
resume each other. `scale_lr` multiplies by the batch size and the number of
hosts (torchrun's WORLD_SIZE // LOCAL_WORLD_SIZE; the JAX package's
process_count counts hosts too).
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from fatezero_tpu_torch.common.checkpoint import save_pipeline_checkpoint
from fatezero_tpu_torch.common.config import instantiate_from_config, load_config, save_config
from fatezero_tpu_torch.common.logdir import logdir_for
from fatezero_tpu_torch.common.profiling import PhaseTimer
from fatezero_tpu_torch.convert.to_flax import clip_text_state_to_flax, unet_state_to_flax, vae_state_to_flax
from fatezero_tpu_torch.data import transform as T
from fatezero_tpu_torch.data.dataset import ImageSequenceDataset
from fatezero_tpu_torch.models.loader import load_models
from fatezero_tpu_torch.parallel.sharding import mesh_from_config, unshard_state
from fatezero_tpu_torch.pipelines.fatezero_pipeline import FateZeroPipeline
from fatezero_tpu_torch.trainer.ddpm_trainer import DDPMTrainer, load_training_state, save_training_state

log = logging.getLogger("fatezero_tpu_torch.train")


def _host_state(state: dict, master=None) -> dict:
    """A state dict's weights as fp32 numpy, the trainable ones from their fp32 masters."""
    master = master or {}
    return {k: (master.get(k, v)).detach().float().cpu().numpy() for k, v in state.items()}


def write_checkpoint(path: str, bundle, state, mesh=None) -> Optional[str]:
    """`checkpoint_{step}`: the pipeline in the flax-native layout, then the
    optimizer state. On a mesh every rank assembles the whole UNet and rank 0
    alone writes. Returns the path (None on the other ranks)."""
    unet = unshard_state(bundle.unet, mesh)
    if mesh is not None and mesh.rank != 0:
        return None
    save_pipeline_checkpoint(
        path,
        bundle.unet.cfg,
        unet_state_to_flax(_host_state(unet, state["master"])),
        vae_cfg=bundle.vae.cfg,
        vae_params=vae_state_to_flax(_host_state(bundle.vae.state_dict())),
        text_cfg=bundle.text_encoder.cfg,
        text_params=clip_text_state_to_flax(_host_state(bundle.text_encoder.state_dict())),
    )
    save_training_state(path, state)
    return path


def chunk_length(step: int, train_steps: int, periods) -> int:
    """Updates in the next chunk: up to the next multiple of every period
    (validation, checkpointing), at most 50, and no further than train_steps."""
    return min([p - step % p for p in periods] + [50, train_steps - step])


def train(
    config: str = "config.yaml",
    pretrained_model_path: str = "random:sd",
    dataset_config: Optional[dict] = None,
    model_config: Optional[dict] = None,
    train_steps: int = 100,
    validation_steps: int = 100,
    checkpointing_steps: int = 100,
    learning_rate: float = 3e-5,
    scale_lr: bool = False,
    lr_scheduler: str = "constant",
    lr_warmup_steps: int = 0,
    train_temporal_conv: bool = False,
    use_8bit_adam: bool = False,
    optimizer: Optional[str] = None,  # "adamw" | "adamw8bit" | "adafactor"
    gradient_checkpointing: bool = False,
    prior_preservation: Optional[float] = None,
    mixed_precision: str = "bf16",
    seed: int = 0,
    batch_size: int = 1,
    logdir: Optional[str] = None,
    validation_sample_logger_config: Optional[dict] = None,
    editing_config: Optional[dict] = None,
    trainer_pipeline_config: Optional[dict] = None,
    sharding: Optional[dict] = None,
    device="cuda",
    **kwargs,
):
    """Tune the UNet on one clip; returns (logdir, trainer state)."""
    dataset_config = dict(dataset_config or {})
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
    logging.basicConfig(
        level=logging.INFO,
        handlers=[logging.StreamHandler()] + ([logging.FileHandler(os.path.join(logdir, "log.log"))] if writer else []),
        force=True,
    )
    log.info("tuning run: config=%s logdir=%s device=%s mesh=%s", config, logdir, device, mesh)
    device = torch.device(device)
    timer = PhaseTimer(device)
    dtype = torch.bfloat16 if (mixed_precision in ("fp16", "bf16") and device.type == "cuda") else torch.float32
    if scale_lr:
        learning_rate *= batch_size * hosts()

    model_config = dict(model_config or {})
    if gradient_checkpointing:
        model_config["gradient_checkpointing"] = True
    with timer.phase("load_models", sync=False):
        bundle = load_models(pretrained_model_path, model_config, dtype=dtype, seed=seed, device=device)
    pipe = FateZeroPipeline(bundle.unet, bundle.vae, bundle.text_encoder, bundle.tokenizer,
                            schedule=bundle.schedule, device=device)
    if mesh is not None:
        pipe.shard(mesh)

    dataset_config.setdefault("crop", "random")
    dataset = ImageSequenceDataset(**dataset_config)
    prompt = dataset_config.get("prompt", "")
    # cond half only; a clone outside inference mode, so autograd may save it
    emb = pipe.encode_prompt(prompt)[-1:].clone()
    class_emb = None
    if dataset_config.get("class_data_root"):
        class_emb = pipe.encode_prompt(dataset_config.get("class_data_prompt", ""))[-1:].clone()

    trainer_kwargs = dict(
        unet=bundle.unet,
        vae=bundle.vae,
        schedule=bundle.schedule,
        learning_rate=learning_rate,
        lr_scheduler=lr_scheduler,
        lr_warmup_steps=lr_warmup_steps,
        train_steps=train_steps,
        train_temporal_conv=train_temporal_conv,
        use_8bit_adam=use_8bit_adam,
        optimizer=optimizer,
        prior_preservation=prior_preservation,
    )
    if mesh is not None:
        trainer_kwargs["mesh"] = mesh
    if trainer_pipeline_config and trainer_pipeline_config.get("target"):
        trainer = instantiate_from_config(trainer_pipeline_config, **trainer_kwargs)
    else:
        trainer = DDPMTrainer(**trainer_kwargs)
    state = trainer.init_state()
    start_step = 0
    resume_from = kwargs.get("resume_from")
    if resume_from:
        state = load_training_state(resume_from, trainer, state)
        start_step = state["step"]
        log.info("resumed optimizer state at step %d from %s", start_step, resume_from)
    gen = torch.Generator().manual_seed(seed)  # every random of the run is drawn on the host

    # one clip window and no class stream: the pixels stay on the device and
    # each chunk of updates takes its random crops there
    fused = dataset.video_len == 1 and not dataset.class_images_path
    if fused:
        size = dataset.image_size
        frames = dataset.scaled_frames(0)
        crop = (size, size) if frames.shape[1:3] != (size, size) and dataset.crop == "random" else None
        if crop is None and frames.shape[1:3] != (size, size):
            frames = T.center_crop(frames, size, size)
        frames_dev = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
        # each chunk stops at the next multiple of every active period
        periods = [p for p in (validation_steps, checkpointing_steps) if p]

    losses = []
    step = start_step
    while step < train_steps:
        if fused:
            n = chunk_length(step, train_steps, periods)
            with timer.phase("train"):
                state, chunk_losses = trainer.run_steps(state, frames_dev, emb, gen, n, crop=crop)
            losses.extend(chunk_losses.float().cpu().tolist())
            step += n
        else:
            step += 1
            sample = dataset[step % max(len(dataset), 1)]
            images = torch.from_numpy(np.ascontiguousarray(sample["images"])).to(device)
            class_images = None
            if "class_images" in sample:
                class_images = torch.from_numpy(np.ascontiguousarray(sample["class_images"]))[None].to(device)
            with timer.phase("train"):
                state, loss = trainer.step(state, images, emb, gen, class_images, class_emb)
                losses.append(float(loss))
        if step % 10 == 0 or step == train_steps or fused:
            log.info("step %d/%d loss %.5f", step, train_steps, np.mean(losses[-10:]))

        if validation_steps and step % validation_steps == 0:
            with timer.phase("validation"):
                n_saved = _validate(pipe, dataset, prompt, logdir, step, editing_config=editing_config,
                                    logger_config=validation_sample_logger_config, timer=timer, writer=writer)
            log.info("validation: %d sample videos saved at step %d", n_saved, step)

        if checkpointing_steps and step % checkpointing_steps == 0:
            with timer.phase("checkpoint"):
                ck = write_checkpoint(os.path.join(logdir, f"checkpoint_{step}"), bundle, state, mesh)
            if writer:
                size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(ck) for f in fs)
                log.info("checkpoint written: %s (%d bytes)", ck, size)

    log.info("%s", timer)
    if not writer:
        return logdir, state
    timer.save(os.path.join(logdir, "phase_timings.json"))
    save_config({"config": config, "train_steps": train_steps, "logdir": logdir,
                 "final_loss": float(np.mean(losses[-10:]))},
                os.path.join(logdir, "config.yml"))
    return logdir, state


def hosts() -> int:
    """The hosts of a torchrun launch (WORLD_SIZE // LOCAL_WORLD_SIZE), 1 without one."""
    return max(1, int(os.environ.get("WORLD_SIZE", 1)) // int(os.environ.get("LOCAL_WORLD_SIZE", 1)))


def _validate(pipe, dataset, prompt, logdir, step, editing_config: Optional[dict] = None,
              logger_config: Optional[dict] = None, timer: Optional[PhaseTimer] = None,
              writer: bool = True) -> int:
    """Online re-inversion with the current UNet, then SampleLogger's prompt x
    seed sweep; the logger is built from `editing_config`, with
    `validation_sample_logger_config` keys taking precedence. On a mesh each
    rank samples its frames and the `writer` (rank 0) alone writes."""
    from fatezero_tpu_torch.pipelines.validation_loop import SampleLogger

    timer = timer or PhaseTimer(pipe.device)
    lc = {**(editing_config or {}), **(logger_config or {})}
    video = dataset[0]["images"]
    lc.setdefault("editing_prompts", [prompt] + list(lc.pop("prompts", [])))
    lc.setdefault("clip_length", int(video.shape[0]))
    lc.setdefault("num_inference_steps", 10)
    logger = SampleLogger(logdir=logdir, subdir=f"validation_{step}", writer=writer, **lc)

    traj = None
    if lc.get("use_invertion_latents", True):
        with timer.phase("validation_invert"):
            emb = pipe.encode_prompt(prompt)
            latents = pipe.encode_video(torch.from_numpy(np.ascontiguousarray(video)).to(pipe.device))
            traj = pipe.invert_fast(latents, emb, logger.num_inference_steps)
    samples = logger.log_sample_images(pipe, step, image=np.asarray(video), traj=traj)
    return len(samples)


def run(config, mesh: Optional[str] = None, **overrides):
    """Load a YAML config (or take a dict) and train; keyword overrides
    replace top-level keys (e.g. logdir=..., device="cpu"), and `mesh`
    (data,seq,tensor or 'auto') the `sharding:` block's mesh."""
    d = load_config(config).to_dict()
    d.setdefault("config", config if isinstance(config, str) else "config.yaml")
    d.update(overrides)
    if mesh:
        d["sharding"] = {**(d.get("sharding") or {}), "mesh": mesh}
    return train(**d)


def main():
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--mesh", type=str, default=None,
                        help="device mesh data,seq,tensor or 'auto', one torchrun process per device")
    parser.add_argument("--device", type=str, default="cuda", help="torch device to run on (cuda or cpu)")
    args = parser.parse_args()
    run(args.config, mesh=args.mesh, device=args.device)


if __name__ == "__main__":
    main()
