"""Training CLI (reference engine/train.py:28-162; engine/pre_train.py
is the same but for the AdamW branch, so this one CLI covers both).

Port of ``givepose_tpu/cli/train.py``:

  python -m givepose_torch.cli.train --dataset CAMERA+Real \\
      --dataset_dir ./data/NOCS --batch_size 48 --total_epoch 300

runs on the GPU unless ``--device cpu`` is given (the device is not a
``Config`` field, so ``config.json`` is the JAX CLI's).  Each step:

  * the prefetch thread (``data.TrainPipeline``) reads and collates the
    host batch;
  * ``data.preprocess_batch`` crops, zooms and augments it on the device,
    with random values drawn on the host (``draw_preprocess``);
  * ``train.make_train_step`` runs forward, loss, gradients and the
    guarded Ranger update.

Random numbers are counter-based, as the JAX CLI's ``fold_in(key0,
step)``: each step seeds a CPU generator (the preprocessing draws) and
one on the device (SizeHead's dropout) from (seed, step), so a resumed
run draws what the uninterrupted run drew.  As in the JAX CLI, the
pipeline's first epoch is consumed before training (the JAX CLI reads its
init sample from it), so both CLIs train on the same host batches.

Checkpoints carry model, optimizer and step (exact resume; the epoch is
derived from the step and the sampler replayed).  The failure seam
(reference :133-143): non-finite steps are skipped by the optimizer's
guard; when the skip counter has grown by a log point, the raw batch and
the state are dumped to ``<model_save>/exception/``.  ``--restart_every
N`` saves and exits with 75 after every N epochs, for
``cli.train_durable``.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np
import torch

from givepose_torch.core.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from givepose_torch.core.config import Config, parse_overrides
from givepose_torch.core.logging_utils import (
    MetricLogger,
    StepTimer,
    setup_logger,
)
from givepose_torch.data import (
    NocsRecordReader,
    TrainPipeline,
    draw_preprocess,
    preprocess_batch,
)
from givepose_torch.eval.serving import resolve_device
from givepose_torch.train import init_train_state, make_train_step

DEVICES = ("cuda", "cpu")


def step_seed(seed: int, step: int, stream: str) -> int:
    """A 64-bit seed for ``stream`` at ``step`` of a run seeded ``seed``."""
    digest = hashlib.sha256(f"{seed}:{step}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little")


def step_generators(seed: int, step: int, device
                    ) -> tuple[torch.Generator, torch.Generator]:
    """(host generator of the preprocessing draws, generator on ``device``
    of the step's dropout) for ``step``."""
    pre = torch.Generator().manual_seed(step_seed(seed, step, "preprocess"))
    dev = torch.Generator(device=device).manual_seed(
        step_seed(seed, step, "step"))
    return pre, dev


def build_model_batch(raw, draws, cfg: Config, train=True, device=None):
    """Device preprocessing -> the dict PoseNet/PoseLoss consume."""
    return preprocess_batch(
        raw, draws, img_size=cfg.data.img_size, out_res=cfg.data.out_res,
        train=train, color_aug_prob=cfg.data.color_aug_prob if train else 0.0,
        resize_full=cfg.model.resize_full, dzi_type=cfg.data.dzi_type,
        dzi_pad_scale=cfg.data.dzi_pad_scale,
        dzi_scale_ratio=cfg.data.dzi_scale_ratio,
        dzi_shift_ratio=cfg.data.dzi_shift_ratio, device=device)


def draw_step(generator, b: int, cfg: Config) -> dict:
    """The preprocessing draws of one training batch of ``b``."""
    return draw_preprocess(generator, b, img_size=cfg.data.img_size,
                           train=True, color_aug_prob=cfg.data.color_aug_prob,
                           mask_pro=cfg.data.roi_mask_pro,
                           dzi_type=cfg.data.dzi_type)


def split_device_flag(argv: list[str]) -> tuple[list[str], str | None]:
    """Take ``--device {cuda,cpu}`` out of ``argv``."""
    rest, device, i = [], None, 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--device":
            if i + 1 >= len(argv):
                raise ValueError("flag --device missing a value")
            device, i = argv[i + 1], i + 2
            continue
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
        i += 1
    if device is not None and device not in DEVICES:
        raise ValueError(f"--device must be one of {DEVICES}, got {device!r}")
    return rest, device


def _dump_failure(cfg: Config, raw: dict, state, global_step: int) -> str:
    dump_dir = os.path.join(cfg.train.model_save, "exception")
    os.makedirs(dump_dir, exist_ok=True)
    np.savez(os.path.join(dump_dir, f"step{global_step}.npz"),
             **{k: np.asarray(v) for k, v in raw.items()})
    save_checkpoint(os.path.join(dump_dir, f"state_{global_step}"), state,
                    keep=3)
    return dump_dir


def train(argv=None, max_steps: int | None = None,
          backbone_variant: str = "base", device=None):
    argv, flag_device = split_device_flag(
        list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(device or flag_device)
    cfg = parse_overrides(Config(), argv)
    if cfg.model.quant_dense:
        raise ValueError(
            "quant_dense is an int8 SERVING mode: gradients through the "
            "activation rounding are zero, so training with it silently "
            "freezes the quantized weights. Unset it for training.")
    os.makedirs(cfg.train.model_save, exist_ok=True)
    logger = setup_logger(
        "train", os.path.join(cfg.train.model_save, "log_train.txt"))
    metrics_log = MetricLogger(cfg.train.model_save)
    with open(os.path.join(cfg.train.model_save, "config.json"),
              "w") as f:
        f.write(cfg.to_json())   # flags snapshot (reference :32)

    reader = NocsRecordReader(
        cfg.data.dataset, "train", cfg.data.dataset_dir,
        cfg.data.ivfc_dir, per_obj=cfg.data.per_obj,
        ban_mug=cfg.data.ban_mug)
    pipeline = TrainPipeline(reader, cfg.train.batch_size,
                             cfg.train.train_size, cfg.data.syn_ratio,
                             seed=cfg.train.seed)
    # the JAX CLI reads its init sample from the first epoch
    # (next(iter(pipeline.epoch()))); consuming that epoch keeps both
    # CLIs on the same host batches
    pipeline.skip_epochs(1)

    state = init_train_state(cfg, backbone_variant, device=device,
                             seed=cfg.train.seed,
                             img_size=cfg.data.img_size)
    step_fn = make_train_step(state.model, cfg)

    start_epoch = 0
    ckpt = None
    if cfg.train.resume:
        ckpt = (cfg.train.resume_model
                or latest_checkpoint(cfg.train.model_save))
    if ckpt:
        state = restore_checkpoint(ckpt, state)
        start_epoch = cfg.train.resume_point
        if start_epoch == 0 and state.step > 0:
            # derive the epoch from the checkpointed step (exact resume;
            # the reference instead restarts its LR schedule, SURVEY §5)
            spe = max(cfg.train.train_size // cfg.train.batch_size, 1)
            start_epoch = state.step // spe
        # replay the host randomness (sampler epoch draws + per-epoch
        # read-rng counter) so epoch E sees the same index stream and
        # the same per-sample instance choices as the uninterrupted run
        pipeline.skip_epochs(start_epoch)
        logger.info("resumed from %s at epoch %d", ckpt, start_epoch)

    timer = StepTimer()
    global_step = state.step
    notfinite_seen = state.optimizer.total_notfinite
    reads_seen = 0
    for epoch in range(start_epoch, cfg.train.total_epoch):
        batches = pipeline.epoch()
        while True:
            t0 = time.perf_counter()
            raw = next(batches, None)
            wait = time.perf_counter() - t0
            if raw is None:
                break
            gen_pre, gen_step = step_generators(cfg.train.seed, global_step,
                                                device)
            draws = draw_step(gen_pre, len(raw["image"]), cfg)
            batch = build_model_batch(raw, draws, cfg, device=device)
            step_metrics = step_fn(state, batch, gen_step)
            global_step += 1
            timer.tick()
            if global_step % cfg.train.log_every == 0:
                vals = {k: float(v) for k, v in step_metrics.items()}
                total = vals.get("total_loss", float("nan"))
                nf = int(vals.pop("notfinite_total", 0))
                if nf > notfinite_seen or not np.isfinite(total):
                    # the skipped steps left the parameters untouched
                    # (the optimizer's finite guard); persist the batch
                    # and the state for offline debugging and go on
                    dump_dir = _dump_failure(cfg, raw, state, global_step)
                    logger.warning(
                        "%d non-finite update(s) skipped by step %d "
                        "(loss %.4f); batch + state dumped to %s",
                        nf - notfinite_seen, global_step, total, dump_dir)
                    notfinite_seen = nf
                vals["steps_per_sec"] = (1.0 / timer.mean
                                         if timer.mean else 0.0)
                vals["imgs_per_sec"] = (cfg.train.batch_size / timer.mean
                                        if timer.mean else 0.0)
                vals["data_wait_ms"] = 1e3 * wait
                reads = pipeline.read_seconds[reads_seen:]
                reads_seen += len(reads)
                if reads:
                    vals["read_ms"] = 1e3 * sum(reads) / len(reads)
                metrics_log.log(global_step, vals)
                logger.info("epoch %d step %d loss %.4f (%.1f img/s)",
                            epoch, global_step, total,
                            vals["imgs_per_sec"])
            if max_steps is not None and global_step >= max_steps:
                save_checkpoint(os.path.join(cfg.train.model_save,
                                             f"ckpt_{global_step}"),
                                state, keep=cfg.train.keep_checkpoints)
                batches.close()
                metrics_log.close()
                return state
        if (epoch + 1) % cfg.train.save_every == 0 \
                or epoch == cfg.train.total_epoch - 1:
            save_checkpoint(os.path.join(cfg.train.model_save,
                                         f"ckpt_{global_step}"), state,
                            keep=cfg.train.keep_checkpoints)
            logger.info("saved checkpoint at epoch %d", epoch)
        if (cfg.train.restart_every
                and (epoch + 1) % cfg.train.restart_every == 0
                and epoch != cfg.train.total_epoch - 1):
            save_checkpoint(os.path.join(cfg.train.model_save,
                                         f"ckpt_{global_step}"), state,
                            keep=cfg.train.keep_checkpoints)
            logger.info("restart_every: exiting cleanly after epoch %d "
                        "(resume with --resume 1)", epoch)
            metrics_log.close()
            raise SystemExit(75)   # EX_TEMPFAIL: wrapper should resume
    metrics_log.close()
    return state


if __name__ == "__main__":
    train()
