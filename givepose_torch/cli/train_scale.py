"""Scale-net training CLI (reference network/scale_net.py:84-134 main()).

Port of ``givepose_tpu/cli/train_scale.py``:

  python -m givepose_torch.cli.train_scale --dataset Real \\
      --dataset_dir ./data/NOCS --data.ivfc_dir ./data/IVFC

trains the two-tower metric-scale regressor against the GT scale
``||real_size||`` with ``scale_loss`` on the GPU, unless ``--device cpu``
is given, from the pose trainer's data pipeline, with Adam behind a
global-norm clip (``train/adam.py``, optax's arithmetic) on the
``flat_and_anneal`` schedule.  The order of events is the JAX CLI's:

  * the pipeline's first epoch is consumed before training (the JAX CLI
    reads its init sample from it);
  * train-mode steps (batch statistics, dropout) until
    ``freeze_at = int(bn_freeze_point · planned steps)``;
  * at ``freeze_at``, ``recalibrate_bn``: the running statistics become
    the exact mean of ``bn_recal_batches`` batches' statistics (the
    variance by the law of total variance), read from a fresh
    ``pipeline.epoch()``, which moves the sampler's stream for every
    later epoch as it does in the JAX CLI;
  * then frozen steps: the serving function (running statistics, no
    dropout) is the loss;
  * ``scale_ckpt_<step>`` checkpoints (model, Adam state, step).

Random numbers are counter-based, as in ``cli/train.py``: each step's
preprocessing draws and dropout masks come from generators seeded by
(seed, step), a recalibration batch's from (seed, step, batch).
"""

from __future__ import annotations

import os
import sys

import torch

from givepose_torch.cli.train import (
    build_model_batch,
    draw_step,
    split_device_flag,
    step_generators,
    step_seed,
)
from givepose_torch.core.checkpoint import save_checkpoint
from givepose_torch.core.config import Config, parse_overrides
from givepose_torch.core.logging_utils import MetricLogger, setup_logger
from givepose_torch.data import NocsRecordReader, TrainPipeline
from givepose_torch.eval.serving import resolve_device
from givepose_torch.losses.pose_loss import scale_loss
from givepose_torch.models.mobilenet import FlaxBatchNorm2d
from givepose_torch.models.scale_net import ScaleNet, build_scalenet
from givepose_torch.train.adam import ClippedAdam
from givepose_torch.train.schedule import flat_and_anneal
from givepose_torch.train.step import TrainState


def make_optimizer(model: ScaleNet, cfg: Config) -> ClippedAdam:
    spe = max(cfg.train.train_size // cfg.train.batch_size, 1)
    schedule = flat_and_anneal(cfg.train.lr, cfg.train.total_epoch * spe,
                               warmup_iters=cfg.train.warmup_iters,
                               anneal_point=cfg.train.anneal_point)
    return ClippedAdam(dict(model.named_parameters()), schedule,
                       cfg.train.grad_clip_norm)


def _gt_scale(batch: dict) -> torch.Tensor:
    return torch.linalg.vector_norm(batch["real_size"].float(), dim=1)


def make_scale_steps(model: ScaleNet, cfg: Config):
    """``(step, step_frozen)``, each ``(state, batch[, generator]) ->
    loss``.  ``step`` trains with batch statistics (moving the running
    ones) and dropout from ``generator``; ``step_frozen`` takes as its loss
    the serving function (running statistics, no dropout), so the
    regressor fits what eval runs (``TrainConfig.bn_freeze_point``)."""
    names, params = zip(*model.named_parameters())

    def apply(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
        grads = torch.autograd.grad(loss, params)
        state.optimizer.step(dict(zip(names, grads)))
        state.step += 1
        return loss.detach()

    def step(state: TrainState, batch: dict,
             generator: torch.Generator) -> torch.Tensor:
        pred = model(batch, train=True, generator=generator)
        return apply(state, scale_loss(cfg.loss, pred, _gt_scale(batch)))

    def step_frozen(state: TrainState, batch: dict) -> torch.Tensor:
        pred = model(batch)
        return apply(state, scale_loss(cfg.loss, pred, _gt_scale(batch)))

    return step, step_frozen


def batch_norms(model: ScaleNet) -> list[FlaxBatchNorm2d]:
    return [m for m in model.modules() if isinstance(m, FlaxBatchNorm2d)]


@torch.no_grad()
def batch_statistics(model: ScaleNet, batch: dict) -> list:
    """Each BatchNorm's (mean, var) of ``batch`` as the JAX CLI recovers
    them: a train-mode forward from zero running statistics, whose EMA
    step wrote ``m·0 + (1 - m)·stat``, divided by ``1 - m``.  Only the
    towers hold BatchNorms, and dropout comes after them, so it does not
    run."""
    norms = batch_norms(model)
    saved = [(bn.running_mean.clone(), bn.running_var.clone())
             for bn in norms]
    for bn in norms:
        bn.running_mean.zero_()
        bn.running_var.zero_()
    model.feat_encoder_bbox(batch["roi_img"], train=True)
    model.feat_encoder_full(batch["full_img"], train=True)
    m = FlaxBatchNorm2d.MOMENTUM
    stats = [(bn.running_mean / (1.0 - m), bn.running_var / (1.0 - m))
             for bn in norms]
    for bn, (mean, var) in zip(norms, saved):
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
    return stats


@torch.no_grad()
def recalibrate_bn(model: ScaleNet, pipeline: TrainPipeline, cfg: Config,
                   step: int, device, logger=None) -> int:
    """Precise-BN: replace the momentum-lagged running averages with the
    exact average of per-batch statistics over ``bn_recal_batches``
    training batches (variance ``E[var_b] + max(Var[mean_b], 0)``, so the
    batch-mean spread is counted), read from a fresh ``pipeline.epoch()``.
    The momentum-0.99 BN co-adapts the regressor to *batch* statistics;
    serving on the lagged running averages cost 0.036 absolute scale
    error on the overfit fixture against 0.010 after recalibration (the
    JAX package's measurement).  Returns the batches used."""
    if cfg.train.bn_recal_batches <= 0 or not batch_norms(model):
        return 0
    n, sum1, sum2 = 0, None, None
    for raw in pipeline.epoch():
        gen = torch.Generator().manual_seed(
            step_seed(cfg.train.seed, step, f"recal{n}:preprocess"))
        batch = build_model_batch(raw, draw_step(gen, len(raw["image"]),
                                                 cfg), cfg, device=device)
        stats = batch_statistics(model, batch)
        if sum1 is None:
            sum1 = [list(s) for s in stats]
            sum2 = [[a * a for a in s] for s in stats]
        else:
            for acc1, acc2, s in zip(sum1, sum2, stats):
                for i, a in enumerate(s):
                    acc1[i] = acc1[i] + a
                    acc2[i] = acc2[i] + a * a
        n += 1
        if n >= cfg.train.bn_recal_batches:
            break
    if n == 0:
        return 0
    for bn, (s_mean, s_var), (q_mean, _) in zip(batch_norms(model), sum1,
                                                sum2):
        mean = s_mean / n
        spread = q_mean / n - mean ** 2
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(s_var / n + torch.clamp(spread, min=0.0))
    if logger is not None:
        logger.info("BN recalibrated over %d batches", n)
    return n


def train_scale(argv=None, max_steps: int | None = None, device=None):
    argv, flag_device = split_device_flag(
        list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(device or flag_device)
    cfg = parse_overrides(Config(), argv)
    os.makedirs(cfg.train.model_save, exist_ok=True)
    logger = setup_logger(
        "train_scale",
        os.path.join(cfg.train.model_save, "log_train_scale.txt"))
    metrics_log = MetricLogger(cfg.train.model_save)

    reader = NocsRecordReader(cfg.data.dataset, "train",
                              cfg.data.dataset_dir, cfg.data.ivfc_dir,
                              per_obj=cfg.data.per_obj,
                              ban_mug=cfg.data.ban_mug)
    pipeline = TrainPipeline(reader, cfg.train.batch_size,
                             cfg.train.train_size, cfg.data.syn_ratio,
                             seed=cfg.train.seed)
    # the JAX CLI reads its init sample from the first epoch
    pipeline.skip_epochs(1)

    model = build_scalenet(cfg.model.feat_dim, cfg.model.use_hw, device,
                           seed=cfg.train.seed)
    state = TrainState(model, make_optimizer(model, cfg))
    step, step_frozen = make_scale_steps(model, cfg)
    spe = max(cfg.train.train_size // cfg.train.batch_size, 1)

    planned = (max_steps if max_steps is not None
               else cfg.train.total_epoch * spe)
    freeze_at = (int(cfg.train.bn_freeze_point * planned)
                 if cfg.train.bn_freeze_point < 1.0 else planned + 1)

    global_step = 0
    # max_steps (tests/tools) drives termination when set: keep cycling
    # epochs until it is reached, even past total_epoch, so that the
    # frozen fine-tune phase runs
    n_epochs = (cfg.train.total_epoch if max_steps is None
                else max(cfg.train.total_epoch, -(-max_steps // spe)))
    for epoch in range(n_epochs):
        batches = pipeline.epoch()
        for raw in batches:
            gen_pre, gen_step = step_generators(cfg.train.seed, global_step,
                                                device)
            batch = build_model_batch(
                raw, draw_step(gen_pre, len(raw["image"]), cfg), cfg,
                device=device)
            if global_step == freeze_at:
                recalibrate_bn(model, pipeline, cfg, global_step, device,
                               logger)
                logger.info("BN frozen at step %d; fine-tuning the "
                            "serving function", global_step)
            if global_step >= freeze_at:
                loss = step_frozen(state, batch)
            else:
                loss = step(state, batch, gen_step)
            global_step += 1
            if global_step % cfg.train.log_every == 0:
                metrics_log.log(global_step, {"scale_loss": float(loss)})
                logger.info("epoch %d step %d scale loss %.5f", epoch,
                            global_step, float(loss))
            if max_steps is not None and global_step >= max_steps:
                if global_step <= freeze_at:   # never froze: recal only
                    recalibrate_bn(model, pipeline, cfg, global_step,
                                   device, logger)
                save_checkpoint(os.path.join(cfg.train.model_save,
                                             f"scale_ckpt_{global_step}"),
                                state, keep=cfg.train.keep_checkpoints)
                batches.close()
                metrics_log.close()
                return state
        if max_steps is None and ((epoch + 1) % cfg.train.save_every == 0
                                  or epoch == cfg.train.total_epoch - 1):
            if epoch == cfg.train.total_epoch - 1 \
                    and global_step <= freeze_at:
                recalibrate_bn(model, pipeline, cfg, global_step, device,
                               logger)
            save_checkpoint(os.path.join(cfg.train.model_save,
                                         f"scale_ckpt_{global_step}"),
                            state, keep=cfg.train.keep_checkpoints)
    metrics_log.close()
    return state


if __name__ == "__main__":
    train_scale()
