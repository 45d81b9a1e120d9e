"""PoseNet training step (PyTorch).

Port of ``givepose_tpu/train/step.py``.  One step is: forward in train
mode (SizeHead on batch statistics, dropout from the step's generator),
the pose loss, the gradients of every parameter, and the update

    apply_if_finite(MultiSteps?(chain(clip_by_global_norm,
                                      Ranger)), max_consecutive_errors=50)

with optax's semantics, which ``TrainOptimizer`` reproduces:

  * the finite check reads the raw gradients; a non-finite step applies
    nothing and leaves every inner state alone (the accumulator, RAdam,
    the schedule count, lookahead), bumps the consecutive and total
    counters, and the 51st consecutive one is applied all the same;
  * with ``accumulate`` k > 1 the gradients are averaged as a running mean
    (acc + (g − acc)/(n + 1)); only every k-th step updates, and the
    schedule counts those steps only;
  * the clip leaves gradients whose global norm is below the limit as
    they are and maps the others to g / norm · limit (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).

BatchNorm running statistics and the step counter advance on every step,
a skipped one included, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from givepose_torch.core.config import Config
from givepose_torch.eval.serving import build_posenet
from givepose_torch.losses.pose_loss import PoseLossFn
from givepose_torch.models.posenet import PoseNet
from givepose_torch.train.ranger import Ranger
from givepose_torch.train.schedule import flat_and_anneal

MAX_CONSECUTIVE_ERRORS = 50


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (f32 0-d tensor)."""
    norms = torch._foreach_norm(list(tensors))
    return torch.stack(norms).float().square().sum().sqrt()


class TrainOptimizer:
    """The wrapped Ranger of ``make_optimizer``, over named parameters
    that it updates in place."""

    def __init__(self, params: dict[str, torch.nn.Parameter], cfg: Config,
                 steps_per_epoch: int | None = None):
        t = cfg.train
        if t.optimizer_type.lower() != "ranger":
            raise NotImplementedError(
                f"optimizer_type={t.optimizer_type!r} is not ported yet; "
                "the port has Ranger (ROADMAP queue A, item 10)")
        spe = steps_per_epoch or (t.train_size // max(t.batch_size, 1))
        schedule = flat_and_anneal(
            t.lr, t.total_epoch * max(spe, 1), warmup_iters=t.warmup_iters,
            warmup_factor=t.warmup_factor, warmup_method=t.warmup_method,
            anneal_point=t.anneal_point, anneal_method=t.anneal_method)
        self.params = params
        self.ranger = Ranger(params, schedule, weight_decay=t.weight_decay)
        self.clip_norm = t.grad_clip_norm
        self.accumulate = t.accumulate
        # apply_if_finite
        self.notfinite_count = 0
        self.total_notfinite = 0
        # MultiSteps
        self.mini_step = 0
        self.acc_grads = None
        if self.accumulate > 1:
            self.acc_grads = {n: torch.zeros_like(p)
                              for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """Apply one step of raw ``grads``; returns their global norm."""
        norm = global_norm(grads.values())
        # one host sync; the norm is finite iff every gradient is (short
        # of a sum of squares beyond f32's range)
        finite = math.isfinite(float(norm))
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        if not finite:
            self.total_notfinite += 1
        if finite or self.notfinite_count > MAX_CONSECUTIVE_ERRORS:
            self._inner(grads, norm)
        return norm

    def _inner(self, grads, norm) -> None:
        if self.acc_grads is not None:
            n = self.mini_step
            for name, g in grads.items():
                acc = self.acc_grads[name]
                self.acc_grads[name] = acc + (g - acc) / (n + 1)
            self.mini_step = (n + 1) % self.accumulate
            if self.mini_step != 0:
                return
            grads = self.acc_grads
            norm = global_norm(grads.values())
            self.acc_grads = {k: 0.0 * v for k, v in grads.items()}
        if not bool(norm < self.clip_norm):
            grads = {k: g / norm * self.clip_norm for k, g in grads.items()}
        updates = self.ranger.updates(grads, self.params)
        for name, u in updates.items():
            self.params[name].add_(u)

    def state_dict(self) -> dict:
        return {"notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite,
                "mini_step": self.mini_step,
                "acc_grads": (None if self.acc_grads is None
                              else dict(self.acc_grads)),
                "ranger": self.ranger.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.notfinite_count = int(state["notfinite_count"])
        self.total_notfinite = int(state["total_notfinite"])
        self.mini_step = int(state["mini_step"])
        if (state["acc_grads"] is None) != (self.acc_grads is None):
            raise ValueError("the state was saved with another accumulate")
        if self.acc_grads is not None:
            self.acc_grads = {
                n: state["acc_grads"][n].to(device=p.device, dtype=p.dtype)
                for n, p in self.params.items()}
        self.ranger.load_state_dict(state["ranger"])


def make_optimizer(params: dict[str, torch.nn.Parameter], cfg: Config,
                   steps_per_epoch: int | None = None) -> TrainOptimizer:
    return TrainOptimizer(params, cfg, steps_per_epoch)


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), the optimizer
    state and the count of steps taken, skipped ones included."""

    model: PoseNet
    optimizer: TrainOptimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def init_train_state(cfg: Config | None = None,
                     backbone_variant: str = "base", device=None,
                     seed: int = 0, state_dict: dict | None = None,
                     steps_per_epoch: int | None = None,
                     **posenet_kwargs) -> TrainState:
    """PoseNet and its optimizer on ``device`` (default: the GPU; raises
    without one).  Weights as in ``eval.serving.build_posenet``."""
    cfg = cfg or Config()
    model = build_posenet(cfg.model, backbone_variant, device=device,
                          seed=seed, state_dict=state_dict, **posenet_kwargs)
    optimizer = make_optimizer(dict(model.named_parameters()), cfg,
                               steps_per_epoch)
    return TrainState(model, optimizer)


def make_train_step(model: PoseNet, cfg: Config):
    """``step(state, batch, generator) -> metrics`` for ``state.model`` ==
    ``model``.  ``generator`` draws SizeHead's dropout mask.  Metrics:
    total_loss, grad_norm (of the raw gradients), every loss term and
    notfinite_total."""
    device = next(model.parameters()).device
    loss_fn = PoseLossFn(cfg.loss, r_type=cfg.model.r_type, device=device)
    names, params = zip(*model.named_parameters())

    def step(state: TrainState, batch: dict,
             generator: torch.Generator) -> dict:
        if state.model is not model:
            raise ValueError("this step was made for another model")
        out = model(batch, train=True, generator=generator)
        losses = loss_fn(out, batch)
        total = sum(losses.values())
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for n, p, g in zip(names, params, grads)}
        grad_norm = state.optimizer.step(grads)
        state.step += 1
        return {"total_loss": total.detach(), "grad_norm": grad_norm,
                **{k: v.detach() for k, v in losses.items()},
                "notfinite_total": state.optimizer.total_notfinite}

    return step
