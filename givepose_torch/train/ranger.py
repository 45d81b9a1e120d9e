"""Ranger: gradient centralization, RAdam with weight decay, −lr·schedule,
and lookahead.

Port of ``givepose_tpu/train/ranger.py``, which composes, per update:

  1. gradient centralization: for every parameter of ndim > 1 subtract
     the mean over all dims but dim 0 (the output unit in the port's
     layouts; for ``ConvTranspose2d``, whose dim 0 is the *input*
     channel, this is the flax kernel's last axis too, as the weight
     bridge maps it, and is kept so);
  2. RAdam (b1 0.95, b2 0.999, eps 1e-5, rectification threshold 5),
     weight decay added to the adaptive step on the current weights;
  3. scaling by −lr(t − 1) from the schedule;
  4. lookahead (k 6, α 0.5): every k-th step the slow weights, which start
     as the initial parameters, move halfway to the fast ones, and the
     fast weights jump to them.

The RAdam scalars (b2^t, N_sma, the rectifier) are computed as float32
tensors in the JAX package's order: they are sensitive (one ulp of b2^t
moves N_sma by ~0.02 near step 6), and f64 would land ~0.6 % away.

State is plain tensors keyed by parameter name and one step count (RAdam's
t, the schedule position and the lookahead counter, which the JAX
package keeps apart but advances together), so a checkpoint or a
converted JAX optimizer state maps onto it.
"""

from __future__ import annotations

from typing import Callable

import torch


def centralize(g: torch.Tensor) -> torch.Tensor:
    if g.dim() > 1:
        return g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)
    return g


def radam_scalars(step: int, b1: float, b2: float, threshold: float
                  ) -> tuple[float, bool]:
    """(step size, adaptive?) of RAdam step ``step`` (1-based), in f32."""
    stepf = torch.tensor(float(step), dtype=torch.float32)
    beta2_t = torch.tensor(b2, dtype=torch.float32) ** stepf
    n_sma_max = 2.0 / (1 - b2) - 1.0
    n_sma = n_sma_max - 2.0 * stepf * beta2_t / (1 - beta2_t)
    rect = torch.sqrt(
        (1 - beta2_t) * (n_sma - 4) / (n_sma_max - 4)
        * (n_sma - 2) / n_sma * n_sma_max / (n_sma_max - 2))
    bias1 = 1.0 / (1 - torch.tensor(b1, dtype=torch.float32) ** stepf)
    adaptive = bool(n_sma > threshold)
    step_size = rect * bias1 if adaptive else bias1
    return float(step_size), adaptive


class Ranger:
    """Ranger over named tensors.  ``updates(grads, params)`` returns the
    deltas to add to ``params`` and advances the state; it does not touch
    the parameters itself."""

    def __init__(self, params: dict[str, torch.Tensor],
                 learning_rate: Callable[[int], torch.Tensor],
                 weight_decay: float = 0.0, b1: float = 0.95,
                 b2: float = 0.999, eps: float = 1e-5,
                 threshold: float = 5.0, alpha: float = 0.5, k: int = 6,
                 use_gc: bool = True):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.threshold = threshold
        self.alpha, self.k = alpha, k
        self.use_gc = use_gc
        with torch.no_grad():
            self.exp_avg = {n: torch.zeros_like(p) for n, p in params.items()}
            self.exp_avg_sq = {n: torch.zeros_like(p)
                               for n, p in params.items()}
            self.slow = {n: p.detach().clone() for n, p in params.items()}
        self.step = 0

    @torch.no_grad()
    def updates(self, grads: dict[str, torch.Tensor],
                params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        neg_lr = float(-self.learning_rate(self.step))
        self.step += 1
        step_size, adaptive = radam_scalars(self.step, b1, b2,
                                            self.threshold)
        sync = self.step % self.k == 0

        out = {}
        for name, g in grads.items():
            p = params[name]
            if self.use_gc:
                g = centralize(g)
            m = b1 * self.exp_avg[name] + (1 - b1) * g
            v = b2 * self.exp_avg_sq[name] + (1 - b2) * g * g
            self.exp_avg[name] = m
            self.exp_avg_sq[name] = v
            u = m / (torch.sqrt(v) + self.eps) if adaptive else m
            if wd != 0.0:
                u = u + wd * p
            u = neg_lr * (step_size * u)
            if sync:
                s = self.slow[name]
                new_slow = s + self.alpha * ((p + u) - s)
                u = new_slow - p
                self.slow[name] = new_slow
            out[name] = u
        return out

    def state_dict(self) -> dict:
        return {"step": self.step,
                "exp_avg": dict(self.exp_avg),
                "exp_avg_sq": dict(self.exp_avg_sq),
                "slow": dict(self.slow)}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        for key in ("exp_avg", "exp_avg_sq", "slow"):
            mine = getattr(self, key)
            if set(state[key]) != set(mine):
                raise KeyError(f"{key}: parameter names differ from the "
                               "optimizer's")
            for n, t in state[key].items():
                mine[n] = t.to(device=mine[n].device, dtype=mine[n].dtype)
