"""Adam behind a global-norm clip, with optax's arithmetic.

Port of the scale-net optimizer of ``givepose_tpu/cli/train_scale.py``,
``optax.chain(clip_by_global_norm(grad_clip_norm), adam(schedule))``:

  1. clip: ``g`` as it is when its global norm is below the limit, else
     ``(g / norm) * limit`` (optax's ``select``; no epsilon);
  2. Adam (b1 0.9, b2 0.999, eps 1e-8 added after the square root):
     ``m = (1 - b1)·g + b1·m``, ``v = (1 - b2)·g² + b2·v``, each moment
     divided by ``1 - b**t`` computed in f32 at the incremented count;
  3. scaling by ``-lr(t)`` from the schedule, read at the count *before*
     its increment.

``torch.optim.Adam`` differs (eps inside the bias correction, the step
size folded into one scalar).  State is plain tensors keyed by parameter
name and one count, which optax's Adam and schedule keep apart but
advance together.
"""

from __future__ import annotations

from typing import Callable

import torch

from givepose_torch.train.step import global_norm

B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.adam's defaults


class ClippedAdam:
    """``step(grads)`` clips, runs Adam and adds the update to the named
    parameters in place; returns the raw gradients' global norm."""

    def __init__(self, params: dict[str, torch.nn.Parameter],
                 learning_rate: Callable[[int], torch.Tensor],
                 clip_norm: float):
        self.params = params
        self.learning_rate = learning_rate
        self.clip_norm = clip_norm
        with torch.no_grad():
            self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
            self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        norm = global_norm(grads.values())
        if not bool(norm < self.clip_norm):
            grads = {k: (g / norm) * self.clip_norm for k, g in grads.items()}
        neg_lr = -self.learning_rate(self.count)
        self.count += 1
        t = torch.tensor(float(self.count), dtype=torch.float32)
        bc1 = 1 - torch.tensor(B1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(B2, dtype=torch.float32) ** t
        for name, g in grads.items():
            m = (1 - B1) * g + B1 * self.mu[name]
            v = (1 - B2) * (g * g) + B2 * self.nu[name]
            self.mu[name], self.nu[name] = m, v
            u = (m / bc1.to(m.device)) / (
                torch.sqrt(v / bc2.to(v.device)) + EPS)
            self.params[name].add_(neg_lr.to(u.device) * u)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu),
                "nu": dict(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for key in ("mu", "nu"):
            mine = getattr(self, key)
            if set(state[key]) != set(mine):
                raise KeyError(f"{key}: parameter names differ from the "
                               "optimizer's")
            for n, t in state[key].items():
                mine[n] = t.to(device=mine[n].device, dtype=mine[n].dtype)
