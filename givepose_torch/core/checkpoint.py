"""Checkpoints of a ``TrainState``.

Port of ``givepose_tpu/core/checkpoint.py``.  One file per checkpoint
(``torch.save``) holds the model's ``state_dict`` (parameters and
BatchNorm statistics), the whole optimizer state (finite-guard and
accumulation counters, RAdam moments, lookahead weights, schedule
position) and the step counter, so a resume continues the run exactly,
schedule included.  Every checkpoint is kept unless ``keep`` says
otherwise.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, state, keep: int = 0) -> None:
    """Write ``state`` (a ``train.step.TrainState``) to ``path``; then,
    if ``keep`` > 0, delete all but the newest ``keep`` checkpoints that
    share the name's prefix (``ckpt_N``) in its directory."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    _prune_checkpoints(os.path.dirname(path), os.path.basename(path), keep)


def _prune_checkpoints(model_dir: str, just_saved: str, keep: int) -> None:
    if not keep or keep <= 0 or "_" not in just_saved:
        return
    prefix = just_saved.rsplit("_", 1)[0] + "_"
    cands = [f for f in os.listdir(model_dir)
             if f.startswith(prefix) and f[len(prefix):].isdigit()
             and os.path.isfile(os.path.join(model_dir, f))]
    cands.sort(key=lambda f: int(f[len(prefix):]))
    for f in cands[:-keep]:
        os.remove(os.path.join(model_dir, f))


def restore_checkpoint(path: str, state):
    """Load the checkpoint at ``path`` into ``state`` (in place, onto the
    devices its tensors live on) and return it."""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    state.load_state_dict(saved)
    return state


def latest_checkpoint(model_dir: str) -> str | None:
    """Path of the ``ckpt_N`` with the largest N in ``model_dir``."""
    if not os.path.isdir(model_dir):
        return None
    cands = [f for f in os.listdir(model_dir)
             if f.startswith("ckpt_") and f[5:].isdigit()
             and os.path.isfile(os.path.join(model_dir, f))]
    if not cands:
        return None
    cands.sort(key=lambda f: int(f[5:]))
    return os.path.join(model_dir, cands[-1])
