"""JAX package weights -> the port's PoseNet or ScaleNet ``state_dict``.

Inverse direction of ``givepose_tpu/models/convert_weights.py``: takes the
flax variables ``{'params': ..., 'batch_stats': ...}`` of
``givepose_tpu.models.PoseNet`` or ``ScaleNet`` (nested dicts of numpy
arrays) and returns a ``state_dict`` that the port's model of the same
name loads with ``strict=True``.  Every flax leaf maps to exactly one torch key; the only
key added is BatchNorm's ``num_batches_tracked`` counter, which flax does
not keep.

Module paths: flax auto-names are renamed by ``_RENAMES``; leaf layouts:
  conv kernel     HWIO (kh,kw,in,out) -> OIHW            .transpose(3,2,0,1)
  dw_conv kernel  (k,k,1,C)           -> (C,1,k,k)        same transpose
  ConvTranspose   (kh,kw,out,in)      -> (in,out,kh,kw)   same transpose
  dw_kernel       (7,7,C)             -> (C,1,7,7)
  Dense kernel    (in,out)            -> (out,in)
  scale -> weight; batch_stats mean/var -> running_mean/running_var.

``flax_train_state_to_torch`` carries a whole JAX ``TrainState`` across
(params, batch_stats, the optax state of ``train/step.py:make_optimizer``
and the step), into the form ``givepose_torch.train.TrainState``
loads, so that the port continues a JAX run.  The optax state is read by
attribute name; nothing of optax or JAX is imported.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_RENAMES = (
    (r"^/ConvNeXt_0/", "/backbone/"),
    (r"/Dense_0/", "/fc1/"),
    (r"/Dense_1/", "/fc2/"),
    (r"/DeconvModule_(\d+)/ConvTranspose_0/", r"/deconvs/\1/conv/"),
    (r"/DeconvModule_(\d+)/GroupNorm32_0/GroupNorm_0/", r"/deconvs/\1/norm/"),
    (r"/ConvModule_(\d+)/Conv_0/", r"/convs/\1/conv/"),
    (r"/ConvModule_(\d+)/GroupNorm32_0/GroupNorm_0/", r"/convs/\1/norm/"),
    (r"/GroupNorm32_(\d+)/GroupNorm_0/", r"/norms/\1/"),
    (r"^/nocs_encoder/(?:dcn|conv)(\d+)/", r"/nocs_encoder/layers/\1/"),
    (r"^/pnp_net/conv(\d+)/", r"/pnp_net/convs/\1/"),
    # ScaleNet's MobileNetV3 towers: flax's auto-names inside Bneck
    (r"/(bneck\d+)/Conv_(\d+)/", r"/\1/convs/\2/"),
    (r"/(bneck\d+)/BatchNorm_(\d+)/", r"/\1/bns/\2/"),
    (r"/SqueezeExcite_0/", "/se/"),
)

_LEAVES = {
    "dw_kernel": "dwconv/weight",
    "dw_bias": "dwconv/bias",
    "dw_ln_scale": "norm/weight",
    "dw_ln_bias": "norm/bias",
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "gamma": "gamma",
    "mean": "running_mean",
    "var": "running_var",
}


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(dict(v), key))
        else:
            out[key] = np.asarray(v)
    return out


def _convert_leaf(leaf: str, v: np.ndarray) -> np.ndarray:
    if leaf == "dw_kernel":                      # (7,7,C) -> (C,1,7,7)
        return v.transpose(2, 0, 1)[:, None]
    if leaf == "kernel" and v.ndim == 4:         # conv / deconv kernels
        return v.transpose(3, 2, 0, 1)
    if leaf == "kernel" and v.ndim == 2:         # Dense
        return v.T
    return v


def torch_key(flax_path: str) -> str:
    """Flax path 'a/b/leaf' -> torch state_dict key 'a.b.leaf'; a bare
    leaf (the variables of a single layer, such as a ``QuantDense``) maps
    to its torch name alone."""
    path, _, leaf = flax_path.rpartition("/")
    path = "/" + path + "/"
    for pat, rep in _RENAMES:
        path = re.sub(pat, rep, path)
    if leaf not in _LEAVES:
        raise KeyError(f"no mapping for flax leaf {flax_path}")
    return (path.strip("/") + "/" + _LEAVES[leaf]).lstrip("/").replace(
        "/", ".")


def _torch_tree(tree, into: dict | None = None,
                dtype=np.float32) -> dict[str, torch.Tensor]:
    """Flax-layout tree of arrays -> {torch key: tensor of ``dtype``}."""
    out = {} if into is None else into
    for path, v in _flatten(dict(tree)).items():
        key = torch_key(path)
        if key in out:
            raise KeyError(f"two flax leaves map to {key}")
        leaf = path.rsplit("/", 1)[-1]
        out[key] = torch.from_numpy(
            np.array(_convert_leaf(leaf, v), dtype=dtype, order="C"))
    return out


def flax_to_state_dict(variables: dict,
                       dtype=np.float32) -> dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} of the JAX PoseNet or ScaleNet -> torch
    state_dict, its floating tensors in ``dtype``."""
    state: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        _torch_tree(variables.get(collection, {}), state, dtype)
    for key in list(state):
        if key.endswith(".running_mean"):
            state[key[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.long)
    return state


def flax_train_state_to_torch(state) -> dict:
    """A JAX ``TrainState`` (``givepose_tpu/train/step.py``, Ranger path,
    with or without accumulation) -> the ``state_dict`` of the port's
    ``TrainState``.

    The optax state is apply_if_finite(MultiSteps?(chain(clip,
    lookahead(chain(GC, RAdam, schedule))))): the finite-guard counters,
    MultiSteps' mini-step and accumulator, the lookahead's slow weights,
    RAdam's moments, and one step count, which RAdam, the schedule and
    the lookahead each keep and advance together."""
    guard = state.opt_state
    inner = guard.inner_state
    acc, mini_step = None, 0
    if hasattr(inner, "mini_step"):                  # MultiSteps
        acc = _torch_tree(inner.acc_grads)
        mini_step = int(np.asarray(inner.mini_step))
        inner = inner.inner_opt_state
    _clip, lookahead = inner
    _gc, radam, schedule = lookahead.inner
    steps = {int(np.asarray(c)) for c in (radam.step, schedule.count,
                                          lookahead.step)}
    if len(steps) != 1:
        raise ValueError(f"RAdam, schedule and lookahead counts differ: "
                         f"{steps}")
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    return {
        "step": int(np.asarray(state.step)),
        "model": flax_to_state_dict(variables),
        "optimizer": {
            "notfinite_count": int(np.asarray(guard.notfinite_count)),
            "total_notfinite": int(np.asarray(guard.total_notfinite)),
            "mini_step": mini_step,
            "acc_grads": acc,
            "ranger": {
                "step": steps.pop(),
                "exp_avg": _torch_tree(radam.exp_avg),
                "exp_avg_sq": _torch_tree(radam.exp_avg_sq),
                "slow": _torch_tree(lookahead.slow),
            },
        },
    }
