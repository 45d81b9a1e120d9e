"""timm ConvNeXt and reference GIVEPose checkpoints -> the port's models.

Port of ``givepose_tpu/models/convert_weights.py``.  Every real training
run of GIVEPose starts from ImageNet ConvNeXt weights (timm names,
reference network/backbone.py:36-46), and serving starts from a released
reference PoseNet ``.pth`` (network/PoseNet.py:134-231).  Nothing is
downloaded: the loaders take a checkpoint FILE (a torch ``state_dict``,
or ``{"state_dict": ...}``), or the converters a dict of tensors or numpy
arrays with the reference's names.

One map from reference names to the port's: the JAX package's map (copied
below: reference names -> its flax tree) composed with the port's flax
bridge (``models/convert_from_flax.py``: flax tree -> the port's
``state_dict``), so the two packages cannot name a weight differently.
Trouble spots the map handles, as the JAX package's does:

  * conv kernels OIHW, depthwise (C,1,K,K), Linear (O,I): the port is
    torch-layout, so each transpose of the first map is undone by the
    second, exactly;
  * the xyz heads' flat ``features.N`` ModuleList indices (deconv at 0,
    its GN at 1, ConvModules at 3,4 / 6,7 / 9,10), with the ``norm.*``
    keys that alias each ConvModule's ``gn.*`` skipped;
  * the DCNv3 wrapper's dead ``bn`` (its forward skips it) skipped;
  * the plain-conv MAP encoder (``use_dcn=''``), told apart by a 4-d
    ``nocs_encoder.features.{0,3,6}.weight``;
  * the size head's Conv1d ``(O, I, 1)`` weights and BatchNorm running
    statistics (``num_batches_tracked`` ignored; the bridge adds its own);
  * timm's classifier head and ``norm_pre`` dropped (features only).

The reference network runs exact (erf) GELU, so these weights belong in a
model built with ``ModelConfig(gelu_exact=True)``; each result loads into
the port's ConvNeXt or PoseNet with ``strict=True``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from givepose_torch.models.convert_from_flax import (_torch_tree,
                                                     flax_to_state_dict)


def _to_numpy(v):
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def load_torch_state_dict(path: str) -> dict:
    """The arrays of a torch checkpoint file, unwrapped from
    ``{"state_dict": ...}``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: _to_numpy(v) for k, v in obj.items()}


def _put(tree: dict, path: list[str], leaf: str, value):
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = np.asarray(value)


def _conv_kernel(v):
    return _to_numpy(v).transpose(2, 3, 1, 0)          # OIHW -> HWIO


def _convnext_tree(state: dict) -> dict:
    """timm-named arrays -> the JAX ConvNeXt's flax param tree."""
    params: dict = {}
    for name, v in state.items():
        v = _to_numpy(v)
        if name.startswith("stem.0."):
            leaf = "kernel" if name.endswith("weight") else "bias"
            _put(params, ["stem_conv"], leaf,
                 v.transpose(2, 3, 1, 0) if leaf == "kernel" else v)
        elif name.startswith("stem.1."):
            leaf = "scale" if name.endswith("weight") else "bias"
            _put(params, ["stem_norm"], leaf, v)
        elif ".downsample." in name:
            m = re.match(r"stages\.(\d+)\.downsample\.(\d)\.(\w+)", name)
            s, idx, leaf_t = int(m.group(1)), int(m.group(2)), m.group(3)
            if idx == 0:   # LN
                leaf = "scale" if leaf_t == "weight" else "bias"
                _put(params, [f"downsample_norm{s}"], leaf, v)
            else:          # 2x2 conv
                leaf = "kernel" if leaf_t == "weight" else "bias"
                _put(params, [f"downsample_conv{s}"], leaf,
                     v.transpose(2, 3, 1, 0) if leaf == "kernel" else v)
        elif ".blocks." in name:
            m = re.match(r"stages\.(\d+)\.blocks\.(\d+)\.(.+)", name)
            s, b, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            block = f"stage{s}_block{b}"
            if rest.startswith("conv_dw."):
                if rest.endswith("weight"):
                    # torch depthwise (C,1,K,K) -> block-owned (K,K,C)
                    _put(params, [block], "dw_kernel",
                         v.transpose(2, 3, 1, 0)[:, :, 0, :])
                else:
                    _put(params, [block], "dw_bias", v)
            elif rest.startswith("norm."):
                leaf = ("dw_ln_scale" if rest.endswith("weight")
                        else "dw_ln_bias")
                _put(params, [block], leaf, v)
            elif rest.startswith(("mlp.fc1.", "mlp.fc2.")):
                dense = "Dense_0" if rest.startswith("mlp.fc1.") else \
                    "Dense_1"
                leaf = "kernel" if rest.endswith("weight") else "bias"
                _put(params, [block, dense], leaf,
                     v.T if leaf == "kernel" else v)
            elif rest == "gamma":
                _put(params, [block], "gamma", v)
        # classifier head / norm_pre are dropped (features_only)
    return params


def _xyz_head_tree(state: dict, prefix: str, out: dict, name: str):
    """Reference TopDownXyzHead (xyz_head.py:195-366) -> the JAX head.

    torch ModuleList flat indices with up_types (deconv,bilinear,bilinear)
    and 2 ConvModules per block:
      0 deconv / 1 GN / 2 act / 3,4 ConvModule    (deconv block)
      5 upsample / 6,7 ConvModule                 (bilinear block 1)
      8 upsample / 9,10 ConvModule                (bilinear block 2)
    """
    conv_map = {3: 0, 4: 1, 6: 2, 7: 3, 9: 4, 10: 5}
    for key, v in state.items():
        if not key.startswith(prefix):
            continue
        rest = key[len(prefix):]
        if rest.startswith("features."):
            parts = rest.split(".")
            idx = int(parts[1])
            if idx == 0:           # deconv weight (in, out, kh, kw)
                _put(out, [name, "DeconvModule_0", "ConvTranspose_0"],
                     "kernel", _to_numpy(v).transpose(2, 3, 1, 0))
            elif idx == 1:         # deconv GN
                leaf = "scale" if parts[2] == "weight" else "bias"
                _put(out, [name, "DeconvModule_0", "GroupNorm32_0",
                           "GroupNorm_0"], leaf, _to_numpy(v))
            elif idx in conv_map:
                mod = f"ConvModule_{conv_map[idx]}"
                if parts[2] == "conv":
                    _put(out, [name, mod, "Conv_0"], "kernel",
                         _conv_kernel(v))
                elif parts[2] == "gn":   # 'norm.*' keys alias the same GN
                    leaf = "scale" if parts[3] == "weight" else "bias"
                    _put(out, [name, mod, "GroupNorm32_0", "GroupNorm_0"],
                         leaf, _to_numpy(v))
        elif rest.startswith("out_layer."):
            leaf = "kernel" if rest.endswith("weight") else "bias"
            v = _conv_kernel(v) if leaf == "kernel" else _to_numpy(v)
            _put(out, [name, "out_layer"], leaf, v)


def _dcnv3_tree(state: dict, prefix: str, out: dict, path: list[str]):
    """Reference DCNv3_C / DCNv3 module params -> the JAX DCNv3Conv tree.
    The wrapper's ``bn`` is dead (its forward comments out bn+gelu,
    network/dcnv3.py:36-37) and is skipped."""
    for key, v in state.items():
        if not key.startswith(prefix):
            continue
        rest = key[len(prefix):]
        if rest.startswith("conv."):
            leaf = "kernel" if rest.endswith("weight") else "bias"
            v = _conv_kernel(v) if leaf == "kernel" else _to_numpy(v)
            _put(out, path + ["proj"], leaf, v)
        elif rest.startswith("dcnv3.dw_conv.0."):
            leaf = "kernel" if rest.endswith("weight") else "bias"
            v = _conv_kernel(v) if leaf == "kernel" else _to_numpy(v)
            _put(out, path + ["dcnv3", "dw_conv"], leaf, v)
        elif rest.startswith("dcnv3.dw_conv.1.1."):
            leaf = "scale" if rest.endswith("weight") else "bias"
            _put(out, path + ["dcnv3", "dw_norm"], leaf, _to_numpy(v))
        elif rest.startswith("dcnv3."):
            sub = rest.split(".")[1]
            if sub in ("offset", "mask", "input_proj", "output_proj"):
                leaf = "kernel" if rest.endswith("weight") else "bias"
                v = _to_numpy(v).T if leaf == "kernel" else _to_numpy(v)
                _put(out, path + ["dcnv3", sub], leaf, v)


def _posenet_tree(state: dict) -> dict:
    """Full reference PoseNet state_dict -> the JAX PoseNet's flax
    variables {'params': ..., 'batch_stats': ...}.  Backbone keys use timm
    names under the ``backbone.`` prefix."""
    params: dict = {}
    batch_stats: dict = {}
    params["ConvNeXt_0"] = _convnext_tree(
        {k[len("backbone."):]: v for k, v in state.items()
         if k.startswith("backbone.")})
    _xyz_head_tree(state, "xyz_nocs_head.", params, "xyz_nocs_head")
    _xyz_head_tree(state, "xyz_deform_head.", params, "xyz_deform_head")

    # nocs_encoder: ModuleList [DCNv3_C, GN, act] x3 -> dcn{i} + GN32_{i};
    # plain-conv variant ([Conv2d, GN, act] x3) -> conv{i} + GN32_{i}
    for i, idx in enumerate((0, 3, 6)):
        conv_w = state.get(f"nocs_encoder.features.{idx}.weight")
        if conv_w is not None and _to_numpy(conv_w).ndim == 4:
            _put(params, ["nocs_encoder", f"conv{i}"], "kernel",
                 _conv_kernel(conv_w))
        else:
            _dcnv3_tree(state, f"nocs_encoder.features.{idx}.", params,
                        ["nocs_encoder", f"dcn{i}"])
        for leaf, t in (("scale", "weight"), ("bias", "bias")):
            _put(params, ["nocs_encoder", f"GroupNorm32_{i}", "GroupNorm_0"],
                 leaf, _to_numpy(state[f"nocs_encoder.features.{idx + 1}."
                                       f"{t}"]))

    _put(params, ["feat_reducer"], "kernel",
         _conv_kernel(state["feat_reducer.weight"]))
    _put(params, ["feat_reducer"], "bias",
         _to_numpy(state["feat_reducer.bias"]))

    for i, idx in enumerate((0, 3, 6)):
        _put(params, ["pnp_net", f"conv{i}"], "kernel",
             _conv_kernel(state[f"pnp_net.features.{idx}.weight"]))
        for leaf, t in (("scale", "weight"), ("bias", "bias")):
            _put(params, ["pnp_net", f"GroupNorm32_{i}", "GroupNorm_0"],
                 leaf, _to_numpy(state[f"pnp_net.features.{idx + 1}.{t}"]))
    for fc in ("fc1", "fc2", "fc1_z", "fc2_z", "fc_z", "fc_r", "fc_t"):
        _put(params, ["pnp_net", fc], "kernel",
             _to_numpy(state[f"pnp_net.{fc}.weight"]).T)
        _put(params, ["pnp_net", fc], "bias",
             _to_numpy(state[f"pnp_net.{fc}.bias"]))

    # size_head: conv1d(1x1) == Dense; BatchNorm running stats
    for conv in ("conv1", "conv2"):
        _put(params, ["size_head", conv], "kernel",
             _to_numpy(state[f"size_head.{conv}.weight"])[:, :, 0].T)
        _put(params, ["size_head", conv], "bias",
             _to_numpy(state[f"size_head.{conv}.bias"]))
    for leaf, t in (("scale", "weight"), ("bias", "bias")):
        _put(params, ["size_head", "bn1"], leaf,
             _to_numpy(state[f"size_head.bn1.{t}"]))
    for leaf, t in (("mean", "running_mean"), ("var", "running_var")):
        _put(batch_stats, ["size_head", "bn1"], leaf,
             _to_numpy(state[f"size_head.bn1.{t}"]))
    return {"params": params, "batch_stats": batch_stats}


def convert_convnext(state: dict) -> dict[str, torch.Tensor]:
    """timm-named arrays -> the ``state_dict`` of the port's ConvNeXt
    (``models/convnext.py``)."""
    return _torch_tree(_convnext_tree(state))


def load_pretrained_backbone(path: str) -> dict[str, torch.Tensor]:
    """A timm ConvNeXt checkpoint file -> the port's ConvNeXt
    ``state_dict`` (``posenet.backbone.load_state_dict(.., strict=True)``)."""
    return convert_convnext(load_torch_state_dict(path))


def convert_posenet(state: dict) -> dict[str, torch.Tensor]:
    """A reference PoseNet ``state_dict`` (network/PoseNet.py:134-231) ->
    the port's PoseNet ``state_dict``, the size head's BatchNorm buffers
    included."""
    return flax_to_state_dict(_posenet_tree(state))


def load_pretrained_posenet(path: str) -> dict[str, torch.Tensor]:
    """A reference PoseNet ``.pth`` file -> the port's PoseNet
    ``state_dict`` (``build_posenet(ModelConfig(gelu_exact=True), ...,
    state_dict=...)``)."""
    return convert_posenet(load_torch_state_dict(path))
