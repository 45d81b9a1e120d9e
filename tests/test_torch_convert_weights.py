"""``givepose_torch/models/convert_weights.py`` against
``givepose_tpu/models/convert_weights.py``.

  * A timm-named tiny ConvNeXt, built as ``tests/test_convert_weights.py``
    builds its torch oracle: both converters, then the JAX ConvNeXt, the
    port's and the oracle, exact GELU, within 2e-5 (that file's bar).
  * A reference-named PoseNet ``state_dict`` of seeded random arrays
    (``custom`` backbone), for the DCNv3 and the plain-conv MAP encoders:
    the test writes the reference's names and torch layouts itself, from
    the JAX PoseNet's parameter tree, with the keys the converters must
    skip (the DCNv3 wrapper's dead ``bn``, the heads' ``norm.*`` aliases,
    ``num_batches_tracked``, timm's classifier head).  The JAX converter
    must give that tree back exactly; the port's converter loads
    strictly; the two forwards (``gelu_exact``) agree within the PoseNet
    bars: maps, size and translation 1e-4, rotation 1e-3.
  * ``.pth`` round trips through ``load_pretrained_*``, bare and inside
    ``{"state_dict": ...}``.
  * The reference key list of a ConvNeXt-B PoseNet checkpoint (names,
    shapes, dtypes) that ``chip_smoke.py`` writes its checkpoint under,
    committed as ``tests/data/reference_posenet_base_keys.json``, equals
    this file's oracle on the JAX PoseNet's tree (shapes by
    ``jax.eval_shape``, nothing computed).  Rewrite it with
    ``PYTHONPATH=.:tests python3 tests/test_torch_convert_weights.py``.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from givepose_torch.core.config import ModelConfig
from givepose_torch.eval.serving import build_posenet, example_serving_batch
from givepose_torch.models import convert_weights as port_cw
from givepose_torch.models.convnext import ConvNeXt
from givepose_tpu.core.config import ModelConfig as JaxModelConfig
from givepose_tpu.models import PoseNet as JaxPoseNet
from givepose_tpu.models import convert_weights as jax_cw
from givepose_tpu.models.convnext import ConvNeXt as JaxConvNeXt
from test_convert_weights import TorchConvNeXtTiny, timm_style_state_dict
from test_torch_posenet import DEPTHS, DIMS, random_variables

torch.set_num_threads(2)

IMG = 64        # 16² maps: the JAX forward's first, op-by-op call is cheap


def _timm_model():
    torch.manual_seed(0)
    model = TorchConvNeXtTiny().eval()
    with torch.no_grad():          # gamma away from 1e-6: the blocks matter
        for stage in model.stages:
            for blk in stage.blocks:
                blk.gamma.copy_(torch.randn_like(blk.gamma) * 0.1)
    return model


def test_convnext_equals_jax_and_the_oracle(tmp_path):
    model = _timm_model()
    state = timm_style_state_dict(model)
    state["head.fc.weight"] = torch.zeros(10, 16)    # timm's, dropped
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 3)).astype(
        np.float32)
    with torch.no_grad():
        oracle = model(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    oracle = oracle.transpose(0, 2, 3, 1)
    ref = JaxConvNeXt(depths=(1, 1), dims=(8, 16), gelu_exact=True).apply(
        {"params": jax_cw.convert_convnext(state)}, jnp.asarray(x))

    port = ConvNeXt(depths=(1, 1), dims=(8, 16), gelu_exact=True).eval()
    sd = port_cw.convert_convnext(state)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-5)

    path = str(tmp_path / "convnext.pth")
    torch.save({"state_dict": {k: v.detach() for k, v in state.items()}},
               path)
    loaded = port_cw.load_pretrained_backbone(path)
    assert loaded.keys() == sd.keys()
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k


_CONV_IDX = {0: 3, 1: 4, 2: 6, 3: 7, 4: 9, 5: 10}


def _oihw(v):
    return v.transpose(3, 2, 0, 1)


def reference_state_dict(variables: dict) -> dict:
    """The reference PoseNet's names and torch layouts for the JAX
    PoseNet's ``variables``, plus the keys a converter must skip."""
    out = {}
    flat = {"/".join(getattr(k, "key", str(k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(variables)}
    for path, v in flat.items():
        coll, *mods, leaf = path.split("/")
        mod = "/".join(mods)
        if coll == "batch_stats":                    # size_head/bn1
            out[f"size_head.bn1.running_{leaf}"] = v
            continue
        wb = "weight" if leaf in ("kernel", "scale") else "bias"
        if mods[0] == "ConvNeXt_0":
            out.update(_backbone_key("/".join(mods[1:]), leaf, v))
        elif mods[0] in ("xyz_nocs_head", "xyz_deform_head"):
            head, rest = mods[0], "/".join(mods[1:])
            if rest == "DeconvModule_0/ConvTranspose_0":
                out[f"{head}.features.0.weight"] = _oihw(v)
            elif rest == "DeconvModule_0/GroupNorm32_0/GroupNorm_0":
                out[f"{head}.features.1.{wb}"] = v
            elif rest.startswith("ConvModule_"):
                idx = _CONV_IDX[int(mods[1].split("_")[1])]
                if mods[2] == "Conv_0":
                    out[f"{head}.features.{idx}.conv.weight"] = _oihw(v)
                else:         # the GN, and its 'norm.*' alias
                    out[f"{head}.features.{idx}.gn.{wb}"] = v
                    out[f"{head}.features.{idx}.norm.{wb}"] = v
            elif rest == "out_layer":
                out[f"{head}.out_layer.{wb}"] = (_oihw(v) if leaf == "kernel"
                                                 else v)
            else:
                raise KeyError(path)
        elif mods[0] == "nocs_encoder":
            i = int(mods[1][-1])
            idx = 3 * i
            p = f"nocs_encoder.features.{idx}"
            if mods[1].startswith("GroupNorm32_"):
                out[f"nocs_encoder.features.{idx + 1}.{wb}"] = v
            elif mods[1].startswith("conv"):
                out[f"{p}.{wb}"] = _oihw(v) if leaf == "kernel" else v
            elif mods[2] == "proj":
                out[f"{p}.conv.{wb}"] = _oihw(v) if leaf == "kernel" else v
            elif mods[3] == "dw_conv":
                out[f"{p}.dcnv3.dw_conv.0.{wb}"] = (_oihw(v)
                                                    if leaf == "kernel"
                                                    else v)
            elif mods[3] == "dw_norm":
                out[f"{p}.dcnv3.dw_conv.1.1.{wb}"] = v
            else:                  # offset, mask, input_proj, output_proj
                out[f"{p}.dcnv3.{mods[3]}.{wb}"] = (v.T if leaf == "kernel"
                                                    else v)
            if mods[1].startswith("dcn"):          # the wrapper's dead bn
                c = out.get(f"{p}.conv.bias", np.zeros(1)).shape[0]
                for name, val in (("weight", 1.0), ("bias", 0.0),
                                  ("running_mean", 0.0),
                                  ("running_var", 1.0)):
                    out[f"{p}.bn.{name}"] = np.full(c, val, np.float32)
                out[f"{p}.bn.num_batches_tracked"] = np.int64(7)
        elif mods[0] == "feat_reducer":
            out[f"feat_reducer.{wb}"] = _oihw(v) if leaf == "kernel" else v
        elif mods[0] == "pnp_net":
            if mods[1].startswith("conv"):
                out[f"pnp_net.features.{3 * int(mods[1][-1])}.{wb}"] = \
                    _oihw(v) if leaf == "kernel" else v
            elif mods[1].startswith("GroupNorm32_"):
                out[f"pnp_net.features.{3 * int(mods[1][-1]) + 1}.{wb}"] = v
            else:
                out[f"pnp_net.{mods[1]}.{wb}"] = (v.T if leaf == "kernel"
                                                  else v)
        elif mod in ("size_head/conv1", "size_head/conv2"):
            out[f"size_head.{mods[1]}.{wb}"] = (v.T[:, :, None]
                                                if leaf == "kernel" else v)
        elif mod == "size_head/bn1":
            out[f"size_head.bn1.{wb}"] = v
        else:
            raise KeyError(path)
    out["size_head.bn1.num_batches_tracked"] = np.int64(3)
    return out


def _backbone_key(mod: str, leaf: str, v) -> dict:
    wb = "weight" if leaf in ("kernel", "scale", "dw_ln_scale") else "bias"
    p = "backbone."
    if mod in ("stem_conv", "stem_norm"):
        i = 0 if mod == "stem_conv" else 1
        return {f"{p}stem.{i}.{wb}": _oihw(v) if leaf == "kernel" else v}
    if mod.startswith(("downsample_norm", "downsample_conv")):
        s = int(mod[-1])
        i = 0 if "norm" in mod else 1
        return {f"{p}stages.{s}.downsample.{i}.{wb}":
                _oihw(v) if leaf == "kernel" else v}
    block, _, dense = mod.partition("/")
    s, b = block[len("stage"):].split("_block")
    q = f"{p}stages.{s}.blocks.{b}."
    if dense:
        fc = "fc1" if dense == "Dense_0" else "fc2"
        return {f"{q}mlp.{fc}.{wb}": v.T if leaf == "kernel" else v}
    if leaf == "dw_kernel":
        return {f"{q}conv_dw.weight": v.transpose(2, 0, 1)[:, None]}
    if leaf == "dw_bias":
        return {f"{q}conv_dw.bias": v}
    if leaf in ("dw_ln_scale", "dw_ln_bias"):
        return {f"{q}norm.{wb}": v}
    return {f"{q}gamma": v}


def _same_tree(a: dict, b: dict):
    fa = {jax.tree_util.keystr(p): np.asarray(v)
          for p, v in jax.tree_util.tree_leaves_with_path(a)}
    fb = {jax.tree_util.keystr(p): np.asarray(v)
          for p, v in jax.tree_util.tree_leaves_with_path(b)}
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("use_dcn", ["dcnv3", ""])
def test_posenet_equals_jax(use_dcn, tmp_path):
    """A reference PoseNet ``state_dict``, DCNv3 or plain-conv encoder:
    both converters, both forwards."""
    batch = example_serving_batch(2, img_size=IMG, seed=3, device="cpu")
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    # dcn_impl 'xla': the JAX package's plain DCNv3 core, which its own
    # tests hold the Pallas kernel to; its interpret mode takes ~30 s here
    jcfg = JaxModelConfig(compute_dtype="float32", use_dcn=use_dcn,
                          gelu_exact=True, dcn_impl="xla")
    jmodel = JaxPoseNet(cfg=jcfg, backbone_variant="custom",
                        backbone_depths=DEPTHS, backbone_dims=DIMS)
    variables = random_variables(jmodel, jb, seed=5)
    state = reference_state_dict(variables)
    state["backbone.head.fc.weight"] = np.zeros((10, DIMS[-1]), np.float32)

    converted = jax_cw.convert_posenet(state)
    _same_tree(converted, variables)      # the reference names are right
    ref = jmodel.apply(converted, jb)

    sd = port_cw.convert_posenet(state)
    model = build_posenet(ModelConfig(compute_dtype="float32",
                                      use_dcn=use_dcn, gelu_exact=True),
                          backbone_variant="custom", device="cpu",
                          state_dict=sd, backbone_depths=DEPTHS,
                          backbone_dims=DIMS, img_size=IMG)
    with torch.inference_mode():
        out = model(batch)
    for key in ("nocs_coor", "ivfc_coor", "size", "trans", "t_raw"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=1e-4, err_msg=key)
    np.testing.assert_allclose(out["rot"].numpy(), np.asarray(ref["rot"]),
                               rtol=0, atol=1e-3)
    assert np.abs(out["rot"].numpy() - np.eye(3)).max() > 1e-2
    for stat in ("running_mean", "running_var"):
        np.testing.assert_array_equal(
            sd[f"size_head.bn1.{stat}"].numpy(),
            state[f"size_head.bn1.{stat}"])

    path = str(tmp_path / "posenet.pth")
    tensors = {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()}
    for i, saved in enumerate((tensors, {"state_dict": tensors,
                                         "epoch": 3})):
        torch.save(saved, path)
        loaded = port_cw.load_pretrained_posenet(path)
        assert loaded.keys() == sd.keys()
        for k in sd:
            assert torch.equal(loaded[k], sd[k]), (i, k)


KEY_LIST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "reference_posenet_base_keys.json")


def reference_key_list() -> dict:
    """{name: [shape, dtype]} of a reference ConvNeXt-B PoseNet checkpoint
    under the default ``ModelConfig`` (DCNv3 encoder) at the serving
    batch's default image size (``pnp_net.fc1``'s width follows it), from
    the oracle."""
    batch = example_serving_batch(1, seed=3, device="cpu")
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jmodel = JaxPoseNet(cfg=JaxModelConfig(gelu_exact=True),
                        backbone_variant="base")
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jb)
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    return {k: [list(np.shape(v)), str(np.asarray(v).dtype)]
            for k, v in sorted(reference_state_dict(zeros).items())}


def test_committed_reference_key_list_is_the_oracles():
    with open(KEY_LIST) as f:
        committed = json.load(f)
    assert committed == reference_key_list()


if __name__ == "__main__":
    with open(KEY_LIST, "w") as f:
        json.dump(reference_key_list(), f, indent=0, sort_keys=True)
        f.write("\n")
