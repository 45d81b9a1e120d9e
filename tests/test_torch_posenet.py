"""The port's PoseNet against the JAX PoseNet, same weights, same inputs.

JAX weights come from a flax init, are perturbed with seeded numpy noise
(the DCNv3 offset/mask projections start at zero, which would sample on
the regular grid only), and are carried over by
``givepose_torch.models.convert_from_flax``.  Both sides run in f32 on the
CPU.  Bars: maps, size and translation 1e-4 absolute, ego rotation 1e-3.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from givepose_tpu.core.config import ModelConfig as JaxModelConfig
from givepose_tpu.models import PoseNet as JaxPoseNet

from givepose_torch.core.config import ModelConfig
from givepose_torch.eval.serving import (build_posenet, example_serving_batch,
                                         serving_batch_spec)
from givepose_torch.models.convert_from_flax import flax_to_state_dict
from givepose_torch.ops.dcnv3_cuda import dcnv3_cuda

torch.set_num_threads(2)

DEPTHS = (1, 1, 2, 1)
DIMS = (16, 32, 48, 64)
IMG = 128
BATCH = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_variables(model, batch, seed):
    """Seeded numpy weights for the flax tree of ``model`` (shapes from
    ``jax.eval_shape``): kernels ~ N(0, 1/fan_in), norm scales and layer
    scales near 1 and 0.5, small biases, DCNv3 offset std 0.05 and mask
    std 0.5, non-trivial BatchNorm statistics."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), batch)

    def leaf(path, s):
        names = [getattr(k, "key", str(k)) for k in path]
        name, shape = names[-1], s.shape
        if names[-2:] == ["offset", "kernel"]:
            v = rng.normal(0, 0.05, shape)
        elif names[-2:] == ["mask", "kernel"]:
            v = rng.normal(0, 0.5, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("kernel", "dw_kernel"):
            fan_in = int(np.prod(shape[:-1])) if name == "kernel" \
                else shape[0] * shape[1]
            v = rng.normal(0, 1 / np.sqrt(fan_in), shape)
        elif name in ("scale", "dw_ln_scale"):
            v = 1 + rng.normal(0, 0.1, shape)
        elif name == "gamma":
            v = 0.5 + rng.normal(0, 0.1, shape)
        else:                                  # biases, BN mean
            v = rng.normal(0, 0.02, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_batch(torch_batch):
    return {k: jax.numpy.asarray(v.numpy()) for k, v in torch_batch.items()}


@pytest.fixture(scope="module")
def batch():
    return example_serving_batch(BATCH, img_size=IMG, seed=3, device="cpu")


CASES = {
    "dcnv3": dict(use_dcn="dcnv3", dcn_window=0),
    "dcnv3_window4": dict(use_dcn="dcnv3", dcn_window=4),
    "conv": dict(use_dcn=""),
}


@pytest.mark.parametrize("case", list(CASES))
def test_posenet_matches_jax(batch, case):
    kw = CASES[case]
    jcfg = JaxModelConfig(compute_dtype="float32", **kw)
    jmodel = JaxPoseNet(cfg=jcfg, backbone_variant="custom",
                        backbone_depths=DEPTHS, backbone_dims=DIMS)
    jb = jax_batch(batch)
    variables = random_variables(jmodel, jb, seed=11)
    ref = jmodel.apply(variables, jb)

    state = flax_to_state_dict(variables)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    # every flax leaf maps to one key; BatchNorm's counter is the one extra
    assert len(state) == n_leaves + 1
    model = build_posenet(ModelConfig(compute_dtype="float32", **kw),
                          backbone_variant="custom", device="cpu",
                          state_dict=state, backbone_depths=DEPTHS,
                          backbone_dims=DIMS, img_size=IMG)
    assert set(model.state_dict()) == set(state)
    dcnv3_cuda.launches = 0
    with torch.inference_mode():
        out = model(batch)
    assert dcnv3_cuda.launches == 0          # CPU tensors take the plain path

    for key in ("nocs_coor", "ivfc_coor", "size", "trans", "t_raw"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, err_msg=key)
    np.testing.assert_allclose(out["rot"].numpy(), np.asarray(ref["rot"]),
                               atol=1e-3)
    # the perturbed pose head gives a rotation far from the identity
    assert np.abs(out["rot"].numpy() - np.eye(3)).max() > 1e-2


def test_serving_batch_contract():
    spec = serving_batch_spec(3, img_size=IMG)
    b = example_serving_batch(3, img_size=IMG, seed=0, device="cpu")
    assert set(spec) == set(b)
    for k, (shape, dtype) in spec.items():
        assert tuple(b[k].shape) == shape and b[k].dtype == dtype, k
    from givepose_tpu.eval.serving import example_serving_batch as jax_ex
    jb = jax_ex(3, img_size=IMG, seed=0)
    for k in spec:
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_posenet(backbone_variant="tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example_serving_batch(1)


@pytest.mark.parametrize("kw,match", [
    (dict(quant_dense=True), "int8"),
    (dict(nocsmap_encoder="att"), "attention"),
    (dict(drop_prob=0.1), "DropBlock"),
])
def test_unported_branches_raise(batch, kw, match):
    """Unported branches raise when the model is built; the int8 serving
    mode builds and serves, and raises on a training forward (rounding has
    zero gradient; the JAX package asserts the same)."""
    def build():
        return build_posenet(ModelConfig(compute_dtype="float32", **kw),
                             backbone_variant="custom", device="cpu",
                             backbone_depths=(1, 1, 1, 1),
                             backbone_dims=DIMS, img_size=IMG)

    if not kw.get("quant_dense"):
        with pytest.raises(NotImplementedError, match=match):
            build()
        return
    model = build()
    with pytest.raises(ValueError, match=match):
        model(batch, train=True, generator=torch.Generator().manual_seed(0))


def test_train_raises(batch):
    """The training forward needs the generator of SizeHead's dropout."""
    model = build_posenet(ModelConfig(compute_dtype="float32"),
                          backbone_variant="custom", device="cpu",
                          backbone_depths=(1, 1, 1, 1), backbone_dims=DIMS,
                          img_size=IMG)
    with pytest.raises(ValueError, match="Generator"):
        model(batch, train=True)


def test_port_imports_no_jax():
    """Every module of the port (the operator library, the W8A8 layer,
    the export, training, scale-net and evaluation CLIs and the data and
    eval layers named as well), chip_smoke.py and the GPU scripts under
    tools/ (the windowed kernel's sweep and the overfit proof too) import
    without JAX, OpenCV, PIL or matplotlib, which the GPU machine lacks;
    the JPEG decoder, PnP, the eval plots and the checkpoint converters
    are named too."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import givepose_torch\n"
        "for m in pkgutil.walk_packages(givepose_torch.__path__, "
        "'givepose_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import givepose_torch.ops.library, givepose_torch.models.quant\n"
        "import givepose_torch.cli.export, givepose_torch.eval\n"
        "import givepose_torch.cli.train, givepose_torch.cli.train_durable\n"
        "import givepose_torch.data.png, givepose_torch.data.native_loader\n"
        "import givepose_torch.data.augment3d, givepose_torch.data.synthetic\n"
        "import givepose_torch.cli.train_scale, givepose_torch.cli.evaluate\n"
        "import givepose_torch.eval.load_eval, givepose_torch.models\n"
        "import givepose_torch.data.jpeg, givepose_torch.eval.pnp\n"
        "import givepose_torch.eval.visualize\n"
        "import givepose_torch.models.convert_weights\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'tools')\n"
        "import train_path_spread, mlp_breakdown, dcnv3_breakdown\n"
        "import reduction_probe, qmm_breakdown, win_kernel_split\n"
        "import overfit_proof\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'givepose_tpu', 'cv2', 'PIL', "
        "'matplotlib')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('givepose_torch.')]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 49
