"""The port's serving graph, on the CPU: an artifact exported from shapes
alone serves real weights, and each kernel is its ``torch.ops.givepose``
operator in the graph (``ops/library.py``), whose CPU implementation is
the kernel's plain version.  Bar: the artifact against the eager forward,
1e-6 (the graph runs the same ops); the operators against the plain
versions, bitwise.
"""

import numpy as np
import pytest
import torch

from givepose_torch.core.config import ModelConfig
from givepose_torch.eval.serving import (build_posenet, example_serving_batch,
                                         export_posenet, load_exported)
from givepose_torch.models.posenet import PoseNet
from givepose_torch.ops import library  # noqa: F401  registers the ops
from givepose_torch.ops.dcnv3_cuda import dcnv3_cuda, dcnv3_win_cuda
from givepose_torch.ops.quant_matmul import mlp_int8_cuda

from test_torch_serving import BATCH, IMG, graph_ops

torch.set_num_threads(2)

# a small custom backbone; the last stage 512 wide, so that quant_dense
# puts it on the int8 MLP
SMALL = dict(backbone_depths=(1, 1, 1, 1), backbone_dims=(16, 32, 48, 512))


def test_shape_level_weights_serve_real_ones():
    """An artifact exported from a meta model's state dict (shapes only)
    serves a real model's weights as its eager forward does."""
    cfg = ModelConfig(compute_dtype="float32")
    with torch.device("meta"):
        meta = PoseNet(cfg, "custom", img_size=IMG, **SMALL)
    blob = export_posenet(meta.state_dict(), cfg, "custom", batch_size=BATCH,
                          img_size=IMG, device="cpu", **SMALL)
    model = build_posenet(cfg, "custom", device="cpu", seed=3, img_size=IMG,
                          **SMALL)
    batch = example_serving_batch(BATCH, img_size=IMG, seed=1, device="cpu")
    with torch.inference_mode():
        want = model(batch)
    got = load_exported(blob)(model.state_dict(), batch)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   msg=k)
    with pytest.raises(ValueError, match="missing"):
        export_posenet({}, cfg, "custom", batch_size=BATCH, img_size=IMG,
                       device="cpu", **SMALL)


@pytest.mark.parametrize("kw,ops", [
    (dict(), {"dcnv3_fwd"}),
    (dict(dcn_window=4, quant_dense=True), {"dcnv3_win_fwd", "int8_mlp"}),
    # asked for: the plain version's ops, no operator
    (dict(dcn_impl="torch"), set()),
])
def test_graph_holds_the_kernels_operators(kw, ops):
    """With ``dcn_impl='auto'`` the DCNv3 and int8 layers are operators in
    the graph whatever the export host (here the CPU), never the plain
    versions' ops; running the artifact on CPU tensors then takes the
    operators' plain versions, and no kernel launches."""
    cfg = ModelConfig(compute_dtype="float32", **kw)
    model = build_posenet(cfg, "custom", device="cpu", seed=4, img_size=IMG,
                          **SMALL)
    blob = export_posenet(model.state_dict(), cfg, "custom",
                          batch_size=BATCH, img_size=IMG, device="cpu",
                          **SMALL)
    assert graph_ops(blob) == ops
    batch = example_serving_batch(BATCH, img_size=IMG, seed=2, device="cpu")
    counters = (dcnv3_cuda, dcnv3_win_cuda, mlp_int8_cuda)
    for c in counters:
        c.launches = 0
    with torch.inference_mode():
        want = model(batch)
    got = load_exported(blob)(model.state_dict(), batch)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   msg=k)
    assert all(c.launches == 0 for c in counters)


def test_operators_registered():
    """Every kernel of the port is an operator of the one namespace, with
    a CPU implementation that is the kernel's plain version."""
    for name in ("dcnv3_fwd", "dcnv3_win_fwd", "dcnv3_bwd", "int8_mlp",
                 "int8_qmm", "int8_qmm_pre"):
        assert hasattr(torch.ops.givepose, name)
    from givepose_torch.ops.dcnv3 import dcnv3_core, dcnv3_core_bwd

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 9, 9, 8)).astype(np.float32))
    off = torch.from_numpy(rng.normal(0, 2, (1, 5, 5, 36)).astype(
        np.float32))
    m = torch.softmax(torch.from_numpy(rng.normal(size=(1, 5, 5, 2, 9))
                                       .astype(np.float32)), -1).reshape(
        1, 5, 5, 18)
    g = torch.from_numpy(rng.normal(size=(1, 5, 5, 8)).astype(np.float32))
    ops = torch.ops.givepose
    torch.testing.assert_close(ops.dcnv3_fwd(x, off, m, 3, 2, 1, 1, 2, 1.0),
                               dcnv3_core(x, off, m, stride=2, group=2),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        ops.dcnv3_win_fwd(x, off, m, 3, 2, 1, 1, 2, 1.0, 1),
        dcnv3_core(x, off, m, stride=2, group=2, window=1), rtol=0, atol=0)
    for a, b in zip(ops.dcnv3_bwd(x, off, m, g, 3, 2, 1, 1, 2, 1.0, 1),
                    dcnv3_core_bwd(x, off, m, g, stride=2, group=2,
                                   window=1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
