"""The port's serving artifact (``eval/serving.py``, ``cli/export.py``),
mirroring ``tests/test_serving.py``, on the CPU.

The artifact must roundtrip through bytes and a file, hold no weights (the
weights are call arguments), reproduce the eager forward, keep every
kernel as its ``torch.ops.givepose`` operator, and agree with the JAX
package's artifact on the same (converted) weights.  Bars: the port's
artifact against its eager forward 1e-6 (the graph runs the same ops);
against the JAX artifact, f32, the PoseNet parity bars: maps, size and
translation 1e-4, rotation 1e-3.
"""

import io
import os

import numpy as np
import pytest
import torch

from givepose_tpu.core.config import ModelConfig as JaxModelConfig
from givepose_tpu.eval.serving import export_posenet as jax_export_posenet
from givepose_tpu.eval.serving import load_exported as jax_load_exported
from givepose_tpu.models import PoseNet as JaxPoseNet

from givepose_torch.core.config import ModelConfig
from givepose_torch.eval.serving import (build_posenet, example_serving_batch,
                                         export_posenet, load_exported,
                                         load_exported_file, save_exported)
from givepose_torch.models.convert_from_flax import flax_to_state_dict
from givepose_torch.ops import library  # noqa: F401  the graph's ops

from test_torch_posenet import jax_batch, random_variables

torch.set_num_threads(2)

IMG = 64
BATCH = 2
KEYS = ("nocs_coor", "ivfc_coor", "size", "trans", "rot", "rot_raw", "t_raw")


@pytest.fixture(scope="module")
def tiny():
    """ConvNeXt-tiny PoseNet (f32, DCNv3 MAPEncoder) at 64² crops: seeded
    flax weights, their torch state dict, a batch, and the port's
    artifact."""
    cfg = dict(compute_dtype="float32")
    batch = example_serving_batch(BATCH, img_size=IMG, seed=5, device="cpu")
    jmodel = JaxPoseNet(cfg=JaxModelConfig(**cfg), backbone_variant="tiny")
    variables = random_variables(jmodel, jax_batch(batch), seed=21)
    state = flax_to_state_dict(variables)
    blob = export_posenet(state, ModelConfig(**cfg), "tiny",
                          batch_size=BATCH, img_size=IMG, device="cpu")
    return dict(cfg=cfg, batch=batch, variables=variables, state=state,
                blob=blob)


def graph_ops(blob: bytes) -> set:
    """Names of the ``givepose`` operators in an artifact's graph."""
    ep = torch.export.load(io.BytesIO(blob))
    return {str(n.target).split(".")[1] for n in ep.graph.nodes
            if str(n.target).startswith("givepose.")}


def test_artifact_matches_jax_artifact(tiny):
    """The same weights through the JAX package's artifact (StableHLO) and
    the port's (torch.export)."""
    blob = jax_export_posenet(tiny["variables"],
                              cfg=JaxModelConfig(**tiny["cfg"]),
                              backbone_variant="tiny", batch_size=BATCH,
                              img_size=IMG, platforms=("cpu",))
    ref = jax_load_exported(blob)(tiny["variables"], jax_batch(tiny["batch"]))
    out = load_exported(tiny["blob"])(tiny["state"], tiny["batch"])
    assert set(out) == set(ref)
    for key in ("nocs_coor", "ivfc_coor", "size", "trans"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, err_msg=key)
    np.testing.assert_allclose(out["rot"].numpy(), np.asarray(ref["rot"]),
                               atol=1e-3)
    assert np.abs(out["rot"].numpy() - np.eye(3)).max() > 1e-2


def test_artifact_holds_no_weights(tiny):
    """< 5 MB, against f32 weights at least 20 times that."""
    weight_bytes = sum(v.numel() * 4 for v in tiny["state"].values())
    assert len(tiny["blob"]) < 5 * 2 ** 20, len(tiny["blob"])
    assert weight_bytes >= 20 * len(tiny["blob"]), weight_bytes


def test_roundtrip_matches_eager(tiny, tmp_path):
    path = os.path.join(tmp_path, "posenet_tiny.pt2")
    save_exported(path, tiny["blob"])
    fn = load_exported_file(path)
    model = build_posenet(ModelConfig(**tiny["cfg"]), "tiny", device="cpu",
                          state_dict=tiny["state"], img_size=IMG)
    with torch.inference_mode():
        want = model(tiny["batch"])
    got = fn(tiny["state"], tiny["batch"])
    assert set(got) == set(want) == set(KEYS)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   msg=k)


def test_export_cli(tmp_path, capsys):
    from givepose_torch.cli.export import main

    out = os.path.join(tmp_path, "posenet.pt2")
    main(["--out", out, "--batch_size", "2", "--img_size", str(IMG),
          "--backbone", "tiny", "--compute_dtype", "float32",
          "--device", "cpu"])
    assert os.path.exists(out)
    printed = capsys.readouterr().out
    assert "exported" in printed and "M params" in printed
    # the CLI's default --use_dcn is '': the plain-conv MAPEncoder
    assert graph_ops(open(out, "rb").read()) == set()
    cfg = ModelConfig(compute_dtype="float32", use_dcn="")
    model = build_posenet(cfg, "tiny", device="cpu", seed=6, img_size=IMG)
    batch = example_serving_batch(BATCH, img_size=IMG, seed=7, device="cpu")
    got = load_exported_file(out)(model.state_dict(), batch)
    with torch.inference_mode():
        want = model(batch)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   msg=k)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a device the export asks for the GPU, and raises without
    one rather than exporting for the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_posenet({}, ModelConfig())
    from givepose_torch.cli.export import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--out", "unused.pt2"])
