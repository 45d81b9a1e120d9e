"""Serving entry points: the inference batch contract, the eager PoseNet
(``build_posenet``) and the ahead-of-time serving artifact.

Port of ``givepose_tpu/eval/serving.py``.  ``build_posenet`` is the eager
entry point; ``export_posenet`` traces the PoseNet forward once with
``torch.export`` into an artifact (a ``.pt2`` archive, returned as bytes)
that ``load_exported`` turns back into ``fn(weights, batch) -> output
dict``, without the model's Python code.  As in the JAX package:

  * the weights are call arguments, not constants of the graph: the
    artifact holds the graph only (kilobytes to a few megabytes, against
    ~400 MB of f32 ConvNeXt-B weights), and one artifact serves every
    checkpoint of its architecture;
  * the batch size is static, one artifact per traffic class.

Every kernel is an operator of ``ops/library.py`` in the graph, so an
artifact served on the card runs the same kernels, and counts the same
launches, as the eager forward.  A graph bakes in the device of the
tensors it creates (``torch.arange(..., device=...)``), so an artifact is
exported for one device, the GPU by default; with ``dcn_impl='auto'`` its
DCNv3 and int8 layers are the operators whatever the export host, never
the plain versions' ops (which ``dcn_impl='torch'`` asks for).

The entry points run on the GPU unless the caller asks for the CPU, and
raise when CUDA is absent rather than running on the CPU unasked.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from givepose_torch.core.config import ModelConfig
from givepose_torch.models.layers import init_weights_
from givepose_torch.models.posenet import PoseNet


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; a GPU device raises if there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run it on the CPU")
    return device


def serving_batch_spec(batch_size: int, img_size: int = 256,
                       out_res: int | None = None) -> dict:
    """Shapes and dtypes of the inference batch dict.  The coordinate map
    resolution is img_size/4 (stride-32 backbone, 8x upsampling heads)."""
    out_res = out_res or img_size // 4
    f32 = torch.float32
    return {
        "roi_img": ((batch_size, img_size, img_size, 3), f32),
        "roi_coord_2d": ((batch_size, out_res, out_res, 2), f32),
        "cam_K": ((batch_size, 3, 3), f32),
        "bbox_center": ((batch_size, 2), f32),
        "resize_ratio": ((batch_size,), f32),
        "roi_wh": ((batch_size, 2), f32),
        "mean_size": ((batch_size, 3), f32),
    }


def example_serving_batch(batch_size: int, img_size: int = 256,
                          out_res: int | None = None, seed: int = 0,
                          device=None) -> dict:
    """Random batch matching ``serving_batch_spec``, drawn from
    ``np.random.default_rng(seed)`` in the JAX package's order, so both
    packages see the same numbers."""
    device = resolve_device(device)
    out_res = out_res or img_size // 4
    rng = np.random.default_rng(seed)
    K = np.tile(np.array([[591.0, 0, 322.5], [0, 590.2, 244.1],
                          [0, 0, 1]], np.float32), (batch_size, 1, 1))
    arrays = {
        "roi_img": rng.normal(size=(batch_size, img_size, img_size, 3)),
        "roi_coord_2d": rng.uniform(-1, 1, (batch_size, out_res, out_res, 2)),
        "cam_K": K,
        "bbox_center": rng.uniform(100, 400, (batch_size, 2)),
        "resize_ratio": rng.uniform(0.2, 0.5, (batch_size,)),
        "roi_wh": rng.uniform(50, 150, (batch_size, 2)),
        "mean_size": np.tile([[0.1, 0.2, 0.1]], (batch_size, 1)),
    }
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
            for k, v in arrays.items()}


def build_posenet(cfg: ModelConfig | None = None,
                  backbone_variant: str = "base", device=None, seed: int = 0,
                  state_dict: dict | None = None, **posenet_kwargs) -> PoseNet:
    """PoseNet in eval mode on ``device`` (default: the GPU).

    Weights come from ``state_dict`` (for example
    ``models.convert_from_flax.flax_to_state_dict``) or, without one, from
    a seeded random init that follows the JAX package's initialisers.

    Turns TF32 off for cuBLAS and cuDNN (process-wide): the f32 parts of
    the model (pose heads, norms, the f32 compute dtype) are meant as full
    f32, as the JAX package's ``precision="highest"`` products are.
    """
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = PoseNet(cfg or ModelConfig(), backbone_variant, **posenet_kwargs)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


class _WeightsAsArguments(torch.nn.Module):
    """``forward(weights, batch)``: ``model``'s forward with every
    parameter and buffer taken from ``weights``.  The model is kept out of
    this module's state, so an export of it carries none of its tensors."""

    def __init__(self, model: PoseNet):
        super().__init__()
        self.__dict__["model"] = model

    def forward(self, weights: dict, batch: dict) -> dict:
        return torch.func.functional_call(self.model, weights, (batch,))


def _no_tf32() -> None:
    """f32 means f32 in the graph's matmuls and convolutions, as in
    ``build_posenet``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def export_posenet(weights: dict, cfg: ModelConfig | None = None,
                   backbone_variant: str = "base", batch_size: int = 128,
                   img_size: int = 256, device=None,
                   **posenet_kwargs) -> bytes:
    """Trace the PoseNet forward at a static batch size on ``device``
    (default: the GPU) and return the serialized artifact.

    ``weights`` (the model's ``state_dict``, or tensors of its shapes and
    dtypes on any device, ``meta`` included) gives only the shapes and
    dtypes of the weights the artifact takes at call time; it holds none
    of them.  ``posenet_kwargs`` go to ``PoseNet`` (backbone depths and
    widths of the ``custom`` variant)."""
    device = resolve_device(device)
    _no_tf32()
    with torch.device("meta"):
        model = PoseNet(cfg or ModelConfig(), backbone_variant,
                        img_size=img_size, **posenet_kwargs).eval()
    expected = set(model.state_dict())
    if set(weights) != expected:
        raise ValueError(
            f"weights do not match the model: missing "
            f"{sorted(expected - set(weights))[:5]}, unexpected "
            f"{sorted(set(weights) - expected)[:5]}")
    example_weights = {k: torch.empty(weights[k].shape,
                                      dtype=weights[k].dtype, device=device)
                       for k in sorted(weights)}
    example_batch = {k: torch.zeros(shape, dtype=dtype, device=device)
                     for k, (shape, dtype) in sorted(
                         serving_batch_spec(batch_size, img_size).items())}
    with torch.no_grad():
        exported = torch.export.export(
            _WeightsAsArguments(model), (example_weights, example_batch),
            strict=False)
    # the archive would keep the example inputs (the weights' size) and
    # each node's Python stack trace (~40 % of the graph's bytes); the
    # dtype assertions export puts beside every ``.to()`` (over a thousand
    # in ConvNeXt-B) check what tracing fixed and cost host time per call
    exported.example_inputs = None
    graph = exported.graph
    for node in list(graph.nodes):
        node.meta.pop("stack_trace", None)
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    exported.graph_module.recompile()
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_exported(blob: bytes):
    """Deserialize an artifact; returns ``fn(weights, batch) -> output
    dict``, with weights and batch on the device it was exported for."""
    from givepose_torch.ops import library  # noqa: F401  the graph's ops

    _no_tf32()
    module = torch.export.load(io.BytesIO(blob)).module()

    def fn(weights: dict, batch: dict) -> dict:
        with torch.inference_mode():
            return module({k: weights[k] for k in sorted(weights)},
                          {k: batch[k] for k in sorted(batch)})

    return fn


def save_exported(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load_exported_file(path: str):
    with open(path, "rb") as f:
        return load_exported(f.read())
