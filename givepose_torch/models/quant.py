"""Int8 dynamic-quantization dense layer for serving (PyTorch).

Port of ``givepose_tpu/models/quant.py``.  ``QuantDense`` is a drop-in for
the port's ``Linear`` (``models/layers.py``): the same parameters, named
and shaped alike (``weight`` (out, in) f32, ``bias`` (out,)), so state
dicts interchange both ways, and a model trained with ``Linear`` serves
with ``QuantDense``.  Its contraction is W8A8:

  * weights: symmetric per-output-channel int8, scales recomputed from the
    f32 master weights on every forward;
  * activations: symmetric per-row (per spatial position) int8 from a
    dynamic amax, quantized inside the kernel (``int8_qmm``, the port of
    the TPU kernel ``_qmm_kernel``);
  * an int32 accumulator, the dequantization, bias and an optional GELU
    (``act``) in the kernel's epilogue.

It is an inference feature: rounding has zero gradient.  No model of the
port instantiates it, as in the JAX package.
"""

from __future__ import annotations

import torch

from givepose_torch.models.layers import Linear
from givepose_torch.ops.quant_matmul import (quant_dense,
                                             quantize_activations,
                                             quantize_weights)


def quant_matmul_w8a8(x: torch.Tensor, w: torch.Tensor,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """(..., K) x (K, N) int8-quantized matmul with f32 dequant, plain
    tensor ops on any device.

    x is quantized per leading position (amax over K), w per output column
    (amax over K), both with the scale ``max(amax, 1e-8) / 127``, which
    keeps 0/0 out of zero rows and columns."""
    xq, x_scale = quantize_activations(x)
    wq, w_scale = quantize_weights(w)
    acc = (xq.double() @ wq.double()).float()        # exact int32 sums
    return (acc * x_scale * w_scale).to(out_dtype)


class QuantDense(Linear):
    """Drop-in ``Linear`` with a fused W8A8 contraction: the ``int8_qmm``
    kernel on CUDA tensors, its plain version on CPU tensors.  ``act``
    (none, gelu_tanh, gelu_exact) runs in the epilogue; ``dtype`` is the
    output's."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, act: str = "none",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, features, bias=use_bias,
                         compute_dtype=dtype)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant_dense(x, self.weight.t(), self.bias, act=self.act,
                           out_dtype=self.compute_dtype)


def make_dense(quant: bool, in_features: int, features: int,
               dtype: torch.dtype, use_bias: bool = True,
               act: str = "none") -> Linear:
    """Dense factory: ``Linear`` (f32 parameters, computed in ``dtype``)
    or ``QuantDense``.  Without ``quant`` the caller applies its own
    activation; ``act`` takes effect only in the fused int8 path."""
    if quant:
        return QuantDense(in_features, features, use_bias=use_bias,
                          dtype=dtype, act=act)
    return Linear(in_features, features, bias=use_bias, compute_dtype=dtype)
