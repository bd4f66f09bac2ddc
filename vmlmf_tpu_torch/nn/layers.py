"""Non-recurrent layers: embedding, dense, dropout, and the convolution
stack of `DeepConvNet` (counterpart of `vmlmf_tpu.nn.layers`)."""

from __future__ import annotations

import dataclasses
import math

import torch

from vmlmf_tpu_torch.cells.base import normal_init
from vmlmf_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Embed:
    vocab_size: int
    embed_size: int

    def init(self, generator, device="cuda", dtype=torch.float32):
        w = normal_init(generator, (self.vocab_size, self.embed_size), dtype=dtype)
        return {"w": w.to(resolve_device(device))}

    def __call__(self, params, ids):
        return params["w"][ids]


@dataclasses.dataclass(frozen=True)
class Dense:
    in_size: int
    out_size: int
    bias_fill: float = 0.0  # the HAR classifier head uses 0.1

    def init(self, generator, device="cuda", dtype=torch.float32):
        """Weight N(0, 0.01), bias ``bias_fill``."""
        dev = resolve_device(device)
        w = normal_init(generator, (self.in_size, self.out_size), scale=0.01, dtype=dtype)
        b = torch.full((self.out_size,), self.bias_fill, dtype=dtype, device=dev)
        return {"w": w.to(dev), "b": b}

    def __call__(self, params, x):
        return x @ params["w"] + params["b"]


def dropout_mask(shape, rate, generator, device, dtype=torch.float32):
    """The pre-scaled inverted-dropout mask: 1/keep where a uniform draw from
    ``generator`` (on ``device``) falls below keep = 1 - rate, else 0. Both
    `dropout` and the wavefront stack's inter-layer masks draw it."""
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = 1.0 - rate
    draw = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return (draw < keep).to(dtype) / keep


def dropout(x, rate, *, generator=None, train=False):
    """Inverted dropout, ``x * dropout_mask(...)``; identity unless training
    with rate > 0. The mask is drawn from ``generator``, which must live on
    x's device.
    """
    if not train or rate == 0.0:
        return x
    return x * dropout_mask(x.shape, rate, generator, x.device, x.dtype)


@dataclasses.dataclass(frozen=True)
class ConvFeatures:
    """``layers`` stacked valid convolutions over time with kernel (kernel_t,
    1): [B, T, F] -> [B, T - layers*(kernel_t-1), channels*F], features
    flattened sensor-major. No nonlinearity between the convolutions unless
    ``activation`` (ReLU).

    The parameters keep the JAX package's HWIO layout, ``k{i}`` [kernel_t, 1,
    in, out] and ``b{i}`` [out], so a JAX tree carries over key for key; the
    layer permutes each kernel to PyTorch's OIHW at use. The convolution is
    `torch.nn.functional.conv2d`: the JAX package computes it with XLA, not
    in a kernel of its own.
    """

    channels: int = 64
    kernel_t: int = 5
    layers: int = 4
    activation: bool = False

    def init(self, generator, device="cuda", dtype=torch.float32):
        """Kernels N(0, 1/fan_in) with fan_in = kernel_t * in, biases zero."""
        dev = resolve_device(device)
        p, c_in = {}, 1
        for i in range(self.layers):
            k = normal_init(generator, (self.kernel_t, 1, c_in, self.channels),
                            scale=1.0 / math.sqrt(self.kernel_t * c_in), dtype=dtype)
            p[f"k{i}"] = k.to(dev)
            p[f"b{i}"] = torch.zeros((self.channels,), dtype=dtype, device=dev)
            c_in = self.channels
        return p

    def __call__(self, params, x):
        y = x[:, None]  # [B, T, F] -> NCHW [B, 1, T, F]
        for i in range(self.layers):
            y = torch.nn.functional.conv2d(y, params[f"k{i}"].permute(3, 2, 0, 1),
                                           params[f"b{i}"])
            if self.activation:
                y = torch.relu(y)
        b, _, t, f = y.shape
        return y.permute(0, 2, 3, 1).reshape(b, t, f * self.channels)
