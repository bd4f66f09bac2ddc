"""Non-recurrent layers: embedding, dense, dropout, the LM head's bf16
product, and the convolution stack of `DeepConvNet` (counterpart of
`vmlmf_tpu.nn.layers`)."""

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


class Bf16Product(torch.autograd.Function):
    """``x [..., k] @ w [k, n]`` with bf16 operands and f32 sums and result:
    `vmlmf_tpu.nn.models.LMModel`'s ``head_bf16`` product, ``jnp.dot(
    x.astype(bf16), w.astype(bf16), preferred_element_type=f32)``. On CUDA
    one cuBLAS bf16 product with an f32 output; on the CPU the f32 product
    of the bf16-rounded operands, the same function (a bf16 product is exact
    in f32). The gradients are JAX's: the f32 product of the cotangent with
    the other rounded operand, rounded to bf16 (the transposes of the
    casts)."""

    @staticmethod
    def forward(ctx, x, w):
        xb, wb = x.bfloat16(), w.bfloat16()
        ctx.save_for_backward(xb, wb)
        x2 = xb.reshape(-1, x.shape[-1])
        if x2.is_cuda:
            y = torch.mm(x2, wb, out_dtype=torch.float32)
        else:
            y = x2.float() @ wb.float()
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g @ wb.float().T).bfloat16().float()
        if ctx.needs_input_grad[1]:
            x2 = xb.reshape(-1, xb.shape[-1]).float()
            dw = (x2.T @ g.reshape(-1, g.shape[-1])).bfloat16().float()
        return dx, dw


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
