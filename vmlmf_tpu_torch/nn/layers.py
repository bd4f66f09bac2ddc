"""Non-recurrent layers of the LM: embedding, dense, dropout
(counterpart of `vmlmf_tpu.nn.layers`)."""

from __future__ import annotations

import dataclasses

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


def dropout(x, rate, *, generator=None, train=False):
    """Inverted dropout; identity unless training with rate > 0.

    The mask is drawn from ``generator``, which must live on x's device.
    """
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
