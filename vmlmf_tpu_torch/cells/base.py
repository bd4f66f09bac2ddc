"""Cell protocol shared by the port's cells (counterpart of `vmlmf_tpu.cells.base`).

A cell is a frozen dataclass of static sizes with functions over a parameter
dict of tensors:

  init(generator, device) -> params        dict of tensors
  prepare(params)         -> prep          params + weight-only precomputes
  inp(prep, xs)           -> gi [..., 4h]  time-parallel input contribution
  step(prep, gi_t, s)     -> (s', h)       serial recurrent part
  state0(batch, device)   -> s

Parameters are made on the CPU from an explicit `torch.Generator` and then
moved, so a seed gives the same weights whatever the device.
"""

from __future__ import annotations

import dataclasses

import torch

from vmlmf_tpu_torch.utils.device import resolve_device
from vmlmf_tpu_torch.utils.tree import tree_leaves


def normal_init(generator, shape, scale=0.1, dtype=torch.float32):
    """0.1 * N(0,1), the weight init of the HAR-family cells (on the CPU)."""
    return scale * torch.randn(shape, generator=generator, dtype=dtype)


def uniform_init(generator, shape, bound, dtype=torch.float32):
    """U(-bound, bound), the LM whole-model reset (on the CPU)."""
    return (torch.rand(shape, generator=generator, dtype=dtype) * 2 - 1) * bound


def reinit_uniform(params, generator, bound):
    """Every tensor of a (nested dict / list) param tree redrawn from U(-bound, bound).

    Leaves are visited depth-first in key order, and each keeps its device.
    """
    if isinstance(params, dict):
        return {k: reinit_uniform(v, generator, bound) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(reinit_uniform(v, generator, bound) for v in params)
    return uniform_init(generator, params.shape, bound, params.dtype).to(params.device)


def side_init(generator, name, n, m, rank, dtype):
    """One side's weights (on the CPU): {name: [n, m]} dense, or {name_fac: [n, rank],
    name_proj: [rank, m]} low-rank."""
    if rank is None:
        return {name: normal_init(generator, (n, m), dtype=dtype)}
    return {f"{name}_fac": normal_init(generator, (n, rank), dtype=dtype),
            f"{name}_proj": normal_init(generator, (rank, m), dtype=dtype)}


def side_apply(prep, name, rank, x):
    """x @ the side's matrix: ``x @ w`` or ``(x @ w_fac) @ w_proj``."""
    if rank is None:
        return x @ prep[name]
    return (x @ prep[f"{name}_fac"]) @ prep[f"{name}_proj"]


def side_factors(prep, name, rank):
    """The side as the fused scan takes it: (dense [n, m], None) or (fac, proj)."""
    if rank is None:
        return prep[name], None
    return prep[f"{name}_fac"], prep[f"{name}_proj"]


def lstm_update(pre, c):
    """LSTM gates and state update; ``pre [..., 4h]`` in (i, f, g, o) order."""
    i, f, g, o = pre.chunk(4, dim=-1)
    c_next = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_next = torch.sigmoid(o) * torch.tanh(c_next)
    return h_next, c_next


def pad_features(x, size):
    """Zero-pad (or truncate) the trailing feature dim of x to `size`.

    The diagonal "vm" term is defined over min(n, h) features.
    """
    n = x.shape[-1]
    if n == size:
        return x
    if n > size:
        return x[..., :size]
    return torch.nn.functional.pad(x, (0, size - n))


@dataclasses.dataclass(frozen=True)
class Cell:
    """Base class: static sizes + the functional protocol."""

    input_size: int
    hidden_size: int

    num_gates = 4  # the LSTM family's; the GRU cells have 3

    def init(self, generator, device="cuda", dtype=torch.float32):
        raise NotImplementedError

    def prepare(self, params):
        return params

    def state0(self, batch, device="cuda", dtype=torch.float32):
        dev = resolve_device(device)
        shape = (batch, self.hidden_size)
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    def out_of(self, state):
        return state[0]

    def inp(self, prep, xs):
        raise NotImplementedError

    def step(self, prep, gi_t, state):
        raise NotImplementedError

    def apply_step(self, params, x_t, state):
        """One step from the parameters (prepare, inp, step), without the
        hoisting of a scan: a test and debug path. -> (state', h)."""
        prep = self.prepare(params)
        return self.step(prep, self.inp(prep, x_t), state)

    def param_count(self, params):
        """Elements of every tensor of ``params``."""
        return sum(p.numel() for p in tree_leaves(params))
