"""Legacy ablation cells: dual-diagonal (proto-VMLMF) and diagonal-only
(counterpart of `vmlmf_tpu.cells.legacy`).

  * `DualDiagonalLSTMCell`: gates ``x W_g + pad(diag(W_g) ⊙ x) + h U_g +
    diag(U_g) ⊙ h + b``, W and U dense or low-rank. The diagonal is added on
    top of the full product (VMLMF later subtracts it). The input diagonal
    covers the first min(n, h) features.
  * `DiagonalLSTMCell`: elementwise gates ``pad(dw_g ⊙ x) + du_g ⊙ h + b_g``.
    It has no fused form: `scan_layer` runs it as a loop under either
    backend, as the JAX package runs it on its XLA scan.
"""

from __future__ import annotations

import dataclasses

import torch

from vmlmf_tpu_torch.cells.base import (
    Cell,
    lstm_update,
    pad_features,
    side_apply,
    side_factors,
    side_init,
)
from vmlmf_tpu_torch.ops.lowrank import gate_diag_rowsum
from vmlmf_tpu_torch.utils.device import resolve_device


def _gate_diagonals(prep, name, rank, h):
    """Per-gate diagonal of a side's stacked [n, 4h] matrix -> [4, min(n, h)]:
    of the dense matrix, or by the rowsum identity of its factors."""
    if rank is None:
        w = prep[name]
        return torch.stack([torch.diagonal(w[:, g * h:(g + 1) * h]) for g in range(4)])
    return gate_diag_rowsum(prep[f"{name}_fac"], prep[f"{name}_proj"].T, 4, h)


@dataclasses.dataclass(frozen=True)
class DualDiagonalLSTMCell(Cell):
    w_rank: int | None = None
    u_rank: int | None = None

    def init(self, generator, device="cuda", dtype=torch.float32):
        n, h = self.input_size, self.hidden_size
        p = {"b": torch.ones((4 * h,), dtype=dtype)}
        p.update(side_init(generator, "w", n, 4 * h, self.w_rank, dtype))
        p.update(side_init(generator, "u", h, 4 * h, self.u_rank, dtype))
        dev = resolve_device(device)
        return {k: v.to(dev) for k, v in p.items()}

    def prepare(self, params):
        h = self.hidden_size
        prep = dict(params)
        prep["diag_w"] = pad_features(_gate_diagonals(params, "w", self.w_rank, h), h)  # [4, h]
        prep["diag_u"] = _gate_diagonals(params, "u", self.u_rank, h)  # [4, h]
        return prep

    def inp(self, prep, xs):
        h = self.hidden_size
        y = side_apply(prep, "w", self.w_rank, xs).reshape(*xs.shape[:-1], 4, h)
        y = y + pad_features(xs, h)[..., None, :] * prep["diag_w"] + prep["b"].reshape(4, h)
        return y.reshape(*xs.shape[:-1], 4 * h)

    def step(self, prep, gi_t, state):
        h_prev, c = state
        h = self.hidden_size
        gr = side_apply(prep, "u", self.u_rank, h_prev).reshape(*h_prev.shape[:-1], 4, h)
        gr = gr + h_prev[..., None, :] * prep["diag_u"]
        h_next, c_next = lstm_update(gi_t + gr.reshape(*gr.shape[:-2], 4 * h), c)
        return (h_next, c_next), h_next

    def fused_rec_inputs(self, prep):
        """(u, v, dvec): the recurrence h @ U + h ⊙ diag_u, diagonal added."""
        u, v = side_factors(prep, "u", self.u_rank)
        return u, v, prep["diag_u"].reshape(-1)

    def fused_x_inputs(self, prep):
        """(ux, vx, xdvec, bias): the input diagonal added on top of the product."""
        ux, vx = side_factors(prep, "w", self.w_rank)
        return ux, vx, prep["diag_w"].contiguous(), prep["b"]


@dataclasses.dataclass(frozen=True)
class DiagonalLSTMCell(Cell):
    """Diagonal-weights-only LSTM. Constant init: 0.1321 for the input
    diagonal, 0.1231 for the recurrent one, ones for the bias."""

    def init(self, generator, device="cuda", dtype=torch.float32):
        del generator  # constant init
        n, h = self.input_size, self.hidden_size
        dev = resolve_device(device)
        return {"dw": torch.full((4, min(n, h)), 0.1321, dtype=dtype, device=dev),
                "du": torch.full((4, h), 0.1231, dtype=dtype, device=dev),
                "b": torch.ones((4 * h,), dtype=dtype, device=dev)}

    def inp(self, prep, xs):
        h = self.hidden_size
        y = (pad_features(xs, h)[..., None, :] * pad_features(prep["dw"], h)
             + prep["b"].reshape(4, h))
        return y.reshape(*xs.shape[:-1], 4 * h)

    def step(self, prep, gi_t, state):
        h_prev, c = state
        h = self.hidden_size
        gr = (h_prev[..., None, :] * prep["du"]).reshape(*h_prev.shape[:-1], 4 * h)
        h_next, c_next = lstm_update(gi_t + gr, c)
        return (h_next, c_next), h_next
