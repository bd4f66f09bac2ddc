"""Dense and plain-low-rank (LMF) LSTM cells (counterpart of
`vmlmf_tpu.cells.lstm`).

The stacked gate matrices are dense (``w [n, 4h]``, ``u [h, 4h]``) or
factored with one factor shared by the four gates (``w_fac [n, r] @ w_proj
[r, 4h]``, and the same for u), each side on its own. Biases start at one.
"""

from __future__ import annotations

import dataclasses

import torch

from vmlmf_tpu_torch.cells.base import Cell, lstm_update, side_apply, side_factors, side_init
from vmlmf_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LSTMCell(Cell):
    """LSTM with optionally low-rank input and recurrent stacked gate matrices;
    ``w_rank``/``u_rank`` None is the dense side (the "mylstm" baseline)."""

    w_rank: int | None = None
    u_rank: int | None = None

    def init(self, generator, device="cuda", dtype=torch.float32):
        n, h = self.input_size, self.hidden_size
        p = side_init(generator, "w", n, 4 * h, self.w_rank, dtype)
        p.update(side_init(generator, "u", h, 4 * h, self.u_rank, dtype))
        p["b"] = torch.ones((4 * h,), dtype=dtype)
        dev = resolve_device(device)
        return {k: v.to(dev) for k, v in p.items()}

    def inp(self, prep, xs):
        return side_apply(prep, "w", self.w_rank, xs) + prep["b"]

    def step(self, prep, gi_t, state):
        h, c = state
        h_next, c_next = lstm_update(gi_t + side_apply(prep, "u", self.u_rank, h), c)
        return (h_next, c_next), h_next

    def fused_rec_inputs(self, prep):
        """(u, v, dvec) for the fused scan: u [h, 4h] and v None when dense,
        else the factors; dvec zeros (no diagonal term)."""
        u, v = side_factors(prep, "u", self.u_rank)
        return u, v, torch.zeros(4 * self.hidden_size, dtype=u.dtype, device=u.device)

    def fused_x_inputs(self, prep):
        """(ux, vx, xdvec, bias) for the fused scan: ux [n, 4h] and vx None
        when dense, else the factors; xdvec zeros."""
        ux, vx = side_factors(prep, "w", self.w_rank)
        xdvec = torch.zeros(4, self.hidden_size, dtype=ux.dtype, device=ux.device)
        return ux, vx, xdvec, prep["b"]

    def pipeline_units(self, prep):
        """The factors of the wavefront stack (`ops.pipeline`, `ops.cuda_stack`)
        for an LMF cell, low-rank on both sides, with zero diagonals; None when
        either side is dense, which leaves the stack to the per-layer schedule."""
        if self.w_rank is None or self.u_rank is None:
            return None
        b = prep["b"]
        zeros = torch.zeros(4, self.hidden_size, dtype=b.dtype, device=b.device)
        return {"u_x": prep["w_fac"], "v_x": prep["w_proj"], "d_x": zeros, "bias": b,
                "u_h": prep["u_fac"], "v_h": prep["u_proj"], "d_h": zeros}
