"""The VMLMF cell: low-rank factorization + learned diagonal, diag-corrected
(counterpart of `vmlmf_tpu.cells.vmlmf`).

Per gate g (stacked over the 4 gates i, f, g, o):

    pre_g = (x U_x) V_x[g]^T - x ⊙ rowdiag_g(U_x, V_x) + b_x[g]     (input side)
          + (h U_h) V_h[g]^T - h ⊙ rowdiag_g(U_h, V_h) + b_h[g]     (recurrent)
          + pad(d_x ⊙ x) + d_h ⊙ h                                  ("vm" terms)

`prepare` computes the weight-only rowdiags once; `inp` is the time-parallel
first line (with both biases); `step` is the serial rest.
"""

from __future__ import annotations

import dataclasses

import torch

from vmlmf_tpu_torch.cells.base import Cell, lstm_update, normal_init, pad_features
from vmlmf_tpu_torch.ops.lowrank import gate_diag_rowsum, lowrank_proj
from vmlmf_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class VMLMFCell(Cell):
    w_rank: int = 8
    u_rank: int = 8

    def init(self, generator, device="cuda", dtype=torch.float32):
        n, h = self.input_size, self.hidden_size
        shapes = {
            "u_x": (n, self.w_rank),
            "u_h": (h, self.u_rank),
            "v_x": (4 * h, self.w_rank),
            "v_h": (4 * h, self.u_rank),
            "b_x": (4 * h,),
            "b_h": (4 * h,),
            "d_x": (n,),
            "d_h": (h,),
        }
        dev = resolve_device(device)
        return {k: normal_init(generator, s, dtype=dtype).to(dev) for k, s in shapes.items()}

    def prepare(self, params):
        h = self.hidden_size
        prep = dict(params)
        dcx = gate_diag_rowsum(params["u_x"], params["v_x"], 4, h)  # [4, min(n, h)]
        prep["dcorr_x"] = pad_features(dcx, h)
        prep["dcorr_h"] = gate_diag_rowsum(params["u_h"], params["v_h"], 4, h)
        return prep

    def inp(self, prep, xs):
        h = self.hidden_size
        y = lowrank_proj(xs, prep["u_x"], prep["v_x"])
        y = y.reshape(*y.shape[:-1], 4, h)
        xp = pad_features(xs, h)
        y = y - xp[..., None, :] * prep["dcorr_x"]
        y = y + pad_features(prep["d_x"] * xs, h)[..., None, :]
        y = y + (prep["b_x"] + prep["b_h"]).reshape(4, h)
        return y.reshape(*y.shape[:-2], 4 * h)

    def step(self, prep, gi_t, state):
        h_prev, c = state
        hdim = self.hidden_size
        gr = lowrank_proj(h_prev, prep["u_h"], prep["v_h"])
        gr = gr.reshape(*gr.shape[:-1], 4, hdim)
        gr = gr + h_prev[..., None, :] * (prep["d_h"] - prep["dcorr_h"])
        pre = gi_t + gr.reshape(*gr.shape[:-2], 4 * hdim)
        h_next, c_next = lstm_update(pre, c)
        return (h_next, c_next), h_next

    def fused_rec_inputs(self, prep):
        """(u [h, r], v [r, 4h], dvec [4h]) for the fused scan, contiguous."""
        dvec = (prep["d_h"][None, :] - prep["dcorr_h"]).reshape(-1)
        return prep["u_h"].contiguous(), prep["v_h"].T.contiguous(), dvec

    def fused_x_inputs(self, prep):
        """(ux [n, rx], vx [rx, 4h], xdvec [4, h], bias [4h]) for the fused scan:
        gi = (x@u_x)@v_xᵀ + tile4(pad(x)) ⊙ (pad(d_x) − dcorr_x) + (b_x + b_h)."""
        h = self.hidden_size
        xdvec = pad_features(prep["d_x"], h)[None, :] - prep["dcorr_x"]
        return (prep["u_x"].contiguous(), prep["v_x"].T.contiguous(),
                xdvec.contiguous(), prep["b_x"] + prep["b_h"])

    def pipeline_units(self, prep):
        """The factors of the wavefront stack (`ops.pipeline`, `ops.cuda_stack`).

        Both paths are ``in @ U @ V + tile4(in) ⊙ D`` per gate; the x path
        also carries the bias sum. The x unit is read only when this cell sits
        above another layer (input_size == hidden_size).
        """
        h = self.hidden_size
        return {
            "u_x": prep["u_x"], "v_x": prep["v_x"].T,
            "d_x": pad_features(prep["d_x"], h)[None, :] - prep["dcorr_x"],
            "bias": prep["b_x"] + prep["b_h"],
            "u_h": prep["u_h"], "v_h": prep["v_h"].T,
            "d_h": prep["d_h"][None, :] - prep["dcorr_h"],
        }
