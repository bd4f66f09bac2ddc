"""GRU cells: dense or shared-factor low-rank, and group-rotated
(counterpart of `vmlmf_tpu.cells.gru`).

Gate order (r, z, n). The two cells differ in where the reset gate acts:
  * `GRUCell` applies it *before* the candidate's recurrent product,
    ``n = tanh(gi_n + (r ⊙ h) @ U_n)``: the fused scan's mode "pre";
  * `GRUGroupCell` applies it to the product's *output*,
    ``n = tanh(gi_n + r ⊙ (h @ U_n))``: mode "post".
Both update ``h' = z ⊙ h + (1 − z) ⊙ n``. The state is one ``[B, h]`` tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from vmlmf_tpu_torch.cells.base import Cell, normal_init, side_apply, side_factors, side_init
from vmlmf_tpu_torch.cells.group import _group_rec, check_groups, tier_init, tiers
from vmlmf_tpu_torch.ops.lowrank import dense_from_group
from vmlmf_tpu_torch.utils.device import resolve_device


class _GRUBase(Cell):
    """What both GRU cells share: the input side, the state and the x side of
    the fused scan."""

    num_gates = 3

    def _init_input_side(self, generator, dtype):
        p = {"b": torch.ones((3 * self.hidden_size,), dtype=dtype)}  # biases start at one
        p.update(side_init(generator, "w", self.input_size, 3 * self.hidden_size, self.w_rank,
                           dtype))
        return p

    def state0(self, batch, device="cuda", dtype=torch.float32):
        return torch.zeros((batch, self.hidden_size), dtype=dtype, device=resolve_device(device))

    def out_of(self, state):
        return state

    def inp(self, prep, xs):
        return side_apply(prep, "w", self.w_rank, xs) + prep["b"]

    def fused_x_inputs_gru(self, prep):
        """(ux, vx, bias) for the fused GRU scan: ux [n, rx], vx [rx, 3h], or
        ux [n, 3h] and vx None for a dense input side."""
        return (*side_factors(prep, "w", self.w_rank), prep["b"])


@dataclasses.dataclass(frozen=True)
class GRUCell(_GRUBase):
    """GRU whose candidate term is ``(r ⊙ h) @ U_n`` (reset before the
    product). ``u_rank`` set: one factor ``u_fac [h, r]`` shared by the r/z
    and n projections."""

    w_rank: int | None = None
    u_rank: int | None = None

    def init(self, generator, device="cuda", dtype=torch.float32):
        h = self.hidden_size
        p = self._init_input_side(generator, dtype)
        if self.u_rank is None:
            p["u_rz"] = normal_init(generator, (h, 2 * h), dtype=dtype)
            p["u_n"] = normal_init(generator, (h, h), dtype=dtype)
        else:
            p["u_fac"] = normal_init(generator, (h, self.u_rank), dtype=dtype)
            p["u_proj_rz"] = normal_init(generator, (self.u_rank, 2 * h), dtype=dtype)
            p["u_proj_n"] = normal_init(generator, (self.u_rank, h), dtype=dtype)
        dev = resolve_device(device)
        return {k: v.to(dev) for k, v in p.items()}

    def step(self, prep, gi_t, h):
        hdim = self.hidden_size
        if self.u_rank is None:
            rz_rec = h @ prep["u_rz"]
        else:
            rz_rec = (h @ prep["u_fac"]) @ prep["u_proj_rz"]
        r = torch.sigmoid(gi_t[..., :hdim] + rz_rec[..., :hdim])
        rh = r * h
        if self.u_rank is None:
            n_rec = rh @ prep["u_n"]
        else:
            n_rec = (rh @ prep["u_fac"]) @ prep["u_proj_n"]
        z = torch.sigmoid(gi_t[..., hdim:2 * hdim] + rz_rec[..., hdim:])
        n = torch.tanh(gi_t[..., 2 * hdim:] + n_rec)
        h_next = z * h + (1.0 - z) * n
        return h_next, h_next

    def fused_rec_inputs_gru(self, prep):
        """(uf, prz, pn, mode) for the fused GRU scan: uf None for a dense
        recurrent side."""
        if self.u_rank is None:
            return None, prep["u_rz"], prep["u_n"], "pre"
        return prep["u_fac"], prep["u_proj_rz"], prep["u_proj_n"], "pre"


@dataclasses.dataclass(frozen=True)
class GRUGroupCell(_GRUBase):
    """Group-rotated GRU: the hidden state splits into ``groups`` groups,
    tier i holds ``u_h_i [g, h/g, r_i]`` and ``v_h_i [g, r_i, 3h/g]``, and
    the reset gate scales the candidate product's output."""

    w_rank: int | None = None
    u_ranks: tuple = (2, 4)
    groups: int = 2

    def __post_init__(self):
        check_groups(self.u_ranks, self.groups, self.hidden_size)

    def init(self, generator, device="cuda", dtype=torch.float32):
        p = self._init_input_side(generator, dtype)
        p.update(tier_init(generator, self.u_ranks, self.groups, self.hidden_size, 3, dtype))
        dev = resolve_device(device)
        return {k: v.to(dev) for k, v in p.items()}

    def step(self, prep, gi_t, h):
        hdim = self.hidden_size
        rec = _group_rec(h, *tiers(prep, self.groups), self.groups, 3)  # [..., 3h]
        r = torch.sigmoid(gi_t[..., :hdim] + rec[..., :hdim])
        z = torch.sigmoid(gi_t[..., hdim:2 * hdim] + rec[..., hdim:2 * hdim])
        n = torch.tanh(gi_t[..., 2 * hdim:] + r * rec[..., 2 * hdim:])
        h_next = z * h + (1.0 - z) * n
        return h_next, h_next

    def fused_rec_inputs_gru(self, prep):
        """The dense [h, 3h] recurrent matrix, built from the tiers once per
        call (weight-only, outside the scan), split into prz [h, 2h] and
        pn [h, h] for the fused scan's mode "post"."""
        h = self.hidden_size
        w = dense_from_group(*tiers(prep, self.groups), 3, h).T  # [h, 3h]
        return None, w[:, :2 * h].contiguous(), w[:, 2 * h:].contiguous(), "post"
