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

from vmlmf_tpu_torch.cells.base import Cell, normal_init
from vmlmf_tpu_torch.ops.lowrank import dense_from_group, group_lowrank_proj
from vmlmf_tpu_torch.utils.device import resolve_device


def _group_rec(h, u_tiers, v_tiers, g, num_gates):
    """Sum of all rotation tiers of a group cell -> [..., G*h], gate-major."""
    k = h.shape[-1] // g
    h_g = h.reshape(*h.shape[:-1], g, k)
    acc = None
    for i in range(g):
        rolled = torch.roll(h_g, -i, dims=-2) if i else h_g  # position p reads group (p+i)%g
        t = group_lowrank_proj(rolled, u_tiers[i], v_tiers[i])  # [..., g, G*k]
        acc = t if acc is None else acc + t
    # [..., g, G, k] -> [..., G, g, k] -> [..., G*h]
    acc = acc.reshape(*acc.shape[:-1], num_gates, k).transpose(-3, -2)
    return acc.reshape(*acc.shape[:-3], num_gates * g * k)


class _GRUBase(Cell):
    """What both GRU cells share: the input side, the state and the x side of
    the fused scan."""

    num_gates = 3

    def _init_input_side(self, generator, dtype):
        n, h = self.input_size, self.hidden_size
        p = {"b": torch.ones((3 * h,), dtype=dtype)}  # biases start at one
        if self.w_rank is None:
            p["w"] = normal_init(generator, (n, 3 * h), dtype=dtype)
        else:
            p["w_fac"] = normal_init(generator, (n, self.w_rank), dtype=dtype)
            p["w_proj"] = normal_init(generator, (self.w_rank, 3 * h), dtype=dtype)
        return p

    def state0(self, batch, device="cuda", dtype=torch.float32):
        return torch.zeros((batch, self.hidden_size), dtype=dtype, device=resolve_device(device))

    def out_of(self, state):
        return state

    def inp(self, prep, xs):
        if self.w_rank is None:
            y = xs @ prep["w"]
        else:
            y = (xs @ prep["w_fac"]) @ prep["w_proj"]
        return y + prep["b"]

    def fused_x_inputs_gru(self, prep):
        """(ux, vx, bias) for the fused GRU scan: ux [n, rx], vx [rx, 3h], or
        ux [n, 3h] and vx None for a dense input side."""
        if self.w_rank is None:
            return prep["w"], None, prep["b"]
        return prep["w_fac"], prep["w_proj"], prep["b"]


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
        if len(self.u_ranks) != self.groups:
            raise ValueError(f"u_ranks {self.u_ranks} needs one rank per group ({self.groups})")
        if self.hidden_size % self.groups:
            raise ValueError(f"hidden_size {self.hidden_size} is not a multiple of "
                             f"groups {self.groups}")

    def init(self, generator, device="cuda", dtype=torch.float32):
        g = self.groups
        k = self.hidden_size // g
        p = self._init_input_side(generator, dtype)
        for i, r in enumerate(self.u_ranks):
            p[f"u_h_{i}"] = normal_init(generator, (g, k, r), dtype=dtype)
            p[f"v_h_{i}"] = normal_init(generator, (g, r, 3 * k), dtype=dtype)
        dev = resolve_device(device)
        return {k: v.to(dev) for k, v in p.items()}

    def _tiers(self, prep):
        return ([prep[f"u_h_{i}"] for i in range(self.groups)],
                [prep[f"v_h_{i}"] for i in range(self.groups)])

    def step(self, prep, gi_t, h):
        hdim = self.hidden_size
        rec = _group_rec(h, *self._tiers(prep), self.groups, 3)  # [..., 3h]
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
        w = dense_from_group(*self._tiers(prep), 3, h).T  # [h, 3h]
        return None, w[:, :2 * h].contiguous(), w[:, 2 * h:].contiguous(), "post"
