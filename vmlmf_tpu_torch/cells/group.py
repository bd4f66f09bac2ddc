"""Group-structured compressed LSTM cells (counterpart of `vmlmf_tpu.cells.group`).

The hidden state splits into ``g`` groups of ``h/g``. Rotation tier ``i``
holds ``u_h_i [g, h/g, r_i]`` and ``v_h_i [g, r_i, G*(h/g)]``: output group
``p`` reads input group ``(p + i) % g`` at rank ``r_i``.

  * `VMLMFGroupCell`: the group VMLMF LSTM (low-rank input side with the
    diagonal correction and the "vm" vectors); ``use_vm=False`` is the
    ablation without vm terms or corrections.
  * `LSTMGroupCell`: the legacy group LSTM (dense or low-rank input side, no
    vm terms); ``shuffle=True`` interleaves the state's groups after every
    step, which the fused scan does not model, so that cell runs as a loop.

The fused scan takes the group recurrence as its dense ``[h, 4h]`` matrix,
built from the tiers once per call by the differentiable `dense_from_group`.
"""

from __future__ import annotations

import dataclasses

import torch

from vmlmf_tpu_torch.cells.base import (
    Cell,
    lstm_update,
    normal_init,
    pad_features,
    side_apply,
    side_factors,
    side_init,
)
from vmlmf_tpu_torch.ops.lowrank import (
    dense_from_group,
    gate_diag_rowsum,
    group_diag_rowsum,
    group_lowrank_proj,
    lowrank_proj,
)
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


def check_groups(u_ranks, groups, hidden_size):
    if len(u_ranks) != groups:
        raise ValueError(f"u_ranks {u_ranks} needs one rank per group ({groups})")
    if hidden_size % groups:
        raise ValueError(f"hidden_size {hidden_size} is not a multiple of groups {groups}")


def tier_init(generator, u_ranks, groups, hidden_size, num_gates, dtype):
    """{u_h_i [g, h/g, r_i], v_h_i [g, r_i, G*(h/g)]} for every tier i."""
    k = hidden_size // groups
    p = {}
    for i, r in enumerate(u_ranks):
        p[f"u_h_{i}"] = normal_init(generator, (groups, k, r), dtype=dtype)
        p[f"v_h_{i}"] = normal_init(generator, (groups, r, num_gates * k), dtype=dtype)
    return p


def tiers(prep, groups):
    return ([prep[f"u_h_{i}"] for i in range(groups)],
            [prep[f"v_h_{i}"] for i in range(groups)])


def _dense_rec(prep, groups, h):
    """The group recurrence as the fused scan's dense u [h, 4h]."""
    return dense_from_group(*tiers(prep, groups), 4, h).T.contiguous()


@dataclasses.dataclass(frozen=True)
class VMLMFGroupCell(Cell):
    """Group VMLMF LSTM; ``use_vm=False`` gives the no-vm ablation cell."""

    w_rank: int = 8
    u_ranks: tuple = (2, 4)
    groups: int = 2
    use_vm: bool = True

    def __post_init__(self):
        check_groups(self.u_ranks, self.groups, self.hidden_size)

    def init(self, generator, device="cuda", dtype=torch.float32):
        n, h = self.input_size, self.hidden_size
        p = {"u_x": normal_init(generator, (n, self.w_rank), dtype=dtype),
             "v_x": normal_init(generator, (4 * h, self.w_rank), dtype=dtype),
             "b_x": torch.ones((4 * h,), dtype=dtype),
             "b_h": torch.ones((4 * h,), dtype=dtype)}
        if self.use_vm:
            p["d_x"] = normal_init(generator, (n,), dtype=dtype)
            p["d_h"] = normal_init(generator, (h,), dtype=dtype)
        p.update(tier_init(generator, self.u_ranks, self.groups, h, 4, dtype))
        dev = resolve_device(device)
        return {k: v.to(dev) for k, v in p.items()}

    def prepare(self, params):
        prep = dict(params)
        if self.use_vm:
            h = self.hidden_size
            prep["dcorr_x"] = pad_features(gate_diag_rowsum(params["u_x"], params["v_x"], 4, h), h)
            prep["dcorr_h"] = group_diag_rowsum(params["u_h_0"], params["v_h_0"], 4)
        return prep

    def inp(self, prep, xs):
        h = self.hidden_size
        y = lowrank_proj(xs, prep["u_x"], prep["v_x"]).reshape(*xs.shape[:-1], 4, h)
        if self.use_vm:
            y = y - pad_features(xs, h)[..., None, :] * prep["dcorr_x"]
            y = y + pad_features(prep["d_x"] * xs, h)[..., None, :]
        y = y + (prep["b_x"] + prep["b_h"]).reshape(4, h)
        return y.reshape(*xs.shape[:-1], 4 * h)

    def step(self, prep, gi_t, state):
        h_prev, c = state
        h = self.hidden_size
        gr = _group_rec(h_prev, *tiers(prep, self.groups), self.groups, 4)
        if self.use_vm:
            gr = gr.reshape(*gr.shape[:-1], 4, h)
            gr = gr + h_prev[..., None, :] * (prep["d_h"] - prep["dcorr_h"])
            gr = gr.reshape(*gr.shape[:-2], 4 * h)
        h_next, c_next = lstm_update(gi_t + gr, c)
        return (h_next, c_next), h_next

    def fused_rec_inputs(self, prep):
        """(u [h, 4h] dense, None, dvec) for the fused scan."""
        h = self.hidden_size
        u = _dense_rec(prep, self.groups, h)
        if self.use_vm:
            dvec = (prep["d_h"][None, :] - prep["dcorr_h"]).reshape(-1)
        else:
            dvec = torch.zeros(4 * h, dtype=u.dtype, device=u.device)
        return u, None, dvec

    def fused_x_inputs(self, prep):
        """(ux, vx, xdvec, bias) for the fused scan: the low-rank input side."""
        h = self.hidden_size
        if self.use_vm:
            xdvec = (pad_features(prep["d_x"], h)[None, :] - prep["dcorr_x"]).contiguous()
        else:
            xdvec = torch.zeros(4, h, dtype=prep["u_x"].dtype, device=prep["u_x"].device)
        return prep["u_x"], prep["v_x"].T.contiguous(), xdvec, prep["b_x"] + prep["b_h"]


@dataclasses.dataclass(frozen=True)
class LSTMGroupCell(Cell):
    """Legacy group LSTM: dense or low-rank input side, group-rotated
    recurrent side, no vm terms. ``shuffle=True`` interleaves the groups of
    both h and c after every step (reshape [g, h/g], transpose, flatten)."""

    w_rank: int | None = None
    u_ranks: tuple = (2, 4)
    groups: int = 2
    shuffle: bool = False

    def __post_init__(self):
        check_groups(self.u_ranks, self.groups, self.hidden_size)

    def init(self, generator, device="cuda", dtype=torch.float32):
        n, h = self.input_size, self.hidden_size
        p = {"b": torch.ones((4 * h,), dtype=dtype)}
        p.update(side_init(generator, "w", n, 4 * h, self.w_rank, dtype))
        p.update(tier_init(generator, self.u_ranks, self.groups, h, 4, dtype))
        dev = resolve_device(device)
        return {k: v.to(dev) for k, v in p.items()}

    def inp(self, prep, xs):
        return side_apply(prep, "w", self.w_rank, xs) + prep["b"]

    def _interleave(self, x):
        g, k = self.groups, self.hidden_size // self.groups
        x = x.reshape(*x.shape[:-1], g, k)
        return x.transpose(-2, -1).reshape(*x.shape[:-2], g * k)

    def step(self, prep, gi_t, state):
        h_prev, c = state
        gr = _group_rec(h_prev, *tiers(prep, self.groups), self.groups, 4)
        h_next, c_next = lstm_update(gi_t + gr, c)
        if self.shuffle:
            h_next, c_next = self._interleave(h_next), self._interleave(c_next)
        return (h_next, c_next), h_next

    def fused_rec_inputs(self, prep):
        """(u [h, 4h] dense, None, zeros) for the fused scan, or None with
        ``shuffle``: the per-step interleave has no fused form."""
        if self.shuffle:
            return None
        h = self.hidden_size
        u = _dense_rec(prep, self.groups, h)
        return u, None, torch.zeros(4 * h, dtype=u.dtype, device=u.device)

    def fused_x_inputs(self, prep):
        """(ux, vx, xdvec, bias) for the fused scan (no vm terms)."""
        ux, vx = side_factors(prep, "w", self.w_rank)
        xdvec = torch.zeros(4, self.hidden_size, dtype=ux.dtype, device=ux.device)
        return ux, vx, xdvec, prep["b"]
