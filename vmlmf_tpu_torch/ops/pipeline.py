"""The wavefront (staircase) schedule of an LSTM stack in plain PyTorch: the
counterpart of `vmlmf_tpu.ops.pipeline`, which the JAX package computes in
XLA with no kernel of its own.

One loop of ``T + L - 1`` steps, where at step ``s`` layer ``l`` runs its
time step ``s - l``. Within a step the layers do not depend on each other,
so their input-path and recurrent-path low-rank products batch into one
stacked `bmm` pair over ``2L - 1`` units. The result is the per-layer
schedule's, in another order of the same adds.

It needs a uniform LSTM-family stack: at least two layers, equal hidden
sizes, every cell with `pipeline_units`, and equal factor ranks across the
layers, so that the units stack (`pipelined_available`). Otherwise
`nn.recurrence.run_wavefront` runs the per-layer schedule, after
`warn_fallback`.
"""

from __future__ import annotations

import warnings

import torch

from vmlmf_tpu_torch.cells.base import lstm_update
from vmlmf_tpu_torch.nn.layers import dropout_mask

_warned: set = set()


def warn_fallback(cells):
    """One warning per stack of cell types that a wavefront backend cannot run."""
    key = tuple(type(c).__name__ for c in cells)
    if key not in _warned:
        _warned.add(key)
        warnings.warn(
            "the wavefront backends need a uniform LSTM-family stack (>=2 layers, equal "
            "hidden sizes, every cell with pipeline_units; 'pipelined' also equal factor "
            f"ranks across layers); running the per-layer schedule for {key}", stacklevel=3)


def stack_cell_units(cells, preps):
    """The per-layer `pipeline_units` of a stack that can run as one
    wavefront, or None: fewer than two layers, unequal hidden sizes, or a
    cell without units. The ranks may differ by layer. Both wavefront
    backends ask this (`cuda_stack.stack_units` too)."""
    if len(cells) < 2:
        return None
    h = cells[0].hidden_size
    if any(c.hidden_size != h or c.input_size != h for c in cells[1:]):
        return None  # layer l >= 1 consumes the previous layer's hidden
    units = []
    for cell, prep in zip(cells, preps):
        fn = getattr(cell, "pipeline_units", None)  # LSTM-family cells only
        if fn is None:
            return None
        u = fn(prep)
        if u is None:
            return None
        units.append(u)
    return units


def _units(cells, preps):
    """`stack_cell_units` with equal ranks across the layers, so that the
    units stack into one bmm; else None."""
    units = stack_cell_units(cells, preps)
    if units is None:
        return None
    ranks = {u["u_x"].shape[-1] for u in units[1:]} | {u["u_h"].shape[-1] for u in units}
    return units if len(ranks) == 1 else None


def pipelined_available(cells, preps):
    return _units(cells, preps) is not None


def pipelined_lstm_scan(cells, preps, xs, states0, *, dropout_rate=0.0, generator=None):
    """Wavefront scan over a uniform LSTM-family stack.

    xs: time-major [T, B, n0]; states0: list of (h, c) per layer. With a
    ``generator`` and ``dropout_rate`` > 0, each layer's output that feeds
    the next layer is dropped out with a fresh mask per step, drawn from the
    generator (the LM's inter-layer dropout); without one, no dropout.

    -> (ys_last [T, B, h], finals list of (h, c)).
    """
    units = _units(cells, preps)
    if units is None:
        raise ValueError("stack not pipelineable (see pipelined_available)")
    n_layers = len(cells)
    t_len, batch = xs.shape[0], xs.shape[1]
    h = cells[0].hidden_size

    # x units (the input path of layers 1..L-1) then h units (the recurrent
    # path of layers 0..L-1): one stacked bmm pair over 2L-1 units
    u_all = torch.stack([u["u_x"] for u in units[1:]] + [u["u_h"] for u in units])
    v_all = torch.stack([u["v_x"] for u in units[1:]] + [u["v_h"] for u in units])
    d_all = torch.stack([u["d_x"] for u in units[1:]] + [u["d_h"] for u in units])
    bias_x = torch.stack([u["bias"] for u in units[1:]])           # [L-1, 4h]

    gi0 = cells[0].inp(preps[0], xs)                               # [T, B, 4h]
    use_drop = generator is not None and dropout_rate > 0.0
    l_idx = torch.arange(n_layers, device=xs.device)
    hs = torch.stack([s[0] for s in states0])                     # [L, B, h]
    cs = torch.stack([s[1] for s in states0])
    xin = torch.zeros(n_layers - 1, batch, h, dtype=xs.dtype, device=xs.device)
    outs = []
    for s in range(t_len + n_layers - 1):
        ins = torch.cat([xin, hs])                                # [2L-1, B, h]
        proj = torch.bmm(torch.bmm(ins, u_all), v_all)            # [2L-1, B, 4h]
        proj = (proj.reshape(2 * n_layers - 1, batch, 4, h)
                + ins[:, :, None, :] * d_all[:, None]).reshape(2 * n_layers - 1, batch, 4 * h)
        gi_t = gi0[s] if s < t_len else torch.zeros_like(gi0[0])
        xpre = proj[: n_layers - 1] + bias_x[:, None, :]
        pre = torch.cat([gi_t[None], xpre]) + proj[n_layers - 1:]
        h_new, c_new = lstm_update(pre, cs)
        # staircase edges: layer l is live for s in [l, T + l)
        live = ((s >= l_idx) & (s < t_len + l_idx))[:, None, None]
        hs = torch.where(live, h_new, hs)
        cs = torch.where(live, c_new, cs)
        xin = hs[: n_layers - 1]
        if use_drop:
            xin = xin * dropout_mask(xin.shape, dropout_rate, generator, xin.device, xin.dtype)
        outs.append(hs[n_layers - 1])
    return torch.stack(outs[n_layers - 1:]), [(hs[i], cs[i]) for i in range(n_layers)]
