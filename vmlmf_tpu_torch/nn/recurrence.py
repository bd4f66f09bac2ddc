"""Recurrence execution: stacked cells over time (counterpart of
`vmlmf_tpu.nn.recurrence`).

Two backends, the same function:
  * "loop"  — the time-parallel ``cell.inp`` for all T, then a Python loop of
    ``cell.step`` (the JAX package's "xla" backend, a `lax.scan` there);
  * "fused" — the whole scan in one call of the port's fused scan (the JAX
    package's "pallas" backend), for the LSTM family (`cuda_scan`) and the
    GRU cells (`cuda_gru`): `LSTMScanXin` / `GRUScanXin` when grad mode is
    on and an input requires a gradient (the residual forward kernel, then
    the BPTT kernel in the backward), else the no-grad
    `lstm_scan_fused_xin` / `gru_scan_fused_xin`. Each launches its CUDA
    kernels on CUDA tensors and runs its plain version on CPU tensors.
    Under ``VMLMF_PALLAS_XIN=0`` a cell runs gi mode instead (`LSTMScan` /
    `lstm_scan_fused`, `GRUScan` / `gru_scan_fused` on ``cell.inp``), as
    the JAX package does.
    A cell with no fused form runs the loop under "fused" too, as the JAX
    package runs it on its XLA scan: one without `fused_rec_inputs`
    (`DiagonalLSTMCell`), or whose `fused_rec_inputs` returns None
    (`LSTMGroupCell(shuffle=True)`). Its own mapping decides, before any
    kernel is called.

Two more run a stack of layers as a wavefront (staircase), and are experiment
knobs behind ``VMLMF_EXPERIMENTAL_WAVEFRONT=1``, as in the JAX package:
  * "fused_pipelined" — the stack kernels (`cuda_stack.run_stack_grouped`;
    the JAX package's "pallas_pipelined"); a stack they cannot take runs
    the per-layer "fused" scans, after a warning. ``reverse=True`` and
    `scan_layer` run the per-layer "fused" scans too;
  * "pipelined" — the plain PyTorch wavefront (`ops.pipeline`; the JAX
    package's "pipelined"); a stack it cannot take runs the per-layer loop,
    after a warning. ``reverse=True`` and `scan_layer` run the loop.

The LSTM scans take the JAX package's ``precision`` ("f32" or "bf16": bf16
product operands, f32 sums), from the argument or, when it is None, from
``VMLMF_PALLAS_PRECISION`` (default "f32"); the residual switches
``VMLMF_PALLAS_RESIDUALS`` and ``VMLMF_PALLAS_SAVED_GATES`` are read by
`cuda_scan`. The JAX package reads these when it traces a step, the port
when it runs one. "fused_pipelined" takes ``precision`` too (the stack
kernels' bf16 form); "pipelined" computes f32 under either, as the JAX
package's XLA wavefront does.

Sequences are time-major ``[T, B, n]``; `RNN.__call__` takes batch-major
input with ``time_major=False``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from vmlmf_tpu_torch.nn.layers import dropout
from vmlmf_tpu_torch.ops.cuda_gru import GRUScan, GRUScanXin, gru_scan_fused, gru_scan_fused_xin
from vmlmf_tpu_torch.ops.cuda_scan import (
    LSTMScan,
    LSTMScanXin,
    lstm_scan_fused,
    lstm_scan_fused_xin,
)
from vmlmf_tpu_torch.ops.cuda_stack import run_stack_grouped
from vmlmf_tpu_torch.ops.pipeline import pipelined_available, pipelined_lstm_scan, warn_fallback

BACKENDS = ("loop", "fused")
WAVEFRONT_BACKENDS = ("pipelined", "fused_pipelined")
WAVEFRONT_KNOB = "VMLMF_EXPERIMENTAL_WAVEFRONT"
# the JAX package's names for the backends, which the entry points also accept
JAX_BACKENDS = {"xla": "loop", "pallas": "fused", "pallas_pipelined": "fused_pipelined"}


def backend_name(name):
    """A backend as the port names it: the JAX package's names map to the
    port's (xla -> loop, pallas -> fused, pallas_pipelined ->
    fused_pipelined); the port's own pass through."""
    return JAX_BACKENDS.get(name, name)


def _check_backend(backend):
    if backend in WAVEFRONT_BACKENDS:
        if os.environ.get(WAVEFRONT_KNOB) == "1":
            return
        raise ValueError(f"backend={backend!r} is an experiment knob: set {WAVEFRONT_KNOB}=1 "
                         f"to use it (production backends: {BACKENDS})")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS} (experiment "
                         f"knobs behind {WAVEFRONT_KNOB}=1: {WAVEFRONT_BACKENDS})")


def env_precision(precision=None):
    """``precision``, or VMLMF_PALLAS_PRECISION ("f32" when unset) when it is
    None: the fused LSTM scans' product precision, read at call time."""
    return precision or os.environ.get("VMLMF_PALLAS_PRECISION", "f32")


def use_xin():
    """Whether a cell's fused scan takes x and its x side (x mode, the
    default) or the hoisted ``cell.inp`` (gi mode): VMLMF_PALLAS_XIN=0|1, as
    `vmlmf_tpu.nn.recurrence._use_xin` reads it."""
    env = os.environ.get("VMLMF_PALLAS_XIN")
    return True if env is None else env == "1"


def _needs_grad(args):
    return torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args)


def _fused_form(cell, prep):
    """("gru", its recurrent inputs), ("lstm", its recurrent inputs), or
    (None, None) for a cell that has no fused form."""
    if hasattr(cell, "fused_rec_inputs_gru"):
        return "gru", cell.fused_rec_inputs_gru(prep)
    rec = cell.fused_rec_inputs(prep) if hasattr(cell, "fused_rec_inputs") else None
    return ("lstm", rec) if rec is not None else (None, None)


def scan_layer(cell, prep, xs, state0, *, reverse=False, backend="fused", precision=None):
    """Run one cell over time-major ``xs [T, B, n]`` -> (ys [T, B, h], state).

    backend="fused" (and "fused_pipelined", whose one-layer form it is) runs
    the fused scan for a cell with `fused_rec_inputs` and `fused_x_inputs`
    (the LSTM family; state (h, c)) or with `fused_rec_inputs_gru` and
    `fused_x_inputs_gru` (the GRU cells; state h), and the loop for a cell
    without a fused form; every other backend runs the loop. The state that
    comes back is (h_last, c_last) or h_last = ys[-1]. ``precision`` (None:
    VMLMF_PALLAS_PRECISION) is the LSTM scans'; ``VMLMF_PALLAS_XIN=0`` runs
    the scans in gi mode on ``cell.inp``.
    """
    _check_backend(backend)
    fused = backend in ("fused", "fused_pipelined")
    kind, rec = _fused_form(cell, prep) if fused else (None, None)
    if kind is not None:
        def stream(a):  # the scan's input in the order it walks
            return (torch.flip(a, (0,)) if reverse else a).contiguous()

        xin = use_xin()
        # x mode: x and the x side; gi mode: the hoisted, time-parallel input contribution
        head = (stream(xs),) if xin else (stream(cell.inp(prep, xs)),)
        if kind == "gru":
            uf, prz, pn, mode = rec
            if xin:
                head += cell.fused_x_inputs_gru(prep)
            args = (*head, uf, prz, pn, state0.contiguous())
            scan, apply = (gru_scan_fused_xin, GRUScanXin.apply) if xin else \
                (gru_scan_fused, GRUScan.apply)
            ys = apply(*args, mode) if _needs_grad(args) else scan(*args, mode=mode)
            state = ys[-1]
        else:
            h0, c0 = state0
            prec = env_precision(precision)
            if xin:
                head += cell.fused_x_inputs(prep)
            args = (*head, *rec, h0.contiguous(), c0.contiguous())
            scan, apply = (lstm_scan_fused_xin, LSTMScanXin.apply) if xin else \
                (lstm_scan_fused, LSTMScan.apply)
            ys, c_last = apply(*args, prec) if _needs_grad(args) else scan(*args, prec)
            state = (ys[-1], c_last)
        if reverse:
            ys = torch.flip(ys, (0,))
        return ys, state

    gi = cell.inp(prep, xs)  # [T, B, G*h], time-parallel
    state = state0
    steps = range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])
    ys = [None] * xs.shape[0]
    for t in steps:
        state, ys[t] = cell.step(prep, gi[t], state)
    return torch.stack(ys), state


def run_wavefront(backend, cells, preps, xs, states, *, masks=None, dropout_rate=0.0,
                  generator=None, precision=None):
    """A stack on a wavefront backend, time-major -> (ys, final states).

    "fused_pipelined" runs `run_stack_grouped` with the pre-scaled
    inter-layer ``masks``. "pipelined" runs the plain wavefront, which draws
    its own masks from ``generator`` at ``dropout_rate``; for a stack it
    cannot take it runs the per-layer loop after `warn_fallback`, with
    `dropout` between layers, as the per-layer path draws it. ``precision``
    (None: VMLMF_PALLAS_PRECISION) is the stack kernels'; "pipelined"
    computes f32 under any precision, as the JAX package's XLA wavefront
    does (it takes none)."""
    if backend == "fused_pipelined":
        return run_stack_grouped(cells, preps, xs, states, masks, env_precision(precision))
    if pipelined_available(cells, preps):
        return pipelined_lstm_scan(cells, preps, xs, states, dropout_rate=dropout_rate,
                                   generator=generator)
    warn_fallback(cells)
    finals = []
    for i, (cell, prep, s0) in enumerate(zip(cells, preps, states)):
        xs, sf = scan_layer(cell, prep, xs, s0, backend="loop")
        finals.append(sf)
        if i < len(cells) - 1:
            xs = dropout(xs, dropout_rate, generator=generator, train=dropout_rate > 0.0)
    return xs, finals


@dataclasses.dataclass(frozen=True)
class RNN:
    """A stack of cells, one per layer; layer i consumes layer i-1's outputs."""

    cells: tuple
    backend: str = "fused"
    precision: str | None = None  # the fused LSTM scans': f32 | bf16 (None: the env's)

    def __post_init__(self):
        _check_backend(self.backend)

    def init(self, generator, device="cuda", dtype=torch.float32):
        return [c.init(generator, device, dtype) for c in self.cells]

    def state0(self, batch, device="cuda", dtype=torch.float32):
        return [c.state0(batch, device, dtype) for c in self.cells]

    def __call__(self, params, xs, states=None, *, time_major=False, reverse=False):
        """-> (ys, final_states); ys in the same layout as xs."""
        if not time_major:
            xs = xs.transpose(0, 1)
        if states is None:
            states = self.state0(xs.shape[1], xs.device, xs.dtype)
        if self.backend in WAVEFRONT_BACKENDS and not reverse:
            preps = [c.prepare(p) for c, p in zip(self.cells, params)]
            ys, finals = run_wavefront(self.backend, self.cells, preps, xs, states,
                                       precision=self.precision)
        else:
            ys, finals = xs, []
            for cell, p, s0 in zip(self.cells, params, states):
                ys, sf = scan_layer(cell, cell.prepare(p), ys, s0, reverse=reverse,
                                    backend=self.backend, precision=self.precision)
                finals.append(sf)
        if not time_major:
            ys = ys.transpose(0, 1)
        return ys, finals

    def last_hidden_concat(self, finals):
        """The layers' last hidden states side by side, [B, sum of widths]."""
        return torch.cat([c.out_of(s) for c, s in zip(self.cells, finals)], -1)
