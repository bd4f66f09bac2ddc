"""Fused LSTM scan: the port's counterpart of `vmlmf_tpu.ops.pallas_scan`'s
`lstm_scan_fused_xin` (x mode, the input projection inside) and
`lstm_scan_fused` (gi mode, the input contribution given), and their VJPs.

Each side of the scan is low-rank (two factors) or dense (one matrix): the
x side ``x @ Ux @ Vx`` or ``x @ Ux`` (vx None), the recurrent side
``h @ U @ V`` or ``h @ U`` (v None), in any of the four combinations. Six
kernel entries, each with a plain version (the same arithmetic in torch
ops) and a launch count:

  * `lstm_scan_fused_xin` — the no-grad forward (serving, eval), kernel
    ``csrc/lstm_scan_xin_fwd.cu`` entry ``lstm_scan_xin_fwd``;
  * `lstm_scan_fused_xin_res` — the residual forward of training, entry
    ``lstm_scan_xin_fwd_res`` of the same source;
  * `lstm_scan_xin_bwd` — the BPTT, ``csrc/lstm_scan_xin_bwd.cu``;
  * `lstm_scan_fused`, `lstm_scan_fused_res`, `lstm_scan_bwd` — the same in
    gi mode (entries ``lstm_scan_fwd``, ``lstm_scan_fwd_res`` and
    ``lstm_scan_bwd`` of the same two sources): gi [T, B, 4h] comes in and
    the BPTT returns dgi = dpre, with no x side.

`LSTMScanXin` and `LSTMScan` are the `torch.autograd.Function`s that pair
the residual forwards with the BPTTs.

The variants of the JAX package's kernels, selected as it selects them:
  * ``precision="bf16"``: every matrix product takes bf16-rounded operands
    and sums in f32, where `pallas_scan` casts them (h, hu, dpre, dhu, x,
    xu, dxu and the factors); the diagonal terms, the bias and the gate
    arithmetic stay f32;
  * ``residuals="bf16"`` (``VMLMF_PALLAS_RESIDUALS=bf16``): the residual
    forward stores the gates and hu as bf16; ys, cs and xu stay f32;
  * ``save_gates=False`` (``VMLMF_PALLAS_SAVED_GATES=0``, x mode only): the
    residual forward stores neither the gates nor hu nor xu, and the BPTT
    rebuilds them from x and the saved h_prev in a batched pre-pass.
The JAX package reads its two environment variables when it traces a step;
the port reads them when the residual forward is called, and the BPTT
follows from what that forward stored.

`scan_plan` decides how the kernels spread a scan over the card's SMs: the
batch groups, each CTA's slices of the recurrent weights and the shared
memory they take. A batch too large for any plan (every CTA of a group
holds that group's rows) runs in chunks of consecutive rows, one launch
each (`scan_chunks`); the BPTTs add the chunks' weight gradients in chunk
order. A width whose weights do not fit in the shared memory of all SMs
even for one row (a dense h past about 1,050 in f32) gets a plan that
streams the weight rows that do not fit through L2 from a device-memory
scratch (`ScanPlan.resident_fwd`, `stream_floats`), which the wrappers
allocate. All of it is plain Python, so the CPU tests reach it.
Each wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors, so on the CPU the autograd functions run the plain forward
and the plain backward. There is no fallback between the two: a CUDA input
that the kernel does not take raises, and a CUDA input that requires a
gradient never reaches a no-grad kernel.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import os

import torch

from vmlmf_tpu_torch.cells.base import pad_features
from vmlmf_tpu_torch.ops import _build

KERNEL = "lstm_scan_xin_fwd"
BWD_KERNEL = "lstm_scan_xin_bwd"
REPLACES = "vmlmf_tpu/ops/pallas_scan.py:236"  # _fwd_kernel
BWD_REPLACES = "vmlmf_tpu/ops/pallas_scan.py:450"  # _bwd_kernel

_ARG_NAMES = ("xs", "ux", "vx", "xdvec", "bias", "u", "v", "dvec", "h0", "c0")
_RES_NAMES = ("xs", "ux", "vx", "xdvec", "u", "v", "dvec", "h0", "c0",
              "ys", "cs", "gates", "hu", "xu")
_GI_NAMES = ("gi", "u", "v", "dvec", "h0", "c0")

PRECISIONS = ("f32", "bf16")
RESIDUALS = ("f32", "bf16")
# the residual policy as the C entries number it
_RES_F32, _RES_BF16, _RES_NONE = 0, 1, 2


def _bf16(precision):
    """True for "bf16", False for "f32"; raises on anything else."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return precision == "bf16"


def env_residuals():
    """The residual store type, "bf16" under VMLMF_PALLAS_RESIDUALS=bf16, else
    "f32" (`pallas_scan._residual_dtype`), read at call time."""
    return "bf16" if os.environ.get("VMLMF_PALLAS_RESIDUALS") == "bf16" else "f32"


def env_saved_gates():
    """False under VMLMF_PALLAS_SAVED_GATES=0 (the recompute policy), else True
    (`pallas_scan.lstm_scan_fused_xin`), read at call time."""
    return os.environ.get("VMLMF_PALLAS_SAVED_GATES", "1") != "0"


def _policy(residuals, save_gates):
    """(residuals, save_gates) with None read from the environment."""
    residuals = env_residuals() if residuals is None else residuals
    if residuals not in RESIDUALS:
        raise ValueError(f"residuals must be one of {RESIDUALS}, got {residuals!r}")
    return residuals, env_saved_gates() if save_gates is None else bool(save_gates)


def variant(precision="f32", residuals="f32", save_gates=True):
    """The name of a kernel variant, as the launch counts file it: "f32",
    or the parts that differ from it joined by "+" ("bf16", "bf16_res",
    "recompute", "bf16+bf16_res", ...). Residuals that are not stored have
    no type."""
    parts = ["bf16"] if precision == "bf16" else []
    if not save_gates:
        parts.append("recompute")
    elif residuals == "bf16":
        parts.append("bf16_res")
    return "+".join(parts) or "f32"


def _res_dtype(residuals):
    return torch.bfloat16 if residuals == "bf16" else torch.float32


def _rb(a, bf16):
    """``a`` rounded to bf16 and back to its type where the JAX kernel casts
    a product's operand (``bf16``), else ``a``."""
    return a.bfloat16().to(a.dtype) if bf16 else a


def _wide(a):
    """A bf16 residual read as f32 (other types as they are)."""
    return a.float() if a.dtype == torch.bfloat16 else a


def _x_side(xs, ux, vx, bf16=False):
    """(xu = x @ Ux, or None for a dense x side; the x product x @ Ux [@ Vx])."""
    xu = _rb(xs, bf16) @ _rb(ux, bf16)
    if vx is None:
        return None, xu
    return xu, _rb(xu, bf16) @ _rb(vx, bf16)


def _gi_plain(xs, ux, vx, xdvec, bias, h, bf16):
    """(xu, gi): the input contribution of x mode, as the kernel builds it."""
    xu, xp = _x_side(xs, ux, vx, bf16)
    return xu, xp + pad_features(xs, h).repeat(1, 1, 4) * xdvec.reshape(-1) + bias


def lstm_scan_fused_xin_plain(xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0, precision="f32"):
    """The kernel's function in torch ops: the batched input projection, then
    a Python loop over T. Same arguments and results as `lstm_scan_fused_xin`."""
    ys, cs = lstm_scan_xin_fwd_res_plain(xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0,
                                         precision)[:2]
    return ys, cs[-1]


def lstm_scan_xin_fwd_res_plain(xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0, precision="f32",
                                residuals="f32", save_gates=True):
    """`lstm_scan_fused_xin_plain` that also returns the backward's residuals:
    -> (ys, cs [T,B,h], gates [T,B,4h] after the nonlinearities, hu =
    h_prev@U [T,B,r] or None for a dense recurrent side, xu = x@Ux [T,B,rx]
    or None for a dense x side). The gates and hu are of the ``residuals``
    type; without ``save_gates`` the gates, hu and xu are None. The final
    cell state is cs[-1]."""
    xu, gi = _gi_plain(xs, ux, vx, xdvec, bias, h0.shape[-1], _bf16(precision))
    ys, cs, gates, hu = lstm_recurrence_plain(gi, u, v, dvec, h0, c0, precision, residuals)
    if not save_gates:
        return ys, cs, None, None, None
    return ys, cs, gates, hu, xu


def lstm_recurrence_plain(gi, u, v, dvec, h0, c0, precision="f32", residuals="f32"):
    """The serial part of the scan in torch ops, step by step: from the input
    contribution gi [T, B, 4h] -> (ys, cs [T,B,h], gates [T,B,4h] after the
    nonlinearities, hu = h_prev@U [T,B,r] or None for a dense U [h, 4h]);
    the gates and hu of the ``residuals`` type, hu the product before any
    rounding. Under bf16 the products take bf16-rounded operands."""
    bf16 = _bf16(precision)
    store = (lambda a: a.bfloat16()) if residuals == "bf16" else (lambda a: a)
    dvec = dvec.reshape(-1)
    uu, vv = _rb(u, bf16), None if v is None else _rb(v, bf16)
    h_t, c_t = h0, c0
    ys, cs, gates, hus = [], [], [], []
    for gi_t in gi:
        if v is None:
            rec = _rb(h_t, bf16) @ uu
        else:
            hu = _rb(h_t, bf16) @ uu
            hus.append(store(hu))
            rec = _rb(hu, bf16) @ vv
        pre = gi_t + rec + h_t.repeat(1, 4) * dvec
        i, f, g, o = pre.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c_t = f * c_t + i * g
        h_t = o * torch.tanh(c_t)
        ys.append(h_t)
        cs.append(c_t)
        gates.append(store(torch.cat([i, f, g, o], dim=-1)))
    return (torch.stack(ys), torch.stack(cs), torch.stack(gates),
            torch.stack(hus) if hus else None)


def lstm_recompute_plain(xs, ux, vx, xdvec, bias, u, v, dvec, h0, ys, precision="f32"):
    """The recompute policy's pre-pass in torch ops, batched over all T*B
    rows as `pallas_scan._bwd_kernel` rebuilds them: -> (gates [T,B,4h], hu
    [T,B,r] or None, xu [T,B,rx] or None), f32, from x and h_prev (h0, then
    ys[:-1])."""
    bf16 = _bf16(precision)
    t, b, h = ys.shape
    xu, gi = _gi_plain(xs, ux, vx, xdvec, bias, h, bf16)
    hprev = torch.cat([h0[None], ys[:-1]]).reshape(t * b, h)
    hu = None
    if v is None:
        rec = _rb(hprev, bf16) @ _rb(u, bf16)
    else:
        hu = _rb(hprev, bf16) @ _rb(u, bf16)
        rec = _rb(hu, bf16) @ _rb(v, bf16)
        hu = hu.reshape(t, b, -1)
    pre = gi.reshape(t * b, 4 * h) + rec + hprev.repeat(1, 4) * dvec.reshape(-1)
    i, f, g, o = pre.chunk(4, dim=-1)
    gates = torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)], -1)
    return gates.reshape(t, b, 4 * h), hu, xu


def lstm_scan_xin_bwd_plain(xs, ux, vx, xdvec, u, v, dvec, h0, c0, ys, cs, gates, hu, xu,
                            dys, dc_last, bias=None, precision="f32"):
    """The BPTT kernel's function in torch ops, step by step as
    `pallas_scan._bwd_kernel` computes it: a reverse loop over T for dpre, the
    dh/dc carry and the recurrent weight gradients, then the x-side gradients
    batched over all T*B rows. ``dys`` and ``dc_last`` may be None (zeros).
    Gates None is the recompute policy: the pre-pass rebuilds the gates, hu
    and xu from x, ``bias`` and h_prev first.

    -> (dxs, dux, dvx, dxdvec, dbias, du, dv, ddvec, dh0, dc0), shaped as the
    forward's inputs; dv is None for a dense recurrent side, dvx for a dense
    x side.
    """
    bf16 = _bf16(precision)
    t, b, f = xs.shape
    h = h0.shape[-1]
    if gates is None:
        gates, hu, xu = lstm_recompute_plain(xs, ux, vx, xdvec, bias, u, v, dvec, h0, ys,
                                             precision)
    dpre, du, dv, ddvec, dh, dc = lstm_bptt_plain(u, v, dvec, h0, c0, ys, cs, gates, hu, dys,
                                                  None, dc_last, precision)
    dpre2 = dpre.reshape(t * b, 4 * h)
    dp_mm, x2 = _rb(dpre2, bf16), xs.reshape(t * b, f)
    if vx is None:
        dxu_mm, dvx = dp_mm, None
    else:
        dxu_mm = _rb(dp_mm @ _rb(vx, bf16).T, bf16)
        dvx = _rb(xu.reshape(t * b, -1), bf16).T @ dp_mm
    dx2 = dxu_mm @ _rb(ux, bf16).T
    dux = _rb(x2, bf16).T @ dxu_mm
    dxe = dpre2 * xdvec.reshape(-1)
    dxe = dxe[:, :h] + dxe[:, h:2 * h] + dxe[:, 2 * h:3 * h] + dxe[:, 3 * h:]
    dx2 = dx2 + pad_features(dxe, f)
    dxdvec = (dpre2 * pad_features(x2, h).repeat(1, 4)).sum(0).reshape(4, h)
    dbias = dpre2.sum(0)
    return dx2.reshape(t, b, f), dux, dvx, dxdvec, dbias, du, dv, ddvec, dh, dc


def lstm_bptt_plain(u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dh_last, dc_last,
                    precision="f32"):
    """The serial reverse walk of the BPTT in torch ops, step by step as
    `pallas_scan._bwd_kernel` computes it: dpre, the dh/dc carry and the
    recurrent weight gradients. ``dys``, ``dh_last`` and ``dc_last`` may be
    None (zeros); gates and hu may be bf16 residuals, read widened. Under
    bf16 the products take bf16-rounded operands, and the dvec terms the
    f32 dpre. -> (dpre [T,B,4h], du, dv (None for a dense U), ddvec [4h],
    dh0, dc0)."""
    bf16 = _bf16(precision)
    t = ys.shape[0]
    h = h0.shape[-1]
    hprev = torch.cat([h0[None], ys[:-1]])
    cprev = torch.cat([c0[None], cs[:-1]])
    dh = torch.zeros_like(h0) if dh_last is None else dh_last
    dc = torch.zeros_like(c0) if dc_last is None else dc_last
    du = torch.zeros_like(u)
    dv = None if v is None else torch.zeros_like(v)
    ddvec = torch.zeros(4 * h, dtype=h0.dtype, device=h0.device)
    dvec = dvec.reshape(-1)
    uu, vv = _rb(u, bf16), None if v is None else _rb(v, bf16)
    dpres = [None] * t
    for s in range(t - 1, -1, -1):
        i, fg, g, o = _wide(gates[s]).chunk(4, dim=-1)
        if dys is not None:
            dh = dh + dys[s]
        tanh_c = torch.tanh(cs[s])
        do = dh * tanh_c
        dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
        di, df, dg = dc * g, dc * cprev[s], dc * i
        dc = dc * fg
        dpre = torch.cat([di * i * (1.0 - i), df * fg * (1.0 - fg), dg * (1.0 - g * g),
                          do * o * (1.0 - o)], dim=-1)
        dpres[s] = dpre
        dvt = dpre * dvec
        dh_prev = dvt[:, :h] + dvt[:, h:2 * h] + dvt[:, 2 * h:3 * h] + dvt[:, 3 * h:]
        ddvec = ddvec + (dpre * hprev[s].repeat(1, 4)).sum(0)
        dp_mm, h_mm = _rb(dpre, bf16), _rb(hprev[s], bf16)
        if v is None:
            dh = dh_prev + dp_mm @ uu.T
            du = du + h_mm.T @ dp_mm
        else:
            dhu_mm = _rb(dp_mm @ vv.T, bf16)
            dh = dh_prev + dhu_mm @ uu.T
            du = du + h_mm.T @ dhu_mm
            dv = dv + _rb(_wide(hu[s]), bf16).T @ dp_mm
    return torch.stack(dpres), du, dv, ddvec, dh, dc


def lstm_scan_fused_plain(gi, u, v, dvec, h0, c0, precision="f32"):
    """`lstm_scan_fused`'s function in torch ops -> (ys, c_last)."""
    ys, cs = lstm_recurrence_plain(gi, u, v, dvec, h0, c0, precision)[:2]
    return ys, cs[-1]


def lstm_scan_bwd_plain(u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dc_last, precision="f32"):
    """`lstm_scan_bwd`'s function in torch ops: the walk of `lstm_bptt_plain`,
    whose dpre is dgi -> (dgi, du, dv, ddvec, dh0, dc0)."""
    return lstm_bptt_plain(u, v, dvec, h0, c0, ys, cs, gates, hu, dys, None, dc_last, precision)


def _check_tensors(names, tensors, want, dtypes=None):
    """Raise unless each tensor has its wanted shape, is float32 (or of its
    dtype in ``dtypes``), contiguous and on the first tensor's device. A
    None tensor is skipped."""
    dev = tensors[0].device
    dtypes = dtypes or {}
    for name, a in zip(names, tensors):
        if a is None:
            continue
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} must have shape {want[name]}, got {tuple(a.shape)}")
        if a.dtype != dtypes.get(name, torch.float32):
            raise TypeError(f"{name} must be {dtypes.get(name, torch.float32)}, got {a.dtype}")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, {names[0]} on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _sizes(xs, ux, vx, u, v, h0):
    """(T, B, F, rx, h, r) of a scan call, from its inputs; rx is 0 for a
    dense x side (vx None) and r 0 for a dense recurrent side (v None)."""
    if xs.dim() != 3:
        raise ValueError(f"xs must be [T, B, F], got {tuple(xs.shape)}")
    t, b, f = xs.shape
    h = h0.shape[-1] if h0.dim() == 2 else -1
    rx = 0 if vx is None else ux.shape[-1]
    r = 0 if v is None else u.shape[-1]
    if min(t, b, f, h) < 1 or (vx is not None and rx < 1) or (v is not None and r < 1):
        raise ValueError(f"empty scan: T={t}, B={b}, F={f}, rx={rx}, h={h}, r={r}")
    return t, b, f, rx, h, r


def _input_shapes(t, b, f, rx, h, r):
    return {
        "xs": (t, b, f), "ux": (f, rx or 4 * h), "vx": (rx, 4 * h), "xdvec": (4, h),
        "bias": (4 * h,), "u": (h, r or 4 * h), "v": (r, 4 * h), "dvec": (4 * h,),
        "h0": (b, h), "c0": (b, h), "gi": (t, b, 4 * h),
    }


def _arg_sizes(args):
    """(T, B, F, rx, h, r) of a forward call's checked inputs."""
    xs, ux, vx, _, _, u, v, _, h0, _ = args
    return _sizes(xs, ux, vx, u, v, h0)


def _check(args):
    """Validate a forward call's inputs; -> (T, B, F, rx, h, r)."""
    xs, ux, vx, _, _, u, v, _, h0, _ = args
    sizes = _sizes(xs, ux, vx, u, v, h0)
    _check_tensors(_ARG_NAMES, args, _input_shapes(*sizes))
    return sizes


def _check_gi(args):
    """Validate a gi-mode forward call's inputs; -> (T, B, h, r)."""
    gi, u, v, _, h0, _ = args
    if gi.dim() != 3 or h0.dim() != 2:
        raise ValueError(f"gi must be [T, B, 4h] and h0 [B, h], got {tuple(gi.shape)} and "
                         f"{tuple(h0.shape)}")
    (t, b, _), h = gi.shape, h0.shape[-1]
    r = 0 if v is None else u.shape[-1]
    if min(t, b, h) < 1 or (v is not None and r < 1):
        raise ValueError(f"empty scan: T={t}, B={b}, h={h}, r={r}")
    _check_tensors(_GI_NAMES, args, _input_shapes(t, b, 1, 0, h, r))
    return t, b, h, r


def _residual_dtypes(gates, hu):
    """The dtypes the residual checks allow: gates f32 or bf16, hu alike."""
    rdt = gates.dtype if gates is not None and gates.dtype == torch.bfloat16 else torch.float32
    return {"gates": rdt, "hu": rdt}, _RES_BF16 if rdt == torch.bfloat16 else _RES_F32


def _check_bwd(saved, dys, dc_last, bias):
    """Validate a backward call's residuals and cotangents; -> ((T, B, F, rx,
    h, r), the residual policy as the C entry numbers it)."""
    xs, ux, vx, _, u, v, _, h0 = saved[:8]
    gates, hu, xu = saved[11:14]
    t, b, f, rx, h, r = sizes = _sizes(xs, ux, vx, u, v, h0)
    if gates is None:
        if hu is not None or xu is not None or bias is None:
            raise ValueError("the recompute policy (gates None) takes no hu or xu, and bias")
        dtypes, policy = {}, _RES_NONE
    else:
        for name, res, factor in (("hu", hu, v), ("xu", xu, vx)):
            if (res is None) != (factor is None):
                raise ValueError(f"{name} is a residual of a low-rank side only: it must be "
                                 f"{'None' if factor is None else 'given'} here")
        dtypes, policy = _residual_dtypes(gates, hu)
    want = dict(_input_shapes(*sizes), ys=(t, b, h), cs=(t, b, h), gates=(t, b, 4 * h),
                hu=(t, b, r), xu=(t, b, rx), dys=(t, b, h), dc_last=(b, h))
    _check_tensors((*_RES_NAMES, "dys", "dc_last", "bias"), (*saved, dys, dc_last, bias), want,
                   dtypes)
    return sizes, policy


def _on_cpu(tensors):
    return all(a is None or a.device.type == "cpu" for a in tensors)


def _require_cuda(name, xs):
    if xs.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {xs.device}")


def _refuse_grad(name, args, apply):
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args):
        raise RuntimeError(f"{name} computes no gradient; inputs that require one go "
                           f"through {apply}.apply")


SMS = 132              # SMs of an H100 SXM: the plan's default
GRID_THREADS = 512     # threads per CTA of the grid kernels (scan_grid.cuh kGridThreads)
MAX_SLICES = 32        # depth slices of one product item (kMaxSlices)
MIN_SLICE_DEPTH = 8    # depth rows a slice takes at least (kMinSliceDepth)
STAGE_FLOATS = 8192    # the most floats a CTA stages of an exchange buffer at once
SMEM_LIMIT = 232448    # bytes of shared memory one block may use on sm_90
SPLIT_TARGET = 264     # CTAs a split-k product aims at (gemm_tile.cuh kSplitTarget)
TC_DEPTH = 32          # k-slice of a tensor-core GEMM stage (gemm_tc.cuh kK)
# multiply-adds of a step below which a CTA's share is not worth a wider
# group barrier: about a microsecond of one SM's f32 work
MIN_STEP_WORK = 32768


def _cdiv(a, b):
    return -(-a // b)


def _round4(n):
    return _cdiv(n, 4) * 4


def _split_at(q, n, parts):
    return q * n // parts


def _slices(items, depth):
    """Depth slices of a product with ``items`` items (scan_grid.cuh)."""
    most = 1 if items >= GRID_THREADS else min(MAX_SLICES, GRID_THREADS // items)
    return max(1, min(most, depth // MIN_SLICE_DEPTH))


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How the scan kernels spread one scan over the card: ``groups`` batch
    groups of consecutive rows, each on ``ctas`` CTAs (one per SM) that hold
    its slices of the recurrent weights in shared memory for the whole scan.
    CTA q of a group owns the hidden units `j_range(q)` (all four gate
    columns of each) and the rank columns `k_range(q)` (none for a dense
    recurrent side, r = 0). ``rpad``: a group's rows padded to a multiple of
    4. Per kernel: ``stage`` and ``red``, floats of the staging buffer and
    of the slice partials; ``smem``, bytes of shared memory per CTA;
    ``xchg``, floats of the exchange buffers. ``elsize``: bytes of a weight
    element in shared memory, 4 (f32) or 2 (the bf16 kernels).

    ``resident_fwd`` and ``resident_bwd``: per kernel, the depth rows of
    each of its two weight slices that stay in shared memory (the forward's
    U[:, k-slice] and V or dense U columns; the BPTT's V^T and U^T rows; 0
    for a dense side's absent first slice). A slice's rows past its
    resident depth are *streamed*: each CTA copies them once into its own
    region of a device-memory scratch (`stream_floats`) and reads them
    through L2 every step, in the same order of sums. A plan whose slices
    are all resident streams nothing."""

    b: int
    h: int
    r: int
    groups: int
    ctas: int
    rpad: int
    stage_fwd: int
    red_fwd: int
    smem_fwd: int
    xchg_fwd: int
    stage_bwd: int
    red_bwd: int
    smem_bwd: int
    xchg_bwd: int
    elsize: int = 4
    resident_fwd: tuple = (0, 0)
    resident_bwd: tuple = (0, 0)

    @property
    def n_ctas(self):
        return self.groups * self.ctas

    @property
    def streamed(self):
        """True where some weight row of either kernel is streamed."""
        return any(self.streamed_elems(k) for k in ("fwd", "bwd"))

    def slices(self, kernel):
        """`_weight_slices` of ``kernel`` ("fwd" or "bwd") on this plan's CTAs."""
        return _weight_slices(self.h, self.r, self.ctas)[kernel]

    def resident(self, kernel):
        return self.resident_fwd if kernel == "fwd" else self.resident_bwd

    def streamed_elems(self, kernel):
        """Weight elements a CTA of ``kernel`` streams: the rows of each
        slice past its resident depth."""
        return sum((d - res) * c for (d, c), res in zip(self.slices(kernel),
                                                        self.resident(kernel)))

    @property
    def smem_bytes(self):
        return max(self.smem_fwd, self.smem_bwd)

    def rows(self, g):
        """Batch rows [b0, b1) of group g."""
        return _split_at(g, self.b, self.groups), _split_at(g + 1, self.b, self.groups)

    def j_range(self, q):
        """Hidden units [j0, j1) of CTA q of a group."""
        return _split_at(q, self.h, self.ctas), _split_at(q + 1, self.h, self.ctas)

    def k_range(self, q):
        """Rank columns [k0, k1) of CTA q of a group (empty when dense)."""
        return _split_at(q, self.r, self.ctas), _split_at(q + 1, self.r, self.ctas)

    def ints(self, kernel):
        """The plan as the C entry of ``kernel`` ("fwd" or "bwd") takes it:
        groups, ctas, rpad, stage, red, smem, and the resident depths of its
        two weight slices."""
        return (self.groups, self.ctas, self.rpad, *((self.stage_fwd, self.red_fwd, self.smem_fwd)
                if kernel == "fwd" else (self.stage_bwd, self.red_bwd, self.smem_bwd)),
                *self.resident(kernel))


def stream_floats(plan, kernel):
    """Floats of the device-memory scratch that ``kernel`` ("fwd" or "bwd")
    streams its weight rows from: each CTA's streamed elements, rounded up
    to 16 bytes (scan_grid.cuh::weight_floats), times the CTAs; 0 for a
    plan that streams nothing."""
    return plan.n_ctas * (_cdiv(plan.streamed_elems(kernel) * plan.elsize, 16) * 4)


@functools.lru_cache(maxsize=4096)
def _weight_slices(h, r, ctas):
    """{kernel: ((depth, columns) of each of its CTAs' two weight slices, as
    it lays them out)}: the forward's U[:, k-slice] [h][kwp] (depth 0 when
    dense) and V or dense U [depth][4 jwm]; the BPTT's V^T [4h][kwp] (0
    when dense) and U^T [depth][jwp]."""
    jwm = _cdiv(h, ctas)
    kwp = _round4(_cdiv(r, ctas))
    return {"fwd": ((h if r else 0, kwp), (r or h, 4 * jwm)),
            "bwd": ((4 * h if r else 0, kwp), (r or 4 * h, _round4(jwm)))}


def _kernel_layout(h, ctas, rpad, phases, weights, slabs, elsize):
    """(stage, red, smem bytes) of one kernel: ``phases`` are its products as
    (depth, columns), ``weights`` the elements of its weight slices held in
    shared memory, of ``elsize`` bytes each (the region rounded up to 16
    bytes), ``slabs`` its [units][rpad] buffers (the carry and the
    prefetched step inputs)."""
    stage = min(max(d for d, _ in phases), max(2, STAGE_FLOATS // rpad)) * rpad
    red = 0
    for depth, cols in phases:
        items = _cdiv(cols, 4) * (rpad // 4)
        slices = _slices(items, depth)
        red = max(red, slices * items * 16 if slices > 1 else 0)
    jwm = _cdiv(h, ctas)
    wfloats = _cdiv(weights * elsize, 16) * 4
    return stage, red, 4 * (wfloats + 4 * jwm + slabs * jwm * rpad + stage + red)


def _streamed_plan(b, h, r, sms, elsize):
    """The plan of `scan_plan` where not even one row has a resident one:
    one group over min(sms, h) CTAs, each kernel holding as much depth of
    each weight slice as fits beside its slabs, stage and red (the same
    share of each slice's depth), the rest streamed. Raises ValueError
    where the slabs alone do not fit: `scan_chunks` then cuts the batch."""
    ctas = min(sms, h)
    empty = plan_layout(b, h, r, 1, ctas, elsize, resident=((0, 0), (0, 0)))
    resident = []
    for kernel, smem in (("fwd", empty.smem_fwd), ("bwd", empty.smem_bwd)):
        room = (SMEM_LIMIT - smem) // 16 * 16 // elsize  # weight elements that fit
        if room < 0:
            raise ValueError(f"the recurrent weights of h={h}, r={r or 'dense'} do not fit in "
                             f"the shared memory of {sms} SMs, and the slabs of B={b} do not "
                             f"fit beside a streamed slice")
        total = sum(d * c for d, c in empty.slices(kernel))
        resident.append(tuple(min(d, d * room // total) for d, _ in empty.slices(kernel)))
    return plan_layout(b, h, r, 1, ctas, elsize, resident=tuple(resident))


@functools.lru_cache(maxsize=256)
def scan_plan(b, h, r, sms=SMS, elsize=4):
    """The layout of the scan kernels for batch ``b``, hidden width ``h`` and
    recurrent rank ``r`` (0: a dense U [h, 4h]) on ``sms`` SMs, with weight
    slices of ``elsize`` bytes an element (4, or 2 for the bf16 kernels)
    -> ScanPlan.

    Each CTA's work per step is about the same for any grouping (the batch
    times the weights over the CTAs), but each CTA reads its group's whole h
    (or dpre) from L2 a step, and a barrier waits for every CTA of the
    group. So the plan takes as many groups as the card holds copies of the
    weights. For each group count from min(b, sms) down it tries ``ctas`` =
    just enough CTAs for MIN_STEP_WORK each (a single CTA per group needs no
    grid barrier), then sms // groups, both at most h; the first whose
    shared memory fits wins, with every weight row resident. Where the
    weights do not fit in the shared memory of all SMs even for one row,
    the plan streams the rows that do not fit (`_streamed_plan`); that is
    chosen by the width alone, so every shape with a resident plan keeps
    it. Raises ValueError where a batch has no plan (`scan_chunks` then
    cuts it into chunks that have one).
    """
    if min(b, h, sms) < 1 or r < 0 or elsize not in (2, 4):
        raise ValueError(f"no scan plan for B={b}, h={h}, r={r} on {sms} SMs, {elsize}-byte "
                         f"weights")
    if not _fits_resident(1, h, r, sms, elsize):
        return _streamed_plan(b, h, r, sms, elsize)
    plan = _fits_resident(b, h, r, sms, elsize)
    if plan is None:
        raise ValueError(f"the recurrent weights of h={h}, r={r or 'dense'} do not fit in the "
                         f"shared memory of {sms} SMs at B={b}")
    return plan


@functools.lru_cache(maxsize=256)
def _fits_resident(b, h, r, sms, elsize):
    """The first grouping of `scan_plan`'s search whose weights are all
    resident and fit, or None."""
    step_work = h * 4 * h if r == 0 else h * r + r * 4 * h  # multiply-adds of a row's step
    for groups in range(min(b, sms), 0, -1):
        most = max(1, min(sms // groups, h))
        work = _round4(_cdiv(b, groups)) * step_work
        for ctas in sorted({min(most, _cdiv(work, MIN_STEP_WORK)), most}):
            plan = plan_layout(b, h, r, groups, ctas, elsize)
            if plan.smem_bytes <= SMEM_LIMIT:
                return plan
    return None


def plan_layout(b, h, r, groups, ctas, elsize=4, resident=None):
    """The ScanPlan of ``groups`` batch groups of ``ctas`` CTAs each, for
    batch ``b``, width ``h`` and rank ``r`` (0: dense), weights of
    ``elsize`` bytes; `scan_plan` picks the grouping. ``resident``: the
    (forward, BPTT) pairs of resident depths (`ScanPlan.resident_fwd`);
    None holds every row in shared memory."""
    rpad = _round4(_cdiv(b, groups))
    slices = _weight_slices(h, r, ctas)
    if resident is None:
        resident = tuple(tuple(d for d, _ in slices[k]) for k in ("fwd", "bwd"))
    held = [sum(res * c for res, (_, c) in zip(resident[i], slices[k]))
            for i, k in enumerate(("fwd", "bwd"))]
    phases = {k: [sl for sl in slices[k] if sl[0]] for k in slices}
    # slabs: forward h, c and the step's gi (4); BPTT dh, dc and phase A's 7 inputs
    fwd = _kernel_layout(h, ctas, rpad, phases["fwd"], held[0], 6, elsize)
    bwd = _kernel_layout(h, ctas, rpad, phases["bwd"], held[1], 9, elsize)
    return ScanPlan(b, h, r, groups, ctas, rpad, *fwd, groups * rpad * (2 * h + r),
                    *bwd, groups * rpad * (8 * h + r), elsize, *map(tuple, resident))


def _splitk_floats(m, n, k, depth=TC_DEPTH):
    """Floats of partial sums that a split-k product c [m, n] = A [m, k] @
    B [k, n] wants (0: it does not split): with fewer than SPLIT_TARGET
    64x64 tiles, the tiles times slices of k in whole ``depth`` steps near
    SPLIT_TARGET CTAs. gemm_tc.cuh::gemm_splitk (whose plan never takes its
    128x128 tile there) slices by TC_DEPTH, gemm_tile.cuh's by 16."""
    if k <= 0:
        return 0
    splits = _cdiv(SPLIT_TARGET, _cdiv(n, 64) * _cdiv(m, 64))
    kslice = _cdiv(_cdiv(k, splits), depth) * depth
    splits = _cdiv(k, kslice)
    return splits * m * n if splits > 1 else 0


def _partial_shapes(t, b, f, rx, h, r, gi, recompute):
    m, g4 = t * b, 4 * h
    shapes = [(h, g4, m)] if not r else [(r, g4, m), (h, r, m)]
    if not gi:
        shapes += [(f, g4, m), (m, f, g4)] if not rx else [(f, rx, m), (rx, g4, m), (m, rx, g4)]
    if recompute:
        shapes.append((m, r or g4, h))
    return shapes


def bwd_partial_floats(t, b, f, rx, h, r, *, gi=False, recompute=False):
    """Floats of split-k scratch for the BPTT's products with few output
    tiles and a long k: the weight gradients (k = T*B) and, in x mode, the
    x side's product over the 4h gate columns (dXU, or dx for a dense x
    side); under the recompute policy also the pre-pass's hu = Hprev @ U
    (k = h). The largest that any of them wants of gemm_tc.cuh's plan."""
    return max(_splitk_floats(*s) for s in _partial_shapes(t, b, f, rx, h, r, gi, recompute))


def tile_partial_floats(t, b, f, rx, h, r, *, gi=False):
    """`bwd_partial_floats` under gemm_tile.cuh's split rule: the scratch of
    the stack's weight gradients (ops/cuda_stack.py), whose products stay on
    that tile, so their slices, and their bits, stay as they were."""
    return max(_splitk_floats(*s, depth=16) for s in _partial_shapes(t, b, f, rx, h, r, gi, False))


@functools.lru_cache(maxsize=256)
def scan_chunks(b, h, r, sms=SMS, elsize=4):
    """The batch cut into as few chunks of consecutive rows as each have a
    `scan_plan`, their sizes at most one apart -> ((b_begin, b_count, plan),
    ...): one launch takes a chunk. A batch that has a plan is one chunk
    (the PTB VMLMF LM layer up to B=656 in f32, 832 in bf16; the dense one
    up to 476). Raises `scan_plan`'s ValueError when not even one row has
    a plan: every width has one (streamed where the weights do not fit),
    so only where one row's slabs alone do not fit in shared memory."""
    scan_plan(1, h, r, sms, elsize)
    for n in range(1, b + 1):
        bounds = [_split_at(i, b, n) for i in range(n + 1)]
        try:
            return tuple((b0, b1 - b0, scan_plan(b1 - b0, h, r, sms, elsize))
                         for b0, b1 in zip(bounds, bounds[1:]))
        except ValueError:
            continue
    raise AssertionError("one row has a plan, so b chunks of one row have")


def _chunks_for(b, h, r, device, bf16=False):
    return scan_chunks(b, h, r, _sm_count(device.index), 2 if bf16 else 4)


def _rows(a, dim, b0, n):
    """Rows [b0, b0 + n) of ``a`` along its batch dim ``dim`` as a contiguous
    tensor; ``a`` itself where it has no batch dim (None) or is None."""
    return a if a is None or dim is None else a.narrow(dim, b0, n).contiguous()


def _by_chunks(fn, name, chunks, launch, tensors, dims, out_dims):
    """Run ``launch(plan, *tensors)`` once for each chunk of rows, on the
    chunk's rows of each tensor whose batch dim ``dims`` gives (None: the
    same tensor for every chunk), counting each launch under ``fn``'s
    variant ``name`` -> its outputs over the whole batch: those with a batch
    dim in ``out_dims`` joined along it, the others (weight gradients, None
    in ``out_dims``) summed over the chunks in chunk order, in f32. One
    chunk is one launch on the caller's tensors."""
    if len(chunks) == 1:
        out = launch(chunks[0][2], *tensors)
        _counted(fn, name)
        return out
    parts = []
    for b0, n, plan in chunks:
        parts.append(launch(plan, *(_rows(a, d, b0, n) for a, d in zip(tensors, dims))))
        _counted(fn, name)
    joined = []
    for i, dim in enumerate(out_dims):
        pieces = [p[i] for p in parts]
        if pieces[0] is None:
            joined.append(None)
        elif dim is None:
            total = pieces[0]
            for piece in pieces[1:]:
                total.add_(piece)
            joined.append(total)
        else:
            joined.append(torch.cat(pieces, dim))
    return tuple(joined)


# batch dims of the entries' tensors (None: no batch dim, the same for every
# chunk): x mode's (xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0) and gi
# mode's (gi, u, v, dvec, h0, c0), which their gradients share; the BPTTs'
# residuals and cotangents
_XIN_ROWS = (1, None, None, None, None, None, None, None, 0, 0)
_GI_ROWS = (1, None, None, None, 0, 0)
_XIN_BWD_ROWS = (1, None, None, None, None, None, None, 0, 0,   # xs ... c0
                 1, 1, 1, 1, 1, 1, 0, None)                    # ys ... xu, dys, dc_last, bias
_GI_BWD_ROWS = (None, None, None, 0, 0, 1, 1, 1, 1, 1, 0)     # u ... hu, dys, dc_last


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(kernel, entry, tensors, sizes, device):
    """Call C entry ``entry`` of csrc/<kernel>.cu on the current stream: the
    tensors' pointers (None -> null), the integers (the sizes T, B, F, rx,
    h, r, the plan's layout and the variant's flags) and the stream. Raises
    on the non-zero cudaError it returns: a plan the kernel cannot take, a
    launch refused, or a grid too large to be co-resident (no fallback)."""
    lib = _build.load(kernel)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(sizes)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*(None if a is None else a.data_ptr() for a in tensors), *sizes, stream)
    if err != 0:
        describe = getattr(lib, f"{kernel}_error")
        describe.argtypes, describe.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{entry} launch failed: {describe(err).decode()} (cudaError {err})")


def _counted(fn, name):
    """Add one to ``fn.launches`` and to ``fn.variants[name]``: a kernel of
    that variant was launched."""
    fn.launches += 1
    fn.variants[name] += 1


# every wrapper that counts its launches, in definition order (`_counter`):
# a captured CUDA graph adds its launches to them at each replay
# (`utils.graphs.StepGraph`)
COUNTED = []


def _counter(fn):
    fn.launches = 0
    fn.variants = collections.Counter()
    COUNTED.append(fn)
    return fn


def _sync_words(plan, like):
    """One barrier word per batch group; the launcher zeroes them."""
    return torch.empty(plan.groups, dtype=torch.int32, device=like.device)


def _empty(like):
    """A maker of uninitialised f32 tensors on ``like``'s device."""
    return lambda *shape: torch.empty(shape, dtype=torch.float32, device=like.device)


def _wstream(plan, kernel, like):
    """(the streamed weights' scratch of ``kernel`` or None, its floats)."""
    n = stream_floats(plan, kernel)
    return (_empty(like)(n) if n else None), n


@_counter
def lstm_scan_fused_xin(xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0, precision="f32"):
    """Fused LSTM scan, x mode, no gradient.

    xs [T, B, F]; x side ux [F, rx], vx [rx, 4h] (low-rank) or ux [F, 4h],
    vx None (dense); xdvec [4, h] (applied to x over its first min(F, h)
    features); bias [4h]; recurrent side u [h, r], v [r, 4h] (low-rank) or
    u [h, 4h], v None (dense); dvec [4h]; h0, c0 [B, h]. Gate order i, f, g,
    o. ``precision`` "f32" or "bf16" (bf16-rounded product operands, f32
    sums). Returns (ys [T, B, h], c_last [B, h]).

    CPU tensors run `lstm_scan_fused_xin_plain`. CUDA tensors must be float32,
    contiguous and on one device; the kernel runs on the current stream, one
    launch for each chunk of rows (`scan_chunks`; one up to B=656 at the
    PTB LM layer), and ``lstm_scan_fused_xin.launches`` counts the launches
    (``.variants`` by precision). A CUDA input that requires a gradient, with grad mode on,
    raises: that call belongs to `LSTMScanXin`.
    """
    args = (xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0)
    bf16 = _bf16(precision)
    if _on_cpu(args):
        return lstm_scan_fused_xin_plain(*args, precision)
    sizes = _check(args)
    _require_cuda("lstm_scan_fused_xin", xs)
    _refuse_grad("lstm_scan_fused_xin", args, "LSTMScanXin")
    _, b, _, _, h, r = sizes
    with torch.cuda.device(xs.device):
        return _by_chunks(lstm_scan_fused_xin, variant(precision),
                          _chunks_for(b, h, r, xs.device, bf16),
                          functools.partial(_xin_fwd_launch, bf16), args, _XIN_ROWS, (1, 0))


def _xin_fwd_launch(bf16, plan, *args):
    """One launch of entry ``lstm_scan_xin_fwd`` on a chunk -> (ys, c_last)."""
    xs = args[0]
    t, b, _, rx, h, _ = sizes = _arg_sizes(args)
    new = _empty(xs)
    xu = new(t * b, rx) if rx else None
    gi, ys, c_last = new(t * b, 4 * h), new(t, b, h), new(b, h)
    xchg, sync = new(plan.xchg_fwd), _sync_words(plan, xs)
    wstream, nstream = _wstream(plan, "fwd", xs)
    _launch(KERNEL, "lstm_scan_xin_fwd", (*args, xu, gi, ys, c_last, xchg, sync, wstream),
            (nstream, *sizes, *plan.ints("fwd"), int(bf16)), xs.device)
    return ys, c_last


@_counter
def lstm_scan_fused_xin_res(xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0, precision="f32",
                            residuals=None, save_gates=None):
    """The residual forward of training: `lstm_scan_fused_xin` that also
    returns the backward's residuals -> (ys, cs, gates, hu, xu), shaped as
    `lstm_scan_xin_fwd_res_plain`'s, which CPU tensors run: hu is None for a
    dense recurrent side and xu for a dense x side. ``residuals`` ("f32" or
    "bf16": the gates and hu stored as bf16) and ``save_gates`` (False: the
    recompute policy, no gates, hu or xu stored) are read from
    VMLMF_PALLAS_RESIDUALS and VMLMF_PALLAS_SAVED_GATES when None. The final
    cell state is cs[-1]. ``lstm_scan_fused_xin_res.launches`` counts the
    kernel's calls, ``.variants`` by `variant`."""
    args = (xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0)
    bf16 = _bf16(precision)
    residuals, save_gates = _policy(residuals, save_gates)
    if _on_cpu(args):
        return lstm_scan_xin_fwd_res_plain(*args, precision, residuals, save_gates)
    sizes = _check(args)
    _require_cuda("lstm_scan_fused_xin_res", xs)
    _, b, _, _, h, r = sizes
    with torch.cuda.device(xs.device):
        return _by_chunks(lstm_scan_fused_xin_res, variant(precision, residuals, save_gates),
                          _chunks_for(b, h, r, xs.device, bf16),
                          functools.partial(_xin_res_launch, bf16, residuals, save_gates), args,
                          _XIN_ROWS, (1, 1, 1, 1, 1))


def _xin_res_launch(bf16, residuals, save_gates, plan, *args):
    """One launch of entry ``lstm_scan_xin_fwd_res`` on a chunk -> (ys, cs,
    gates, hu, xu)."""
    xs = args[0]
    t, b, _, rx, h, r = sizes = _arg_sizes(args)
    rdt = _res_dtype(residuals)
    new = _empty(xs)
    xu = new(t, b, rx) if rx else None
    gates = hu = None
    if save_gates:
        gates = torch.empty((t, b, 4 * h), dtype=rdt, device=xs.device)
        hu = torch.empty((t, b, r), dtype=rdt, device=xs.device) if r else None
    gi, ys, cs = new(t * b, 4 * h), new(t, b, h), new(t, b, h)
    xchg, sync = new(plan.xchg_fwd), _sync_words(plan, xs)
    wstream, nstream = _wstream(plan, "fwd", xs)
    policy = (_RES_BF16 if residuals == "bf16" else _RES_F32) if save_gates else _RES_NONE
    _launch(KERNEL, "lstm_scan_xin_fwd_res",
            (*args, xu, gi, ys, cs, gates, hu, xchg, sync, wstream),
            (nstream, *sizes, *plan.ints("fwd"), int(bf16), policy), xs.device)
    return ys, cs, gates, hu, (xu if save_gates else None)


@_counter
def lstm_scan_xin_bwd(xs, ux, vx, xdvec, u, v, dvec, h0, c0, ys, cs, gates, hu, xu,
                      dys, dc_last, bias=None, precision="f32"):
    """Gradients of the fused scan from the residual forward's outputs and the
    cotangents ``dys [T, B, h]`` and ``dc_last [B, h]`` (either may be None,
    read as zeros) -> (dxs, dux, dvx, dxdvec, dbias, du, dv, ddvec, dh0, dc0);
    dv is None for a dense recurrent side and dvx for a dense x side. The
    residual forward's choices come with its outputs: bf16 gates and hu
    are bf16 residuals, gates None the recompute policy (hu and xu None
    too, ``bias`` given). ``precision`` must be the forward's.

    CPU tensors run `lstm_scan_xin_bwd_plain`; CUDA tensors launch the BPTT
    kernel, counted by ``lstm_scan_xin_bwd.launches`` (``.variants``).
    """
    saved = (xs, ux, vx, xdvec, u, v, dvec, h0, c0, ys, cs, gates, hu, xu)
    bf16 = _bf16(precision)
    if _on_cpu((*saved, dys, dc_last, bias)):
        return lstm_scan_xin_bwd_plain(*saved, dys, dc_last, bias=bias, precision=precision)
    sizes, policy = _check_bwd(saved, dys, dc_last, bias)
    _require_cuda("lstm_scan_xin_bwd", xs)
    _, b, _, _, h, r = sizes
    res = ("bf16" if policy == _RES_BF16 else "f32")
    with torch.cuda.device(xs.device):
        return _by_chunks(lstm_scan_xin_bwd, variant(precision, res, policy != _RES_NONE),
                          _chunks_for(b, h, r, xs.device, bf16),
                          functools.partial(_xin_bwd_launch, bf16), (*saved, dys, dc_last, bias),
                          _XIN_BWD_ROWS, _XIN_ROWS)


def _xin_bwd_launch(bf16, plan, *tensors):
    """One launch of the BPTT on a chunk of rows -> its gradients, the
    weights' over the chunk's rows alone."""
    *saved, dys, dc_last, bias = tensors
    xs, ux, vx, _, u, v, _, h0 = saved[:8]
    t, b, f, rx, h, r = sizes = _sizes(xs, ux, vx, u, v, h0)
    policy = _RES_NONE if saved[11] is None else _residual_dtypes(saved[11], saved[12])[1]
    rebuild = policy != _RES_F32  # widened bf16 residuals, or the recompute pre-pass
    new = _empty(xs)
    dpre = new(t * b, 4 * h)
    dhu = new(t * b, r) if r else None
    dxu = new(t * b, rx) if rx else None
    work = (new(t * b, 4 * h) if rebuild else None, new(t * b, r) if rebuild and r else None,
            new(t * b, rx) if policy == _RES_NONE and rx else None)
    grads = (new(t, b, f), torch.empty_like(ux), new(rx, 4 * h) if rx else None, new(4, h),
             new(4 * h), torch.empty_like(u), new(r, 4 * h) if r else None, new(4 * h),
             new(b, h), new(b, h))
    partial = new(max(1, bwd_partial_floats(*sizes, recompute=policy == _RES_NONE)))
    wstream, nstream = _wstream(plan, "bwd", xs)
    _launch(BWD_KERNEL, "lstm_scan_xin_bwd",
            (*saved[:4], bias, *saved[4:], dys, dc_last, *work, dpre, dhu, dxu, *grads,
             new(plan.xchg_bwd), _sync_words(plan, xs), partial, wstream),
            (partial.numel(), nstream, *sizes, *plan.ints("bwd"), int(bf16), policy), xs.device)
    return grads


def _pad_grads(ctx, grads):
    """``grads`` with None for the non-tensor argument that follows the
    tensors in the call (precision)."""
    return (*grads, *[None] * (len(ctx.needs_input_grad) - len(grads)))


class LSTMScanXin(torch.autograd.Function):
    """The differentiable fused scan: the residual forward, then the BPTT.

    ``LSTMScanXin.apply(xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0,
    precision="f32")`` -> (ys, c_last), with gradients for every tensor
    input (vx and v may be None, for a dense side). The residual dtype and
    policy come from VMLMF_PALLAS_RESIDUALS and VMLMF_PALLAS_SAVED_GATES,
    read at call time (the JAX package reads them at trace time). A
    cotangent that autograd leaves out (an output no loss reads, as the
    LM's detached final state) is passed to the backward as None and read
    there as zeros.
    """

    @staticmethod
    def forward(ctx, xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0, precision="f32"):
        ys, cs, gates, hu, xu = lstm_scan_fused_xin_res(xs, ux, vx, xdvec, bias, u, v, dvec,
                                                        h0, c0, precision)
        ctx.save_for_backward(xs, ux, vx, xdvec, u, v, dvec, h0, c0, ys, cs, gates, hu, xu,
                              None if gates is not None else bias)
        ctx.precision = precision
        ctx.set_materialize_grads(False)
        return ys, cs[-1].clone()

    @staticmethod
    def backward(ctx, dys, dc_last):
        if dys is not None:
            dys = dys.contiguous()
        if dc_last is not None:
            dc_last = dc_last.contiguous()
        *saved, bias = ctx.saved_tensors
        return _pad_grads(ctx, lstm_scan_xin_bwd(*saved, dys, dc_last, bias, ctx.precision))


@_counter
def lstm_scan_fused(gi, u, v, dvec, h0, c0, precision="f32"):
    """Fused LSTM scan, gi mode, no gradient: `pallas_scan.lstm_scan_fused`.

    gi [T, B, 4h] is the input contribution (the cell's ``inp``, gate order
    i, f, g, o); the recurrent side, dvec, h0, c0 and ``precision`` as
    `lstm_scan_fused_xin` takes them. Returns (ys [T, B, h], c_last [B, h]).
    CPU tensors run `lstm_scan_fused_plain`; CUDA tensors launch entry
    ``lstm_scan_fwd``, counted by ``lstm_scan_fused.launches``."""
    args = (gi, u, v, dvec, h0, c0)
    bf16 = _bf16(precision)
    if _on_cpu(args):
        return lstm_scan_fused_plain(*args, precision)
    _, b, h, r = _check_gi(args)
    _require_cuda("lstm_scan_fused", gi)
    _refuse_grad("lstm_scan_fused", args, "LSTMScan")
    with torch.cuda.device(gi.device):
        return _by_chunks(lstm_scan_fused, variant(precision),
                          _chunks_for(b, h, r, gi.device, bf16),
                          functools.partial(_gi_fwd_launch, bf16), args, _GI_ROWS, (1, 0))


def _gi_fwd_launch(bf16, plan, *args):
    """One launch of entry ``lstm_scan_fwd`` on a chunk -> (ys, c_last)."""
    gi, u, v, _, h0, _ = args
    (t, b, _), h, r = gi.shape, h0.shape[-1], 0 if v is None else u.shape[-1]
    new = _empty(gi)
    ys, c_last = new(t, b, h), new(b, h)
    wstream, nstream = _wstream(plan, "fwd", gi)
    _launch(KERNEL, "lstm_scan_fwd", (*args, ys, c_last, new(plan.xchg_fwd),
                                      _sync_words(plan, gi), wstream),
            (nstream, t, b, h, r, *plan.ints("fwd"), int(bf16)), gi.device)
    return ys, c_last


@_counter
def lstm_scan_fused_res(gi, u, v, dvec, h0, c0, precision="f32", residuals=None):
    """The residual forward of gi mode -> (ys, cs, gates, hu), as
    `lstm_recurrence_plain` returns them (which CPU tensors run). gi mode
    always saves the gates (the JAX package's recompute policy is x mode
    only); ``residuals`` as `lstm_scan_fused_xin_res` takes it. Entry
    ``lstm_scan_fwd_res``, counted by ``lstm_scan_fused_res.launches``."""
    args = (gi, u, v, dvec, h0, c0)
    bf16 = _bf16(precision)
    residuals, _ = _policy(residuals, True)
    if _on_cpu(args):
        return lstm_recurrence_plain(*args, precision, residuals)
    _, b, h, r = _check_gi(args)
    _require_cuda("lstm_scan_fused_res", gi)
    with torch.cuda.device(gi.device):
        return _by_chunks(lstm_scan_fused_res, variant(precision, residuals),
                          _chunks_for(b, h, r, gi.device, bf16),
                          functools.partial(_gi_res_launch, bf16, residuals), args, _GI_ROWS,
                          (1, 1, 1, 1))


def _gi_res_launch(bf16, residuals, plan, *args):
    """One launch of entry ``lstm_scan_fwd_res`` on a chunk -> (ys, cs,
    gates, hu)."""
    gi, u, v, _, h0, _ = args
    (t, b, _), h, r = gi.shape, h0.shape[-1], 0 if v is None else u.shape[-1]
    rdt = _res_dtype(residuals)
    new = _empty(gi)
    ys, cs = new(t, b, h), new(t, b, h)
    gates = torch.empty((t, b, 4 * h), dtype=rdt, device=gi.device)
    hu = torch.empty((t, b, r), dtype=rdt, device=gi.device) if r else None
    wstream, nstream = _wstream(plan, "fwd", gi)
    _launch(KERNEL, "lstm_scan_fwd_res", (*args, ys, cs, gates, hu, new(plan.xchg_fwd),
                                          _sync_words(plan, gi), wstream),
            (nstream, t, b, h, r, *plan.ints("fwd"), int(bf16),
             _RES_BF16 if residuals == "bf16" else _RES_F32), gi.device)
    return ys, cs, gates, hu


@_counter
def lstm_scan_bwd(u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dc_last, precision="f32"):
    """Gradients of the gi-mode scan -> (dgi, du, dv, ddvec, dh0, dc0): the
    BPTT walk, whose dpre is dgi, and the recurrent weight gradients; no x
    side (`pallas_scan._scan_core_bwd`). gates and hu are the residual
    forward's (f32 or bf16); ``dys``/``dc_last`` may be None. CPU tensors
    run `lstm_scan_bwd_plain`; CUDA tensors launch entry ``lstm_scan_bwd``,
    counted by ``lstm_scan_bwd.launches``."""
    bf16 = _bf16(precision)
    if _on_cpu((u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dc_last)):
        return lstm_scan_bwd_plain(u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dc_last, precision)
    tensors = (u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dc_last)
    _, b, h, r, policy = _check_gi_bwd(tensors)
    _require_cuda("lstm_scan_bwd", ys)
    res = "bf16" if policy == _RES_BF16 else "f32"
    with torch.cuda.device(ys.device):
        return _by_chunks(lstm_scan_bwd, variant(precision, res),
                          _chunks_for(b, h, r, ys.device, bf16),
                          functools.partial(_gi_bwd_launch, bf16), tensors, _GI_BWD_ROWS,
                          _GI_ROWS)


def _check_gi_bwd(tensors):
    """Validate a gi-mode BPTT call's residuals and cotangents -> (T, B, h,
    r, the residual policy as the C entry numbers it)."""
    u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dc_last = tensors
    t, b, h = ys.shape
    r = 0 if v is None else u.shape[-1]
    if (hu is None) != (v is None):
        raise ValueError("hu is a residual of a low-rank recurrent side only")
    dtypes, policy = _residual_dtypes(gates, hu)
    want = dict(_input_shapes(t, b, 1, 0, h, r), ys=(t, b, h), cs=(t, b, h), gates=(t, b, 4 * h),
                hu=(t, b, r), dys=(t, b, h), dc_last=(b, h))
    names = ("ys", "u", "v", "dvec", "h0", "c0", "cs", "gates", "hu", "dys", "dc_last")
    _check_tensors(names, (ys, u, v, dvec, h0, c0, cs, gates, hu, dys, dc_last), want, dtypes)
    return t, b, h, r, policy


def _gi_bwd_launch(bf16, plan, *tensors):
    """One launch of entry ``lstm_scan_bwd`` on a chunk -> (dgi, du, dv,
    ddvec, dh0, dc0), the weights' over the chunk's rows alone."""
    u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dc_last = tensors
    (t, b, h), r = ys.shape, 0 if v is None else u.shape[-1]
    widen = _residual_dtypes(gates, hu)[1] == _RES_BF16
    policy = _RES_BF16 if widen else _RES_F32
    new = _empty(ys)
    work = (new(t * b, 4 * h) if widen else None, new(t * b, r) if widen and r else None)
    dgi, dhu = new(t, b, 4 * h), new(t * b, r) if r else None
    grads = (dgi, torch.empty_like(u), new(r, 4 * h) if r else None, new(4 * h), new(b, h),
             new(b, h))
    partial = new(max(1, bwd_partial_floats(t, b, 1, 0, h, r, gi=True)))
    wstream, nstream = _wstream(plan, "bwd", ys)
    _launch(BWD_KERNEL, "lstm_scan_bwd",
            (u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dc_last, *work, dgi, dhu, *grads[1:],
             new(plan.xchg_bwd), _sync_words(plan, ys), partial, wstream),
            (partial.numel(), nstream, t, b, h, r, *plan.ints("bwd"), int(bf16), policy),
            ys.device)
    return grads


class LSTMScan(torch.autograd.Function):
    """The differentiable gi-mode scan: `lstm_scan_fused_res`, then
    `lstm_scan_bwd`. ``LSTMScan.apply(gi, u, v, dvec, h0, c0,
    precision="f32")`` -> (ys, c_last), with gradients for gi, the recurrent
    weights and the initial state; the residual dtype from
    VMLMF_PALLAS_RESIDUALS, read at call time."""

    @staticmethod
    def forward(ctx, gi, u, v, dvec, h0, c0, precision="f32"):
        ys, cs, gates, hu = lstm_scan_fused_res(gi, u, v, dvec, h0, c0, precision)
        ctx.save_for_backward(u, v, dvec, h0, c0, ys, cs, gates, hu)
        ctx.precision = precision
        ctx.set_materialize_grads(False)
        return ys, cs[-1].clone()

    @staticmethod
    def backward(ctx, dys, dc_last):
        if dys is not None:
            dys = dys.contiguous()
        if dc_last is not None:
            dc_last = dc_last.contiguous()
        return _pad_grads(ctx, lstm_scan_bwd(*ctx.saved_tensors, dys, dc_last, ctx.precision))


def _side(n, rank, h):
    """Multiply-adds per row of one side's product into 4h gate columns, which
    are also its weights' floats: n*rank + rank*4h for two factors (rank
    > 0), n*4h for a dense matrix (rank 0)."""
    return n * rank + rank * 4 * h if rank else n * 4 * h


def scan_mm_ops(t, b, f, rx, h, r, *, gi=False):
    """Operations of the forward's matrix products (two per multiply-add of
    the x side, none in gi mode, and of the recurrent side over all T*B
    rows): the share of `scan_cost`'s operations that bf16 moves to the
    tensor-core rate. The BPTT's products are twice these, and the recompute
    pre-pass adds them once more."""
    return 2 * t * b * ((0 if gi else _side(f, rx, h)) + _side(h, r, h))


def scan_cost(t, b, f, rx, h, r, *, gi=False):
    """(operations, bytes) that the scan needs at least, for its roofline bound
    (rx = 0 and r = 0 mean a dense side; ``gi``: gi mode, whose input is gi
    [T,B,4h] and which has no x side).

    Operations: two per multiply-add of the x and the recurrent products, 6
    per gate element (the x term and bias, the h term and the sums; 3 in gi
    mode) and 9 per hidden unit (the nonlinearities and the state update),
    each step and row. Bytes: each input read once and each output written
    once, f32.
    """
    rm = _side(h, r, h)
    if gi:
        ops = scan_mm_ops(t, b, f, rx, h, r, gi=True) + t * b * (3 * 4 * h + 9 * h)
        floats = t * b * 4 * h + rm + 4 * h + 2 * b * h + t * b * h + b * h
        return ops, 4 * floats
    xm = _side(f, rx, h)
    ops = scan_mm_ops(t, b, f, rx, h, r) + t * b * (6 * 4 * h + 9 * h)
    floats = t * b * f + xm + 4 * h + 4 * h + rm + 4 * h + 2 * b * h + t * b * h + b * h
    return ops, 4 * floats


def scan_res_cost(t, b, f, rx, h, r, *, gi=False, residuals="f32", save_gates=True):
    """(operations, bytes) of the residual forward: `scan_cost` plus the
    residual outputs written once, less the c_last row that it does not
    write: cs [T,B,h]; with ``save_gates`` gates [T,B,4h] and hu [T,B,r]
    (2 bytes an element under bf16 ``residuals``) and, in x mode, xu
    [T,B,rx] (none for a dense side)."""
    ops, nbytes = scan_cost(t, b, f, rx, h, r, gi=gi)
    rb = 2 if residuals == "bf16" else 4
    saved = rb * t * b * (4 * h + r) + (0 if gi else 4 * t * b * rx) if save_gates else 0
    return ops, nbytes + 4 * (t * b * h - b * h) + saved


def scan_bwd_cost(t, b, f, rx, h, r, *, dys=True, dc_last=False, gi=False, residuals="f32",
                  save_gates=True):
    """(operations, bytes) that the BPTT needs at least, for its roofline bound.

    Operations: two per multiply-add of its products over all T*B rows. Each
    side's products are twice the forward's: on the recurrent side the data
    gradient along the chain (dhu = dpre V^T and dh += dhu U^T, or dh +=
    dpre U^T) and the weight gradients (dU, dV, or dU); on the x side dXU
    and dx, then dUx and dVx (or dx and dUx). Plus 30 per hidden unit for
    dpre, the carry and the column sums. Without ``save_gates`` (the
    recompute policy) the forward's products and gate arithmetic once more.
    Bytes: each residual and cotangent read once and each gradient written
    once, f32 (the gates and hu 2 bytes under bf16 ``residuals``);
    ``dys``/``dc_last`` say whether those cotangents are given; gi mode has
    no x side and returns dgi [T,B,4h].
    """
    mm = scan_mm_ops(t, b, f, rx, h, r, gi=gi)
    ops = 2 * mm + t * b * 30 * h
    if not save_gates:
        ops += mm + t * b * (6 * 4 * h)
    rb = 2 if residuals == "bf16" else 4
    xm, rm = (0 if gi else _side(f, rx, h)), _side(h, r, h)
    weights = xm + rm + 4 * h + (0 if gi else 4 * h)              # ux, vx, u, v, dvec, xdvec
    res = rb * t * b * (4 * h + r) + (0 if gi else 4 * t * b * rx) if save_gates else 4 * 4 * h
    inputs = (4 * ((0 if gi else t * b * f) + weights + 2 * b * h  # x, weights, h0, c0
                   + 2 * t * b * h                                  # ys, cs
                   + (t * b * h if dys else 0) + (b * h if dc_last else 0)) + res)
    outputs = 4 * ((t * b * 4 * h if gi else t * b * f + 4 * h) + weights + 2 * b * h)
    return ops, inputs + outputs
