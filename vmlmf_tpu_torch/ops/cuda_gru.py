"""Fused GRU scan with the input projection inside: the port's counterpart of
`vmlmf_tpu.ops.pallas_gru.gru_scan_fused_xin` and its VJP.

For each step, in gate order (r, z, n):

    gi      = (x @ Ux) @ Vx + bias   or   x @ Ux + bias (dense)   (time-parallel)
    r, z    = σ(gi_rz + (h @ Uf) @ Prz)    or  σ(gi_rz + h @ Prz)   (dense)
    mode "pre":  n = tanh(gi_n + ((r ⊙ h) @ Uf) @ Pn)  or  tanh(gi_n + (r ⊙ h) @ Pn)
    mode "post": n = tanh(gi_n + r ⊙ (h @ Pn))                      (dense only)
    h'      = z ⊙ h + (1 − z) ⊙ n

Three kernel entries, each with a plain version (the same arithmetic in torch
ops, step by step as the Pallas kernel computes it) and a launch count:

  * `gru_scan_fused_xin` — the no-grad forward, kernel
    ``csrc/gru_scan_xin_fwd.cu`` entry ``gru_scan_xin_fwd``;
  * `gru_scan_fused_xin_res` — the residual forward of training, entry
    ``gru_scan_xin_fwd_res`` of the same source;
  * `gru_scan_xin_bwd` — the BPTT, ``csrc/gru_scan_xin_bwd.cu``.

`GRUScanXin` is the `torch.autograd.Function` that pairs the last two. On CPU
tensors the wrappers run their plain versions; on CUDA tensors they launch
the kernel or raise. The kernels take x mode with a low-rank x side (vx
given) or a dense one (ux [F, 3h], vx None) and the saved-gates residual
policy, in the three recurrent forms. For CUDA tensors a wrapper raises on
what they do not take yet: the JAX package's gi mode (``VMLMF_PALLAS_XIN=0``)
and recompute policy (``VMLMF_PALLAS_SAVED_GATES=0``). On the CPU those two
switches change nothing: every policy computes the same function.
"""

from __future__ import annotations

import os

import torch

from vmlmf_tpu_torch.ops.cuda_scan import (
    _check_tensors,
    _empty,
    _launch,
    _on_cpu,
    _require_cuda,
)

KERNEL = "gru_scan_xin_fwd"
BWD_KERNEL = "gru_scan_xin_bwd"
REPLACES = "vmlmf_tpu/ops/pallas_gru.py:55"  # _fwd_kernel
BWD_REPLACES = "vmlmf_tpu/ops/pallas_gru.py:217"  # _bwd_kernel

# The recurrent forms, as the kernels' `form` argument numbers them.
LOWRANK_PRE, DENSE_PRE, DENSE_POST = 0, 1, 2

_ARG_NAMES = ("xs", "ux", "vx", "bias", "uf", "prz", "pn", "h0")
_RES_NAMES = ("xs", "ux", "vx", "uf", "prz", "pn", "h0", "ys", "gates", "hu", "rhu", "recn",
              "xu", "dys")


def form_of(uf, mode):
    """The recurrent form of a call: LOWRANK_PRE, DENSE_PRE or DENSE_POST."""
    if mode not in ("pre", "post"):
        raise ValueError(f"mode must be 'pre' or 'post', got {mode!r}")
    if mode == "post":
        if uf is not None:
            raise ValueError("mode='post' is dense-only (uf must be None)")
        return DENSE_POST
    return DENSE_PRE if uf is None else LOWRANK_PRE


def gru_scan_xin_fwd_res_plain(xs, ux, vx, bias, uf, prz, pn, h0, *, mode="pre"):
    """The kernel's function in torch ops: the batched input projection, then
    a Python loop over T. -> (ys [T,B,h], gates [T,B,3h] after the
    nonlinearities, hu = h_prev@Uf and rhu = (r⊙h_prev)@Uf [T,B,r] (low-rank,
    else None), recn = h_prev@Pn [T,B,h] (post, else None), xu = x@Ux
    [T,B,rx] (None for a dense x side))."""
    form = form_of(uf, mode)
    h = h0.shape[-1]
    xu = xs @ ux
    gi = xu + bias if vx is None else xu @ vx + bias
    h_t = h0
    ys, gates, hus, rhus, recns = [], [], [], [], []
    for gi_t in gi:
        if form == LOWRANK_PRE:
            hu = h_t @ uf
            hus.append(hu)
            rz = hu @ prz
        else:
            rz = h_t @ prz
        r = torch.sigmoid(gi_t[:, :h] + rz[:, :h])
        z = torch.sigmoid(gi_t[:, h:2 * h] + rz[:, h:])
        if form == DENSE_POST:
            recn = h_t @ pn
            recns.append(recn)
            n = torch.tanh(gi_t[:, 2 * h:] + r * recn)
        elif form == LOWRANK_PRE:
            rhu = (r * h_t) @ uf
            rhus.append(rhu)
            n = torch.tanh(gi_t[:, 2 * h:] + rhu @ pn)
        else:
            n = torch.tanh(gi_t[:, 2 * h:] + (r * h_t) @ pn)
        gates.append(torch.cat([r, z, n], dim=-1))
        h_t = z * h_t + (1.0 - z) * n
        ys.append(h_t)

    def stack(a):
        return torch.stack(a) if a else None

    return (torch.stack(ys), torch.stack(gates), stack(hus), stack(rhus), stack(recns),
            None if vx is None else xu)


def gru_scan_fused_xin_plain(xs, ux, vx, bias, uf, prz, pn, h0, *, mode="pre"):
    """`gru_scan_xin_fwd_res_plain`'s ys: the no-grad kernel's function."""
    return gru_scan_xin_fwd_res_plain(xs, ux, vx, bias, uf, prz, pn, h0, mode=mode)[0]


def gru_scan_xin_bwd_plain(xs, ux, vx, uf, prz, pn, h0, ys, gates, hu, rhu, recn, xu, dys, *,
                           mode="pre", dx=True):
    """The BPTT kernel's function in torch ops, step by step as
    `pallas_gru._bwd_kernel` computes it: a reverse loop over T for the gate
    pre-activation gradients dpre = (dr_pre, dz_pre, dn_pre), the dh carry
    and the recurrent weight gradients, then the x-side gradients batched
    over all T*B rows.

    -> (dxs, dux, dvx, dbias, duf, dprz, dpn, dh0), shaped as the forward's
    inputs; duf is None for a dense recurrent side, dvx for a dense x side,
    and dxs when ``dx`` is False.
    """
    form = form_of(uf, mode)
    t, b, f = xs.shape
    h = h0.shape[-1]
    hprev = torch.cat([h0[None], ys[:-1]])
    dh = torch.zeros_like(h0)
    duf = None if uf is None else torch.zeros_like(uf)
    dprz, dpn = torch.zeros_like(prz), torch.zeros_like(pn)
    dpres = [None] * t
    for s in range(t - 1, -1, -1):
        hp = hprev[s]
        r, z, n = gates[s].split(h, dim=-1)
        dh = dh + dys[s]
        dz = dh * (hp - n)
        dn_pre = dh * (1.0 - z) * (1.0 - n * n)
        dh_prev = dh * z
        if form == DENSE_POST:
            drecn = dn_pre * r
            dr = dn_pre * recn[s]
            dpn = dpn + hp.T @ drecn
            dh_prev = dh_prev + drecn @ pn.T
        else:
            if form == LOWRANK_PRE:
                drhu = dn_pre @ pn.T
                dpn = dpn + rhu[s].T @ dn_pre
                drh = drhu @ uf.T
                duf = duf + (r * hp).T @ drhu
            else:
                drh = dn_pre @ pn.T
                dpn = dpn + (r * hp).T @ dn_pre
            dr = drh * hp
            dh_prev = dh_prev + drh * r
        drz = torch.cat([dr * r * (1.0 - r), dz * z * (1.0 - z)], dim=-1)
        if form == LOWRANK_PRE:
            dhu = drz @ prz.T
            dprz = dprz + hu[s].T @ drz
            dh_prev = dh_prev + dhu @ uf.T
            duf = duf + hp.T @ dhu
        else:
            dprz = dprz + hp.T @ drz
            dh_prev = dh_prev + drz @ prz.T
        dpres[s] = torch.cat([drz, dn_pre], dim=-1)
        dh = dh_prev
    dpre2 = torch.stack(dpres).reshape(t * b, 3 * h)
    x2 = xs.reshape(t * b, f)
    if vx is None:
        dxu, dvx = dpre2, None
    else:
        dxu = dpre2 @ vx.T
        dvx = xu.reshape(t * b, -1).T @ dpre2
    dux = x2.T @ dxu
    dxs = (dxu @ ux.T).reshape(t, b, f) if dx else None
    return dxs, dux, dvx, dpre2.sum(0), duf, dprz, dpn, dh


def _unported():
    """Why the CUDA kernels do not take this call yet, or None."""
    if os.environ.get("VMLMF_PALLAS_XIN", "1") != "1":
        return "gi mode (VMLMF_PALLAS_XIN=0)"
    if os.environ.get("VMLMF_PALLAS_SAVED_GATES", "1") == "0":
        return "the recompute policy (VMLMF_PALLAS_SAVED_GATES=0)"
    return None


def _sizes(xs, ux, vx, uf, h0, mode):
    """(T, B, F, rx, h, r, form) of a scan call; rx is 0 for a dense x side
    and r 0 for a dense recurrent side."""
    form = form_of(uf, mode)
    if xs.dim() != 3 or h0.dim() != 2:
        raise ValueError(f"xs must be [T, B, F] and h0 [B, h], got {tuple(xs.shape)} and "
                         f"{tuple(h0.shape)}")
    t, b, f = xs.shape
    h = h0.shape[-1]
    rx = 0 if vx is None else ux.shape[-1]
    r = 0 if uf is None else uf.shape[-1]
    if min(t, b, f, h) < 1 or (vx is not None and rx < 1) or (uf is not None and r < 1):
        raise ValueError(f"empty scan: T={t}, B={b}, F={f}, rx={rx}, h={h}, r={r}")
    return t, b, f, rx, h, r, form


def _shapes(t, b, f, rx, h, r, form):
    k = h if r == 0 else r  # the depth of Prz and Pn
    return {"xs": (t, b, f), "ux": (f, rx or 3 * h), "vx": (rx, 3 * h), "bias": (3 * h,),
            "uf": (h, r), "prz": (k, 2 * h), "pn": (k, h), "h0": (b, h), "ys": (t, b, h),
            "gates": (t, b, 3 * h), "hu": (t, b, r), "rhu": (t, b, r), "recn": (t, b, h),
            "xu": (t, b, rx), "dys": (t, b, h)}


def _check(names, tensors, mode):
    """Validate a CUDA call: sizes, shapes, types, contiguity and a form the
    kernels take. -> (T, B, F, rx, h, r, form)."""
    named = dict(zip(names, tensors))
    sizes = _sizes(named["xs"], named["ux"], named["vx"], named["uf"], named["h0"], mode)
    why = _unported()
    if why is not None:
        raise NotImplementedError(f"the CUDA GRU scan does not take {why} yet")
    given = [(n, a) for n, a in named.items() if a is not None]
    _check_tensors(tuple(n for n, _ in given), [a for _, a in given], _shapes(*sizes))
    return sizes


def gru_scan_fused_xin(xs, ux, vx, bias, uf, prz, pn, h0, *, mode="pre"):
    """Fused GRU scan, x mode, no gradient.

    xs [T, B, F]; ux [F, rx], vx [rx, 3h], bias [3h]; low-rank: uf [h, r],
    prz [r, 2h], pn [r, h]; dense: uf None, prz [h, 2h], pn [h, h]; h0
    [B, h]; mode "pre" or "post" (dense only). Returns ys [T, B, h].

    CPU tensors run `gru_scan_fused_xin_plain`. CUDA tensors must be float32,
    contiguous and on one device; the kernel runs on the current stream and
    ``gru_scan_fused_xin.launches`` counts its calls. A CUDA input that
    requires a gradient, with grad mode on, raises: that call belongs to
    `GRUScanXin`.
    """
    args = (xs, ux, vx, bias, uf, prz, pn, h0)
    if _on_cpu(args):
        return gru_scan_fused_xin_plain(*args, mode=mode)
    sizes = _check(_ARG_NAMES, args, mode)
    _require_cuda("gru_scan_fused_xin", xs)
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args):
        raise RuntimeError("gru_scan_fused_xin computes no gradient; inputs that require "
                           "one go through GRUScanXin.apply")
    t, b, f, rx, h, r, form = sizes
    with torch.cuda.device(xs.device):
        new = _empty(xs)
        xu = new(t * b, rx) if rx else None
        gi, ys = new(t * b, 3 * h), new(t, b, h)
        _launch(KERNEL, "gru_scan_xin_fwd", (*args, xu, gi, ys), sizes, xs.device)
    gru_scan_fused_xin.launches += 1
    return ys


gru_scan_fused_xin.launches = 0


def gru_scan_fused_xin_res(xs, ux, vx, bias, uf, prz, pn, h0, *, mode="pre"):
    """The residual forward of training: `gru_scan_fused_xin` that also
    returns the backward's residuals -> (ys, gates, hu, rhu, recn, xu),
    shaped as `gru_scan_xin_fwd_res_plain`'s, which CPU tensors run.
    ``gru_scan_fused_xin_res.launches`` counts the kernel's calls."""
    args = (xs, ux, vx, bias, uf, prz, pn, h0)
    if _on_cpu(args):
        return gru_scan_xin_fwd_res_plain(*args, mode=mode)
    sizes = _check(_ARG_NAMES, args, mode)
    _require_cuda("gru_scan_fused_xin_res", xs)
    t, b, f, rx, h, r, form = sizes
    with torch.cuda.device(xs.device):
        new = _empty(xs)
        xu = new(t, b, rx) if rx else None
        gi, ys, gates = new(t * b, 3 * h), new(t, b, h), new(t, b, 3 * h)
        hu = rhu = recn = None
        if form == LOWRANK_PRE:
            hu, rhu = new(t, b, r), new(t, b, r)
        elif form == DENSE_POST:
            recn = new(t, b, h)
        _launch(KERNEL, "gru_scan_xin_fwd_res", (*args, xu, gi, ys, gates, hu, rhu, recn),
                sizes, xs.device)
    gru_scan_fused_xin_res.launches += 1
    return ys, gates, hu, rhu, recn, xu


gru_scan_fused_xin_res.launches = 0


def gru_scan_xin_bwd(xs, ux, vx, uf, prz, pn, h0, ys, gates, hu, rhu, recn, xu, dys, *,
                     mode="pre", dx=True):
    """Gradients of the fused GRU scan from the residual forward's outputs and
    the cotangent ``dys [T, B, h]`` -> (dxs, dux, dvx, dbias, duf, dprz, dpn,
    dh0); duf is None for a dense recurrent side, dxs when ``dx`` is False.

    CPU tensors run `gru_scan_xin_bwd_plain`; CUDA tensors launch the BPTT
    kernel, counted by ``gru_scan_xin_bwd.launches``.
    """
    if dys is None:
        raise ValueError("gru_scan_xin_bwd needs the cotangent dys")
    saved = (xs, ux, vx, uf, prz, pn, h0, ys, gates, hu, rhu, recn, xu, dys)
    if _on_cpu(saved):
        return gru_scan_xin_bwd_plain(*saved, mode=mode, dx=dx)
    sizes = _check(_RES_NAMES, saved, mode)
    _require_cuda("gru_scan_xin_bwd", xs)
    t, b, f, rx, h, r, form = sizes
    want = {LOWRANK_PRE: ("hu", "rhu"), DENSE_PRE: (), DENSE_POST: ("recn",)}[form]
    for name, a in zip(("hu", "rhu", "recn"), (hu, rhu, recn)):
        if (a is not None) != (name in want):
            raise ValueError(f"{name} must {'' if name in want else 'not '}be given for "
                             f"mode={mode!r} with uf {'given' if uf is not None else 'None'}")
    if (xu is None) != (vx is None):
        raise ValueError(f"xu must {'not ' if vx is None else ''}be given with vx "
                         f"{'None' if vx is None else 'given'}")
    with torch.cuda.device(xs.device):
        new = _empty(xs)
        lowrank = form == LOWRANK_PRE
        dpre = new(t * b, 3 * h)
        dxu = new(t * b, rx) if rx else None
        dhu, drhu = (new(t * b, r), new(t * b, r)) if lowrank else (None, None)
        grads = (new(t, b, f) if dx else None, torch.empty_like(ux),
                 new(rx, 3 * h) if rx else None, new(3 * h),
                 new(h, r) if lowrank else None, torch.empty_like(prz), torch.empty_like(pn),
                 new(b, h))
        _launch(BWD_KERNEL, "gru_scan_xin_bwd", (*saved, dpre, dhu, drhu, dxu, *grads), sizes,
                xs.device)
    gru_scan_xin_bwd.launches += 1
    return grads


gru_scan_xin_bwd.launches = 0


class GRUScanXin(torch.autograd.Function):
    """The differentiable fused GRU scan: the residual forward, then the BPTT.

    ``GRUScanXin.apply(xs, ux, vx, bias, uf, prz, pn, h0, mode)`` -> ys, with
    gradients for every tensor input (uf may be None). The final state is
    ``ys[-1]``, whose gradient reaches the backward through autograd's
    indexing. dx is computed only when xs needs a gradient (not for a first
    layer's raw input).
    """

    @staticmethod
    def forward(ctx, xs, ux, vx, bias, uf, prz, pn, h0, mode):
        ys, gates, hu, rhu, recn, xu = gru_scan_fused_xin_res(xs, ux, vx, bias, uf, prz, pn, h0,
                                                              mode=mode)
        ctx.save_for_backward(xs, ux, vx, uf, prz, pn, h0, ys, gates, hu, rhu, recn, xu)
        ctx.mode = mode
        ctx.set_materialize_grads(False)
        return ys

    @staticmethod
    def backward(ctx, dys):
        if dys is None:
            return (None,) * 9
        grads = gru_scan_xin_bwd(*ctx.saved_tensors, dys.contiguous(), mode=ctx.mode,
                                 dx=ctx.needs_input_grad[0])
        return (*grads, None)


def _macs(f, rx, h, r, form):
    """Multiply-adds per row and step of the forward: the x side (x@Ux@Vx, or
    x@Ux for a dense one, rx = 0), then the recurrent side (h@Uf, hu@Prz,
    (r⊙h)@Uf, rhu@Pn; or h@Prz and the [h, h] candidate product)."""
    rec = 5 * h * r if form == LOWRANK_PRE else 3 * h * h
    return (f * rx + rx * 3 * h if rx else f * 3 * h), rec


def _weights(f, rx, h, r, form):
    """Floats of ux, vx, bias, uf, prz and pn."""
    rec = h * r + 3 * h * r if form == LOWRANK_PRE else 3 * h * h
    return _macs(f, rx, h, r, form)[0] + 3 * h + rec


def gru_scan_cost(t, b, f, rx, h, r, form):
    """(operations, bytes) that the no-grad scan needs at least, for its
    roofline bound.

    Operations: two per multiply-add of the products, two per gate element
    (the bias and the recurrent term) and eight per hidden unit (three
    nonlinearities, the reset product and the four of z·h + (1−z)·n), each
    step and row. Bytes: x, the weights and h0 read once, ys written once,
    f32.
    """
    xm, rm = _macs(f, rx, h, r, form)
    ops = t * b * (2 * (xm + rm) + 2 * 3 * h + 8 * h)
    floats = t * b * f + _weights(f, rx, h, r, form) + b * h + t * b * h
    return ops, 4 * floats


def gru_scan_res_cost(t, b, f, rx, h, r, form):
    """(operations, bytes) of the residual forward: `gru_scan_cost` plus the
    residual outputs written once: gates [T,B,3h], xu [T,B,rx] (low-rank x
    side), and hu, rhu [T,B,r] (low-rank) or recn [T,B,h] (post)."""
    ops, nbytes = gru_scan_cost(t, b, f, rx, h, r, form)
    extra = {LOWRANK_PRE: 2 * r, DENSE_PRE: 0, DENSE_POST: h}[form]
    return ops, nbytes + 4 * t * b * (3 * h + rx + extra)


def gru_scan_bwd_cost(t, b, f, rx, h, r, form, *, dx=True):
    """(operations, bytes) that the BPTT needs at least, for its roofline bound.

    Operations: two per multiply-add, per row and step: the recurrent side
    twice the forward's (the data gradients along the serial chain and the
    weight gradients); the x side dXU = dPre Vxᵀ and dVx = XUᵀ dPre (rx·3h
    each, with xu a residual, not recomputed; none for a dense x side), dUx
    = Xᵀ dXU (F·kx, kx = rx, or 3h for a dense x side) and, when ``dx``, dx =
    dXU Uxᵀ (F·kx); plus 20 per hidden unit for dpre, the carry and the bias
    sums. Bytes: each residual, the weights (ux only when ``dx``), x and dys
    read once and each gradient written once, f32.
    """
    _, rm = _macs(f, rx, h, r, form)
    kx = rx or 3 * h
    macs = 2 * rm + 2 * rx * 3 * h + f * kx + (f * kx if dx else 0)
    ops = t * b * (2 * macs + 20 * h)
    extra = {LOWRANK_PRE: 2 * r, DENSE_PRE: 0, DENSE_POST: h}[form]
    weights = _weights(f, rx, h, r, form)
    read = weights - 3 * h - (0 if dx else f * kx)                 # less bias, and ux without dx
    inputs = (t * b * f + read + b * h                              # x, weights, h0
              + t * b * (h + 3 * h + extra + rx) + t * b * h)      # ys, gates, hu.., xu, dys
    outputs = (t * b * f if dx else 0) + weights + b * h          # dx, dweights, dh0
    return ops, 4 * (inputs + outputs)
