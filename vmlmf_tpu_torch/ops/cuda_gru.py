"""Fused GRU scan: the port's counterpart of `vmlmf_tpu.ops.pallas_gru`'s
`gru_scan_fused_xin` (x mode, the input projection inside) and
`gru_scan_fused` (gi mode, the input contribution given), and their VJPs.

For each step, in gate order (r, z, n):

    gi      = (x @ Ux) @ Vx + bias   or   x @ Ux + bias (dense)   (time-parallel)
    r, z    = σ(gi_rz + (h @ Uf) @ Prz)    or  σ(gi_rz + h @ Prz)   (dense)
    mode "pre":  n = tanh(gi_n + ((r ⊙ h) @ Uf) @ Pn)  or  tanh(gi_n + (r ⊙ h) @ Pn)
    mode "post": n = tanh(gi_n + r ⊙ (h @ Pn))                      (dense only)
    h'      = z ⊙ h + (1 − z) ⊙ n

Six kernel entries, each with a plain version (the same arithmetic in torch
ops, step by step as the Pallas kernel computes it) and a launch count:

  * `gru_scan_fused_xin` — the no-grad forward, kernel
    ``csrc/gru_scan_xin_fwd.cu`` entry ``gru_scan_xin_fwd``;
  * `gru_scan_fused_xin_res` — the residual forward of training, entry
    ``gru_scan_xin_fwd_res`` of the same source;
  * `gru_scan_xin_bwd` — the BPTT, ``csrc/gru_scan_xin_bwd.cu``;
  * `gru_scan_fused`, `gru_scan_fused_res`, `gru_scan_bwd` — the same in gi
    mode (entries ``gru_scan_fwd``, ``gru_scan_fwd_res`` and
    ``gru_scan_bwd`` of the same two sources): gi [T, B, 3h] comes in and
    the BPTT returns dgi = dpre, with no x side.

`GRUScanXin` and `GRUScan` are the `torch.autograd.Function`s that pair the
residual forwards with the BPTTs. The kernels take a low-rank x side (vx
given) or a dense one (ux [F, 3h], vx None), in the three recurrent forms.

The residual policy is the JAX package's: ``VMLMF_PALLAS_SAVED_GATES=0``
(`cuda_scan.env_saved_gates`, read when the residual forward is called)
selects the recompute policy in x mode, whose forward stores ys alone (the
no-grad kernel body, counted under the variant "recompute") and whose BPTT
rebuilds the gates, hu, rhu, recn and xu from x and the saved h_prev in a
batched pre-pass (`gru_recompute_plain`). gi mode always saves the gates,
as `pallas_gru._scan_core_fwd` does. On CPU tensors the wrappers run their
plain versions; on CUDA tensors they launch the kernel or raise.

`gru_plan` decides how the kernels lay a call out (batch rows per CTA,
threads, the forward's time block, where the weights are held, and, for a
width whose state does not fit in shared memory, which regions live in a
device-memory scratch: `state_floats`) and `gru_bwd_partial_floats` sizes
the BPTT's split-k scratch. Where `gru_plan` would read a kernel's
recurrent weights through L2, that kernel runs the grid layout instead
(`gru_layout`): `gru_grid_plan` spreads the units over the CTAs of a
cooperative launch, each holding its weight slices in shared memory
(csrc/gru_grid.cuh, entries ``gru_grid_fwd`` and ``gru_grid_bwd``), and
`gru_grid_chunks` cuts a batch that no grid plan takes into chunks of rows,
one launch each. All are plain Python, so the CPU tests reach them.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from vmlmf_tpu_torch.ops.cuda_scan import (
    GRID_THREADS,
    MIN_STEP_WORK,
    RING_STAGES,
    SMEM_LIMIT,
    SMS,
    SPLIT_TARGET,
    STAGE_COPIES,
    STAGE_FLOATS,
    _by_chunks,
    _cdiv,
    _check_tensors,
    _counted,
    _counter,
    _empty,
    _launch,
    _on_cpu,
    _refuse_grad,
    _require_cuda,
    _ring_fit,
    _slices,
    _sm_count,
    _split_at,
    _sync_words,
    env_saved_gates,
    ring_chunk,
    ring_piece,
    ring_pieces,
    staged_copies,
    tc_route,
    tc_splitk_floats,
    variant,
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
_GI_NAMES = ("gi", "uf", "prz", "pn", "h0")
_GI_BWD_NAMES = ("ys", "uf", "prz", "pn", "h0", "gates", "hu", "rhu", "recn", "dys")


def form_of(uf, mode):
    """The recurrent form of a call: LOWRANK_PRE, DENSE_PRE or DENSE_POST."""
    if mode not in ("pre", "post"):
        raise ValueError(f"mode must be 'pre' or 'post', got {mode!r}")
    if mode == "post":
        if uf is not None:
            raise ValueError("mode='post' is dense-only (uf must be None)")
        return DENSE_POST
    return DENSE_PRE if uf is None else LOWRANK_PRE


def _x_side(xs, ux, vx, bias):
    """(xu = x @ Ux, or None for a dense x side; gi = x @ Ux [@ Vx] + bias)."""
    xu = xs @ ux
    return (None, xu + bias) if vx is None else (xu, xu @ vx + bias)


def gru_recurrence_plain(gi, uf, prz, pn, h0, *, mode="pre"):
    """The serial part of the scan in torch ops, step by step, from the input
    contribution gi [T, B, 3h] -> (ys [T,B,h], gates [T,B,3h] after the
    nonlinearities, hu = h_prev@Uf and rhu = (r⊙h_prev)@Uf [T,B,r]
    (low-rank, else None), recn = h_prev@Pn [T,B,h] (post, else None))."""
    form = form_of(uf, mode)
    h = h0.shape[-1]
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

    return torch.stack(ys), torch.stack(gates), stack(hus), stack(rhus), stack(recns)


def gru_scan_xin_fwd_res_plain(xs, ux, vx, bias, uf, prz, pn, h0, *, mode="pre",
                               save_gates=True):
    """The kernel's function in torch ops: the batched input projection, then
    `gru_recurrence_plain` -> (ys, gates, hu, rhu, recn, xu = x@Ux [T,B,rx]
    (None for a dense x side)). Without ``save_gates`` (the recompute
    policy) every residual but ys is None."""
    xu, gi = _x_side(xs, ux, vx, bias)
    out = gru_recurrence_plain(gi, uf, prz, pn, h0, mode=mode)
    if not save_gates:
        return out[0], None, None, None, None, None
    return (*out, xu)


def gru_scan_fused_xin_plain(xs, ux, vx, bias, uf, prz, pn, h0, *, mode="pre"):
    """`gru_scan_xin_fwd_res_plain`'s ys: the no-grad kernel's function."""
    return gru_scan_xin_fwd_res_plain(xs, ux, vx, bias, uf, prz, pn, h0, mode=mode)[0]


def gru_scan_fused_plain(gi, uf, prz, pn, h0, *, mode="pre"):
    """`gru_scan_fused`'s function in torch ops -> ys [T, B, h]."""
    return gru_recurrence_plain(gi, uf, prz, pn, h0, mode=mode)[0]


def gru_recompute_plain(xs, ux, vx, bias, uf, prz, pn, h0, ys, *, mode="pre"):
    """The recompute policy's pre-pass in torch ops, batched over all T*B rows
    as `pallas_gru._bwd_kernel` rebuilds them (pallas_gru.py:278-300), from x
    and h_prev (h0, then ys[:-1]) -> (gates [T,B,3h], hu, rhu [T,B,r] or
    None, recn [T,B,h] or None, xu [T,B,rx] or None), as the saved-gates
    forward stores them."""
    form = form_of(uf, mode)
    t, b, h = ys.shape
    xu, gi = _x_side(xs, ux, vx, bias)
    gi = gi.reshape(t * b, 3 * h)
    hp = torch.cat([h0[None], ys[:-1]]).reshape(t * b, h)
    hu = rhu = recn = None
    if form == LOWRANK_PRE:
        hu = hp @ uf
        rz = hu @ prz
    else:
        rz = hp @ prz
    r = torch.sigmoid(gi[:, :h] + rz[:, :h])
    z = torch.sigmoid(gi[:, h:2 * h] + rz[:, h:])
    if form == DENSE_POST:
        recn = hp @ pn
        n = torch.tanh(gi[:, 2 * h:] + r * recn)
    elif form == LOWRANK_PRE:
        rhu = (r * hp) @ uf
        n = torch.tanh(gi[:, 2 * h:] + rhu @ pn)
    else:
        n = torch.tanh(gi[:, 2 * h:] + (r * hp) @ pn)

    def rows(a):
        return None if a is None else a.reshape(t, b, -1)

    return rows(torch.cat([r, z, n], dim=-1)), rows(hu), rows(rhu), rows(recn), xu


def gru_scan_bwd_plain(uf, prz, pn, h0, ys, gates, hu, rhu, recn, dys, *, mode="pre"):
    """The serial reverse walk of the BPTT in torch ops, step by step as
    `pallas_gru._bwd_kernel` computes it: the gate pre-activation gradients
    dpre = (dr_pre, dz_pre, dn_pre), the dh carry and the recurrent weight
    gradients. In gi mode dpre is dgi. -> (dpre [T,B,3h], duf (None for a
    dense recurrent side), dprz, dpn, dh0)."""
    form = form_of(uf, mode)
    t = ys.shape[0]
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
    return torch.stack(dpres), duf, dprz, dpn, dh


def gru_scan_xin_bwd_plain(xs, ux, vx, uf, prz, pn, h0, ys, gates, hu, rhu, recn, xu, dys, *,
                           mode="pre", dx=True, bias=None):
    """The BPTT kernel's function in torch ops: `gru_scan_bwd_plain`'s walk,
    then the x-side gradients batched over all T*B rows. Gates None is the
    recompute policy: `gru_recompute_plain` rebuilds the residuals from x,
    ``bias`` and h_prev first.

    -> (dxs, dux, dvx, dbias, duf, dprz, dpn, dh0), shaped as the forward's
    inputs; duf is None for a dense recurrent side, dvx for a dense x side,
    and dxs when ``dx`` is False.
    """
    t, b, f = xs.shape
    h = h0.shape[-1]
    if gates is None:
        gates, hu, rhu, recn, xu = gru_recompute_plain(xs, ux, vx, bias, uf, prz, pn, h0, ys,
                                                       mode=mode)
    dpre, duf, dprz, dpn, dh = gru_scan_bwd_plain(uf, prz, pn, h0, ys, gates, hu, rhu, recn, dys,
                                                  mode=mode)
    dpre2 = dpre.reshape(t * b, 3 * h)
    x2 = xs.reshape(t * b, f)
    if vx is None:
        dxu, dvx = dpre2, None
    else:
        dxu = dpre2 @ vx.T
        dvx = xu.reshape(t * b, -1).T @ dpre2
    dux = x2.T @ dxu
    dxs = (dxu @ ux.T).reshape(t, b, f) if dx else None
    return dxs, dux, dvx, dpre2.sum(0), duf, dprz, dpn, dh


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
    """Validate a CUDA call: sizes, shapes, types and contiguity. -> (T, B, F,
    rx, h, r, form)."""
    named = dict(zip(names, tensors))
    sizes = _sizes(named["xs"], named["ux"], named["vx"], named["uf"], named["h0"], mode)
    given = [(n, a) for n, a in named.items() if a is not None]
    _check_tensors(tuple(n for n, _ in given), [a for _, a in given], _shapes(*sizes))
    return sizes


def _check_gi(names, tensors, mode):
    """Validate a gi-mode CUDA call, whose first tensor is gi [T, B, 3h] or
    ys [T, B, h]. -> (T, B, h, r, form)."""
    named = dict(zip(names, tensors))
    lead, h0, uf = tensors[0], named["h0"], named["uf"]
    form = form_of(uf, mode)
    if lead.dim() != 3 or h0.dim() != 2:
        raise ValueError(f"{names[0]} must be [T, B, n] and h0 [B, h], got {tuple(lead.shape)} "
                         f"and {tuple(h0.shape)}")
    (t, b, _), h = lead.shape, h0.shape[-1]
    r = 0 if uf is None else uf.shape[-1]
    if min(t, b, h) < 1 or (uf is not None and r < 1):
        raise ValueError(f"empty scan: T={t}, B={b}, h={h}, r={r}")
    want = dict(_shapes(t, b, 1, 0, h, r, form), gi=(t, b, 3 * h))
    given = [(n, a) for n, a in named.items() if a is not None]
    _check_tensors(tuple(n for n, _ in given), [a for _, a in given], want)
    return t, b, h, r, form


def _check_residuals(form, hu, rhu, recn, mode, uf):
    """Raise unless exactly the residuals of the form are given."""
    want = {LOWRANK_PRE: ("hu", "rhu"), DENSE_PRE: (), DENSE_POST: ("recn",)}[form]
    for name, a in zip(("hu", "rhu", "recn"), (hu, rhu, recn)):
        if (a is not None) != (name in want):
            raise ValueError(f"{name} must {'' if name in want else 'not '}be given for "
                             f"mode={mode!r} with uf {'given' if uf is not None else 'None'}")


def _form_buffers(new, t, b, h, r, form):
    """(hu, rhu, recn) buffers of a form: [T,B,r] twice (low-rank), [T,B,h]
    ("post"), None otherwise."""
    if form == LOWRANK_PRE:
        return new(t, b, r), new(t, b, r), None
    return None, None, new(t, b, h) if form == DENSE_POST else None


# -- the kernels' layout (csrc/gru_tile.cuh, gru_scan_xin_fwd.cu, gru_scan_xin_bwd.cu)

GRU_SLICES = 4        # lanes of a unit group, each a quarter of the depth (kSlices)
GRU_MAX_ROWS = 4      # batch rows of a CTA (kMaxRows)
ROW_BOUNDS = (4, 2, 1)  # the row bounds the kernels are built for (gru_tile.cuh::row_bound)
GRU_MAX_THREADS = 512  # threads of a CTA (kMaxThreads)
GI_MODE, LOWRANK_X, DENSE_X = 0, 1, 2  # the forward's input side
# where a kernel keeps its recurrent weights, as the C entries number it
# (gru_tile.cuh kInL2, kInShared, kInRegisters)
WEIGHT_PLACES = ("L2", "shared", "registers")
REG_H, REG_R = 64, 16  # widest h and r whose lane shares fit in registers (kRegH, kRegR)


def _q4(n):
    return _cdiv(n, 4) * 4


def _ldt(n):
    """Row stride of a weight the BPTT holds for products along its rows:
    a multiple of 4 floats and an odd number of float4s (gru_tile.cuh)."""
    q = _cdiv(n, 4)
    return 4 * (q + 1 - q % 2)


def _regions(*sizes):
    """Floats of shared regions laid out one after another, each rounded up
    to a float4 (gru_tile.cuh::take)."""
    return sum(_q4(n) for n in sizes)


def _fwd_floats(t_block, rows, f, rx, h, r, form, xside, rec, x_res):
    """Floats of the forward's shared memory, region by region as
    gru_scan_xin_fwd.cu::fwd_layout lays them out; ``rec`` is where the
    recurrent weights are (a WEIGHT_PLACES name)."""
    return _regions(*_fwd_region_sizes(t_block, rows, f, rx, h, r, form, xside, rec, x_res))


def _fwd_region_sizes(t_block, rows, f, rx, h, r, form, xside, rec, x_res):
    """The floats of each region of `_fwd_floats`, in their order."""
    lowrank, pre = form == LOWRANK_PRE, form != DENSE_POST
    rec_res = rec == "shared"
    depth4 = _q4(r) if lowrank else _q4(h)
    mb, g3 = t_block * rows, 3 * h
    return (
        _q4(h) * r if rec_res and lowrank else 0,
        depth4 * 2 * h if rec_res else 0,
        depth4 * h if rec_res else 0,
        _q4(f) * (rx if xside == LOWRANK_X else g3) if x_res and xside != GI_MODE else 0,
        _q4(rx) * g3 if x_res and xside == LOWRANK_X else 0,
        mb * g3,
        mb * _q4(f) if xside != GI_MODE else 0,
        mb * _q4(rx) if xside == LOWRANK_X else 0,
        2 * rows * _q4(h),
        rows * _q4(h) if pre else 0,
        rows * _q4(r) if lowrank else 0,
        rows * _q4(r) if lowrank else 0,
        rows * h if pre else 0)


def _bwd_floats(rows, h, r, form, rec):
    """Floats of the BPTT walk's shared memory, region by region as
    gru_scan_xin_bwd.cu::walk_layout lays them out."""
    return _regions(*_bwd_region_sizes(rows, h, r, form, rec))


def _bwd_region_sizes(rows, h, r, form, rec):
    """The floats of each region of `_bwd_floats`, in their order."""
    lowrank, post = form == LOWRANK_PRE, form == DENSE_POST
    rec_res = rec == "shared"
    depth, nbuf = (r if lowrank else h), (2 if post else 1)
    return (
        h * _ldt(r) if rec_res and lowrank else 0,
        depth * _ldt(2 * h) if rec_res else 0,
        depth * _ldt(h) if rec_res else 0,
        2 * rows * (6 if post else 5) * h,
        rows * h,
        nbuf * rows * _q4(2 * h),
        nbuf * rows * _q4(h),
        0 if post else rows * h,
        rows * _q4(r) if lowrank else 0,
        rows * _q4(r) if lowrank else 0)


def _spill(sizes, regions=None):
    """(spill, shared floats) of a layout of regions ``sizes`` whose leading
    ones, ``spill`` floats in all, go to a device-memory scratch: the first
    ``regions`` non-empty ones, or where None the fewest that make the rest
    fit in shared memory."""
    padded = [_q4(n) for n in sizes if n]
    if regions is None:
        regions = next(k for k in range(len(padded) + 1)
                       if 4 * sum(padded[k:]) <= SMEM_LIMIT)
    return sum(padded[:regions]), sum(padded[regions:])


@dataclasses.dataclass(frozen=True)
class GRUPlan:
    """How the GRU kernels lay out one call: ``ctas`` CTAs of ``threads``
    threads, each owning ``rows`` consecutive batch rows for all T steps.
    The forward projects (x mode) or copies (gi mode) its input ``tblock``
    steps at a time into shared memory. ``rec_weights`` and
    ``bwd_rec_weights`` say where the forward and the walk keep the
    recurrent weights ("registers": each lane's share for the whole scan;
    "shared"; "L2": read through it every step); ``x_resident`` whether the
    x side's weights stay in shared memory. ``smem_fwd`` and ``smem_bwd``:
    bytes of shared memory per CTA of the forward and of the walk.
    ``spill_fwd`` and ``spill_bwd``: floats of each CTA's leading regions
    (the walk's staged inputs, the forward's gi block, ...) that a layout
    too wide for shared memory keeps in a device-memory scratch instead
    (`state_floats`); 0 where every region fits."""

    t: int
    b: int
    h: int
    r: int
    form: int
    rows: int
    threads: int
    tblock: int
    rec_weights: str
    x_resident: bool
    smem_fwd: int
    bwd_rec_weights: str
    smem_bwd: int
    spill_fwd: int = 0
    spill_bwd: int = 0

    @property
    def ctas(self):
        return _cdiv(self.b, self.rows)

    @property
    def blocks(self):
        """Time blocks of the forward."""
        return _cdiv(self.t, self.tblock)

    def ints(self, kernel):
        """The plan as the C entries of ``kernel`` ("fwd" or "bwd") take it:
        rows, threads, tblock, rec_res, x_res, smem, spill; or rows,
        threads, rec_res, smem, spill."""
        if kernel == "fwd":
            return (self.rows, self.threads, self.tblock, WEIGHT_PLACES.index(self.rec_weights),
                    int(self.x_resident), self.smem_fwd, self.spill_fwd)
        return (self.rows, self.threads, WEIGHT_PLACES.index(self.bwd_rec_weights),
                self.smem_bwd, self.spill_bwd)


def state_floats(plan, kernel):
    """Floats of the device-memory scratch that ``kernel`` ("fwd" or "bwd")
    keeps its spilled regions in: ``spill`` floats a CTA."""
    return plan.ctas * (plan.spill_fwd if kernel == "fwd" else plan.spill_bwd)


@functools.lru_cache(maxsize=256)
def gru_plan(t, b, f, rx, h, r, form, *, gi=False, sms=SMS):
    """The layout of the GRU kernels for a call of T steps, batch ``b``,
    input width ``f`` (x side rank ``rx``, 0 for a dense x side), hidden
    width ``h``, recurrent rank ``r`` (0 dense) and recurrent ``form``, in
    gi mode when ``gi``, on ``sms`` SMs -> GRUPlan.

    A step is a chain of dependent products whose latency, not the card's
    throughput, sets the time; so the batch is spread over the SMs, a CTA
    taking ``ceil(b / sms)`` rows (at most GRU_MAX_ROWS). Where that many
    rows do not fit, it takes each smaller row count the kernels are built
    for (ROW_BOUNDS), so more CTAs than SMs: the GRU kernels have no grid
    barrier. Each CTA has four lanes per unit of the widest product (max(h,
    r) units; GRU_MAX_THREADS at most, more passes past that). The
    recurrent weights are read every step: in registers, each lane holding
    its share, where h <= REG_H and r <= REG_R; else in shared memory where
    they fit, else through L2. The forward then keeps, in this order of
    preference, the x side's weights in shared memory (read once a time
    block) and as long a time block as fits, down to one step. Where not
    even one row for one step fits beside weights read through L2 (a dense
    "post" h past 3,058, whose walk holds 19 h floats a row), the plan
    takes one row a CTA and puts the leading regions that do not fit (the
    walk's staged inputs, the forward's gi block, then the carry) in a
    device-memory scratch (`GRUPlan.spill_fwd`, `state_floats`), of the
    forward or the walk alone where the other fits. Raises ValueError only
    on arguments the kernels do not take.
    """
    if form not in (LOWRANK_PRE, DENSE_PRE, DENSE_POST) or (form == LOWRANK_PRE) != (r > 0):
        raise ValueError(f"no GRU plan for form {form} with r={r}")
    if min(t, b, h, sms) < 1 or min(f, rx, r) < 0 or (not gi and f < 1):
        raise ValueError(f"no GRU plan for T={t}, B={b}, F={f}, rx={rx}, h={h}, r={r} on "
                         f"{sms} SMs")
    xside = GI_MODE if gi else (LOWRANK_X if rx else DENSE_X)
    want = min(GRU_MAX_ROWS, _cdiv(b, sms))
    threads = min(GRU_MAX_THREADS, GRU_SLICES * _cdiv(max(h, r), 8) * 8)
    for rows in (want, *(n for n in ROW_BOUNDS if n < want)):
        layout = _gru_layout(t, rows, f, rx, h, r, form, xside)
        if layout is not None:
            return GRUPlan(t, b, h, r, form, rows, threads, *layout)
    return GRUPlan(t, b, h, r, form, 1, threads, *_spilled_layout(t, f, rx, h, r, form, xside))


def spill_plan(t, b, f, rx, h, r, form, regions, *, gi=False, sms=SMS):
    """The layout `gru_plan` gives a kernel that does not fit in shared
    memory, for both kernels at any width: one row a CTA, every weight read
    through L2, one step a block, and the first ``regions`` = (forward,
    walk) non-empty regions of each kernel in the device-memory scratch (0:
    none) -> GRUPlan. The tests force it at small widths, where every spill
    must give the bits of the same layout with none."""
    threads = gru_plan(t, b, f, rx, h, r, form, gi=gi, sms=sms).threads
    xside = GI_MODE if gi else (LOWRANK_X if rx else DENSE_X)
    spill_f, floats_f = _spill(_fwd_region_sizes(1, 1, f, rx, h, r, form, xside, "L2", False),
                               regions[0])
    spill_b, floats_b = _spill(_bwd_region_sizes(1, h, r, form, "L2"), regions[1])
    return GRUPlan(t, b, h, r, form, 1, threads, 1, "L2", False, 4 * floats_f, "L2",
                   4 * floats_b, spill_f, spill_b)


def _spilled_layout(t, f, rx, h, r, form, xside):
    """`_gru_layout`'s tuple at one row a CTA and its spills, for a width
    whose forward or walk does not fit in shared memory: a kernel that fits
    keeps its layout; one that does not reads its recurrent weights
    through L2, its x side's too, takes one step a block, and spills."""
    places = ("shared", "L2")
    fwd = _fwd_layout(t, 1, f, rx, h, r, form, xside, places)
    if fwd is None:
        spill, floats = _spill(_fwd_region_sizes(1, 1, f, rx, h, r, form, xside, "L2", False))
        fwd = (1, "L2", False, 4 * floats, spill)
    else:
        fwd = (*fwd, 0)
    bwd = _bwd_layout(1, h, r, form, places)
    if bwd is None:
        spill, floats = _spill(_bwd_region_sizes(1, h, r, form, "L2"))
        bwd = ("L2", 4 * floats, spill)
    else:
        bwd = (*bwd, 0)
    (tblock, rec, x_res, smem_fwd, spill_fwd), (bwd_rec, smem_bwd, spill_bwd) = fwd, bwd
    return tblock, rec, x_res, smem_fwd, bwd_rec, smem_bwd, spill_fwd, spill_bwd


def _gru_layout(t, rows, f, rx, h, r, form, xside):
    """(tblock, rec_weights, x_resident, smem_fwd, bwd_rec_weights, smem_bwd)
    of ``rows`` rows a CTA, as `gru_plan` prefers them, or None where the
    forward or the walk does not fit."""
    places = ("registers",) if h <= REG_H and r <= REG_R else ("shared", "L2")
    fwd = _fwd_layout(t, rows, f, rx, h, r, form, xside, places)
    bwd = _bwd_layout(rows, h, r, form, places)
    return None if fwd is None or bwd is None else (*fwd, *bwd)


def _bwd_layout(rows, h, r, form, places):
    """(bwd_rec_weights, smem_bwd) of the walk, the first place that fits,
    or None."""
    return next(((rec, 4 * _bwd_floats(rows, h, r, form, rec)) for rec in places
                 if 4 * _bwd_floats(rows, h, r, form, rec) <= SMEM_LIMIT), None)


def _fwd_layout(t, rows, f, rx, h, r, form, xside, places):
    """(tblock, rec_weights, x_resident, smem_fwd) of the forward, the first
    that fits in `gru_plan`'s order of preference, or None."""
    for rec in places:
        for x_res in ((True, False) if xside != GI_MODE else (False,)):
            tblock = t
            while tblock >= 1:
                floats = _fwd_floats(tblock, rows, f, rx, h, r, form, xside, rec, x_res)
                if 4 * floats <= SMEM_LIMIT:
                    return tblock, rec, x_res, 4 * floats
                tblock = tblock // 2 if tblock > 1 else 0
    return None


# -- the grid layout (csrc/gru_grid.cuh: grid_fwd_kernel, grid_walk_kernel)

@dataclasses.dataclass(frozen=True)
class GRUGridPlan:
    """How the grid layout of the GRU kernels spreads one call of batch
    ``b``, width ``h``, rank ``r`` (0 dense) and ``form`` over the card:
    ``groups`` batch groups of consecutive rows, each on ``ctas``
    co-resident CTAs of one cooperative launch. CTA q of a group owns the
    hidden units `j_range(q)` and the rank columns `k_range(q)`, and holds
    its two weight slices (`slices`) in shared memory for the whole scan;
    ``rpad``: a group's rows padded to a multiple of 4. Per kernel ("fwd",
    the forward; "bwd", the walk): ``stage`` and ``red``, floats of the
    staging buffer and of the slice partials; ``smem``, bytes of shared
    memory a CTA; ``xchg``, floats of the exchange buffers; ``resident``,
    the depth rows of each slice held in shared memory. A slice's rows past
    its resident depth are streamed: the CTA copies them once into its own
    region of a device-memory scratch (`grid_stream_floats`) and reads them
    every step, in the same order of sums. ``piece``: the floats of each of
    the RING_STAGES stages of the kernel's ring (scan_grid.cuh::Ring; 0:
    none), which takes the staging buffer's place where the kernel streams
    rows (`walk`). ``tile``: the batch rows R of a product item of each
    kernel, the sums a consumer thread keeps (4 columns by R rows;
    `grid_tiles`); ``rpad`` is a multiple of both, and each kernel's items,
    slices and ``red`` are cut by its own."""

    b: int
    h: int
    r: int
    form: int
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
    resident_fwd: tuple = (0, 0)
    resident_bwd: tuple = (0, 0)
    piece_fwd: int = 0
    piece_bwd: int = 0
    tile_fwd: int = 4
    tile_bwd: int = 4

    @property
    def n_ctas(self):
        return self.groups * self.ctas

    def slices(self, kernel):
        """`_grid_slices` of ``kernel`` ("fwd" or "bwd") on this plan's CTAs."""
        return _grid_slices(self.h, self.r, self.form, self.ctas)[kernel]

    def resident(self, kernel):
        return self.resident_fwd if kernel == "fwd" else self.resident_bwd

    def piece(self, kernel):
        """Floats of a stage of ``kernel``'s ring (0: no ring)."""
        return self.piece_fwd if kernel == "fwd" else self.piece_bwd

    def walk(self, kernel):
        """Each product of ``kernel``'s step as its ring walks it ->
        ((depth, its chunk, rows of a piece, `ring_pieces`), ...), in step
        order; () without a ring. A product over rows d0 .. d0 + depth of a
        slice has the slice's resident rows among them resident."""
        piece = self.piece(kernel)
        if not piece:
            return ()
        stage = self.stage_fwd if kernel == "fwd" else self.stage_bwd
        res = dict(zip("ab", self.resident(kernel)))
        out = []
        for sl, d0, depth, _, ncols in _grid_operands(self.h, self.r, self.form,
                                                      self.ctas)[kernel]:
            held = min(depth, max(0, res[sl] - d0))
            if held == depth:  # the exchange alone: pieces of piece // rpad rows
                n = piece // self.rpad
                walk = (0, tuple((e0, min(depth, e0 + n)) for e0 in range(0, depth, n)))
            else:
                walk = ring_pieces(depth, ncols, self.rpad, piece, 4, held)
            out.append((depth, ring_chunk(depth, self.rpad, stage), *walk))
        return tuple(out)

    def streamed_elems(self, kernel):
        """Weight elements a CTA of ``kernel`` streams a step."""
        return sum((d - res) * c for (d, c), res in zip(self.slices(kernel),
                                                        self.resident(kernel)))

    @property
    def streamed(self):
        return any(self.streamed_elems(k) for k in ("fwd", "bwd"))

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

    def tile(self, kernel):
        """The batch rows of a product item of ``kernel`` (4, 8 or 12)."""
        return self.tile_fwd if kernel == "fwd" else self.tile_bwd

    def ints(self, kernel):
        """The plan as entry gru_grid_fwd or gru_grid_bwd takes it: groups,
        ctas, rpad, stage, red, smem, the resident depths of slices A and B,
        the ring's floats a stage and the item's rows."""
        fwd = kernel == "fwd"
        return (self.groups, self.ctas, self.rpad,
                *((self.stage_fwd, self.red_fwd, self.smem_fwd) if fwd
                  else (self.stage_bwd, self.red_bwd, self.smem_bwd)), *self.resident(kernel),
                self.piece(kernel), self.tile(kernel))


def grid_stream_floats(plan, kernel):
    """Floats of the device-memory scratch that ``kernel`` streams its weight
    rows from: each CTA's streamed elements, rounded up to a float4
    (gru_grid.cuh::grid_stream_floats), times the CTAs; 0 where none."""
    return plan.n_ctas * _q4(plan.streamed_elems(kernel))


@functools.lru_cache(maxsize=4096)
def _grid_slices(h, r, form, ctas):
    """{kernel: ((depth, columns) of slice A, of slice B)} of a CTA, as
    gru_grid.cuh::SliceShapes lays them out: the forward's Uf[:, k-slice]
    [h][kwp] (depth 0 when dense) and [Prz_r | Prz_z | Pn][:, j-slice]
    [r or h][3 jwp]; the walk's [Prz; Pn]^T rows of the k-slice [3h][kwp]
    (0 when dense) and, of the j-slice, [Prz; Pn]^T [3h][jwp] (dense) or
    Uf^T [r][jwp] (low-rank)."""
    lowrank = form == LOWRANK_PRE
    jwp, kwp = _q4(_cdiv(h, ctas)), (_q4(_cdiv(r, ctas)) if lowrank else 0)
    return {"fwd": ((h if lowrank else 0, kwp), (r if lowrank else h, 3 * jwp)),
            "bwd": ((3 * h if lowrank else 0, kwp), (r if lowrank else 3 * h, jwp))}


@functools.lru_cache(maxsize=4096)
def _grid_operands(h, r, form, ctas):
    """{kernel: its products in a step's order, as (slice "a" or "b", first
    row d0, depth, first column, columns)}: each reads rows d0 .. d0 + depth
    and its columns of one slice (gru_grid.cuh::GridSlice::rows), and
    streams rows of its own columns alone."""
    jwp = _q4(_cdiv(h, ctas))
    kwp = _q4(_cdiv(r, ctas)) if form == LOWRANK_PRE else 0
    if form == LOWRANK_PRE:
        return {"fwd": [("a", 0, h, 0, kwp), ("b", 0, r, 0, 2 * jwp), ("a", 0, h, 0, kwp),
                        ("b", 0, r, 2 * jwp, jwp)],
                "bwd": [("a", 2 * h, h, 0, kwp), ("b", 0, r, 0, jwp), ("a", 0, 2 * h, 0, kwp),
                        ("b", 0, r, 0, jwp)]}
    if form == DENSE_PRE:
        return {"fwd": [("b", 0, h, 0, 2 * jwp), ("b", 0, h, 2 * jwp, jwp)],
                "bwd": [("b", 2 * h, h, 0, jwp), ("b", 0, 2 * h, 0, jwp)]}
    return {"fwd": [("b", 0, h, 0, 3 * jwp)], "bwd": [("b", 0, 3 * h, 0, jwp)]}


def _grid_phases(h, r, form, ctas):
    """{kernel: its products as (depth, columns)}, in a step's order."""
    return {k: [(depth, cols) for _, _, depth, _, cols in ops]
            for k, ops in _grid_operands(h, r, form, ctas).items()}


# The rows R of a product item of the grid kernels (gru_grid.cuh, `grid_tiles`):
# (on the ring, kernel, form) -> the taller items that kernel may take, as
# (R, the least and the most rows of a group, padded to 4; None: any), the
# first that fits winning. From `tools/gru_phases.py --grid`'s ``tiles`` and
# ptxas on the H100 (PERF.md, Findings):
# * On the ring (544 threads, 96 registers) only the "post" forward builds
#   at 8 and 12 without spilling more than at 4. Its step ran 21% faster at
#   12 with groups of 84 rows (h=3200, 8: 17%) and 13% faster at 8 with 132
#   rows (h=2000; 12 ran 3% slower than 4 there).
# * With every row resident (512 threads, 128 registers: no R spills) the
#   dense "pre" kernels ran 3% faster at 8 in groups of 256 rows (h=1000)
#   and 10-15% slower in groups of 24 to 64 rows; 12 ran no faster.
# HAR-width groups (4 and 8 rows, h=180) ran slower at 8 and keep 4.
GRID_TILES = {(True, "fwd", DENSE_POST): ((12, 16, 96), (8, 16, None)),
              (False, "fwd", DENSE_PRE): ((8, 256, None),),
              (False, "bwd", DENSE_PRE): ((8, 256, None),)}
TILE_PAD = 1 / 16     # the share of a group's padded rows that a taller item may add
TILE_MIN_UNITS = 384  # threads each product keeps busy at least (items x slices): 12 warps


def _fill(phases, rpad, tile):
    """The fewest consumer threads that one of ``phases``' products keeps
    busy with items of ``tile`` rows."""
    return min(min(GRID_THREADS, items * _slices(items, depth)) for depth, cols in phases
               for items in (_cdiv(cols, 4) * (rpad // tile),))


def grid_tiles(b, h, r, form, groups, ctas, streams):
    """The rows R of a product item (`GRUGridPlan.tile`) of the forward and
    of the walk, in a grid plan of ``b`` rows in ``groups`` groups of
    ``ctas`` CTAs; ``streams``: whether its kernels run on the ring. A
    consumer thread loads one float4 of W and R/4 of the exchange a depth
    row for 4R FMAs, so a taller item feeds more FMAs from each
    shared-memory load. It costs padding (rows to a multiple of R), fewer
    items (fewer busy threads where the depth cannot be sliced further)
    and registers (4R sums). Each kernel takes the first of its GRID_TILES
    whose bounds hold the group's rows, whose padding adds at most
    TILE_PAD of the rows padded to 4, and whose products each keep
    TILE_MIN_UNITS threads busy (or as many as items of 4 rows do); else
    4, the parent's item, as every kernel without an entry does."""
    rows = _cdiv(b, groups)
    base = _q4(rows)
    out = []
    for kernel, phases in _grid_phases(h, r, form, ctas).items():
        least = min(TILE_MIN_UNITS, _fill(phases, base, 4))
        out.append(next((tile for tile, lo, hi in GRID_TILES.get((streams, kernel, form), ())
                         if lo <= base <= (hi or base)
                         and _cdiv(rows, tile) * tile - base <= base * TILE_PAD
                         and _fill(phases, _cdiv(rows, tile) * tile, tile) >= least), 4))
    return tuple(out)


# [units][rpad] buffers of each kernel (gru_grid.cuh::grid_slabs)
GRID_SLABS = {"fwd": {LOWRANK_PRE: 5, DENSE_PRE: 5, DENSE_POST: 7},
              "bwd": {LOWRANK_PRE: 6, DENSE_PRE: 6, DENSE_POST: 7}}


def grid_plan_layout(b, h, r, form, groups, ctas, resident=None, piece=None, tile=None):
    """The GRUGridPlan of ``groups`` batch groups of ``ctas`` CTAs each;
    `gru_grid_plan` picks the grouping. ``resident``: the (forward, walk)
    pairs of resident depths; None holds every row in shared memory.
    ``tile``: the batch rows of a product item, one for both kernels or a
    (forward, walk) pair (None: `grid_tiles`' rule); a group's rows pad to a
    multiple of each.

    A product stages its exchange rows in halves of ``stage`` (each an L2
    round trip), so where every weight row fits with room to spare, the
    stage takes that room, in whole pairs of rows, up to the deepest
    product. The room is that of the all-resident layout of this grouping,
    so a plan that streams some rows stages, and sums, as it does.

    A kernel runs its products on a ring (`GRUGridPlan.walk`) where it
    streams some row, its stages ``piece`` floats: a (forward, walk) pair
    as given; or a size (None: `cuda_scan.ring_piece`), taken where it fits
    beside the rest, else as large a stage as fits (`cuda_scan._ring_fit`;
    the smallest where the shared memory then exceeds SMEM_LIMIT). Its
    order of sums stays the staging buffer's. A plan whose rows are all resident keeps
    the staging buffer, also where an exchange does not fit in it whole:
    there a ring in its room ran slower on the H100 (h=1000, B=512;
    `tools/gru_phases.py --grid`'s ``other_ring``, PERF.md)."""
    slices = _grid_slices(h, r, form, ctas)
    if resident is None:
        resident = tuple(tuple(d for d, _ in slices[k]) for k in ("fwd", "bwd"))
    if tile is None:
        streams = any(res < d for k, held in zip(("fwd", "bwd"), resident)
                      for res, (d, _) in zip(held, slices[k]))
        tile = grid_tiles(b, h, r, form, groups, ctas, streams)
    tiles = (tile, tile) if isinstance(tile, int) else tuple(tile)
    rpad = _cdiv(_cdiv(b, groups), math.lcm(*tiles)) * math.lcm(*tiles)
    phases = _grid_phases(h, r, form, ctas)
    jwp = _q4(_cdiv(h, ctas))
    layout = []
    for i, kernel in enumerate(("fwd", "bwd")):
        weights = sum(res * c for res, (_, c) in zip(resident[i], slices[kernel]))
        deepest = max(d for d, _ in phases[kernel])
        stage = min(deepest, max(2, STAGE_FLOATS // rpad)) * rpad
        red = 0
        for depth, cols in phases[kernel]:
            items = _cdiv(cols, 4) * (rpad // tiles[i])
            n = _slices(items, depth)
            red = max(red, n * items * 16 if n > 1 else 0)
        slabs = GRID_SLABS[kernel][form] * jwp * rpad
        room = SMEM_LIMIT // 4 - (_q4(sum(d * c for d, c in slices[kernel])) + slabs + stage + red)
        if room >= 2 * rpad:
            stage = min(deepest * rpad, stage + room // (2 * rpad) * 2 * rpad)
        rpiece = 0
        if any(res < d for res, (d, _) in zip(resident[i], slices[kernel])):
            if isinstance(piece, tuple):
                rpiece = piece[i]
            else:
                need = _q4(max(rpad + c for _, c in phases[kernel]))
                free = SMEM_LIMIT // 4 - (_q4(weights) + slabs + red)
                rpiece = _ring_fit(free, need, piece or ring_piece(rpad)) or need
        staged = RING_STAGES * (rpiece + 4) if rpiece else stage
        layout += [stage, red, 4 * (_q4(weights) + slabs + staged + red), rpiece]
    pre, lowrank = form != DENSE_POST, form == LOWRANK_PRE
    xchg_fwd = groups * rpad * (2 * h + (h if pre else 0) + (r if lowrank else 0))
    xchg_bwd = groups * rpad * (6 * h + (r if lowrank else 0))
    return GRUGridPlan(b, h, r, form, groups, ctas, rpad, *layout[:3], xchg_fwd, *layout[4:7],
                       xchg_bwd, *map(tuple, resident), layout[3], layout[7], *tiles)


def _grid_rec_macs(h, r, form):
    """Multiply-adds of one row's step of the recurrence."""
    return 5 * h * r if form == LOWRANK_PRE else 3 * h * h


@functools.lru_cache(maxsize=1024)
def _grid_fits_resident(b, h, r, form, sms):
    """The first grouping of `gru_grid_plan`'s search whose weights are all
    resident and fit, or None."""
    for groups in range(min(b, sms), 0, -1):
        most = max(1, min(sms // groups, h))
        work = _q4(_cdiv(b, groups)) * _grid_rec_macs(h, r, form)
        for ctas in sorted({min(most, _cdiv(work, MIN_STEP_WORK)), most}):
            plan = grid_plan_layout(b, h, r, form, groups, ctas)
            if plan.smem_bytes <= SMEM_LIMIT:
                return plan
    return None


def _grid_streamed(b, h, r, form, sms, piece=None, tile=None):
    """The plan where not even one row's weights fit in the shared memory of
    all SMs: one group over min(sms, h) CTAs, each kernel with a ring of
    stages of ``piece`` floats (None: `cuda_scan.ring_piece`, or as large
    as fit) and holding as much depth of each slice as fits beside its
    slabs, ring and red (the same share of each slice's depth), the rest
    streamed through the ring; items of ``tile`` rows (None: `grid_tiles`).
    Raises ValueError where the slabs and the smallest ring do not fit."""
    ctas = min(sms, h)
    empty = grid_plan_layout(b, h, r, form, 1, ctas, resident=((0, 0), (0, 0)), piece=piece,
                             tile=tile)
    resident = []
    for kernel, smem in (("fwd", empty.smem_fwd), ("bwd", empty.smem_bwd)):
        room = (SMEM_LIMIT - smem) // 16 * 4  # weight floats that fit
        if room < 0:
            raise ValueError(f"no GRU grid plan for B={b}, h={h}, r={r}: the slabs do not fit "
                             f"beside a streamed slice")
        total = sum(d * c for d, c in empty.slices(kernel))
        resident.append(tuple(min(d, d * room // total) for d, _ in empty.slices(kernel)))
    return grid_plan_layout(b, h, r, form, 1, ctas, resident=tuple(resident),
                            piece=(empty.piece_fwd, empty.piece_bwd),
                            tile=(empty.tile_fwd, empty.tile_bwd))


def grid_streamed_plan(b, h, r, form, sms=SMS, piece=None, tile=None):
    """`gru_grid_plan`'s streamed plan of a width whose weights do not fit,
    with ring stages of another size (the checks that hold one ring to
    another: the same groups, CTAs, stage and red, so the same sums), or
    with items of another ``tile`` of rows (other sums)."""
    return _grid_streamed(b, h, r, form, sms, piece, tile)


@functools.lru_cache(maxsize=1024)
def gru_grid_plan(t, b, f, rx, h, r, form, *, gi=False, sms=SMS):
    """The grid layout of the GRU kernels for a call of T steps, batch
    ``b``, input width ``f`` (x side rank ``rx``), width ``h``, recurrent
    rank ``r`` (0 dense) and ``form`` on ``sms`` SMs -> GRUGridPlan. The x
    side (``f``, ``rx``, ``gi``) runs before the scan as a time-parallel
    projection, and T steps run one after another: neither changes the
    layout.

    As `cuda_scan.scan_plan` does for the LSTM: for each group count from
    min(b, sms) down, ``ctas`` = just enough CTAs for MIN_STEP_WORK each,
    then sms // groups, both at most h; the first whose shared memory fits,
    every weight row resident, wins. Where the weights do not fit in the
    shared memory of all SMs even for one row, the plan streams the rows
    that do not fit (`_grid_streamed`). Raises ValueError where the batch
    has no plan (`gru_grid_chunks` then cuts it)."""
    if form not in (LOWRANK_PRE, DENSE_PRE, DENSE_POST) or (form == LOWRANK_PRE) != (r > 0):
        raise ValueError(f"no GRU grid plan for form {form} with r={r}")
    if min(t, b, h, sms) < 1 or min(f, rx, r) < 0 or (not gi and f < 1):
        raise ValueError(f"no GRU grid plan for T={t}, B={b}, F={f}, rx={rx}, h={h}, r={r} on "
                         f"{sms} SMs")
    if _grid_fits_resident(1, h, r, form, sms) is None:
        return _grid_streamed(b, h, r, form, sms)
    plan = _grid_fits_resident(b, h, r, form, sms)
    if plan is None:
        raise ValueError(f"the GRU weights of h={h}, r={r or 'dense'} do not fit in the shared "
                         f"memory of {sms} SMs at B={b}")
    return plan


@functools.lru_cache(maxsize=1024)
def gru_grid_chunks(t, b, f, rx, h, r, form, *, gi=False, sms=SMS):
    """The batch cut into as few chunks of consecutive rows as each have a
    `gru_grid_plan`, their sizes at most one apart -> ((b_begin, b_count,
    plan), ...): one cooperative launch a chunk. Raises ValueError where not
    even one row has a plan."""
    gru_grid_plan(t, 1, f, rx, h, r, form, gi=gi, sms=sms)
    for n in range(1, b + 1):
        bounds = [_split_at(i, b, n) for i in range(n + 1)]
        try:
            return tuple((b0, b1 - b0, gru_grid_plan(t, b1 - b0, f, rx, h, r, form, gi=gi,
                                                      sms=sms))
                         for b0, b1 in zip(bounds, bounds[1:]))
        except ValueError:
            continue
    raise AssertionError("one row has a plan, so b chunks of one row have")


def gru_layout(t, b, f, rx, h, r, form, *, kernel="fwd", gi=False, sms=SMS):
    """The layout the wrappers run ``kernel`` of a call in ("fwd": the two
    forward entries; "bwd": the BPTT): `gru_plan`'s GRUPlan where that
    kernel holds its recurrent weights in registers or shared memory (every
    HAR-width shape keeps its plan and its bits); where it would read them
    through L2, the grid layout, `gru_grid_chunks`. The residuals do not
    depend on the layout, so a forward on rows and a walk on the grid
    compose (a dense h of 135–136, whose walk alone reads through L2). On
    an H100 the grid ran faster than the row layout at every such shape
    measured (PERF.md, PR 17)."""
    plan = gru_plan(t, b, f, rx, h, r, form, gi=gi, sms=sms)
    if (plan.rec_weights if kernel == "fwd" else plan.bwd_rec_weights) != "L2":
        return plan
    return gru_grid_chunks(t, b, f, rx, h, r, form, gi=gi, sms=sms)


def _plan_for(t, b, f, rx, h, r, form, device, kernel="fwd", gi=False):
    return gru_layout(t, b, f, rx, h, r, form, kernel=kernel, gi=gi,
                      sms=_sm_count(device.index))


def _grid_scratch(plan, kernel, like):
    """(exchange buffers, barrier words, streamed scratch or None, its
    floats) of one grid launch."""
    new = _empty(like)
    n = grid_stream_floats(plan, kernel)
    return (new(plan.xchg_fwd if kernel == "fwd" else plan.xchg_bwd), _sync_words(plan, like),
            new(n) if n else None, n)


def _chunks(layout, b):
    """A layout as `_by_chunks` takes it: a row plan is one chunk."""
    return ((0, b, layout),) if isinstance(layout, GRUPlan) else layout


def _fwd_launch(residuals, form, plan, *tensors):
    """One launch of the forward on a chunk of rows, from x mode's (xs, ux,
    vx, bias, uf, prz, pn, h0) or gi mode's (gi, uf, prz, pn, h0) -> (ys,)
    or, with ``residuals``, (ys, gates, hu, rhu, recn[, xu in x mode]). A
    GRUPlan runs the row entries (gru_scan_xin_fwd[_res], gru_scan_fwd[_res]),
    a GRUGridPlan entry gru_grid_fwd, which in x mode first projects into a
    gi scratch."""
    gi_mode = len(tensors) == 5
    lead, h0, uf = tensors[0], tensors[-1], tensors[-4]
    t, b = lead.shape[:2]
    h, r = h0.shape[-1], 0 if uf is None else uf.shape[-1]
    f, rx = (0, 0) if gi_mode else (lead.shape[-1], 0 if tensors[2] is None
                                    else tensors[1].shape[-1])
    new = _empty(lead)
    ys = new(t, b, h)
    gates = new(t, b, 3 * h) if residuals else None
    hu, rhu, recn = _form_buffers(new, t, b, h, r, form) if residuals else (None,) * 3
    xu = new(t, b, rx) if rx and (residuals or not isinstance(plan, GRUPlan)) else None
    outs = (ys, gates, hu, rhu, recn) if residuals else (ys,)
    sizes = (t, b, h, r, form) if gi_mode else (t, b, f, rx, h, r, form)
    if isinstance(plan, GRUPlan):
        entry = ("gru_scan_fwd" if gi_mode else "gru_scan_xin_fwd") + ("_res" if residuals
                                                                        else "")
        kept = outs if gi_mode or not residuals else (xu, *outs)
        _launch(KERNEL, entry, (*tensors, *kept, _state(plan, "fwd", lead)),
                (*sizes, *plan.ints("fwd")), lead.device)
    else:
        xin = (None,) * 4 + tensors[:1] if gi_mode else (*tensors[:4], new(t, b, 3 * h))
        xchg, sync, wstream, nstream = _grid_scratch(plan, "fwd", lead)
        _launch(KERNEL, "gru_grid_fwd",
                (*xin, *tensors[-4:], xu, ys, gates, hu, rhu, recn, xchg, sync, wstream),
                (nstream, t, b, f, rx, h, r, form, *plan.ints("fwd"), int(residuals)),
                lead.device)
    return outs if gi_mode or not residuals else (*outs, xu)


def _bwd_launch(form, dx, plan, *tensors):
    """One launch of the BPTT on a chunk of rows, from x mode's (xs, ux, vx,
    uf, prz, pn, h0, ys, gates, hu, rhu, recn, xu, dys, bias) or gi mode's
    (uf, prz, pn, h0, ys, gates, hu, rhu, recn, dys) -> the gradients, as
    `gru_scan_xin_bwd` or `gru_scan_bwd` returns them. A GRUPlan runs the
    row entries (gru_scan_xin_bwd, gru_scan_bwd), a GRUGridPlan entry
    gru_grid_bwd; gates None is the recompute policy (x mode)."""
    gi_mode = len(tensors) == 10
    if gi_mode:
        uf, prz, pn, h0, ys, gates, hu, rhu, recn, dys = tensors
        xs = ux = vx = xu = bias = None
        f = rx = 0
    else:
        xs, ux, vx, uf, prz, pn, h0, ys, gates, hu, rhu, recn, xu, dys, bias = tensors
        f, rx = xs.shape[-1], 0 if vx is None else ux.shape[-1]
    t, b, h = ys.shape
    r = 0 if uf is None else uf.shape[-1]
    new = _empty(ys)
    lowrank = form == LOWRANK_PRE
    work = (None,) * 5
    if gates is None:  # what the recompute pre-pass rebuilds: gates, hu, rhu, recn, xu
        work = (new(t, b, 3 * h), *_form_buffers(new, t, b, h, r, form),
                new(t, b, rx) if rx else None)
    dhu, drhu = (new(t * b, r), new(t * b, r)) if lowrank else (None, None)
    nparts = gru_bwd_partial_floats(t, b, f, rx, h, r, form, gi=gi_mode, dx=dx)
    nstaged = gru_tc_stage_floats(t, b, f, rx, h, r, form, gi=gi_mode, recompute=gates is None,
                                  dx=dx)
    staged = new(nstaged) if nstaged else None
    if gi_mode:
        grads = (new(t, b, 3 * h), new(h, r) if lowrank else None, torch.empty_like(prz),
                 torch.empty_like(pn), new(b, h))
        dpre, dxu = grads[0], None
    else:
        grads = (new(t, b, f) if dx else None, torch.empty_like(ux),
                 new(rx, 3 * h) if rx else None, new(3 * h),
                 new(h, r) if lowrank else None, torch.empty_like(prz), torch.empty_like(pn),
                 new(b, h))
        dpre, dxu = new(t * b, 3 * h), new(t * b, rx) if rx else None
    if isinstance(plan, GRUPlan):
        state = _state(plan, "bwd", ys)
        if gi_mode:
            _launch(BWD_KERNEL, "gru_scan_bwd",
                    (*tensors, dpre, dhu, drhu, new(nparts), staged, *grads[1:], state),
                    (t, b, h, r, form, nparts, nstaged, *plan.ints("bwd")), ys.device)
        else:
            _launch(BWD_KERNEL, "gru_scan_xin_bwd",
                    (*tensors, *work, dpre, dhu, drhu, dxu, new(nparts), staged, *grads, state),
                    (t, b, f, rx, h, r, form, nparts, nstaged, *plan.ints("bwd")), ys.device)
        return grads
    xchg, sync, wstream, nstream = _grid_scratch(plan, "bwd", ys)
    out = (None,) * 4 + grads[1:] if gi_mode else grads
    _launch(BWD_KERNEL, "gru_grid_bwd",
            (xs, ux, vx, uf, prz, pn, h0, ys, gates, hu, rhu, recn, xu, dys, bias, *work, dpre,
             dhu, drhu, dxu, new(nparts), staged, *out, xchg, sync, wstream),
            (t, b, f, rx, h, r, form, nparts, nstaged, nstream, *plan.ints("bwd")), ys.device)
    return grads


# batch dims of the entries' tensors (None: the same for every chunk), and
# of their outputs (None: a weight gradient, summed over the chunks)
_XIN_ROWS = (1, None, None, None, None, None, None, 0)
_GI_ROWS = (1, None, None, None, 0)
_XIN_BWD_ROWS = (1, None, None, None, None, None, 0, 1, 1, 1, 1, 1, 1, 1, None)
_GI_BWD_ROWS = (None, None, None, 0, 1, 1, 1, 1, 1, 1)
_XIN_GRAD_DIMS = (1, None, None, None, None, None, None, 0)
_GI_GRAD_DIMS = (1, None, None, None, 0)


def _state(plan, kernel, like):
    """The device-memory scratch of ``kernel``'s spilled regions, or None."""
    n = state_floats(plan, kernel)
    return _empty(like)(n) if n else None


GROUP_TARGET = 2 * SPLIT_TARGET  # CTAs a grouped split-k aims at (gemm_tile.cuh kGroupTarget)


def group_splits(products, sized_by=None):
    """The slices gemm_tile.cuh::gemm_splitk_group cuts each product's k
    into, for a group of products given as (m, n, k): one slice length for
    all, whole 16-row steps, so that the tiles times slices of the products
    ``sized_by`` (all of them when None) come near GROUP_TARGET CTAs
    (gemm_tile.cuh::group_kslice)."""
    work = sum(_cdiv(n, 64) * _cdiv(m, 64) * k for m, n, k in sized_by or products)
    kslice = _cdiv(_cdiv(work, GROUP_TARGET), 16) * 16
    return [_cdiv(k, kslice) for _, _, k in products]


def _group_floats(products, sized_by=None):
    """Floats of a group's scratch: each product's slices times m n."""
    splits = group_splits(products, sized_by)
    return sum(s * m * n for s, (m, n, _) in zip(splits, products))


def gru_bwd_products(t, b, f, rx, h, r, form, *, gi=False, dx=True):
    """(m, n, k) of each product of the BPTT's grouped split-k, in order:
    dPrz and dPn; dUf (low-rank) as one product over [Hprev | R*Hprev] with
    k = 2 T*B; in x mode dUx, dVx (low-rank x side), dbias = ones^T dPre
    and, with ``dx``, dx = dXU Uxᵀ [T*B, F], which takes the slice length
    of the others (their sums do not depend on it)."""
    m, g3 = t * b, 3 * h
    k = r if form == LOWRANK_PRE else h
    out = [(k, 2 * h, m), (k, h, m)] + ([(h, r, 2 * m)] if form == LOWRANK_PRE else [])
    if not gi:
        out += [(f, rx or g3, m)] + ([(rx, g3, m)] if rx else []) + [(1, g3, m)]
        out += [(m, f, rx or g3)] if dx else []
    return out


def _routed(products, count):
    """The first ``count`` of ``products`` (m, n, k) that gemm_tc.cuh's rule
    sends to its Hopper tile (`cuda_scan.tc_route`): the recurrent weight
    gradients of `gru_bwd_products`, which the BPTT takes out of its group
    (m = 0 there: no CTA, no output)."""
    return [i < count and tc_route(*p) for i, p in enumerate(products)]


@functools.lru_cache(maxsize=256)
def gru_bwd_partial_floats(t, b, f, rx, h, r, form, *, gi=False, dx=True):
    """Floats of split-k scratch for the BPTT's grouped products
    (`gru_bwd_products`, csrc/gemm_tile.cuh::gemm_splitk_group): they run
    at once, each in a region of its own, so they need the sum of the
    regions; the recurrent ones that take the Hopper tile (`_routed`) run
    before them, one at a time, each wanting its own k slices
    (`cuda_scan.tc_splitk_floats`), and keep no region in the group, whose
    slice length is still that of every weight gradient; before them, in x
    mode with a low-rank x side, dXU = dPre Vxᵀ runs as a group of its own
    in the same scratch. The largest of these."""
    weights = gru_bwd_products(t, b, f, rx, h, r, form, gi=gi, dx=False)
    products = gru_bwd_products(t, b, f, rx, h, r, form, gi=gi, dx=dx)
    nrec = 3 if form == LOWRANK_PRE else 2
    routed = _routed(products, nrec)
    left = [(0, n, k) if go else (m, n, k) for go, (m, n, k) in zip(routed, products)]
    main = _group_floats(left, weights)
    tiles = [tc_splitk_floats(*p, False) for go, p in zip(routed, products) if go]
    return max([main, *tiles] + ([_group_floats([(t * b, rx, 3 * h)])] if rx and not gi else []))


def gru_tc_products(t, b, f, rx, h, r, form, *, gi=False, recompute=False):
    """The BPTT's products that may take gemm_tc.cuh's Hopper tile, in launch
    order, as `cuda_scan.staged_copies` reads them: [(m, n, k, A, B, split,
    store)], A and B (source, runs along j). The recompute pre-pass's
    recurrent products (csrc/gru_scan_xin_bwd.cu::recompute: unsplit, their
    epilogues reading the gates but for HU and RHU's Store; a dense [R Z]
    as two products of h columns where the Hopper tile takes such a half),
    then the recurrent weight gradients (grouped_grads: split, Store).
    Sources:
    "hprev" the rows [h0; ys], "rh" those rows times R (R * Hprev, formed as
    staged), "dn_r" dPre's n columns times R, "hprev_rh" [Hprev; R * Hprev]
    and "dhu_drhu" [dHU; dRHU] over 2 T*B rows, "dpre" and "dpre_n" dPre
    from its first and its n columns."""
    m, a, c = t * b, True, False
    out = []
    if recompute:
        if form == LOWRANK_PRE:
            out += [(m, r, h, ("hprev", a), ("uf", a), False, True),
                    (m, 2 * h, r, ("hu", a), ("prz", a), False, False),
                    (m, r, h, ("rh", a), ("uf", a), False, True),
                    (m, h, r, ("rhu", a), ("pn", a), False, False)]
        else:
            out += ([(m, h, h, ("hprev", a), (half, a), False, False)
                     for half in ("prz_r", "prz_z")] if tc_route(m, h, h) else
                    [(m, 2 * h, h, ("hprev", a), ("prz", a), False, False)])
            out += [(m, h, h, ("rh" if form == DENSE_PRE else "hprev", a), ("pn", a), False,
                     False)]
    if form == LOWRANK_PRE:
        out += [(r, 2 * h, m, ("hu", c), ("dpre", a), True, True),
                (r, h, m, ("rhu", c), ("dpre_n", a), True, True),
                (h, r, 2 * m, ("hprev_rh", c), ("dhu_drhu", a), True, True)]
    else:
        out += [(h, 2 * h, m, ("hprev", c), ("dpre", a), True, True),
                (h, h, m, ("rh", c) if form == DENSE_PRE else ("hprev", c),
                 ("dpre_n", a) if form == DENSE_PRE else ("dn_r", a), True, True)]
    return out


def gru_gemm_ops(t, b, f, rx, h, r, form, *, gi=False, save_gates=True):
    """Operations of the BPTT's products that run as 3xTF32 on gemm_tc.cuh's
    Hopper tile (two per multiply-add): those of `gru_tc_products` that
    `cuda_scan.tc_route` sends there, the recurrent weight gradients and,
    without ``save_gates``, the recompute pre-pass's recurrent products; the
    share of `gru_scan_bwd_cost`'s operations that `bound` prices at the
    3xTF32 rate (0 at every HAR width)."""
    return sum(2 * m * n * k for m, n, k, *_ in gru_tc_products(
        t, b, f, rx, h, r, form, gi=gi, recompute=not save_gates) if tc_route(m, n, k))


@functools.lru_cache(maxsize=256)
def gru_tc_stage_floats(t, b, f, rx, h, r, form, *, gi=False, recompute=False, dx=True):
    """Floats of the Hopper tile's staged copies and raw sums in one BPTT
    call (the scratch ``staged`` of its entry): `cuda_scan.staged_copies`
    of `gru_tc_products`, with the call's split-k scratch
    (`gru_bwd_partial_floats`), the most that one phase holds: each
    recompute pre-pass product alone, then the weight gradients together,
    each phase from the scratch's start; 0 where no product takes that
    tile (every HAR width)."""
    partial = gru_bwd_partial_floats(t, b, f, rx, h, r, form, gi=gi, dx=dx)
    grads = gru_tc_products(t, b, f, rx, h, r, form, gi=gi)
    rebuild = gru_tc_products(t, b, f, rx, h, r, form, gi=gi, recompute=recompute)[:-len(grads)]
    most = 0
    for phase in [[p] for p in rebuild] + [grads]:
        copies = staged_copies(phase, False, partial)
        assert sum(cp[3] != "raw" for cp in copies) <= STAGE_COPIES
        most = max(most, sum(cp[-1] for cp in copies))
    return most // 4

@_counter
def gru_scan_fused_xin(xs, ux, vx, bias, uf, prz, pn, h0, *, mode="pre"):
    """Fused GRU scan, x mode, no gradient.

    xs [T, B, F]; ux [F, rx], vx [rx, 3h], bias [3h]; low-rank: uf [h, r],
    prz [r, 2h], pn [r, h]; dense: uf None, prz [h, 2h], pn [h, h]; h0
    [B, h]; mode "pre" or "post" (dense only). Returns ys [T, B, h].

    CPU tensors run `gru_scan_fused_xin_plain`. CUDA tensors must be float32,
    contiguous and on one device; the kernel runs on the current stream, in
    the layout of `gru_layout` (one launch, or one a chunk of rows on the
    grid), and ``gru_scan_fused_xin.launches`` counts its launches
    (``.variants``). A CUDA
    input that requires a gradient, with grad mode on, raises: that call
    belongs to `GRUScanXin`.
    """
    args = (xs, ux, vx, bias, uf, prz, pn, h0)
    if _on_cpu(args):
        return gru_scan_fused_xin_plain(*args, mode=mode)
    sizes = _check(_ARG_NAMES, args, mode)
    _require_cuda("gru_scan_fused_xin", xs)
    _refuse_grad("gru_scan_fused_xin", args, "GRUScanXin")
    return _launch_nograd(gru_scan_fused_xin, variant(), args, sizes)


def _launch_nograd(fn, name, args, sizes):
    """The no-grad forward in x mode, one launch a chunk of rows counted
    under ``fn``'s variant ``name`` -> ys."""
    xs = args[0]
    with torch.cuda.device(xs.device):
        return _by_chunks(fn, name, _chunks(_plan_for(*sizes, xs.device), sizes[1]),
                          functools.partial(_fwd_launch, False, sizes[-1]), args, _XIN_ROWS,
                          (1,))[0]


@_counter
def gru_scan_fused_xin_res(xs, ux, vx, bias, uf, prz, pn, h0, *, mode="pre", save_gates=None):
    """The residual forward of training: `gru_scan_fused_xin` that also
    returns the backward's residuals -> (ys, gates, hu, rhu, recn, xu),
    shaped as `gru_scan_xin_fwd_res_plain`'s, which CPU tensors run.
    ``save_gates`` False (None: read from VMLMF_PALLAS_SAVED_GATES) is the
    recompute policy: ys alone, from the no-grad kernel body, and None for
    every residual. ``gru_scan_fused_xin_res.launches`` counts the kernel's
    calls, ``.variants`` by policy ("f32" or "recompute")."""
    args = (xs, ux, vx, bias, uf, prz, pn, h0)
    save_gates = env_saved_gates() if save_gates is None else bool(save_gates)
    if _on_cpu(args):
        return gru_scan_xin_fwd_res_plain(*args, mode=mode, save_gates=save_gates)
    sizes = _check(_ARG_NAMES, args, mode)
    _require_cuda("gru_scan_fused_xin_res", xs)
    if not save_gates:
        ys = _launch_nograd(gru_scan_fused_xin_res, variant(save_gates=False), args, sizes)
        return ys, None, None, None, None, None
    with torch.cuda.device(xs.device):
        return _by_chunks(gru_scan_fused_xin_res, variant(),
                          _chunks(_plan_for(*sizes, xs.device), sizes[1]),
                          functools.partial(_fwd_launch, True, sizes[-1]), args, _XIN_ROWS,
                          (1,) * 6)


@_counter
def gru_scan_xin_bwd(xs, ux, vx, uf, prz, pn, h0, ys, gates, hu, rhu, recn, xu, dys, *,
                     mode="pre", dx=True, bias=None):
    """Gradients of the fused GRU scan from the residual forward's outputs and
    the cotangent ``dys [T, B, h]`` -> (dxs, dux, dvx, dbias, duf, dprz, dpn,
    dh0); duf is None for a dense recurrent side, dxs when ``dx`` is False.
    Gates None is the recompute policy: hu, rhu, recn and xu are None too,
    ``bias`` is given, and a pre-pass rebuilds them.

    CPU tensors run `gru_scan_xin_bwd_plain`; CUDA tensors launch the BPTT
    kernel, counted by ``gru_scan_xin_bwd.launches`` (``.variants``).
    """
    if dys is None:
        raise ValueError("gru_scan_xin_bwd needs the cotangent dys")
    saved = (xs, ux, vx, uf, prz, pn, h0, ys, gates, hu, rhu, recn, xu, dys)
    if _on_cpu((*saved, bias)):
        return gru_scan_xin_bwd_plain(*saved, mode=mode, dx=dx, bias=bias)
    sizes = _check((*_RES_NAMES, "bias"), (*saved, bias), mode)
    _require_cuda("gru_scan_xin_bwd", xs)
    b, form = sizes[1], sizes[-1]
    recompute = gates is None
    if recompute:
        if any(a is not None for a in (hu, rhu, recn, xu)) or bias is None:
            raise ValueError("the recompute policy (gates None) takes no hu, rhu, recn or xu, "
                             "and takes bias")
    else:
        _check_residuals(form, hu, rhu, recn, mode, uf)
        if (xu is None) != (vx is None):
            raise ValueError(f"xu must {'not ' if vx is None else ''}be given with vx "
                             f"{'None' if vx is None else 'given'}")
    with torch.cuda.device(xs.device):
        return _by_chunks(gru_scan_xin_bwd, variant(save_gates=not recompute),
                          _chunks(_plan_for(*sizes, xs.device, "bwd"), b),
                          functools.partial(_bwd_launch, form, dx), (*saved, bias),
                          _XIN_BWD_ROWS, _XIN_GRAD_DIMS)


class GRUScanXin(torch.autograd.Function):
    """The differentiable fused GRU scan: the residual forward, then the BPTT.

    ``GRUScanXin.apply(xs, ux, vx, bias, uf, prz, pn, h0, mode)`` -> ys, with
    gradients for every tensor input (uf may be None). The residual policy
    comes from VMLMF_PALLAS_SAVED_GATES, read at call time (the JAX package
    reads it at trace time). The final state is ``ys[-1]``, whose gradient
    reaches the backward through autograd's indexing. dx is computed only
    when xs needs a gradient (not for a first layer's raw input).
    """

    @staticmethod
    def forward(ctx, xs, ux, vx, bias, uf, prz, pn, h0, mode):
        ys, gates, hu, rhu, recn, xu = gru_scan_fused_xin_res(xs, ux, vx, bias, uf, prz, pn, h0,
                                                              mode=mode)
        ctx.save_for_backward(xs, ux, vx, uf, prz, pn, h0, ys, gates, hu, rhu, recn, xu,
                              bias if gates is None else None)
        ctx.mode = mode
        ctx.set_materialize_grads(False)
        return ys

    @staticmethod
    def backward(ctx, dys):
        if dys is None:
            return (None,) * 9
        *saved, bias = ctx.saved_tensors
        grads = gru_scan_xin_bwd(*saved, dys.contiguous(), mode=ctx.mode,
                                 dx=ctx.needs_input_grad[0], bias=bias)
        return (*grads, None)


@_counter
def gru_scan_fused(gi, uf, prz, pn, h0, *, mode="pre"):
    """Fused GRU scan, gi mode, no gradient: `pallas_gru.gru_scan_fused`.

    gi [T, B, 3h] is the input contribution (the cell's ``inp``, gate order
    r, z, n); the recurrent side, h0 and ``mode`` as `gru_scan_fused_xin`
    takes them. Returns ys [T, B, h]. CPU tensors run
    `gru_scan_fused_plain`; CUDA tensors launch entry ``gru_scan_fwd``,
    counted by ``gru_scan_fused.launches``.
    """
    args = (gi, uf, prz, pn, h0)
    if _on_cpu(args):
        return gru_scan_fused_plain(*args, mode=mode)
    sizes = _check_gi(_GI_NAMES, args, mode)
    _require_cuda("gru_scan_fused", gi)
    _refuse_grad("gru_scan_fused", args, "GRUScan")
    t, b, h, r, form = sizes
    with torch.cuda.device(gi.device):
        return _by_chunks(gru_scan_fused, variant(),
                          _chunks(_plan_for(t, b, 0, 0, h, r, form, gi.device, gi=True), b),
                          functools.partial(_fwd_launch, False, form), args, _GI_ROWS, (1,))[0]


@_counter
def gru_scan_fused_res(gi, uf, prz, pn, h0, *, mode="pre"):
    """The residual forward of gi mode -> (ys, gates, hu, rhu, recn), as
    `gru_recurrence_plain` returns them (which CPU tensors run). gi mode
    always saves the gates (the JAX package's recompute policy is x mode
    only). Entry ``gru_scan_fwd_res``, counted by
    ``gru_scan_fused_res.launches``."""
    args = (gi, uf, prz, pn, h0)
    if _on_cpu(args):
        return gru_recurrence_plain(*args, mode=mode)
    sizes = _check_gi(_GI_NAMES, args, mode)
    _require_cuda("gru_scan_fused_res", gi)
    t, b, h, r, form = sizes
    with torch.cuda.device(gi.device):
        return _by_chunks(gru_scan_fused_res, variant(),
                          _chunks(_plan_for(t, b, 0, 0, h, r, form, gi.device, gi=True), b),
                          functools.partial(_fwd_launch, True, form), args, _GI_ROWS, (1,) * 5)


@_counter
def gru_scan_bwd(uf, prz, pn, h0, ys, gates, hu, rhu, recn, dys, *, mode="pre"):
    """Gradients of the gi-mode scan -> (dgi, duf, dprz, dpn, dh0): the BPTT
    walk, whose dpre is dgi, and the recurrent weight gradients; no x side
    (`pallas_gru._scan_core_bwd`). duf is None for a dense recurrent side.
    CPU tensors run `gru_scan_bwd_plain`; CUDA tensors launch entry
    ``gru_scan_bwd``, counted by ``gru_scan_bwd.launches``."""
    if dys is None:
        raise ValueError("gru_scan_bwd needs the cotangent dys")
    saved = (uf, prz, pn, h0, ys, gates, hu, rhu, recn, dys)
    if _on_cpu(saved):
        return gru_scan_bwd_plain(*saved, mode=mode)
    t, b, h, r, form = _check_gi(_GI_BWD_NAMES, (ys, uf, prz, pn, h0, gates, hu, rhu, recn, dys),
                                 mode)
    if gates is None:
        raise ValueError("gru_scan_bwd needs the saved gates: gi mode always saves them")
    _check_residuals(form, hu, rhu, recn, mode, uf)
    _require_cuda("gru_scan_bwd", ys)
    with torch.cuda.device(ys.device):
        return _by_chunks(gru_scan_bwd, variant(),
                          _chunks(_plan_for(t, b, 0, 0, h, r, form, ys.device, "bwd", gi=True), b),
                          functools.partial(_bwd_launch, form, True), saved, _GI_BWD_ROWS,
                          _GI_GRAD_DIMS)


class GRUScan(torch.autograd.Function):
    """The differentiable gi-mode scan: `gru_scan_fused_res`, then
    `gru_scan_bwd`. ``GRUScan.apply(gi, uf, prz, pn, h0, mode)`` -> ys, with
    gradients for gi, the recurrent weights and h0."""

    @staticmethod
    def forward(ctx, gi, uf, prz, pn, h0, mode):
        ys, gates, hu, rhu, recn = gru_scan_fused_res(gi, uf, prz, pn, h0, mode=mode)
        ctx.save_for_backward(uf, prz, pn, h0, ys, gates, hu, rhu, recn)
        ctx.mode = mode
        ctx.set_materialize_grads(False)
        return ys

    @staticmethod
    def backward(ctx, dys):
        if dys is None:
            return (None,) * 6
        return (*gru_scan_bwd(*ctx.saved_tensors, dys.contiguous(), mode=ctx.mode), None)


def _macs(f, rx, h, r, form):
    """Multiply-adds per row and step of the forward: the x side (x@Ux@Vx, or
    x@Ux for a dense one, rx = 0), then the recurrent side (h@Uf, hu@Prz,
    (r⊙h)@Uf, rhu@Pn; or h@Prz and the [h, h] candidate product)."""
    rec = 5 * h * r if form == LOWRANK_PRE else 3 * h * h
    return (f * rx + rx * 3 * h if rx else f * 3 * h), rec


def _rec_weights(h, r, form):
    """Floats of uf, prz and pn."""
    return h * r + 3 * h * r if form == LOWRANK_PRE else 3 * h * h


def _weights(f, rx, h, r, form):
    """Floats of ux, vx, bias, uf, prz and pn."""
    return _macs(f, rx, h, r, form)[0] + 3 * h + _rec_weights(h, r, form)


def _fwd_ops(t, b, f, rx, h, r, form, gi):
    """Operations of the forward: two per multiply-add of the products (no x
    side in gi mode), two per gate element (the bias, in gi mode already in
    gi, and the recurrent term) and eight per hidden unit (three
    nonlinearities, the reset product and the four of z·h + (1−z)·n), each
    step and row."""
    xm, rm = _macs(f, rx, h, r, form)
    return t * b * (2 * ((0 if gi else xm) + rm) + (1 if gi else 2) * 3 * h + 8 * h)


def gru_scan_cost(t, b, f, rx, h, r, form, *, gi=False):
    """(operations, bytes) that the no-grad scan needs at least, for its
    roofline bound: `_fwd_ops`; x (gi [T,B,3h] in gi mode), the weights (the
    recurrent ones in gi mode) and h0 read once, ys written once, f32."""
    ops = _fwd_ops(t, b, f, rx, h, r, form, gi)
    if gi:
        floats = t * b * 3 * h + _rec_weights(h, r, form) + b * h + t * b * h
    else:
        floats = t * b * f + _weights(f, rx, h, r, form) + b * h + t * b * h
    return ops, 4 * floats


def _res_floats(t, b, h, r, form):
    """Floats of the saved residuals of a form: gates [T,B,3h], and hu, rhu
    [T,B,r] (low-rank) or recn [T,B,h] (post)."""
    return t * b * (3 * h + {LOWRANK_PRE: 2 * r, DENSE_PRE: 0, DENSE_POST: h}[form])


def gru_scan_res_cost(t, b, f, rx, h, r, form, *, gi=False, save_gates=True):
    """(operations, bytes) of the residual forward: `gru_scan_cost` plus the
    residual outputs written once: gates and the form's hu, rhu or recn, and
    xu [T,B,rx] (x mode, low-rank x side). The recompute policy writes ys
    alone: `gru_scan_cost`."""
    ops, nbytes = gru_scan_cost(t, b, f, rx, h, r, form, gi=gi)
    if not save_gates:
        return ops, nbytes
    return ops, nbytes + 4 * (_res_floats(t, b, h, r, form) + (0 if gi else t * b * rx))


def gru_scan_bwd_cost(t, b, f, rx, h, r, form, *, dx=True, gi=False, save_gates=True):
    """(operations, bytes) that the BPTT needs at least, for its roofline bound.

    Operations: two per multiply-add, per row and step: the recurrent side
    twice the forward's (the data gradients along the serial chain and the
    weight gradients); in x mode the x side dXU = dPre Vxᵀ and dVx = XUᵀ
    dPre (rx·3h each; none for a dense x side), dUx = Xᵀ dXU (F·kx, kx = rx,
    or 3h for a dense x side) and, when ``dx``, dx = dXU Uxᵀ (F·kx); plus 20
    per hidden unit for dpre, the carry and the bias sums. Without
    ``save_gates`` (the recompute policy) the forward's `_fwd_ops` once more.
    Bytes: each residual (none under recompute, which reads the bias
    instead), the weights (ux only when ``dx``), x and dys read once and
    each gradient written once, f32; gi mode reads no x side and writes dgi
    [T,B,3h].
    """
    _, rm = _macs(f, rx, h, r, form)
    if gi:
        ops = t * b * (2 * 2 * rm + 20 * h)
        weights = _rec_weights(h, r, form)
        inputs = weights + b * h + 2 * t * b * h + _res_floats(t, b, h, r, form)  # ys, dys
        outputs = t * b * 3 * h + weights + b * h
        return ops, 4 * (inputs + outputs)
    kx = rx or 3 * h
    macs = 2 * rm + 2 * rx * 3 * h + f * kx + (f * kx if dx else 0)
    ops = t * b * (2 * macs + 20 * h)
    if not save_gates:
        ops += _fwd_ops(t, b, f, rx, h, r, form, False)
    weights = _weights(f, rx, h, r, form)
    read = weights - 3 * h - (0 if dx else f * kx)                 # less bias, and ux without dx
    res = _res_floats(t, b, h, r, form) + t * b * rx if save_gates else 3 * h  # or the bias
    inputs = t * b * f + read + b * h + 2 * t * b * h + res         # x, weights, h0, ys, dys
    outputs = (t * b * f if dx else 0) + weights + b * h          # dx, dweights, dh0
    return ops, 4 * (inputs + outputs)
