"""Fused LSTM scan with the input projection inside: the port's counterpart
of `vmlmf_tpu.ops.pallas_scan.lstm_scan_fused_xin` and its VJP.

Each side of the scan is low-rank (two factors) or dense (one matrix): the
x side ``x @ Ux @ Vx`` or ``x @ Ux`` (vx None), the recurrent side
``h @ U @ V`` or ``h @ U`` (v None), in any of the four combinations. Three
kernel entries, each with a plain version (the same arithmetic in torch
ops) and a launch count:

  * `lstm_scan_fused_xin` — the no-grad forward (serving, eval), kernel
    ``csrc/lstm_scan_xin_fwd.cu`` entry ``lstm_scan_xin_fwd``;
  * `lstm_scan_fused_xin_res` — the residual forward of training, entry
    ``lstm_scan_xin_fwd_res`` of the same source;
  * `lstm_scan_xin_bwd` — the BPTT, ``csrc/lstm_scan_xin_bwd.cu``.

`LSTMScanXin` is the `torch.autograd.Function` that pairs the last two.
`scan_plan` decides how the kernels spread a scan over the card's SMs: the
batch groups, each CTA's slices of the recurrent weights and the shared
memory they take. It is plain Python, so the CPU tests reach it.
Each wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors, so on the CPU the same `LSTMScanXin` runs the plain
forward and the plain backward. There is no fallback between the two: a
CUDA input that the kernel does not take raises, and a CUDA input that
requires a gradient never reaches the no-grad kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

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


def _x_side(xs, ux, vx):
    """(xu = x @ Ux, or None for a dense x side; the x product x @ Ux [@ Vx])."""
    if vx is None:
        return None, xs @ ux
    xu = xs @ ux
    return xu, xu @ vx


def lstm_scan_fused_xin_plain(xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0):
    """The kernel's function in torch ops: the batched input projection, then
    a Python loop over T. Same arguments and results as `lstm_scan_fused_xin`."""
    ys, cs = lstm_scan_xin_fwd_res_plain(xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0)[:2]
    return ys, cs[-1]


def lstm_scan_xin_fwd_res_plain(xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0):
    """`lstm_scan_fused_xin_plain` that also returns the backward's residuals:
    -> (ys, cs [T,B,h], gates [T,B,4h] after the nonlinearities, hu =
    h_prev@U [T,B,r] or None for a dense recurrent side, xu = x@Ux [T,B,rx]
    or None for a dense x side). The final cell state is cs[-1]."""
    h = h0.shape[-1]
    xu, xp = _x_side(xs, ux, vx)
    gi = xp + pad_features(xs, h).repeat(1, 1, 4) * xdvec.reshape(-1) + bias
    return (*lstm_recurrence_plain(gi, u, v, dvec, h0, c0), xu)


def lstm_recurrence_plain(gi, u, v, dvec, h0, c0):
    """The serial part of the scan in torch ops, step by step: from the input
    contribution gi [T, B, 4h] -> (ys, cs [T,B,h], gates [T,B,4h] after the
    nonlinearities, hu = h_prev@U [T,B,r] or None for a dense U [h, 4h])."""
    dvec = dvec.reshape(-1)
    h_t, c_t = h0, c0
    ys, cs, gates, hus = [], [], [], []
    for gi_t in gi:
        if v is None:
            rec = h_t @ u
        else:
            hu = h_t @ u
            hus.append(hu)
            rec = hu @ v
        pre = gi_t + rec + h_t.repeat(1, 4) * dvec
        i, f, g, o = pre.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c_t = f * c_t + i * g
        h_t = o * torch.tanh(c_t)
        ys.append(h_t)
        cs.append(c_t)
        gates.append(torch.cat([i, f, g, o], dim=-1))
    return (torch.stack(ys), torch.stack(cs), torch.stack(gates),
            torch.stack(hus) if hus else None)


def lstm_scan_xin_bwd_plain(xs, ux, vx, xdvec, u, v, dvec, h0, c0, ys, cs, gates, hu, xu,
                            dys, dc_last):
    """The BPTT kernel's function in torch ops, step by step as
    `pallas_scan._bwd_kernel` computes it: a reverse loop over T for dpre, the
    dh/dc carry and the recurrent weight gradients, then the x-side gradients
    batched over all T*B rows. ``dys`` and ``dc_last`` may be None (zeros).

    -> (dxs, dux, dvx, dxdvec, dbias, du, dv, ddvec, dh0, dc0), shaped as the
    forward's inputs; dv is None for a dense recurrent side, dvx for a dense
    x side.
    """
    t, b, f = xs.shape
    h = h0.shape[-1]
    dpre, du, dv, ddvec, dh, dc = lstm_bptt_plain(u, v, dvec, h0, c0, ys, cs, gates, hu, dys,
                                                  None, dc_last)
    dpre2 = dpre.reshape(t * b, 4 * h)
    x2 = xs.reshape(t * b, f)
    if vx is None:
        dxu, dvx = dpre2, None
    else:
        dxu = dpre2 @ vx.T
        dvx = xu.reshape(t * b, -1).T @ dpre2
    dx2 = dxu @ ux.T
    dux = x2.T @ dxu
    dxe = dpre2 * xdvec.reshape(-1)
    dxe = dxe[:, :h] + dxe[:, h:2 * h] + dxe[:, 2 * h:3 * h] + dxe[:, 3 * h:]
    dx2 = dx2 + pad_features(dxe, f)
    dxdvec = (dpre2 * pad_features(x2, h).repeat(1, 4)).sum(0).reshape(4, h)
    dbias = dpre2.sum(0)
    return dx2.reshape(t, b, f), dux, dvx, dxdvec, dbias, du, dv, ddvec, dh, dc


def lstm_bptt_plain(u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dh_last, dc_last):
    """The serial reverse walk of the BPTT in torch ops, step by step as
    `pallas_scan._bwd_kernel` computes it: dpre, the dh/dc carry and the
    recurrent weight gradients. ``dys``, ``dh_last`` and ``dc_last`` may be
    None (zeros). -> (dpre [T,B,4h], du, dv (None for a dense U), ddvec [4h],
    dh0, dc0)."""
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
    dpres = [None] * t
    for s in range(t - 1, -1, -1):
        i, fg, g, o = gates[s].chunk(4, dim=-1)
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
        if v is None:
            dh = dh_prev + dpre @ u.T
            du = du + hprev[s].T @ dpre
        else:
            dhu = dpre @ v.T
            dh = dh_prev + dhu @ u.T
            du = du + hprev[s].T @ dhu
            dv = dv + hu[s].T @ dpre
    return torch.stack(dpres), du, dv, ddvec, dh, dc


def _check_tensors(names, tensors, want):
    """Raise unless each tensor has its wanted shape, is f32, contiguous and
    on the first tensor's device. A None tensor is skipped."""
    dev = tensors[0].device
    for name, a in zip(names, tensors):
        if a is None:
            continue
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} must have shape {want[name]}, got {tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
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
        "h0": (b, h), "c0": (b, h),
    }


def _check(args):
    """Validate a forward call's inputs; -> (T, B, F, rx, h, r)."""
    xs, ux, vx, _, _, u, v, _, h0, _ = args
    sizes = _sizes(xs, ux, vx, u, v, h0)
    _check_tensors(_ARG_NAMES, args, _input_shapes(*sizes))
    return sizes


def _check_bwd(saved, dys, dc_last):
    """Validate a backward call's residuals and cotangents; -> (T, B, F, rx, h, r)."""
    xs, ux, vx, _, u, v, _, h0 = saved[:8]
    hu, xu = saved[12:14]
    t, b, f, rx, h, r = sizes = _sizes(xs, ux, vx, u, v, h0)
    for name, res, factor in (("hu", hu, v), ("xu", xu, vx)):
        if (res is None) != (factor is None):
            raise ValueError(f"{name} is a residual of a low-rank side only: it must be "
                             f"{'None' if factor is None else 'given'} here")
    want = dict(_input_shapes(*sizes), ys=(t, b, h), cs=(t, b, h), gates=(t, b, 4 * h),
                hu=(t, b, r), xu=(t, b, rx), dys=(t, b, h), dc_last=(b, h))
    _check_tensors((*_RES_NAMES, "dys", "dc_last"), (*saved, dys, dc_last), want)
    return sizes


def _on_cpu(tensors):
    return all(a is None or a.device.type == "cpu" for a in tensors)


def _require_cuda(name, xs):
    if xs.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {xs.device}")


SMS = 132              # SMs of an H100 SXM: the plan's default
GRID_THREADS = 512     # threads per CTA of the grid kernels (scan_grid.cuh kGridThreads)
MAX_SLICES = 32        # depth slices of one product item (kMaxSlices)
MIN_SLICE_DEPTH = 8    # depth rows a slice takes at least (kMinSliceDepth)
STAGE_FLOATS = 8192    # the most floats a CTA stages of an exchange buffer at once
SMEM_LIMIT = 232448    # bytes of shared memory one block may use on sm_90
SPLIT_TARGET = 264     # CTAs a split-k product aims at (gemm_tile.cuh kSplitTarget)
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
    ``xchg``, floats of the exchange buffers."""

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

    @property
    def n_ctas(self):
        return self.groups * self.ctas

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
        groups, ctas, rpad, stage, red, smem."""
        return (self.groups, self.ctas, self.rpad, *((self.stage_fwd, self.red_fwd, self.smem_fwd)
                if kernel == "fwd" else (self.stage_bwd, self.red_bwd, self.smem_bwd)))


def _kernel_layout(h, ctas, rpad, phases, weights, slabs):
    """(stage, red, smem bytes) of one kernel: ``phases`` are its products as
    (depth, columns), ``weights`` the floats of its weight slices, ``slabs``
    its [units][rpad] buffers (the carry and the prefetched step inputs)."""
    stage = min(max(d for d, _ in phases), max(2, STAGE_FLOATS // rpad)) * rpad
    red = 0
    for depth, cols in phases:
        items = _cdiv(cols, 4) * (rpad // 4)
        slices = _slices(items, depth)
        red = max(red, slices * items * 16 if slices > 1 else 0)
    jwm = _cdiv(h, ctas)
    return stage, red, 4 * (weights + 4 * jwm + slabs * jwm * rpad + stage + red)


@functools.lru_cache(maxsize=256)
def scan_plan(b, h, r, sms=SMS):
    """The layout of the scan kernels for batch ``b``, hidden width ``h`` and
    recurrent rank ``r`` (0: a dense U [h, 4h]) on ``sms`` SMs -> ScanPlan.

    Each CTA's work per step is about the same for any grouping (the batch
    times the weights over the CTAs), but each CTA reads its group's whole h
    (or dpre) from L2 a step, and a barrier waits for every CTA of the
    group. So the plan takes as many groups as the card holds copies of the
    weights. For each group count from min(b, sms) down it tries ``ctas`` =
    just enough CTAs for MIN_STEP_WORK each (a single CTA per group needs no
    grid barrier), then sms // groups, both at most h; the first whose
    shared memory fits wins. Raises ValueError when the weights do not fit
    in the shared memory of all SMs.
    """
    if min(b, h, sms) < 1 or r < 0:
        raise ValueError(f"no scan plan for B={b}, h={h}, r={r} on {sms} SMs")
    step_work = h * 4 * h if r == 0 else h * r + r * 4 * h  # multiply-adds of a row's step
    for groups in range(min(b, sms), 0, -1):
        most = max(1, min(sms // groups, h))
        work = _round4(_cdiv(b, groups)) * step_work
        for ctas in sorted({min(most, _cdiv(work, MIN_STEP_WORK)), most}):
            plan = plan_layout(b, h, r, groups, ctas)
            if plan.smem_bytes <= SMEM_LIMIT:
                return plan
    raise ValueError(f"the recurrent weights of h={h}, r={r or 'dense'} do not fit in the "
                     f"shared memory of {sms} SMs")


def plan_layout(b, h, r, groups, ctas):
    """The ScanPlan of ``groups`` batch groups of ``ctas`` CTAs each, for
    batch ``b``, width ``h`` and rank ``r`` (0: dense); `scan_plan` picks
    the grouping."""
    rpad = _round4(_cdiv(b, groups))
    jwm = _cdiv(h, ctas)
    jwp, kwp = _round4(jwm), _round4(_cdiv(r, ctas))
    # slabs: forward h, c and the step's gi (4); BPTT dh, dc and phase A's 7 inputs
    if r == 0:
        fwd = _kernel_layout(h, ctas, rpad, [(h, 4 * jwm)], h * 4 * jwm, 6)
        bwd = _kernel_layout(h, ctas, rpad, [(4 * h, jwp)], 4 * h * jwp, 9)
    else:
        fwd = _kernel_layout(h, ctas, rpad, [(h, kwp), (r, 4 * jwm)], h * kwp + r * 4 * jwm, 6)
        bwd = _kernel_layout(h, ctas, rpad, [(4 * h, kwp), (r, jwp)], 4 * h * kwp + r * jwp, 9)
    return ScanPlan(b, h, r, groups, ctas, rpad, *fwd, groups * rpad * (2 * h + r),
                    *bwd, groups * rpad * (8 * h + r))


def _splitk_floats(m, n, k):
    """Floats of partial sums that gemm_tile.cuh::gemm_splitk wants for
    c [m, n] = A [m, k] @ B [k, n] (0: it does not split)."""
    splits = _cdiv(SPLIT_TARGET, _cdiv(n, 64) * _cdiv(m, 64))
    kslice = _cdiv(_cdiv(k, splits), 16) * 16
    splits = _cdiv(k, kslice)
    return splits * m * n if splits > 1 else 0


def bwd_partial_floats(t, b, f, rx, h, r):
    """Floats of split-k scratch for the BPTT's products with few output
    tiles and a long k: the weight gradients (k = T*B) and the x side's
    product over the 4h gate columns (dXU, or dx for a dense x side). The
    largest that any of them wants."""
    m, g4 = t * b, 4 * h
    shapes = [(h, g4, m)] if not r else [(r, g4, m), (h, r, m)]
    shapes += [(f, g4, m), (m, f, g4)] if not rx else [(f, rx, m), (rx, g4, m), (m, rx, g4)]
    return max(_splitk_floats(*shape) for shape in shapes)


def _plan_for(b, h, r, device):
    return scan_plan(b, h, r, _sm_count(device.index))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(kernel, entry, tensors, sizes, device):
    """Call C entry ``entry`` of csrc/<kernel>.cu on the current stream: the
    tensors' pointers (None -> null), the integers (the sizes T, B, F, rx,
    h, r and the plan's layout) and the stream. Raises on the non-zero
    cudaError it returns: a plan the kernel cannot take, a launch refused, or
    a grid too large to be co-resident (no fallback)."""
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


def _sync_words(plan, like):
    """One barrier word per batch group; the launcher zeroes them."""
    return torch.empty(plan.groups, dtype=torch.int32, device=like.device)


def _empty(like):
    """A maker of uninitialised f32 tensors on ``like``'s device."""
    return lambda *shape: torch.empty(shape, dtype=torch.float32, device=like.device)


def lstm_scan_fused_xin(xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0):
    """Fused LSTM scan, x mode, no gradient.

    xs [T, B, F]; x side ux [F, rx], vx [rx, 4h] (low-rank) or ux [F, 4h],
    vx None (dense); xdvec [4, h] (applied to x over its first min(F, h)
    features); bias [4h]; recurrent side u [h, r], v [r, 4h] (low-rank) or
    u [h, 4h], v None (dense); dvec [4h]; h0, c0 [B, h]. Gate order i, f, g,
    o. Returns (ys [T, B, h], c_last [B, h]).

    CPU tensors run `lstm_scan_fused_xin_plain`. CUDA tensors must be float32,
    contiguous and on one device; the kernel runs on the current stream and
    ``lstm_scan_fused_xin.launches`` counts its calls. A CUDA input that
    requires a gradient, with grad mode on, raises: that call belongs to
    `LSTMScanXin`.
    """
    args = (xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0)
    if _on_cpu(args):
        return lstm_scan_fused_xin_plain(*args)
    sizes = _check(args)
    _require_cuda("lstm_scan_fused_xin", xs)
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args):
        raise RuntimeError("lstm_scan_fused_xin computes no gradient; inputs that require "
                           "one go through LSTMScanXin.apply")
    t, b, f, rx, h, r = sizes
    with torch.cuda.device(xs.device):
        plan = _plan_for(b, h, r, xs.device)
        new = _empty(xs)
        xu = new(t * b, rx) if rx else None
        gi, ys, c_last = new(t * b, 4 * h), new(t, b, h), new(b, h)
        xchg, sync = new(plan.xchg_fwd), _sync_words(plan, xs)
        _launch(KERNEL, "lstm_scan_xin_fwd", (*args, xu, gi, ys, c_last, xchg, sync),
                (*sizes, *plan.ints("fwd")), xs.device)
    lstm_scan_fused_xin.launches += 1
    return ys, c_last


lstm_scan_fused_xin.launches = 0


def lstm_scan_fused_xin_res(xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0):
    """The residual forward of training: `lstm_scan_fused_xin` that also
    returns the backward's residuals -> (ys, cs, gates, hu, xu), shaped as
    `lstm_scan_xin_fwd_res_plain`'s, which CPU tensors run: hu is None for a
    dense recurrent side and xu for a dense x side. The final cell state is
    cs[-1]. ``lstm_scan_fused_xin_res.launches`` counts the kernel's calls."""
    args = (xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0)
    if _on_cpu(args):
        return lstm_scan_xin_fwd_res_plain(*args)
    sizes = _check(args)
    _require_cuda("lstm_scan_fused_xin_res", xs)
    t, b, f, rx, h, r = sizes
    with torch.cuda.device(xs.device):
        plan = _plan_for(b, h, r, xs.device)
        new = _empty(xs)
        xu = new(t, b, rx) if rx else None
        hu = new(t, b, r) if r else None
        gi, ys, cs, gates = new(t * b, 4 * h), new(t, b, h), new(t, b, h), new(t, b, 4 * h)
        xchg, sync = new(plan.xchg_fwd), _sync_words(plan, xs)
        _launch(KERNEL, "lstm_scan_xin_fwd_res", (*args, xu, gi, ys, cs, gates, hu, xchg, sync),
                (*sizes, *plan.ints("fwd")), xs.device)
    lstm_scan_fused_xin_res.launches += 1
    return ys, cs, gates, hu, xu


lstm_scan_fused_xin_res.launches = 0


def lstm_scan_xin_bwd(xs, ux, vx, xdvec, u, v, dvec, h0, c0, ys, cs, gates, hu, xu,
                      dys, dc_last):
    """Gradients of the fused scan from the residual forward's outputs and the
    cotangents ``dys [T, B, h]`` and ``dc_last [B, h]`` (either may be None,
    read as zeros) -> (dxs, dux, dvx, dxdvec, dbias, du, dv, ddvec, dh0, dc0);
    dv is None for a dense recurrent side and dvx for a dense x side.

    CPU tensors run `lstm_scan_xin_bwd_plain`; CUDA tensors launch the BPTT
    kernel, counted by ``lstm_scan_xin_bwd.launches``.
    """
    saved = (xs, ux, vx, xdvec, u, v, dvec, h0, c0, ys, cs, gates, hu, xu)
    if _on_cpu((*saved, dys, dc_last)):
        return lstm_scan_xin_bwd_plain(*saved, dys, dc_last)
    sizes = _check_bwd(saved, dys, dc_last)
    _require_cuda("lstm_scan_xin_bwd", xs)
    t, b, f, rx, h, r = sizes
    with torch.cuda.device(xs.device):
        plan = _plan_for(b, h, r, xs.device)
        new = _empty(xs)
        dpre = new(t * b, 4 * h)
        dhu = new(t * b, r) if r else None
        dxu = new(t * b, rx) if rx else None
        grads = (new(t, b, f), torch.empty_like(ux), new(rx, 4 * h) if rx else None, new(4, h),
                 new(4 * h), torch.empty_like(u), new(r, 4 * h) if r else None, new(4 * h),
                 new(b, h), new(b, h))
        partial = new(max(1, bwd_partial_floats(*sizes)))
        _launch(BWD_KERNEL, "lstm_scan_xin_bwd",
                (*saved, dys, dc_last, dpre, dhu, dxu, *grads, new(plan.xchg_bwd),
                 _sync_words(plan, xs), partial),
                (partial.numel(), *sizes, *plan.ints("bwd")), xs.device)
    lstm_scan_xin_bwd.launches += 1
    return grads


lstm_scan_xin_bwd.launches = 0


class LSTMScanXin(torch.autograd.Function):
    """The differentiable fused scan: the residual forward, then the BPTT.

    ``LSTMScanXin.apply(xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0)`` ->
    (ys, c_last), with gradients for every tensor input (vx and v may be
    None, for a dense side). A cotangent that autograd leaves out (an output
    no loss reads, as the LM's detached final state) is passed to the
    backward as None and read there as zeros.
    """

    @staticmethod
    def forward(ctx, xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0):
        ys, cs, gates, hu, xu = lstm_scan_fused_xin_res(xs, ux, vx, xdvec, bias, u, v, dvec,
                                                        h0, c0)
        ctx.save_for_backward(xs, ux, vx, xdvec, u, v, dvec, h0, c0, ys, cs, gates, hu, xu)
        ctx.set_materialize_grads(False)
        return ys, cs[-1].clone()

    @staticmethod
    def backward(ctx, dys, dc_last):
        if dys is not None:
            dys = dys.contiguous()
        if dc_last is not None:
            dc_last = dc_last.contiguous()
        return lstm_scan_xin_bwd(*ctx.saved_tensors, dys, dc_last)


def _side(n, rank, h):
    """Multiply-adds per row of one side's product into 4h gate columns, which
    are also its weights' floats: n*rank + rank*4h for two factors (rank
    > 0), n*4h for a dense matrix (rank 0)."""
    return n * rank + rank * 4 * h if rank else n * 4 * h


def scan_cost(t, b, f, rx, h, r):
    """(operations, bytes) that the scan needs at least, for its roofline bound
    (rx = 0 and r = 0 mean a dense side).

    Operations: two per multiply-add of the x and the recurrent products, 6
    per gate element (the x term and bias, the h term and the sums) and 9
    per hidden unit (the nonlinearities and the state update), each step and
    row. Bytes: each input read once and each output written once, f32.
    """
    xm, rm = _side(f, rx, h), _side(h, r, h)
    ops = t * b * (2 * (xm + rm) + 6 * 4 * h + 9 * h)
    floats = t * b * f + xm + 4 * h + 4 * h + rm + 4 * h + 2 * b * h + t * b * h + b * h
    return ops, 4 * floats


def scan_res_cost(t, b, f, rx, h, r):
    """(operations, bytes) of the residual forward: `scan_cost` plus the
    residual outputs cs [T,B,h], gates [T,B,4h], hu [T,B,r] and xu [T,B,rx]
    (none for a dense side) written once, less the c_last row that it does
    not write."""
    ops, nbytes = scan_cost(t, b, f, rx, h, r)
    return ops, nbytes + 4 * (t * b * (h + 4 * h + r + rx) - b * h)


def scan_bwd_cost(t, b, f, rx, h, r, *, dys=True, dc_last=False):
    """(operations, bytes) that the BPTT needs at least, for its roofline bound.

    Operations: two per multiply-add of its products over all T*B rows. Each
    side's products are twice the forward's: on the recurrent side the data
    gradient along the chain (dhu = dpre V^T and dh += dhu U^T, or dh +=
    dpre U^T) and the weight gradients (dU, dV, or dU); on the x side dXU
    and dx, then dUx and dVx (or dx and dUx). Plus 30 per hidden unit for
    dpre, the carry and the column sums. Bytes: each residual and cotangent
    read once and each gradient written once, f32; ``dys``/``dc_last`` say
    whether those cotangents are given.
    """
    xm, rm = _side(f, rx, h), _side(h, r, h)
    ops = t * b * (2 * 2 * (xm + rm) + 30 * h)
    weights = xm + 4 * h + rm + 4 * h                                # ux, vx, xdvec, u, v, dvec
    inputs = (t * b * f + weights + 2 * b * h                       # x, weights, h0, c0
              + t * b * (h + h + 4 * h + r + rx)                    # ys, cs, gates, hu, xu
              + (t * b * h if dys else 0) + (b * h if dc_last else 0))
    outputs = t * b * f + weights + 4 * h + 2 * b * h               # dx, dweights, dbias, dh0, dc0
    return ops, 4 * (inputs + outputs)
