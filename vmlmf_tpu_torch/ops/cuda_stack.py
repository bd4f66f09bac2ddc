"""The wavefront LSTM stack: the port's counterpart of
`vmlmf_tpu.ops.pallas_pipeline` and its VJP.

A stack of L LSTM layers runs as one pipelined walk: layer l's step t needs
only layer l - 1's step t, so layer l works beside layer l - 1 instead of
after it, and the chain is ``T + L - 1`` steps long instead of ``L * T``.
Layer 0 reads ``gi0``, its input contribution (`Cell.inp` of the stack's
input); layer l >= 1 projects its input, the output of layer l - 1 times the
inter-layer dropout mask, as ``x @ ux @ vx + tile4(x) * dxvec + bias``. The
recurrence of every layer is ``h @ u @ v + tile4(h) * dvec``: the
`pipeline_units` of the cells (`stack_units`).

Three kernel entries, each with a plain version (the same arithmetic in
torch ops, layer by layer), a launch count and a cost function:

  * `lstm_stack_scan_fused` — the no-grad forward (serving, eval), kernel
    ``csrc/lstm_stack_fwd.cu`` entry ``lstm_stack_fwd``;
  * `lstm_stack_scan_fused_res` — the residual forward of training, the
    same entry with residuals;
  * `lstm_stack_bwd` — the reverse walk and the weight gradients,
    ``csrc/lstm_stack_bwd.cu``.

Each is one cooperative launch over the SMs (the BPTT then runs its weight
GEMMs), laid out by `stack_plan`: batch groups, and in each a set of CTAs
per layer that hold the layer's factor slices in shared memory for the whole
launch. `LSTMStackScan` is the `torch.autograd.Function` that pairs the last
two, and `stack_scan` picks it or the no-grad entry. `run_stack_grouped`
runs a stack of cells through groups that one launch takes (`stack_groups`).
As in `cuda_scan`, a wrapper launches its kernel for CUDA tensors and runs
its plain version for CPU tensors, and a CUDA input that the kernel does not
take raises: there is no fallback from one to the other.

Every entry takes the JAX package's ``precision``: "f32", or "bf16", whose
products take bf16-rounded operands where `pallas_pipeline` casts them (x,
xu, h and hu forward; dpre, dhu, h_prev, hu, dXU, x and xu backward; the
weights) and sum in f32. The diagonal terms, the bias, the gate arithmetic,
the residuals and the gradients stay f32. The launch counts file each call
under its variant ("f32" or "bf16", `cuda_scan.variant`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from vmlmf_tpu_torch.ops import _build
from vmlmf_tpu_torch.ops.cuda_scan import (
    MIN_STEP_WORK,
    SMEM_LIMIT,
    SMS,
    STAGE_FLOATS,
    _bf16,
    _cdiv,
    _counted,
    _counter,
    _rb,
    _round4,
    _slices,
    _sm_count,
    _split_at,
    lstm_bptt_plain,
    lstm_recurrence_plain,
    tile_partial_floats,
    variant,
)
from vmlmf_tpu_torch.ops.pipeline import stack_cell_units, warn_fallback

KERNEL = "lstm_stack_fwd"
BWD_KERNEL = "lstm_stack_bwd"
REPLACES = "vmlmf_tpu/ops/pallas_pipeline.py:145"  # _mlfwd_kernel
BWD_REPLACES = "vmlmf_tpu/ops/pallas_pipeline.py:342"  # _mlbwd_kernel

MAX_LAYERS = 8  # kMaxLayers of both sources: the depth of their layer tables

# layer-dict keys: the recurrence of every layer, then the x side of layers >= 1
REC_KEYS = ("u", "v", "dvec")
X_KEYS = ("ux", "vx", "dxvec", "bias")

# the per-layer pointer tables of the C entries, in the order of their
# structs: operands, outputs, then the exchange and handoff buffers
FWD_FIELDS = ("u", "v", "dvec", "ux", "vx", "dxvec", "bias", "mask", "h0", "c0",
              "ys", "hlast", "clast", "cs", "gates", "hu", "xu", "hx", "px", "xx", "xt")
BWD_FIELDS = ("u", "v", "dvec", "ux", "vx", "dxvec", "mask", "h0", "c0",
              "ys", "cs", "gates", "hu", "xu", "dys", "dhlast", "dclast",
              "dpre", "dhu", "dxu", "du", "dv", "ddvec", "dux", "dvx", "ddxvec", "dbias",
              "dh0", "dc0", "dpx", "px", "dyx")


def _keys(l):
    return REC_KEYS + (X_KEYS if l else ())


def _sum4(a, h):
    return a[..., :h] + a[..., h:2 * h] + a[..., 2 * h:3 * h] + a[..., 3 * h:]


def _layer_input(ys_below, masks, l):
    """Layer l's input: the output of layer l - 1 times the mask of interface l."""
    return ys_below if masks is None else ys_below * masks[l - 1]


def lstm_stack_fwd_res_plain(gi0, layers, h0s, c0s, masks=None, precision="f32"):
    """The stack's function in torch ops, layer by layer (the kernel's
    pipelined walk is a schedule of the same arithmetic) -> (ys, cs, gates, hu, xu): lists over
    the layers of ys, cs [T,B,h], gates [T,B,4h] after the nonlinearities,
    hu = h_prev@u [T,B,r]; xu = x@ux [T,B,rx] for layers >= 1 only. Under
    bf16 the products take bf16-rounded operands; hu and xu are the f32
    products, before any rounding."""
    bf16 = _bf16(precision)
    ys, cs, gates, hus, xus = [], [], [], [], []
    gi = gi0
    for l, lay in enumerate(layers):
        if l:
            x = _layer_input(ys[-1], masks, l)
            xu = _rb(x, bf16) @ _rb(lay["ux"], bf16)
            xus.append(xu)
            gi = (_rb(xu, bf16) @ _rb(lay["vx"], bf16) + x.repeat(1, 1, 4) * lay["dxvec"]
                  + lay["bias"])
        y, c, g, hu = lstm_recurrence_plain(gi, lay["u"], lay["v"], lay["dvec"], h0s[l], c0s[l],
                                            precision)
        ys.append(y)
        cs.append(c)
        gates.append(g)
        hus.append(hu)
    return ys, cs, gates, hus, xus


def lstm_stack_scan_fused_plain(gi0, layers, h0s, c0s, masks=None, precision="f32"):
    """Same arguments and results as `lstm_stack_scan_fused`, in torch ops."""
    ys, cs = lstm_stack_fwd_res_plain(gi0, layers, h0s, c0s, masks, precision)[:2]
    return ys[-1], [y[-1] for y in ys], [c[-1] for c in cs]


def lstm_stack_bwd_plain(layers, h0s, c0s, masks, ys, cs, gates, hu, xu, dys, dhlast, dclast,
                         precision="f32"):
    """The stack's BPTT in torch ops, layer by layer from the top:
    each layer's serial reverse walk (`cuda_scan.lstm_bptt_plain`), then, for
    a layer l >= 1, its x-side gradients over all T*B rows and dx, which
    times the mask is the cotangent of layer l - 1's outputs. Under bf16
    the products take bf16-rounded operands (dpre, dXU, x, xu, the weights)
    and the dxvec terms and column sums the f32 dpre.

    ``dys`` [T,B,h] (the top layer's outputs) may be None; ``dhlast`` and
    ``dclast`` are lists whose items may be None (zeros). -> (dgi0 [T,B,4h],
    dlayers: a list of dicts keyed as the layers, dh0s, dc0s).
    """
    bf16 = _bf16(precision)
    n = len(layers)
    t, b, h = ys[0].shape
    dlayers, dh0s, dc0s = [None] * n, [None] * n, [None] * n
    dy = dys
    for l in range(n - 1, -1, -1):
        lay = layers[l]
        dpre, du, dv, ddvec, dh0s[l], dc0s[l] = lstm_bptt_plain(
            lay["u"], lay["v"], lay["dvec"], h0s[l], c0s[l], ys[l], cs[l], gates[l], hu[l], dy,
            dhlast[l], dclast[l], precision)
        dlayers[l] = {"u": du, "v": dv, "dvec": ddvec}
        if l == 0:
            return dpre, dlayers, dh0s, dc0s
        dpre2 = dpre.reshape(t * b, 4 * h)
        dp_mm = _rb(dpre2, bf16)
        x2 = _layer_input(ys[l - 1], masks, l).reshape(t * b, h)
        dxu_mm = _rb(dp_mm @ _rb(lay["vx"], bf16).T, bf16)
        dx = dxu_mm @ _rb(lay["ux"], bf16).T + _sum4(dpre2 * lay["dxvec"], h)
        dlayers[l].update(ux=_rb(x2, bf16).T @ dxu_mm,
                          vx=_rb(xu[l - 1].reshape(t * b, -1), bf16).T @ dp_mm,
                          dxvec=(dpre2 * x2.repeat(1, 4)).sum(0), bias=dpre2.sum(0))
        dy = _layer_input(dx.reshape(t, b, h), masks, l)


# -- the layout of the kernels ------------------------------------------------

def _wfloats(elems, elsize):
    """Floats of shared memory that ``elems`` weight elements of ``elsize``
    bytes take, rounded up to 16 bytes (scan_grid.cuh weight_floats)."""
    return _cdiv(elems * elsize, 16) * 4


def _red(phases, rpad):
    """Floats of slice partials that the products ``phases``, (depth,
    columns) each, want (scan_grid.cuh slice_product)."""
    red = 0
    for depth, cols in phases:
        items = _cdiv(cols, 4) * (rpad // 4)
        slices = _slices(items, depth) if items else 1
        red = max(red, slices * items * 16 if slices > 1 else 0)
    return red


def _rank_split(ctas, r, rx):
    """(ua, kwp, kxwp, packed) of a layer on ``ctas`` CTAs with ranks r and
    rx (0: layer 0), as scan_grid.cuh RankSlices has them: layer 0, and a
    layer on one CTA (``packed``), split r and rx over all its CTAs; a layer
    l >= 1 on more gives its first ``ua`` CTAs (in proportion r : rx) U's r
    columns and the others Ux's rx columns. kwp and kxwp: the padded widths
    of a CTA's U and Ux slices."""
    packed = rx == 0 or ctas == 1
    ua = ctas if packed else min(max((ctas * r + (r + rx) // 2) // (r + rx), 1), ctas - 1)
    kxwp = _round4(_cdiv(rx, 1 if packed else ctas - ua)) if rx else 0
    return ua, _round4(_cdiv(r, ua)), kxwp, packed


def _layer_layout(h, r, rx, ctas, rpad, elsize):
    """One layer's CTAs -> ((fwd floats, fwd phases), (bwd floats, bwd
    phases)): the floats of each kernel's carve without stage and red (the
    weight slices, the diagonal vectors and the [jwm][rpad] slabs, as
    lstm_stack_fwd.cu::fwd_smem_floats and lstm_stack_bwd.cu::
    bwd_smem_floats count them), and its products as (depth, columns)."""
    jwm = _cdiv(h, ctas)
    jwp = _round4(jwm)
    _, kwp, kxwp, packed = _rank_split(ctas, r, rx)
    u, ux = _wfloats(h * kwp, elsize), _wfloats(h * kxwp, elsize)
    kcols = kwp + kxwp if packed else max(kwp, kxwp)
    # forward: the U and/or Ux slice, [V; Vx] gate columns; dvec, dxvec,
    # bias; the carry (2 slabs) and gi0 (4) or x (1)
    fwd = ((u + ux if packed else max(u, ux)) + _wfloats((r + rx) * 4 * jwm, elsize) + 12 * jwm
           + (2 + (1 if rx else 4)) * jwm * rpad)
    # BPTT: the V^T and/or Vx^T slice, U^T and Ux^T j-slices; dvec, dxvec;
    # the carry (2), phase A's 7 inputs and, with an x side, its dxvec part (1)
    bwd = (_wfloats(4 * h * kcols, elsize) + _wfloats(r * jwp, elsize)
           + _wfloats(rx * jwp, elsize) + 8 * jwm + (9 + (1 if rx else 0)) * jwm * rpad)
    return ((fwd, [(h, kwp), (h, kxwp), (r + rx, 4 * jwm)]),
            (bwd, [(4 * h, kcols), (r, jwp), (rx, jwp)]))


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """How the stack kernels spread one stack over the card: ``groups``
    batch groups of consecutive rows, and in each, ``ctas[l]`` CTAs (one per
    SM) for layer l that hold its factor slices in shared memory for the
    whole launch, layer 0's first. CTA q of layer l owns the hidden units
    `j_range(l, q)` (all four gate columns of each), the rank columns
    `k_range(l, q)` and the x rank columns `kx_range(l, q)`. ``rpad``: a
    group's rows padded to a multiple of 4. Per kernel: ``stage`` and
    ``red``, floats of the staging buffer and of the slice partials;
    ``smem``, bytes of shared memory per CTA (the most that a layer's CTAs
    carve). ``elsize``: bytes of a weight element in shared memory, 4 (f32)
    or 2 (bf16)."""

    b: int
    h: int
    ranks: tuple
    xranks: tuple
    groups: int
    ctas: tuple
    rpad: int
    stage_fwd: int
    red_fwd: int
    smem_fwd: int
    stage_bwd: int
    red_bwd: int
    smem_bwd: int
    elsize: int = 4

    @property
    def n_ctas(self):
        return self.groups * sum(self.ctas)

    @property
    def smem_bytes(self):
        return max(self.smem_fwd, self.smem_bwd)

    def rx(self, l):
        return self.xranks[l - 1] if l else 0

    def rows(self, g):
        """Batch rows [b0, b1) of group g."""
        return _split_at(g, self.b, self.groups), _split_at(g + 1, self.b, self.groups)

    def j_range(self, l, q):
        """Hidden units [j0, j1) of CTA q of layer l."""
        return _split_at(q, self.h, self.ctas[l]), _split_at(q + 1, self.h, self.ctas[l])

    def k_range(self, l, q):
        """Rank columns [k0, k1) of CTA q of layer l (`_rank_split`)."""
        r = self.ranks[l]
        ua = _rank_split(self.ctas[l], r, self.rx(l))[0]
        return (_split_at(q, r, ua), _split_at(q + 1, r, ua)) if q < ua else (0, 0)

    def kx_range(self, l, q):
        """x rank columns [k0, k1) of CTA q of layer l (empty for layer 0)."""
        c, rx = self.ctas[l], self.rx(l)
        ua, _, _, packed = _rank_split(c, self.ranks[l], rx)
        if not rx or (q < ua and not packed):
            return 0, 0
        qx, cx = (0, 1) if packed else (q - ua, c - ua)
        return _split_at(qx, rx, cx), _split_at(qx + 1, rx, cx)

    def layer_ints(self):
        """(r, rx, ctas) per layer, as the C entries take them."""
        return [v for l, r in enumerate(self.ranks) for v in (r, self.rx(l), self.ctas[l])]

    def ints(self, kernel):
        """groups, rpad, stage, red, smem of ``kernel`` ("fwd" or "bwd")."""
        if kernel == "fwd":
            return self.groups, self.rpad, self.stage_fwd, self.red_fwd, self.smem_fwd
        return self.groups, self.rpad, self.stage_bwd, self.red_bwd, self.smem_bwd

    def describe(self):
        return (f"{self.groups} group(s) x {sum(self.ctas)} CTAs "
                f"({' + '.join(map(str, self.ctas))} by layer), rpad {self.rpad}, "
                f"{self.smem_fwd} / {self.smem_bwd} bytes of shared memory a CTA "
                f"(forward / BPTT), {self.elsize}-byte weights")


def _layer_work(h, ranks, xranks):
    """Multiply-adds of a row's step, per layer: the recurrent side, and the
    x side of a layer l >= 1 (rx = 0: none)."""
    return [h * r + r * 4 * h + h * rx + rx * 4 * h for r, rx in zip(ranks, (0, *xranks))]


def _split_ctas(total, work, h):
    """``total`` CTAs over the layers in proportion to ``work``: at least
    one each, at most h (one hidden unit a CTA), the remainder to the
    largest fractions."""
    s, n = sum(work), len(work)
    ctas = [min(h, max(1, total * w // s)) for w in work]
    order = sorted(range(n), key=lambda l: (-(total * work[l] % s), l))
    while sum(ctas) > total:
        ctas[max(range(n), key=lambda l: ctas[l])] -= 1
    for l in order * total:
        if sum(ctas) >= total:
            break
        if ctas[l] < h:
            ctas[l] += 1
    return tuple(ctas)


def stack_layout(b, h, ranks, xranks, groups, ctas, elsize=4, stage_floats=STAGE_FLOATS):
    """The StackPlan of ``groups`` batch groups with ``ctas[l]`` CTAs for
    layer l, staging at most ``stage_floats`` floats of an exchange buffer
    at once; `stack_plan` picks them."""
    rpad = _round4(_cdiv(b, groups))
    lays = [_layer_layout(h, r, rx, c, rpad, elsize)
            for r, rx, c in zip(ranks, (0, *xranks), ctas)]
    out = []
    for k in (0, 1):
        phases = [ph for lay in lays for ph in lay[k][1]]
        stage = min(max(d for d, _ in phases), max(2, stage_floats // rpad)) * rpad
        red = _red(phases, rpad)
        out += [stage, red, 4 * (max(lay[k][0] for lay in lays) + stage + red)]
    return StackPlan(b, h, tuple(ranks), tuple(xranks), groups, tuple(ctas), rpad, *out, elsize)


@functools.lru_cache(maxsize=256)
def stack_plan(b, h, ranks, xranks, sms=SMS, elsize=4):
    """The layout of the stack kernels for batch ``b``, hidden width ``h``,
    the layers' recurrent ``ranks`` and the x ranks of layers >= 1
    (``xranks``; tuples) on ``sms`` SMs, with weight slices of ``elsize``
    bytes an element (4, or 2 for the bf16 kernels) -> StackPlan.

    As `cuda_scan.scan_plan`: for each group count from min(b, sms) down
    (each group holds a full copy of every layer's factors), a group's CTAs
    are just enough for MIN_STEP_WORK each, then sms // groups; they are
    split over the layers in proportion to each layer's multiply-adds per
    row and step, so every CTA holds about the same share of the factors.
    Where the shared memory does not fit, the staging buffer is halved,
    twice. The first that fits wins. Raises ValueError when the factors do
    not fit in the shared memory of all SMs (`stack_chunks` cuts a batch
    whose staging does not fit into chunks of rows).
    """
    ranks, xranks = tuple(ranks), tuple(xranks)
    n = len(ranks)
    if (not 1 <= n <= MAX_LAYERS or len(xranks) != n - 1 or min(b, h, sms, *ranks) < 1
            or min(xranks, default=0) < 0 or elsize not in (2, 4)):
        raise ValueError(f"no stack plan for B={b}, h={h}, ranks {ranks}, x ranks {xranks} "
                         f"on {sms} SMs, {elsize}-byte weights")
    work = _layer_work(h, ranks, xranks)
    for groups in range(min(b, sms // n), 0, -1):
        most = sms // groups
        want = _round4(_cdiv(b, groups)) * sum(work)
        for total in sorted({min(most, max(n, _cdiv(want, MIN_STEP_WORK))), most}):
            ctas = _split_ctas(total, work, h)
            for stage in (STAGE_FLOATS, STAGE_FLOATS // 2, STAGE_FLOATS // 4):
                plan = stack_layout(b, h, ranks, xranks, groups, ctas, elsize, stage)
                if plan.smem_bytes <= SMEM_LIMIT:
                    return plan
    raise ValueError(f"the factors of the {n}-layer stack (h={h}, ranks {ranks}, x ranks "
                     f"{xranks}) do not fit in the shared memory of {sms} SMs at B={b}: "
                     f"split the stack with stack_groups")


@functools.lru_cache(maxsize=64)
def stack_chunks(b, h, ranks, xranks, sms=SMS, elsize=4):
    """The batch cut into as few chunks of consecutive rows as each have a
    `stack_plan`, their sizes at most one apart -> ((b_begin, b_count,
    plan), ...): one launch takes a chunk. One chunk up to the largest batch
    whose staging fits (B=164 for the f32 LM stack, 272 in bf16). Raises ValueError,
    naming stack_groups, when not even one row has a plan."""
    ranks, xranks = tuple(ranks), tuple(xranks)
    stack_plan(1, h, ranks, xranks, sms, elsize)
    for n in range(1, b + 1):
        bounds = [_split_at(i, b, n) for i in range(n + 1)]
        try:
            return tuple((b0, b1 - b0, stack_plan(b1 - b0, h, ranks, xranks, sms, elsize))
                         for b0, b1 in zip(bounds, bounds[1:]))
        except ValueError:
            continue
    raise AssertionError("one row has a plan, so b chunks of one row have")


def _stack_ranks(layers):
    """(ranks, x ranks) of a group's layer dicts; the group's first layer
    reads gi0, so its x side does not count (a layer without one: 0)."""
    ranks = tuple(lay["u"].shape[-1] for lay in layers)
    xranks = tuple(lay["ux"].shape[-1] if "ux" in lay else 0 for lay in layers[1:])
    return ranks, xranks


def _sizes(t, b, h, layers, h0s, c0s, masks):
    """(ranks, xranks) of a stack call; raises on a depth that the kernels'
    tables do not take or on mismatched lists."""
    n = len(layers)
    if not 1 <= n <= MAX_LAYERS:
        raise ValueError(f"the stack kernels take 1 to {MAX_LAYERS} layers, got {n}: "
                         f"split the stack with stack_groups")
    if len(h0s) != n or len(c0s) != n or (masks is not None and len(masks) != n - 1):
        raise ValueError(f"{n} layers need {n} h0s and c0s and {n - 1} masks")
    ranks = [lay["u"].shape[-1] for lay in layers]
    xranks = [lay["ux"].shape[-1] for lay in layers[1:]]
    if min(t, b, h, *ranks, *xranks) < 1:
        raise ValueError(f"empty stack: T={t}, B={b}, h={h}, ranks {ranks}, x ranks {xranks}")
    return ranks, xranks


def _check_tensor(name, a, want, dev):
    if tuple(a.shape) != want:
        raise ValueError(f"{name} must have shape {want}, got {tuple(a.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {a.dtype}: the stack kernels take f32 "
                        f"tensors in either precision")
    if a.device != dev:
        raise ValueError(f"{name} is on {a.device}, the stack's first input on {dev}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(dev, t, b, h, layers, h0s, c0s, masks, extra):
    """Validate a CUDA call's layers, states and masks on device ``dev`` at
    T, B, h, and ``extra``: (name, tensor or None, shape) triples ->
    (ranks, xranks)."""
    if dev.type != "cuda":
        raise ValueError(f"the stack runs on CPU or CUDA tensors, got {dev}")
    ranks, xranks = _sizes(t, b, h, layers, h0s, c0s, masks)
    for l, lay in enumerate(layers):
        if set(lay) != set(_keys(l)):
            raise ValueError(f"layer {l} must have the keys {_keys(l)}, got {sorted(lay)}")
        r, rx = ranks[l], xranks[l - 1] if l else 0
        want = {"u": (h, r), "v": (r, 4 * h), "dvec": (4 * h,), "h0": (b, h), "c0": (b, h),
                "ux": (h, rx), "vx": (rx, 4 * h), "dxvec": (4 * h,), "bias": (4 * h,),
                "mask": (t, b, h)}
        tensors = dict(lay, h0=h0s[l], c0=c0s[l])
        if l and masks is not None:
            tensors["mask"] = masks[l - 1]
        for key, a in tensors.items():
            _check_tensor(f"layer {l} {key}", a, want[key], dev)
    for name, a, shape in extra:
        if a is not None:
            _check_tensor(name, a, shape, dev)
    return ranks, xranks


def _on_cpu(gi0, layers, h0s, c0s, masks, extra=()):
    tensors = [gi0, *h0s, *c0s, *(masks or ()), *extra]
    tensors += [a for lay in layers for a in lay.values()]
    return all(a is None or a.device.type == "cpu" for a in tensors)


def _table(fields, per_layer):
    """A ctypes array of the layers' pointers, ``fields`` per layer in order
    (a missing or None tensor is a null pointer)."""
    ptrs = [None if d.get(k) is None else d[k].data_ptr() for d in per_layer for k in fields]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _launch(kernel, tables, plan, pointers, sizes, device):
    """Call C entry ``kernel`` of csrc/<kernel>.cu on the current stream with
    its pointer table, the plan's per-layer integers, the tensors
    ``pointers`` (their data pointers), the integer sizes and the stream.
    Raises on the non-zero cudaError it returns: a plan the kernel cannot
    take, a launch refused, or a grid too large to be co-resident (no
    fallback)."""
    lib = _build.load(kernel)
    fn = getattr(lib, kernel)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * len(sizes)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    layer_ints = plan.layer_ints()
    ints = (ctypes.c_int * len(layer_ints))(*layer_ints)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(tables, ints, *(a.data_ptr() for a in pointers), *sizes, stream)
    if err != 0:
        describe = getattr(lib, f"{kernel}_error")
        describe.argtypes, describe.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{kernel} launch failed: {describe(err).decode()} (cudaError {err})")


def _chunks_for(b, h, ranks, xranks, device, bf16):
    return stack_chunks(b, h, tuple(ranks), tuple(xranks), _sm_count(device.index),
                        2 if bf16 else 4)


def _room(chunks, units):
    """Floats of an exchange buffer of ``units`` units a row that every
    chunk's plan can use: the most groups x rpad of any."""
    return max(plan.groups * plan.rpad for _, _, plan in chunks) * units


def _sync_words(chunks, n, like):
    """One barrier word per layer and batch group; the launcher zeroes them."""
    return torch.empty(n * max(plan.groups for _, _, plan in chunks), dtype=torch.int32,
                       device=like.device)


def _fwd(entry, gi0, layers, h0s, c0s, masks, residuals, precision):
    """Launch the forward stack, one launch a chunk of rows, each counted
    under ``entry`` -> the per-layer dicts of its outputs."""
    bf16 = _bf16(precision)
    if gi0.dim() != 3 or gi0.shape[-1] % 4:
        raise ValueError(f"gi0 must be [T, B, 4h], got {tuple(gi0.shape)}")
    t, b, h = gi0.shape[0], gi0.shape[1], gi0.shape[2] // 4
    ranks, xranks = _check(gi0.device, t, b, h, layers, h0s, c0s, masks,
                           [("gi0", gi0, (t, b, 4 * h))])
    n = len(layers)
    with torch.cuda.device(gi0.device):
        chunks = _chunks_for(b, h, ranks, xranks, gi0.device, bf16)
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=gi0.device)  # noqa: E731
        per_layer = []
        for l, lay in enumerate(layers):
            rx = xranks[l - 1] if l else 0
            d = dict(lay, h0=h0s[l], c0=c0s[l], hx=new(_room(chunks, h)),
                     px=new(_room(chunks, ranks[l] + rx)))
            if residuals:
                d.update(ys=new(t, b, h), cs=new(t, b, h), gates=new(t, b, 4 * h),
                         hu=new(t, b, ranks[l]))
            else:
                d.update(ys=new(t, b, h) if l == n - 1 else None, hlast=new(b, h),
                         clast=new(b, h))
            if l:
                d.update(mask=None if masks is None else masks[l - 1],
                         xu=new(t, b, rx) if residuals else None,
                         xx=new(_room(chunks, t * h)),
                         xt=new(_room(chunks, t * h)) if bf16 else None)
            per_layer.append(d)
        table, sync = _table(FWD_FIELDS, per_layer), _sync_words(chunks, n, gi0)
        for b0, rows, plan in chunks:
            _launch(KERNEL, table, plan, (gi0, sync),
                    (n, t, b, b0, rows, h, *plan.ints("fwd"), int(residuals), int(bf16)),
                    gi0.device)
            _counted(entry, variant(precision))
    return per_layer


def _needs_grad(gi0, layers, h0s, c0s, masks):
    tensors = [gi0, *h0s, *c0s, *(masks or ()), *(a for lay in layers for a in lay.values())]
    return torch.is_grad_enabled() and any(a.requires_grad for a in tensors)


@_counter
def lstm_stack_scan_fused(gi0, layers, h0s, c0s, masks=None, precision="f32"):
    """The wavefront stack, no gradient.

    gi0 [T, B, 4h]: layer 0's input contribution (gate order i, f, g, o).
    layers: a list of dicts, ``{u [h, r], v [r, 4h], dvec [4h]}`` for layer
    0 and also ``{ux [h, rx], vx [rx, 4h], dxvec [4h], bias [4h]}`` for
    layers >= 1 (the ranks may differ by layer); h0s, c0s: lists of [B, h];
    masks: None or L - 1 pre-scaled dropout masks [T, B, h], masks[l - 1]
    applied to layer l's input; ``precision`` "f32" or "bf16" (bf16-rounded
    product operands, f32 sums). -> (ys_last [T, B, h], hlast, clast: lists
    of [B, h]).

    CPU tensors run `lstm_stack_scan_fused_plain`. CUDA tensors must be f32,
    contiguous and on one device, at most MAX_LAYERS layers, with a
    `stack_plan` (else ValueError: split the stack with `stack_groups`); the
    kernel runs on the current stream, one cooperative launch for each chunk
    of rows (`stack_chunks`; one up to B=164 in f32), and
    ``lstm_stack_scan_fused.launches`` counts those launches (``.variants``
    by precision). A CUDA input that requires a gradient, with grad mode on,
    raises: that call belongs to `LSTMStackScan`.
    """
    if _on_cpu(gi0, layers, h0s, c0s, masks):
        return lstm_stack_scan_fused_plain(gi0, layers, h0s, c0s, masks, precision)
    if _needs_grad(gi0, layers, h0s, c0s, masks):
        raise RuntimeError("lstm_stack_scan_fused computes no gradient; inputs that require "
                           "one go through LSTMStackScan (stack_scan)")
    out = _fwd(lstm_stack_scan_fused, gi0, layers, h0s, c0s, masks, False, precision)
    return out[-1]["ys"], [d["hlast"] for d in out], [d["clast"] for d in out]


@_counter
def lstm_stack_scan_fused_res(gi0, layers, h0s, c0s, masks=None, precision="f32"):
    """The residual forward of training: `lstm_stack_scan_fused` that returns
    the backward's residuals instead -> (ys, cs, gates, hu, xu), shaped as
    `lstm_stack_fwd_res_plain`'s, which CPU tensors run. The final state of
    layer l is (ys[l][-1], cs[l][-1]). ``lstm_stack_scan_fused_res.launches``
    counts the kernel's launches, one a chunk of rows (``.variants`` by
    precision)."""
    if _on_cpu(gi0, layers, h0s, c0s, masks):
        return lstm_stack_fwd_res_plain(gi0, layers, h0s, c0s, masks, precision)
    out = _fwd(lstm_stack_scan_fused_res, gi0, layers, h0s, c0s, masks, True, precision)
    return ([d["ys"] for d in out], [d["cs"] for d in out], [d["gates"] for d in out],
            [d["hu"] for d in out], [d["xu"] for d in out[1:]])


@_counter
def lstm_stack_bwd(layers, h0s, c0s, masks, ys, cs, gates, hu, xu, dys, dhlast, dclast,
                   precision="f32"):
    """Gradients of the stack from the residual forward's outputs and the
    cotangents ``dys`` [T, B, h] of the top layer's outputs and ``dhlast``,
    ``dclast`` (lists of [B, h]); dys and any item of the lists may be None
    (zeros). ``precision`` must be the forward's. -> (dgi0 [T, B, 4h],
    dlayers: a list of dicts keyed as the layers, dh0s, dc0s).

    CPU tensors run `lstm_stack_bwd_plain`; CUDA tensors launch the BPTT
    (one cooperative launch of the walk for each chunk of rows, the weight
    GEMMs after the last), each launch counted by ``lstm_stack_bwd.launches``
    (``.variants`` by precision).
    """
    bf16 = _bf16(precision)
    res = (*ys, *cs, *gates, *hu, *xu)
    cots = (dys, *dhlast, *dclast)
    n = len(layers)
    if _on_cpu(ys[0], layers, h0s, c0s, masks, (*res, *cots)):
        return lstm_stack_bwd_plain(layers, h0s, c0s, masks, ys, cs, gates, hu, xu, dys,
                                    dhlast, dclast, precision)
    if len(ys) != n or len(xu) != n - 1 or len(dhlast) != n or len(dclast) != n:
        raise ValueError(f"{n} layers need {n} ys, cs, gates, hu, dhlast, dclast and "
                         f"{n - 1} xu")
    t, b, h = ys[0].shape
    ranks = [lay["u"].shape[-1] for lay in layers]
    extra = [("dys", dys, (t, b, h))]
    for l in range(n):
        extra += [(f"layer {l} ys", ys[l], (t, b, h)), (f"layer {l} cs", cs[l], (t, b, h)),
                  (f"layer {l} gates", gates[l], (t, b, 4 * h)),
                  (f"layer {l} hu", hu[l], (t, b, ranks[l])),
                  (f"layer {l} dhlast", dhlast[l], (b, h)),
                  (f"layer {l} dclast", dclast[l], (b, h))]
        if l:
            extra.append((f"layer {l} xu", xu[l - 1], (t, b, layers[l]["ux"].shape[-1])))
    ranks, xranks = _check(ys[0].device, t, b, h, layers, h0s, c0s, masks, extra)
    dev = ys[0].device
    with torch.cuda.device(dev):
        chunks = _chunks_for(b, h, ranks, xranks, dev, bf16)
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
        dgi0 = new(t, b, 4 * h)
        per_layer = []
        for l, lay in enumerate(layers):
            rx = xranks[l - 1] if l else 0
            d = dict(lay, h0=h0s[l], c0=c0s[l], ys=ys[l], cs=cs[l], gates=gates[l], hu=hu[l],
                     dys=dys if l == n - 1 else None, dhlast=dhlast[l], dclast=dclast[l],
                     dpre=dgi0 if l == 0 else new(t, b, 4 * h), dhu=new(t, b, ranks[l]),
                     du=torch.empty_like(lay["u"]), dv=torch.empty_like(lay["v"]),
                     ddvec=new(4 * h), dh0=new(b, h), dc0=new(b, h),
                     dpx=new(_room(chunks, 4 * h)), px=new(_room(chunks, ranks[l] + rx)),
                     dyx=new(_room(chunks, t * h)) if l < n - 1 else None)
            if l:
                d.update(mask=None if masks is None else masks[l - 1], xu=xu[l - 1],
                         dxu=new(t, b, rx), dux=torch.empty_like(lay["ux"]),
                         dvx=torch.empty_like(lay["vx"]), ddxvec=new(4 * h), dbias=new(4 * h))
            per_layer.append(d)
        # split-k scratch for the weight gradients, whose k is T*B
        partial = new(max(1, *(tile_partial_floats(t, b, h, xranks[l - 1] if l else 0, h, r,
                                                   gi=l == 0) for l, r in enumerate(ranks))))
        table, sync = _table(BWD_FIELDS, per_layer), _sync_words(chunks, n, dgi0)
        for i, (b0, rows, plan) in enumerate(chunks):  # the weight gradients after the last
            _launch(BWD_KERNEL, table, plan, (sync, partial),
                    (partial.numel(), n, t, b, b0, rows, h, *plan.ints("bwd"),
                     int(i == len(chunks) - 1), int(bf16)), dev)
            _counted(lstm_stack_bwd, variant(precision))
    dlayers = [{k: d["d" + k] for k in _keys(l)} for l, d in enumerate(per_layer)]
    return dgi0, dlayers, [d["dh0"] for d in per_layer], [d["dc0"] for d in per_layer]


def _flatten(gi0, layers, h0s, c0s, masks):
    return (gi0, *(lay[k] for l, lay in enumerate(layers) for k in _keys(l)), *h0s, *c0s,
            *(masks or ()))


def _unflatten(flat, n):
    it = iter(flat)
    gi0 = next(it)
    layers = [{k: next(it) for k in _keys(l)} for l in range(n)]
    h0s = [next(it) for _ in range(n)]
    c0s = [next(it) for _ in range(n)]
    masks = list(it) or None
    return gi0, layers, h0s, c0s, masks


class LSTMStackScan(torch.autograd.Function):
    """The differentiable stack: the residual forward, then the BPTT.

    ``LSTMStackScan.apply(L, precision, *flat)`` with flat = (gi0, each
    layer's tensors in `REC_KEYS` then `X_KEYS` order, h0s, c0s, masks or
    nothing) ->
    (ys_last, *hlast, *clast), with gradients for every tensor but the masks,
    which get none. A cotangent that autograd leaves out (an output no loss
    reads, as the LM's detached final states) comes to the backward as None
    and is read there as zeros.
    """

    @staticmethod
    def forward(ctx, n_layers, precision, *flat):
        gi0, layers, h0s, c0s, masks = _unflatten(flat, n_layers)
        ys, cs, gates, hu, xu = lstm_stack_scan_fused_res(gi0, layers, h0s, c0s, masks,
                                                          precision)
        ctx.n_layers, ctx.n_masks, ctx.precision = n_layers, len(masks or ()), precision
        ctx.save_for_backward(*flat[1:], *ys, *cs, *gates, *hu, *xu)
        ctx.set_materialize_grads(False)
        return (ys[-1], *(y[-1].clone() for y in ys), *(c[-1].clone() for c in cs))

    @staticmethod
    def backward(ctx, dys, *dstates):
        n = ctx.n_layers
        saved = list(ctx.saved_tensors)
        n_inputs = len(saved) - (5 * n - 1)
        _, layers, h0s, c0s, masks = _unflatten([None, *saved[:n_inputs]], n)
        res = saved[n_inputs:]
        ys, cs, gates, hu = (res[i * n:(i + 1) * n] for i in range(4))
        xu = res[4 * n:]
        cont = lambda a: None if a is None else a.contiguous()  # noqa: E731
        dgi0, dlayers, dh0s, dc0s = lstm_stack_bwd(
            layers, h0s, c0s, masks, ys, cs, gates, hu, xu, cont(dys),
            [cont(a) for a in dstates[:n]], [cont(a) for a in dstates[n:]], ctx.precision)
        grads = (dgi0, *(d[k] for l, d in enumerate(dlayers) for k in _keys(l)), *dh0s, *dc0s)
        return (None, None, *grads, *([None] * ctx.n_masks))


def stack_scan(gi0, layers, h0s, c0s, masks=None, precision="f32"):
    """The stack through `LSTMStackScan` when grad mode is on and an input
    requires a gradient, else through the no-grad `lstm_stack_scan_fused`.
    -> (ys_last, hlast list, clast list)."""
    if not _needs_grad(gi0, layers, h0s, c0s, masks):
        return lstm_stack_scan_fused(gi0, layers, h0s, c0s, masks, precision)
    n = len(layers)
    out = LSTMStackScan.apply(n, precision, *_flatten(gi0, layers, h0s, c0s, masks))
    return out[0], list(out[1:1 + n]), list(out[1 + n:])


def stack_units(cells, preps):
    """The cells' `pipeline_units` as the stack's layer dicts (contiguous),
    or None when the stack cannot run as one: fewer than two layers, unequal
    hidden sizes, or a cell without units. The ranks may differ by layer."""
    units = stack_cell_units(cells, preps)
    if units is None:
        return None
    layers = []
    for l, un in enumerate(units):
        d = {"u": un["u_h"], "v": un["v_h"], "dvec": un["d_h"].reshape(-1)}
        if l:
            d.update(ux=un["u_x"], vx=un["v_x"], dxvec=un["d_x"].reshape(-1), bias=un["bias"])
        layers.append({k: a.contiguous() for k, a in d.items()})
    return layers


def stack_fits(layers):
    """True when the stack kernels take the group: at most MAX_LAYERS layers
    (the fixed depth of the kernels' layer tables), and a `stack_plan` at f32
    for one row, so that its factors fit in the shared memory of the card's
    SMs; `stack_chunks` runs a larger batch in chunks of rows. Independent of
    precision and batch, as the JAX package's is (bf16 slices take half the
    bytes, so a group that fits in f32 fits in bf16). A 2x650 w300/u300
    stack holds 11.7 MB of factors, a 3x650 one 19.5 MB."""
    if layers is None or not 1 <= len(layers) <= MAX_LAYERS:
        return False
    try:
        stack_plan(1, layers[0]["u"].shape[0], *_stack_ranks(layers))
    except ValueError:
        return False
    return True


def stack_groups(layers):
    """Partition the stack into maximal contiguous groups that `stack_fits`
    takes -> a list of half-open (start, end) pairs. A singleton group runs
    the per-layer fused scan."""
    groups, i, n = [], 0, len(layers)
    while i < n:
        j = n
        while j - i >= 2 and not stack_fits(layers[i:j]):
            j -= 1
        groups.append((i, max(j, i + 1)))
        i = max(j, i + 1)
    return groups


def _group_layers(layers, start, end):
    """The group's layer dicts. Its first layer reads gi0, so its x side is
    dropped: the caller's `inp` applies it."""
    return [{k: layers[i][k] for k in _keys(i - start)} for i in range(start, end)]


def run_stack_grouped(cells, preps, xs, states, masks=None, precision="f32"):
    """A stack of cells through the wavefront kernels, group by group
    (`stack_groups`); a singleton group, or every layer of a stack that
    `stack_units` refuses (after `warn_fallback`), runs the per-layer
    "fused" scan.

    xs: time-major [T, B, n]; states: per-layer (h0, c0); masks: None or L -
    1 pre-scaled dropout masks, masks[i] applied to the output of layer i.
    Within a group they run inside the kernel; at a group boundary they
    multiply the handoff. ``precision`` ("f32" or "bf16") goes to the groups
    and to the per-layer scans alike; the grouping does not depend on it.
    -> (ys [T, B, h], final states list).
    """
    from vmlmf_tpu_torch.nn.recurrence import scan_layer  # recurrence imports this module

    n = len(cells)
    layers = stack_units(cells, preps)
    finals = [None] * n
    x = xs
    if layers is None:
        warn_fallback(cells)
        for i, (cell, prep) in enumerate(zip(cells, preps)):
            x, finals[i] = scan_layer(cell, prep, x, states[i], backend="fused",
                                      precision=precision)
            if masks is not None and i < n - 1:
                x = x * masks[i]
        return x, finals
    for start, end in stack_groups(layers):
        if end - start == 1:
            x, finals[start] = scan_layer(cells[start], preps[start], x, states[start],
                                          backend="fused", precision=precision)
        else:
            gi0 = cells[start].inp(preps[start], x).contiguous()
            gmasks = None if masks is None else [masks[i] for i in range(start, end - 1)]
            x, hl, cl = stack_scan(gi0, _group_layers(layers, start, end),
                                   [states[i][0].contiguous() for i in range(start, end)],
                                   [states[i][1].contiguous() for i in range(start, end)],
                                   gmasks, precision)
            for i in range(start, end):
                finals[i] = (hl[i - start], cl[i - start])
        if masks is not None and end < n:
            x = x * masks[end - 1]  # the group boundary's inter-layer dropout
    return x, finals


def _row_ops(h, r, rx):
    """Operations per batch row and step of one layer (rx = 0 for layer 0):
    two per multiply-add of the recurrent and x-side products, 6 per gate
    element (the x term and bias or gi0, the h term, the sums) and 9 per
    hidden unit (the nonlinearities and the state update), one for the mask."""
    ops = 2 * (h * r + r * 4 * h) + 6 * 4 * h + 9 * h
    return ops + (2 * (h * rx + rx * 4 * h) + h if rx else 0)


def stack_mm_ops(t, b, h, ranks, xranks):
    """Operations of the forward's matrix products (two per multiply-add of
    every layer's recurrent and x-side products over all T*B rows): the
    share of `stack_cost`'s operations that bf16 moves to the tensor-core
    rate. The BPTT's products are twice these."""
    return 2 * t * b * sum(h * r + r * 4 * h + (h * rx + rx * 4 * h if rx else 0)
                           for r, rx in zip(ranks, [0, *xranks]))


def _weight_floats(h, ranks, xranks):
    rec = sum(h * r + r * 4 * h + 4 * h for r in ranks)
    return rec + sum(h * rx + rx * 4 * h + 2 * 4 * h for rx in xranks)


def stack_cost(t, b, h, ranks, xranks, *, masks=False):
    """(operations, bytes) that the no-grad stack needs at least, for its
    roofline bound: `_row_ops` over every layer, row and step; each input
    read once (gi0, the weights, the masks, h0s, c0s) and each output
    written once (ys_last, hlast, clast), f32."""
    n = len(ranks)
    ops = t * b * sum(_row_ops(h, r, xranks[l - 1] if l else 0) for l, r in enumerate(ranks))
    floats = (t * b * 4 * h + _weight_floats(h, ranks, xranks)
              + (n - 1) * t * b * h * masks + 2 * n * b * h + t * b * h + 2 * n * b * h)
    return ops, 4 * floats


def stack_res_cost(t, b, h, ranks, xranks, *, masks=False):
    """(operations, bytes) of the residual forward: `stack_cost` with the
    residual outputs in place of hlast and clast: the ys of the lower layers,
    cs, gates, hu and xu, each written once."""
    ops, nbytes = stack_cost(t, b, h, ranks, xranks, masks=masks)
    n = len(ranks)
    res = t * b * ((n - 1) * h + n * h + n * 4 * h + sum(ranks) + sum(xranks))
    return ops, nbytes + 4 * (res - 2 * n * b * h)


def stack_bwd_cost(t, b, h, ranks, xranks, *, masks=False):
    """(operations, bytes) that the BPTT needs at least, for its roofline
    bound. Operations: twice each forward product (the data gradient along
    the chain and the weight gradients), 30 per hidden unit for dpre, the
    carry and the column sums, and the masks. Bytes: each residual and
    cotangent read once (the ys, cs, gates, hu, xu, the masks, dys),
    the weights, h0s and c0s, and each gradient written once (dgi0, the
    weight gradients, dh0s, dc0s), f32."""
    n = len(ranks)
    ops = 0
    for l, r in enumerate(ranks):
        rx = xranks[l - 1] if l else 0
        ops += 2 * 2 * (h * r + r * 4 * h + (h * rx + rx * 4 * h if rx else 0)) + 30 * h
        ops += 2 * h if rx and masks else 0
    ops *= t * b
    weights = _weight_floats(h, ranks, xranks)
    res = t * b * (n * h + n * h + n * 4 * h + sum(ranks) + sum(xranks))
    inputs = weights + 2 * n * b * h + res + (n - 1) * t * b * h * masks + t * b * h
    outputs = t * b * 4 * h + weights + 2 * n * b * h
    return ops, 4 * (inputs + outputs)
