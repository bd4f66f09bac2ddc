"""Fault 11: layers too wide for the shared memory of all SMs, on the CPU.

The JAX package computes an LSTM or GRU layer of any width (its Pallas
scan where the weights fit in VMEM, else its XLA scan). The port's scan
kernels hold the recurrent weights in shared memory, so past some width no
plan took a layer: a dense LSTM h >= 1,058 in f32 (the PTB "large" LM's
1500 x 6000 U), a dense "post" GRU past h = 3,056. Now `cuda_scan.scan_plan`
streams the weight rows that do not fit through L2 from a device-memory
scratch (`ScanPlan.resident_fwd`, `stream_floats`), and `cuda_gru.gru_plan`
keeps the leading state regions that do not fit in device memory
(`GRUPlan.spill_fwd`, `state_floats`).

Here every width in range gets a plan (or chunks of rows) that the kernels'
own region arithmetic accepts, every shape that had a plan before keeps it
(held to copies of the earlier plan functions, kept in this file), an
emulation of the kernels' phases on streamed plans, with each CTA's slices
split into their resident and streamed rows, is held to the plain walks and
to the JAX kernel and its VJP, and the port's dense LM at h = 1500 is held
to the JAX package's.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu.config import LMConfig as JaxLMConfig  # noqa: E402
from vmlmf_tpu.ops.pallas_scan import lstm_scan_fused_xin as jax_scan  # noqa: E402
from vmlmf_tpu_torch.config import LMConfig  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_gru, cuda_scan  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

SMS = 132  # an H100 SXM
SMEM_LIMIT = cuda_scan.SMEM_LIMIT
EMU_TOL = dict(atol=1e-6, rtol=1e-6)  # float64: only the order of sums differs
FWD_TOL = dict(atol=2e-5, rtol=2e-5)  # f32 against the JAX kernel (tests/test_pallas.py)
GRAD_TOL = dict(atol=3e-4, rtol=3e-4)

# every width to 2048, then every 64th to 4096; the GRU's to 8192
LSTM_WIDTHS = list(range(1, 2049)) + list(range(2112, 4097, 64))
GRU_WIDTHS = list(range(1, 4097)) + list(range(4160, 8193, 64))
BATCHES = (1, 20, 128)


def ranks(h):
    """The recurrent ranks of a width: dense (0) and r in h/4, h/2, h."""
    return sorted({0, *(r for r in (h // 4, h // 2, h) if r >= 1)})


# -- the kernels' region arithmetic, as lstm_scan_xin_fwd.cu / _bwd.cu check it

def weight_floats(elems, elsize):
    return -(-elems * elsize // 16) * 4


def ring_ld(cols, elsize):
    """A streamed row's elements in a CTA's region: 16-byte rows."""
    return -(-cols * elsize // 16) * 16 // elsize


def round16(n):
    return -(-n // 16) * 16


def mma_kernel_accepts(plan):
    """The checks of the kernels' mma launches (`scan_mma`, `bptt_mma`) and
    the walk they run: rows padded to 8 and exchange rows of xld = rpad
    made 8 mod 16; resident depths in whole 16-row blocks (or the whole
    depth); the carve (bf16 blocks, the staging buffer or the ring, `red`
    holding each product's sums, [rpad][cols made 4 mod 8]) within the
    plan's shared bytes and the card's; the streamed scratch holding every
    CTA's blocks past the resident ones; a ring in each kernel, streaming
    or not, whose stages hold a block of each product, cut into pieces of
    whole blocks that each fit a stage (in bytes); no staging buffer."""
    h, r, dense = plan.h, plan.r, plan.r == 0
    rpad = plan.rpad
    assert plan.mma and plan.elsize == 2 and rpad >= 8 and rpad % 8 == 0
    xld = rpad if rpad % 16 else rpad + 8
    assert xld == plan.xld and xld % 16 == 8
    jwm = -(-h // plan.ctas)
    jwp, kwp = -(-jwm // 4) * 4, 0 if dense else -(-(-(-r // plan.ctas)) // 4) * 4
    for kernel, slab, (ca, cb), depth_a, depth_b in (
            ("fwd", 6, (kwp, 4 * jwm), h, r or h), ("bwd", 9, (kwp, jwp), 4 * h, r or 4 * h)):
        ra, rb = plan.resident(kernel)
        for res, depth in ((rb, depth_b),) + (() if dense else ((ra, depth_a),)):
            assert 0 <= res <= depth and (res == depth or res % 16 == 0)
        ma = 0 if dense else (round16(depth_a) if ra >= depth_a else ra)
        mb = round16(depth_b) if rb >= depth_b else rb
        stage, red, smem = ((plan.stage_fwd, plan.red_fwd, plan.smem_fwd) if kernel == "fwd"
                            else (plan.stage_bwd, plan.red_bwd, plan.smem_bwd))
        products = ([] if dense else [(depth_a, ca)]) + [(depth_b, cb)]  # the walk's order
        for depth, cols in products:
            assert red >= rpad * (cols if cols % 8 else cols + 4)
        piece = plan.piece(kernel)
        carve = (weight_floats(ma * ca + mb * cb, 2) + 4 * jwm + slab * jwm * rpad
                 + (2 * (piece + 4) if piece else stage) + red)
        assert 4 * carve <= smem <= SMEM_LIMIT
        streamed = weight_floats((0 if dense else (round16(depth_a) - ma) * ca)
                                 + (round16(depth_b) - mb) * cb, 2)
        assert streamed * plan.n_ctas <= cuda_scan.stream_floats(plan, kernel)
        assert (streamed > 0) == (plan.streamed_elems(kernel) > 0)
        assert stage == 0 and piece > 0
        if piece:
            assert piece % 4 == 0
            assert len(plan.walk(kernel)) == len(products)
            for (depth, cols), res, (d, _, rows, pieces) in zip(
                    products, ([] if dense else [ma]) + [mb], plan.walk(kernel)):
                assert d == depth and 4 * piece >= 32 * (xld + cols)
                assert pieces[0][0] == 0 and pieces[-1][1] == round16(depth)
                for (e0, e1), nxt in zip(pieces, pieces[1:] + ((pieces[-1][1], None),)):
                    assert e0 % 16 == 0 and e1 % 16 == 0 and e1 > e0 and nxt[0] == e1
                    if e1 <= res:  # the exchange alone
                        assert 2 * (e1 - e0) * xld <= 4 * piece
                    else:  # `rows` rows of it, then the streamed blocks
                        assert e0 >= res and e1 - e0 <= rows
                        assert 2 * rows * xld + 2 * (e1 - e0) * cols <= 4 * piece


def kernel_accepts(plan):
    """The checks the scan kernels make before a launch (`scan` and `bptt`):
    resident depths within their slices, the carve (the staging buffer, or
    on a streamed plan the ring: its stages and two 8-byte barriers a
    stage) within the plan's shared bytes and the card's, the streamed
    scratch that `stream_floats` sizes holding every CTA's region of
    16-byte rows, and a ring exactly where a kernel streams, of whole
    16-byte stages that hold a row of each product. An mma plan's checks
    are `mma_kernel_accepts`'."""
    if plan.mma:
        return mma_kernel_accepts(plan)
    h, r, dense = plan.h, plan.r, plan.r == 0
    jwm = -(-h // plan.ctas)
    jwp, kwp = -(-jwm // 4) * 4, 0 if dense else -(-(-(-r // plan.ctas)) // 4) * 4
    for kernel, slab, (ca, cb), depth_a, depth_b in (
            ("fwd", 6, (kwp, 4 * jwm), h, r or h), ("bwd", 9, (kwp, jwp), 4 * h, r or 4 * h)):
        ra, rb = plan.resident(kernel)
        assert 0 <= rb <= depth_b and (ra == 0 if dense else 0 <= ra <= depth_a)
        stage, red, smem = ((plan.stage_fwd, plan.red_fwd, plan.smem_fwd) if kernel == "fwd"
                            else (plan.stage_bwd, plan.red_bwd, plan.smem_bwd))
        piece = plan.piece(kernel)
        carve = (weight_floats(ra * ca + rb * cb, plan.elsize) + 4 * jwm
                 + slab * jwm * plan.rpad + (2 * (piece + 4) if piece else stage) + red)
        assert 4 * carve <= smem <= SMEM_LIMIT
        streamed = weight_floats((0 if dense else (depth_a - ra) * ring_ld(ca, plan.elsize))
                                 + (depth_b - rb) * ring_ld(cb, plan.elsize), plan.elsize)
        assert streamed * plan.n_ctas <= cuda_scan.stream_floats(plan, kernel)
        assert (streamed > 0) == (plan.streamed_elems(kernel) > 0) == (piece > 0)
        if piece:
            assert piece % 4 == 0
            for cols in ((ca, cb) if not dense else (cb,)):
                assert 4 * piece >= 4 * plan.rpad + ring_ld(cols, plan.elsize) * plan.elsize


def chunks_cover(b, h, r, elsize, sms=SMS):
    chunks = cuda_scan.scan_chunks(b, h, r, sms, elsize)
    at = 0
    for b0, n, plan in chunks:
        assert b0 == at and n >= 1 and plan.b == n and plan.elsize == elsize
        at += n
        kernel_accepts(plan)
    assert at == b
    return chunks


@pytest.mark.parametrize("elsize", [4, 2], ids=["f32", "bf16"])
def test_every_lstm_width_has_a_plan_or_chunks(elsize):
    streamed = []
    for h in LSTM_WIDTHS:
        for r in ranks(h):
            for b in BATCHES:
                chunks = chunks_cover(b, h, r, elsize)
                if chunks[0][2].streamed:
                    streamed.append((h, r, b))
    # the first streamed dense width at one row: about 1,058 in f32, 1,590 in bf16
    first = min(h for h, r, b in streamed if r == 0 and b == 1)
    assert first == (1057 if elsize == 4 else 1585)
    assert not any(h < 1000 for h, _, _ in streamed)


def test_the_ptb_large_layer_streams_in_f32_and_not_in_bf16():
    f32 = cuda_scan.scan_plan(20, 1500, 0)
    assert f32.streamed and (f32.groups, f32.ctas) == (1, SMS)
    # about 34 MB of the 36 MB U streamed a step (16 MB before the ring took
    # the shared memory of most resident rows), as much again in the BPTT
    assert 32e6 < 4 * cuda_scan.stream_floats(f32, "fwd") < 36e6
    assert not cuda_scan.scan_plan(20, 1500, 0, SMS, 2).streamed
    # bf16 at B=128: three resident chunks before the ring, now one streamed
    # launch, which measured faster in every entry
    (chunk,) = cuda_scan.scan_chunks(128, 1500, 0, SMS, 2)
    assert chunk[2].streamed and chunk[2].elsize == 2 and chunk[2].n_ctas == SMS
    assert not cuda_scan.scan_chunks(20, 1500, 0, SMS, 2)[0][2].streamed  # resident, as before
    assert len(cuda_scan.scan_chunks(128, 1500, 0, SMS, 4)) == 1


# -- the plans before fault 11's repair, copied from cuda_scan.py and cuda_gru.py

def parent_plan_layout(b, h, r, groups, ctas, elsize=4):
    rpad = cuda_scan._round4(cuda_scan._cdiv(b, groups))
    jwm = cuda_scan._cdiv(h, ctas)
    jwp, kwp = cuda_scan._round4(jwm), cuda_scan._round4(cuda_scan._cdiv(r, ctas))
    layout = functools.partial(cuda_scan._kernel_layout, h, ctas, rpad)
    if r == 0:
        fwd = layout([(h, 4 * jwm)], h * 4 * jwm, 6, elsize)
        bwd = layout([(4 * h, jwp)], 4 * h * jwp, 9, elsize)
    else:
        fwd = layout([(h, kwp), (r, 4 * jwm)], h * kwp + r * 4 * jwm, 6, elsize)
        bwd = layout([(4 * h, kwp), (r, jwp)], 4 * h * kwp + r * jwp, 9, elsize)
    return (b, h, r, groups, ctas, rpad, *fwd, groups * rpad * (2 * h + r), *bwd,
            groups * rpad * (8 * h + r), elsize)


def parent_scan_plan(b, h, r, sms=SMS, elsize=4):
    step_work = h * 4 * h if r == 0 else h * r + r * 4 * h
    for groups in range(min(b, sms), 0, -1):
        most = max(1, min(sms // groups, h))
        work = cuda_scan._round4(cuda_scan._cdiv(b, groups)) * step_work
        for ctas in sorted({min(most, cuda_scan._cdiv(work, cuda_scan.MIN_STEP_WORK)), most}):
            plan = parent_plan_layout(b, h, r, groups, ctas, elsize)
            if max(plan[8], plan[12]) <= SMEM_LIMIT:
                return plan
    return None


def as_parent(plan):
    """A ScanPlan's fields that the earlier plan had; every weight resident."""
    full = tuple(tuple(d for d, _ in plan.slices(k)) for k in ("fwd", "bwd"))
    assert (plan.resident_fwd, plan.resident_bwd) == full and not plan.streamed
    return (plan.b, plan.h, plan.r, plan.groups, plan.ctas, plan.rpad, plan.stage_fwd,
            plan.red_fwd, plan.smem_fwd, plan.xchg_fwd, plan.stage_bwd, plan.red_bwd,
            plan.smem_bwd, plan.xchg_bwd, plan.elsize)


@pytest.mark.parametrize("elsize", [4, 2], ids=["f32", "bf16"])
def test_every_lstm_shape_with_a_plan_keeps_it(elsize):
    # a stride over the widths, every width around the last resident ones
    widths = sorted({*range(1, 1700, 31), *range(1040, 1080), *range(1570, 1600), 650, 1000})
    for h in widths:
        for r in ranks(h):
            one = parent_scan_plan(1, h, r, SMS, elsize)
            for b in (*BATCHES, 477, 657):
                before = parent_scan_plan(b, h, r, SMS, elsize)
                if before is not None and cuda_scan.scan_plan(b, h, r, SMS, elsize).mma:
                    # the tensor-core walk's layout (bf16, groups of 8 rows or
                    # more), at the parent's grouping or one of more groups,
                    # holds every weight row; where it does not fit, the
                    # parent's plan below
                    plan = cuda_scan.scan_plan(b, h, r, SMS, elsize)
                    assert not plan.streamed and plan.groups >= before[3]
                elif before is not None:
                    assert as_parent(cuda_scan.scan_plan(b, h, r, SMS, elsize)) == before
                elif one is not None and elsize == 4:  # chunks of rows, as before
                    with pytest.raises(ValueError, match="do not fit"):
                        cuda_scan.scan_plan(b, h, r, SMS, elsize)
                elif one is not None:  # chunks of rows, or the mma layout takes the batch whole
                    try:
                        plan = cuda_scan.scan_plan(b, h, r, SMS, elsize)
                    except ValueError as e:
                        assert "do not fit" in str(e)
                    else:
                        assert plan.mma and not plan.streamed
                else:  # fault 11: streamed now
                    assert cuda_scan.scan_chunks(b, h, r, SMS, elsize)[0][2].streamed


def parent_gru_plan(t, b, f, rx, h, r, form, gi=False, sms=SMS):
    """cuda_gru.gru_plan before fault 11's repair -> its fields, or None."""
    xside = cuda_gru.GI_MODE if gi else (cuda_gru.LOWRANK_X if rx else cuda_gru.DENSE_X)
    want = min(cuda_gru.GRU_MAX_ROWS, -(-b // sms))
    threads = min(cuda_gru.GRU_MAX_THREADS, cuda_gru.GRU_SLICES * (-(-max(h, r) // 8)) * 8)
    for rows in (want, *(n for n in cuda_gru.ROW_BOUNDS if n < want)):
        places = (("registers",) if h <= cuda_gru.REG_H and r <= cuda_gru.REG_R
                  else ("shared", "L2"))
        fwd = None
        for rec in places:
            for x_res in ((True, False) if xside != cuda_gru.GI_MODE else (False,)):
                tblock = t
                while tblock >= 1 and fwd is None:
                    floats = cuda_gru._fwd_floats(tblock, rows, f, rx, h, r, form, xside, rec,
                                                  x_res)
                    if 4 * floats <= SMEM_LIMIT:
                        fwd = (tblock, rec, x_res, 4 * floats)
                    tblock = tblock // 2 if tblock > 1 else 0
                if fwd is not None:
                    break
            if fwd is not None:
                break
        bwd = next(((rec, 4 * cuda_gru._bwd_floats(rows, h, r, form, rec)) for rec in places
                    if 4 * cuda_gru._bwd_floats(rows, h, r, form, rec) <= SMEM_LIMIT), None)
        if fwd is not None and bwd is not None:
            return (t, b, h, r, form, rows, threads, *fwd, *bwd)
    return None


def gru_fields(plan):
    assert plan.spill_fwd == plan.spill_bwd == 0
    return (plan.t, plan.b, plan.h, plan.r, plan.form, plan.rows, plan.threads, plan.tblock,
            plan.rec_weights, plan.x_resident, plan.smem_fwd, plan.bwd_rec_weights,
            plan.smem_bwd)


FORMS = {"lowrank_pre": cuda_gru.LOWRANK_PRE, "dense_pre": cuda_gru.DENSE_PRE,
         "dense_post": cuda_gru.DENSE_POST}


def gru_rank(h, form):
    return max(1, h // 4) if form == cuda_gru.LOWRANK_PRE else 0


def test_every_gru_shape_with_a_plan_keeps_it():
    # the shapes of fault 10's tests and the widths up to where the
    # walk stopped fitting, x mode and gi mode
    shapes = [(24, b, f, rx, 64, r, form) for b in (1, 81, 256, 600) for f in (77, 64)
              for rx in (9, 0) for r, form in ((9, 0), (0, 1), (0, 2))]
    shapes += [(24, b, 77, rx, 256, r, form) for b in (81, 256) for rx in (9, 0)
               for r, form in ((64, 0), (0, 1), (0, 2))]
    shapes += [(t, b, f, rx, h, r, form) for t in (1, 5) for b in (1, 3, 133, 530)
               for f, rx in ((13, 3), (7, 0)) for h, r, form in ((37, 5, 0), (21, 0, 1),
                                                                  (33, 0, 2))]
    shapes += [(24, b, 77, 0, h, r, form) for b, h in ((512, 1000), (256, 2000))
               for r, form in ((0, 2), (0, 1), (h // 2, 0))]
    shapes += [(24, b, 77, 0, h, gru_rank(h, form), form) for b in (81, 512)
               for h in range(64, 4100, 37) for form in FORMS.values()]
    kept = 0
    for t, b, f, rx, h, r, form in shapes:
        for gi in (False, True):
            before = parent_gru_plan(t, b, 0 if gi else f, 0 if gi else rx, h, r, form, gi)
            plan = cuda_gru.gru_plan(t, b, 0 if gi else f, 0 if gi else rx, h, r, form, gi=gi)
            if before is not None:
                assert gru_fields(plan) == before
                kept += 1
            else:
                assert plan.rows == 1 and plan.spill_fwd + plan.spill_bwd > 0
    assert kept > 1000


def gru_region_sizes(plan, kernel, f, rx, gi):
    xside = cuda_gru.GI_MODE if gi else (cuda_gru.LOWRANK_X if rx else cuda_gru.DENSE_X)
    if kernel == "fwd":
        return cuda_gru._fwd_region_sizes(plan.tblock, plan.rows, f, rx, plan.h, plan.r,
                                          plan.form, xside, plan.rec_weights, plan.x_resident)
    return cuda_gru._bwd_region_sizes(plan.rows, plan.h, plan.r, plan.form,
                                      plan.bwd_rec_weights)


def gru_kernel_accepts(plan, f, rx, gi):
    """The checks of gru_scan_xin_fwd.cu::launch and gru_scan_xin_bwd.cu::
    walk: the spill a region boundary of a one-row plan with the recurrent
    weights (and the x side's) read through L2, the shared bytes the layout
    less the spill, within the card's."""
    for kernel, spill, smem in (("fwd", plan.spill_fwd, plan.smem_fwd),
                                ("bwd", plan.spill_bwd, plan.smem_bwd)):
        sizes = [cuda_gru._q4(n) for n in gru_region_sizes(plan, kernel, f, rx, gi)]
        bounds = np.cumsum([0] + sizes)
        assert spill in bounds and 4 * (bounds[-1] - spill) == smem <= SMEM_LIMIT
        if spill:
            rec = plan.rec_weights if kernel == "fwd" else plan.bwd_rec_weights
            assert plan.rows == 1 and rec == "L2"
            if kernel == "fwd":
                assert not plan.x_resident and plan.tblock == 1
        assert cuda_gru.state_floats(plan, kernel) == plan.ctas * spill


@pytest.mark.parametrize("form", list(FORMS))
def test_every_gru_width_has_a_plan(form):
    spilled = []
    for h in GRU_WIDTHS:
        r = gru_rank(h, FORMS[form])
        for gi in (False, True):
            f, rx = (0, 0) if gi else (77, 0)
            plan = cuda_gru.gru_plan(24, 81, f, rx, h, r, FORMS[form], gi=gi)
            gru_kernel_accepts(plan, f, rx, gi)
            spills = bool(plan.spill_fwd or plan.spill_bwd)
            # exactly where the earlier plan raised
            assert spills == (parent_gru_plan(24, 81, f, rx, h, r, FORMS[form], gi) is None)
            if spills:
                spilled.append(h)
    # the walk's state stopped fitting past about these widths (one row a CTA)
    first = {"dense_post": 3059, "dense_pre": 3874, "lowrank_pre": 3749}[form]
    assert min(spilled) == first
    assert all(h in spilled for h in GRU_WIDTHS if h > min(spilled))


@pytest.mark.parametrize("form", list(FORMS))
def test_a_forced_gru_spill_is_a_layout_the_kernels_take(form):
    """`spill_plan` at a small width with each count of spilled regions: a
    layout the kernels take, from every region in shared memory to none;
    and where `gru_plan` spills a kernel, its layout is `spill_plan`'s with
    the fewest regions whose rest fits."""
    for gi in (False, True):
        f, rx = (0, 0) if gi else (77, 9)
        h = 64
        r = gru_rank(h, FORMS[form])
        plans = [cuda_gru.spill_plan(24, 81, f, rx, h, r, FORMS[form], (k, k), gi=gi)
                 for k in range(12)]
        for plan in plans:
            gru_kernel_accepts(plan, f, rx, gi)
        for kernel in ("fwd", "bwd"):
            sizes = [cuda_gru._q4(n) for n in gru_region_sizes(plans[0], kernel, f, rx, gi) if n]
            spills = [p.spill_fwd if kernel == "fwd" else p.spill_bwd for p in plans]
            assert spills == [sum(sizes[:k]) for k in range(12)]
            assert spills[0] == 0 and spills[-1] == sum(sizes) and len(sizes) < 12
        h = 6000
        r = gru_rank(h, FORMS[form])
        plan = cuda_gru.gru_plan(24, 81, f, rx, h, r, FORMS[form], gi=gi)
        forced = [cuda_gru.spill_plan(24, 81, f, rx, h, r, FORMS[form], (k, k), gi=gi)
                  for k in range(12)]
        assert plan.spill_fwd + plan.spill_bwd > 0
        for kernel in ("fwd", "bwd"):
            spill, smem = ((plan.spill_fwd, plan.smem_fwd) if kernel == "fwd" else
                           (plan.spill_bwd, plan.smem_bwd))
            fits = [(p.spill_fwd, p.smem_fwd) if kernel == "fwd" else (p.spill_bwd, p.smem_bwd)
                    for p in forced]
            if spill:  # a kernel that fits keeps its own layout
                assert (spill, smem) == next(x for x in fits if x[1] <= SMEM_LIMIT)


def test_gru_plan_raises_only_on_arguments():
    for h in (1, 3056, 3057, 5000, 8192, 20000):
        for form in FORMS.values():
            cuda_gru.gru_plan(24, 81, 77, 9, h, gru_rank(h, form), form)
    for args in ((24, 81, 77, 9, 64, 0, 0), (24, 81, 77, 9, 64, 9, 2), (0, 81, 77, 9, 64, 9, 0),
                 (24, 0, 77, 9, 64, 0, 1), (24, 81, 0, 9, 64, 0, 1)):
        with pytest.raises(ValueError, match="no GRU plan"):
            cuda_gru.gru_plan(*args)


# -- the kernels' phases on streamed plans, each CTA's slices split into
# their resident rows and their streamed ones

def fwd_slices(plan, u, v):
    """Each CTA's forward slices as the kernels lay them out: U[:, k-slice]
    [h][kwp] (None when dense) and V or dense U, gate columns of the
    j-slice interleaved [depth][jwm][4]; each as (resident rows, streamed
    rows) at the plan's resident depths."""
    h = plan.h
    (_, kwp), (depth, cols) = plan.slices("fwd")
    ra, rb = plan.resident_fwd
    out = []
    for q in range(plan.ctas):
        j0, j1 = plan.j_range(q)
        k0, k1 = plan.k_range(q)
        wa = None
        if v is not None:
            wa = u.new_zeros(h, kwp)
            wa[:, :k1 - k0] = u[:, k0:k1]
            wa = (wa[:ra], wa[ra:])
        w = u if v is None else v
        wb = w.new_zeros(depth, cols // 4, 4)
        for g in range(4):
            wb[:, :j1 - j0, g] = w[:, g * h + j0:g * h + j1]
        wb = wb.reshape(depth, cols)
        out.append((wa, (wb[:rb], wb[rb:])))
    return out


def bwd_slices(plan, u, v):
    """Each CTA's BPTT slices: V[k-slice, :]^T [4h][kwp] (None when dense)
    and U[j-slice, :]^T [depth][jwp], split at the plan's resident depths."""
    (_, kwp), (depth, jwp) = plan.slices("bwd")
    ra, rc = plan.resident_bwd
    out = []
    for q in range(plan.ctas):
        j0, j1 = plan.j_range(q)
        k0, k1 = plan.k_range(q)
        wb = None
        if v is not None:
            wb = v.new_zeros(v.shape[1], kwp)
            wb[:, :k1 - k0] = v[k0:k1].T
            wb = (wb[:ra], wb[ra:])
        wc = u.new_zeros(depth, jwp)
        wc[:, :j1 - j0] = u[j0:j1].T
        out.append((wb, (wc[:rc], wc[rc:])))
    return out


def split_product(plan, kernel, which, src, parts):
    """src @ W for product ``which`` of ``kernel`` (its index among the
    kernel's products, `ScanPlan.walk`). Without a ring, W's resident rows
    and streamed rows multiplied apart. On a ring, piece by piece in ring
    order: each piece's rows [e0, e1) of src times its resident rows, from
    the slice in shared memory, and its streamed rows, from a ring stage
    that one bulk copy fills from the CTA's streamed region (rows padded to
    16 bytes, as the prologue lays them out); the pieces' products summed
    in order."""
    res, streamed = parts
    d = res.shape[0]
    if not plan.piece(kernel):
        return src[:, :d] @ res + src[:, d:] @ streamed
    cols = res.shape[1]
    ld = ring_ld(cols, plan.elsize)
    region = streamed.new_zeros(streamed.shape[0], ld)
    region[:, :cols] = streamed
    region = region.reshape(-1)
    depth, _, rows, pieces = plan.walk(kernel)[which]
    assert depth == d + streamed.shape[0]
    out = src.new_zeros(src.shape[0], cols)
    for e0, e1 in pieces:
        assert e1 - e0 <= (plan.piece(kernel) // plan.rpad if e1 <= d else rows)
        es = max(e0, d)
        stage = region[(es - d) * ld:max(0, e1 - d) * ld].reshape(-1, ld)[:, :cols]
        out = out + src[:, e0:e1] @ torch.cat([res[e0:min(e1, d)], stage])
    return out


def emulate_recurrence(plan, gi, u, v, dvec, h0, c0):
    """The forward kernel's phases, group by group and CTA by CTA, on the
    slices of `fwd_slices` -> as `lstm_recurrence_plain`."""
    t, b, g4 = gi.shape
    h = g4 // 4
    dvec = dvec.reshape(-1)
    slices = fwd_slices(plan, u, v)
    ys, cs, gates = gi.new_empty(t, b, h), gi.new_empty(t, b, h), gi.new_empty(t, b, g4)
    hus = None if v is None else gi.new_empty(t, b, u.shape[1])
    for grp in range(plan.groups):
        b0, b1 = plan.rows(grp)
        h_t, c_t = h0[b0:b1], c0[b0:b1]
        for s in range(t):
            src = h_t
            if v is not None:
                hu = gi.new_empty(b1 - b0, u.shape[1])
                for q, (wa, _) in enumerate(slices):
                    k0, k1 = plan.k_range(q)
                    hu[:, k0:k1] = split_product(plan, "fwd", 0, h_t, wa)[:, :k1 - k0]
                hus[s, b0:b1] = src = hu
            h_n, c_n = torch.empty_like(h_t), torch.empty_like(c_t)
            for q, (_, wb) in enumerate(slices):
                j0, j1 = plan.j_range(q)
                acc = split_product(plan, "fwd", int(v is not None), src, wb).reshape(
                    b1 - b0, -1, 4)[:, :j1 - j0]
                pre = [gi[s, b0:b1, g * h + j0:g * h + j1] + acc[..., g]
                       + h_t[:, j0:j1] * dvec[g * h + j0:g * h + j1] for g in range(4)]
                i, f, g, o = (torch.sigmoid(pre[0]), torch.sigmoid(pre[1]), torch.tanh(pre[2]),
                              torch.sigmoid(pre[3]))
                c_n[:, j0:j1] = f * c_t[:, j0:j1] + i * g
                h_n[:, j0:j1] = o * torch.tanh(c_n[:, j0:j1])
                for k, a in enumerate((i, f, g, o)):
                    gates[s, b0:b1, k * h + j0:k * h + j1] = a
            h_t, c_t = h_n, c_n
            ys[s, b0:b1], cs[s, b0:b1] = h_t, c_t
    return ys, cs, gates, hus


def emulate_bptt(plan, u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dc_last):
    """The BPTT kernel's walk on the slices of `bwd_slices`, then the weight
    gradients over all rows -> as `lstm_bptt_plain`."""
    t, b, h = ys.shape
    dvec = dvec.reshape(-1)
    slices = bwd_slices(plan, u, v)
    dpre = ys.new_empty(t, b, 4 * h)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
    for grp in range(plan.groups):
        b0, b1 = plan.rows(grp)
        dh = torch.zeros_like(h0[b0:b1])
        dc = dc_last[b0:b1].clone()
        for s in range(t - 1, -1, -1):
            c_prev = c0[b0:b1] if s == 0 else cs[s - 1, b0:b1]
            i, f, g, o = (gates[s, b0:b1, k * h:(k + 1) * h] for k in range(4))
            dh = dh + dys[s, b0:b1]
            tc = torch.tanh(cs[s, b0:b1])
            dc = dc + dh * o * (1 - tc * tc)
            d_t = torch.cat([dc * g * i * (1 - i), dc * c_prev * f * (1 - f),
                             dc * i * (1 - g * g), dh * tc * o * (1 - o)], dim=1)
            dc = dc * f
            dpre[s, b0:b1] = d_t
            dvt = d_t * dvec
            dh_part = dvt[:, :h] + dvt[:, h:2 * h] + dvt[:, 2 * h:3 * h] + dvt[:, 3 * h:]
            src = d_t
            if v is not None:
                src = d_t.new_empty(b1 - b0, v.shape[0])
                for q, (wb, _) in enumerate(slices):
                    k0, k1 = plan.k_range(q)
                    src[:, k0:k1] = split_product(plan, "bwd", 0, d_t, wb)[:, :k1 - k0]
            dh = torch.empty_like(dh)
            for q, (_, wc) in enumerate(slices):
                j0, j1 = plan.j_range(q)
                dh[:, j0:j1] = dh_part[:, j0:j1] + split_product(
                    plan, "bwd", int(v is not None), src, wc)[:, :j1 - j0]
        dh0[b0:b1], dc0[b0:b1] = dh, dc
    hprev = torch.cat([h0[None], ys[:-1]]).reshape(t * b, h)
    d2 = dpre.reshape(t * b, 4 * h)
    if v is None:
        du, dv = hprev.T @ d2, None
    else:
        du, dv = hprev.T @ (d2 @ v.T), hu.reshape(t * b, -1).T @ d2
    ddvec = (d2 * hprev.repeat(1, 4)).sum(0)
    return dpre, du, dv, ddvec, dh0, dc0


def coverage(plan, u, v):
    """How many times each element of U and V lies in some CTA's slice,
    resident or streamed, in each kernel -> (fwd counts, bwd counts)."""
    out = []
    for slices, kernel in ((fwd_slices, "fwd"), (bwd_slices, "bwd")):
        marks = [torch.zeros_like(u)] + ([] if v is None else [torch.zeros_like(v)])
        ones = (torch.ones_like(u), None if v is None else torch.ones_like(v))
        got = slices(plan, *ones)
        streamed = 0
        for q, (first, second) in enumerate(got):
            j0, j1 = plan.j_range(q)
            k0, k1 = plan.k_range(q)
            for parts in (first, second):
                if parts is not None:
                    streamed += parts[1].numel()
            if kernel == "fwd":
                if v is not None:
                    marks[0][:, k0:k1] += torch.cat(first)[:, :k1 - k0]
                w = marks[0] if v is None else marks[1]
                wb = torch.cat(second).reshape(w.shape[0], -1, 4)
                for g in range(4):
                    w[:, g * plan.h + j0:g * plan.h + j1] += wb[:, :j1 - j0, g]
            else:
                if v is not None:
                    marks[1][k0:k1] += torch.cat(first)[:, :k1 - k0].T
                marks[0][j0:j1] += torch.cat(second)[:, :j1 - j0].T
        assert streamed == plan.n_ctas * plan.streamed_elems(kernel)
        out.append(marks)
    return out


# (T, B, F, h, rx, r): a dense U [128, 512] (262 KB) and a low-rank pair at
# h=160, r=80 (256 KB) stream on one SM; ragged B
STREAM_CASES = {"dense": (3, 5, 7, 128, 0, 0), "lowrank": (3, 3, 9, 160, 4, 80)}


def streamed_case(name, dtype):
    t, b, f, h, rx, r = STREAM_CASES[name]
    plan = cuda_scan.scan_plan(b, h, r, 1)
    assert plan.streamed and (plan.groups, plan.ctas) == (1, 1)
    assert all(0 < res < d for (d, _), res in zip(plan.slices("fwd"), plan.resident_fwd) if d)
    rng = np.random.default_rng(0)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    arrs = (n(t, b, f, scale=1.0), n(f, rx or 4 * h), n(rx, 4 * h) if rx else None, n(4, h),
            n(4 * h), n(h, r or 4 * h, scale=0.1), n(r, 4 * h, scale=0.1) if r else None,
            n(4 * h), n(b, h), n(b, h))
    a = [None if x is None else torch.from_numpy(x).to(dtype) for x in arrs]
    xu, gi = cuda_scan._gi_plain(a[0], a[1], a[2], a[3], a[4], h, False)
    dys = torch.from_numpy(rng.standard_normal((t, b, h))).to(dtype)
    dc_last = torch.from_numpy(rng.standard_normal((b, h))).to(dtype)
    return plan, arrs, a, gi, dys, dc_last


@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_every_weight_element_is_resident_or_streamed_once(name):
    plan, _, a, _, _, _ = streamed_case(name, torch.float32)
    for marks in coverage(plan, a[5], a[6]):
        for m in marks:
            assert bool((m == 1).all())


def test_every_weight_element_is_placed_once_at_the_ptb_large_layer():
    for r in (0, 750):
        plan = cuda_scan.scan_plan(20, 1500, r)
        assert plan.streamed
        u = torch.zeros(1500, r or 6000)
        v = torch.zeros(r, 6000) if r else None
        for marks in coverage(plan, u, v):
            for m in marks:
                assert bool((m == 1).all())


@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_streamed_phases_match_the_plain_walks(name):
    plan, _, a, gi, dys, dc_last = streamed_case(name, torch.float64)
    u, v, dvec, h0, c0 = a[5:]
    got = emulate_recurrence(plan, gi, u, v, dvec, h0, c0)
    want = cuda_scan.lstm_recurrence_plain(gi, u, v, dvec, h0, c0)
    for label, g, w in zip(("ys", "cs", "gates", "hu"), got, want):
        assert (g is None) == (w is None), label
        if w is not None:
            torch.testing.assert_close(g, w, msg=label, **EMU_TOL)
    ys, cs, gates, hu = want
    got = emulate_bptt(plan, u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dc_last)
    want = cuda_scan.lstm_bptt_plain(u, v, dvec, h0, c0, ys, cs, gates, hu, dys, None, dc_last)
    for label, g, w in zip(("dpre", "du", "dv", "ddvec", "dh0", "dc0"), got, want):
        assert (g is None) == (w is None), label
        if w is not None:
            torch.testing.assert_close(g, w, msg=label, **EMU_TOL)


@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_streamed_phases_match_the_jax_kernel_and_its_vjp(name):
    plan, arrs, a, gi, dys, dc_last = streamed_case(name, torch.float32)
    u, v, dvec, h0, c0 = a[5:]
    ys, cs, gates, hu = emulate_recurrence(plan, gi, u, v, dvec, h0, c0)

    def f(*prim):
        j = [None if x is None else jnp.asarray(x) for x in arrs[:5]]
        return jax_scan(*j, *prim, interpret=True)

    prim = [None if x is None else jnp.asarray(x) for x in arrs[5:]]
    (ys_j, c_j), vjp = jax.vjp(f, *prim)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), **FWD_TOL)
    np.testing.assert_allclose(cs[-1].numpy(), np.asarray(c_j), **FWD_TOL)
    _, du, dv, ddvec, dh0, dc0 = emulate_bptt(plan, u, v, dvec, h0, c0, ys, cs, gates, hu,
                                              dys, dc_last)
    g_j = vjp((jnp.asarray(dys.numpy()), jnp.asarray(dc_last.numpy())))
    for label, got, want in zip(("du", "dv", "ddvec", "dh0", "dc0"), (du, dv, ddvec, dh0, dc0),
                                g_j):
        assert (got is None) == (want is None), label
        if want is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(got.shape),
                                       err_msg=label, **GRAD_TOL)


# -- the ring of the streamed plans: the parent's chunks, slices and red, and
# each thread's order of sums, kept

def parent_streamed_plan(b, h, r, sms=SMS, elsize=4):
    """cuda_scan._streamed_plan before the ring: the staging buffer of
    `stage` floats, the resident depths that fit beside it -> ScanPlan, or
    None where its slabs did not fit."""
    ctas = min(sms, h)
    none = (0, 0)
    empty = cuda_scan.plan_layout(b, h, r, 1, ctas, elsize, resident=(none, none), ring=none)
    resident = []
    for kernel, smem in (("fwd", empty.smem_fwd), ("bwd", empty.smem_bwd)):
        room = (SMEM_LIMIT - smem) // 16 * 16 // elsize
        if room < 0:
            return None
        total = sum(d * c for d, c in empty.slices(kernel))
        resident.append(tuple(min(d, d * room // total) for d, _ in empty.slices(kernel)))
    return cuda_scan.plan_layout(b, h, r, 1, ctas, elsize, resident=tuple(resident), ring=none)


def parent_chunk_plan(b, h, r, sms=SMS, elsize=4):
    if parent_scan_plan(1, h, r, sms, elsize) is None:
        return parent_streamed_plan(b, h, r, sms, elsize)
    return parent_scan_plan(b, h, r, sms, elsize)


def parent_chunks(b, h, r, sms=SMS, elsize=4):
    """scan_chunks before the ring -> ((b0, n), ...)."""
    for n in range(1, b + 1):
        bounds = [cuda_scan._split_at(i, b, n) for i in range(n + 1)]
        if all(parent_chunk_plan(b1 - b0, h, r, sms, elsize) is not None
               for b0, b1 in zip(bounds, bounds[1:])):
            return tuple((b0, b1 - b0) for b0, b1 in zip(bounds, bounds[1:]))
    raise AssertionError("one row had a plan")


@pytest.mark.parametrize("elsize", [4, 2], ids=["f32", "bf16"])
def test_ring_plans_keep_the_parents_chunks_stage_and_red(elsize):
    """Every streamed width of the sweep: the batch in the parent's chunks,
    each with the parent's groups, CTAs, rpad, stage (the chunks whose
    order of sums the ring keeps) and red (so the same slices), and a ring
    in place of the staging buffer within the card's shared memory."""
    seen = 0
    for h in [w for w in LSTM_WIDTHS if w >= 1000]:
        for r in ranks(h):
            if parent_scan_plan(1, h, r, SMS, elsize) is not None:
                continue
            for b in BATCHES:
                chunks = chunks_cover(b, h, r, elsize)
                assert tuple((b0, n) for b0, n, _ in chunks) == parent_chunks(b, h, r, SMS,
                                                                             elsize)
                for _, n, plan in chunks:
                    parent = parent_streamed_plan(n, h, r, SMS, elsize)
                    assert plan.streamed and plan.piece_fwd and plan.piece_bwd
                    # an mma plan (bf16, 24 rows or more) stages and sums its
                    # own way (`mma_kernel_accepts`): the same grouping
                    fields = ("groups", "ctas") if plan.mma else (
                        "groups", "ctas", "rpad", "stage_fwd", "red_fwd", "stage_bwd", "red_bwd",
                        "xchg_fwd", "xchg_bwd")
                    for field in fields:
                        assert getattr(plan, field) == getattr(parent, field), field
                    seen += 1
    assert seen > 500


def mma_first(kb0, kw, j):
    """The first block at or after kb0 of k-group j (MmaTiles::first)."""
    return kb0 + ((j - kb0 % kw) % kw + kw) % kw


def mma_blocks(spans, kw, j):
    """The blocks k-group j walks over the ring's pieces [e0, e1) of whole
    blocks, in order."""
    return [kb for e0, e1 in spans for kb in range(mma_first(e0 // 16, kw, j), e1 // 16, kw)]


def parent_walk(depth, chunk, slices, s):
    """The rows thread s of a product item walks in slice_product, in order."""
    return [d for d0 in range(0, depth, chunk) for d in range(d0 + s, min(depth, d0 + chunk),
                                                              slices)]


def ring_walk(pieces, chunk, slices, s):
    """The same on the ring (scan_grid.cuh::Ring::consume): piece by piece,
    the thread's next row carried across pieces, moving to the next chunk's
    row c0 + s where a chunk ends; one chunk of the whole depth where the
    slices divide the chunk."""
    depth = pieces[-1][1]
    chunk = depth if chunk % slices == 0 else chunk
    out, c0, d = [], 0, s
    for _, e1 in pieces:
        while True:
            b = min(e1, c0 + chunk)
            while d < b:
                out.append(d)
                d += slices
            if b < c0 + chunk:
                break
            c0 += chunk
            d = c0 + s
            if c0 >= e1:
                break
    return out


RING_SHAPES = [(b, 1500, r, elsize) for b in BATCHES for r in (0, 750) for elsize in (4,)] + [
    (20, 1600, 0, 2), (128, 1600, 0, 2), (5, 128, 0, 4), (3, 160, 80, 4)]


@pytest.mark.parametrize("b,h,r,elsize", RING_SHAPES)
def test_ring_walk_keeps_each_threads_order_of_sums(b, h, r, elsize):
    """Each product's pieces tile its depth (`ring_pieces`): the exchange
    alone over its resident rows, as many as a stage holds, then the
    exchange and the streamed rows, each piece within a stage; the chunks
    are the parent's, and for every slice count a product can take, every
    thread walks the rows of the parent's chunks in the parent's order."""
    sms = SMS if h >= 1000 else 1
    plan = cuda_scan.scan_plan(b, h, r, sms, elsize)
    assert plan.streamed
    if plan.mma:  # the tensor-core walk: its own order, whatever the pieces
        for kernel in ("fwd", "bwd"):
            for depth, chunk, _, pieces in plan.walk(kernel):
                d16 = -(-depth // 16) * 16
                assert chunk == d16
                cols = max(c for d, c in plan.slices(kernel) if d == depth)
                kw = cuda_scan.mma_split(depth, cols, plan.rpad).kw
                for j in range(kw):
                    assert mma_blocks(pieces, kw, j) == list(range(j, d16 // 16, kw))
        return
    for kernel in ("fwd", "bwd"):
        stage = plan.stage_fwd if kernel == "fwd" else plan.stage_bwd
        walks = plan.walk(kernel)
        assert [w[0] for w in walks] == [d for d, _ in plan.slices(kernel) if d]
        piece = plan.piece(kernel)
        residents = [res for (d, _), res in zip(plan.slices(kernel), plan.resident(kernel)) if d]
        for (depth, chunk, rows, pieces), res in zip(walks, residents):
            assert chunk == (depth if depth * plan.rpad <= stage else stage // 2 // plan.rpad)
            rows_a = piece // plan.rpad
            assert rows >= 1 and list(pieces) == [
                (e0, min(e0 + rows_a, res)) for e0 in range(0, res, rows_a)] + [
                (e0, min(e0 + rows, depth)) for e0 in range(res, depth, rows)]
            cols = max(c for d, c in plan.slices(kernel) if d == depth)
            for e0, e1 in pieces:
                if e1 <= res:  # the exchange alone
                    assert (e1 - e0) * plan.rpad <= piece
                else:  # its streamed rows after `rows` rows of it (Ring::issue_weights)
                    assert e0 >= res and e1 - e0 <= rows
                    assert 4 * rows * plan.rpad + (e1 - e0) * ring_ld(
                        cols, plan.elsize) * plan.elsize <= 4 * piece
            for slices in range(1, cuda_scan.MAX_SLICES + 1):
                for s in range(slices):
                    assert ring_walk(pieces, chunk, slices, s) == parent_walk(depth, chunk,
                                                                              slices, s)


@pytest.mark.parametrize("r", [0, 750], ids=["dense", "r750"])
@pytest.mark.parametrize("b", [1, 2, 4, 5, 8, 20, 128, 256])
def test_ring_stage_size_follows_the_batch(b, r):
    """The large layer's streamed plans (one group): stages of
    RING_PIECE_SMALL floats where the group pads its rows to 4 (B <= 4),
    of RING_PIECE_FLOATS past that, each cut only to what fits beside the
    slabs; the same plan as one asked for with that stage size."""
    plan = cuda_scan.scan_plan(b, 1500, r)
    assert plan.streamed and plan.groups == 1 and plan.rpad == -(-b // 4) * 4
    want = cuda_scan.RING_PIECE_SMALL if b <= 4 else cuda_scan.RING_PIECE_FLOATS
    assert cuda_scan.ring_piece(plan.rpad) == want
    for kernel, smem in (("fwd", plan.smem_fwd), ("bwd", plan.smem_bwd)):
        piece = plan.piece(kernel)
        assert 0 < piece <= want
        if piece < want:  # cut: one more 16 bytes a stage would not fit
            assert smem + 2 * 16 > cuda_scan.SMEM_LIMIT
    kernel_accepts(plan)
    assert plan == cuda_scan.streamed_plan(b, 1500, r, piece=want)


def test_forced_ring_depths_and_clusters_keep_the_layout():
    """The sweeps' plans: stages of another size move only the ring and the
    resident depths, never the chunks, slices or red; a stage larger than
    fits is cut to the most that fits, and smaller stages leave more rows
    resident."""
    base = cuda_scan.scan_plan(128, 1500, 0)
    assert (base.piece_fwd, base.piece_bwd) != (0, 0)
    resident = []
    for piece in (1 << 20, cuda_scan.RING_PIECE_FLOATS, 12288, 6144, 2048):
        plan = cuda_scan.streamed_plan(128, 1500, 0, piece=piece)
        kernel_accepts(plan)
        for field in ("groups", "ctas", "rpad", "stage_fwd", "red_fwd", "stage_bwd", "red_bwd"):
            assert getattr(plan, field) == getattr(base, field), field
        if piece < 1 << 20:
            assert (plan.piece_fwd, plan.piece_bwd)[:1] == (piece,)
        else:  # the most that fits: one more 16 bytes a stage would not
            assert plan.smem_fwd + 2 * 16 > cuda_scan.SMEM_LIMIT
        resident.append(sum(plan.resident_fwd) + sum(plan.resident_bwd))
    assert resident == sorted(resident) and resident[0] < resident[-1]


def test_ring_emulation_of_the_transplanted_large_layer_matches_jax(monkeypatch):
    """Layer 0 of the dense PTB "large" LM (2x1500; JAX's initialisation,
    transplanted): its phases emulated on the ring plans of B = 2 (132
    CTAs, each product in pieces of the CTA's resident and streamed rows)
    against the JAX kernel and its VJP, interpreted (with a VMEM budget
    that takes the 1500-wide backward's tiles, as tests/test_pallas.py sets
    budgets)."""
    monkeypatch.setenv("VMLMF_VMEM_BYTES", str(1 << 30))
    t, b, h = 3, 2, 1500
    jparams = JaxLMConfig(**LARGE).build_model(12).init(jax.random.PRNGKey(0))
    layer = jax.tree_util.tree_map(np.asarray, jparams["rnn"][0])
    plan = cuda_scan.scan_plan(b, h, 0)
    assert plan.streamed and plan.piece_fwd and plan.piece_bwd and plan.ctas == SMS
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((t, b, h)).astype(np.float32)
    h0, c0 = (0.3 * rng.standard_normal((2, b, h))).astype(np.float32)
    zeros4, zeros = np.zeros((4, h), np.float32), np.zeros(4 * h, np.float32)
    arrs = (xs, layer["w"], None, zeros4, layer["b"], layer["u"], None, zeros, h0, c0)
    a = [None if x is None else torch.from_numpy(np.array(x)) for x in arrs]
    _, gi = cuda_scan._gi_plain(a[0], a[1], a[2], a[3], a[4], h, False)
    ys, cs, gates, hu = emulate_recurrence(plan, gi, *a[5:])

    def f(u, c0_):
        j = [None if x is None else jnp.asarray(x) for x in arrs[:5]]
        return jax_scan(*j, u, None, jnp.asarray(zeros), jnp.asarray(h0), c0_, interpret=True)

    (ys_j, c_j), vjp = jax.vjp(f, jnp.asarray(layer["u"]), jnp.asarray(c0))
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), **FWD_TOL)
    np.testing.assert_allclose(cs[-1].numpy(), np.asarray(c_j), **FWD_TOL)
    dys = torch.from_numpy(rng.standard_normal((t, b, h)).astype(np.float32))
    dc_last = torch.from_numpy(rng.standard_normal((b, h)).astype(np.float32))
    _, du, _, _, _, dc0 = emulate_bptt(plan, *a[5:], ys, cs, gates, hu, dys, dc_last)
    du_j, dc0_j = vjp((jnp.asarray(dys.numpy()), jnp.asarray(dc_last.numpy())))
    np.testing.assert_allclose(du.numpy(), np.asarray(du_j), **GRAD_TOL)
    np.testing.assert_allclose(dc0.numpy(), np.asarray(dc0_j), **GRAD_TOL)


# -- the PTB "large" LM of Zaremba et al. (2014), dense, at full width

LARGE = dict(lstm_type="custom", hidden_size=1500, layer_num=2, dropout=0.65, winit=0.04,
             max_grad_norm=10, factor=1.15, factor_epoch=14)


def test_dense_large_lm_matches_jax_logits_and_gradients():
    vocab, t, b = 12, 3, 2
    jm = JaxLMConfig(**LARGE).build_model(vocab)             # the XLA backend
    m = LMConfig(**LARGE).build_model(vocab)                 # "fused": the plain scans here
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(1)
    ids = rng.integers(0, vocab, (t, b)).astype(np.int32)
    tgt = rng.integers(0, vocab, (t, b)).astype(np.int32)
    states = [tuple((0.2 * rng.standard_normal((b, 1500))).astype(np.float32) for _ in range(2))
              for _ in range(2)]

    def jloss(p):
        logits, _ = jm.apply(p, jnp.asarray(ids), [tuple(map(jnp.asarray, s)) for s in states],
                             train=False)
        logp = jax.nn.log_softmax(logits, -1)
        return -jnp.take_along_axis(logp, jnp.asarray(tgt)[..., None], -1).mean(), logits

    (_, logits_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = jax.tree_util.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    logits, _ = m.apply(params, torch.from_numpy(ids).long(),
                        [tuple(map(torch.from_numpy, s)) for s in states], train=False)
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, vocab),
                                             torch.from_numpy(tgt).long().reshape(-1))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), **FWD_TOL)
    jleaves = jax.tree_util.tree_leaves(grads_j)
    assert len(jleaves) == len(leaves)
    for p, gj in zip(leaves, jleaves):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gj), **GRAD_TOL)


def test_dense_large_lm_train_steps_match_jax_under_the_clip():
    """Four train steps of the large LM at full width (T=35, B=20; the
    synthetic corpus at vocabulary 1000, where a step's gradient norm
    passes the clip), lr 1 under clip 10, dropout 0, from transplanted
    parameters: the JAX trainer's losses, gradient norms and parameters.
    This file run as a script trains both longer (`witness_main`)."""
    from vmlmf_tpu.train.lm import LMTrainer as JaxLMTrainer
    from vmlmf_tpu_torch.data.ptb import load_or_synthesize, minibatch
    from vmlmf_tpu_torch.train.lm import LMTrainer

    vocab, t, b = 1000, 35, 20
    fields = dict(LARGE, dropout=0.0)
    jm, m = JaxLMConfig(**fields).build_model(vocab), LMConfig(**fields).build_model(vocab)
    kw = dict(batch_size=b, seq_length=t, learning_rate=1.0, max_grad_norm=LARGE["max_grad_norm"])
    jt, tt = JaxLMTrainer(jm, fuse_chunks=1, **kw), LMTrainer(m, device="cpu", **kw)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jstates, states = jt.state0(), tt.state0()
    chunks = minibatch(load_or_synthesize(None, vocab_size=vocab, seed=0)[0], b, t)
    norms = []
    for step, (x, y) in enumerate(chunks[:4]):
        jparams, jstates, jloss, jnorm = jt._train_step(jparams, jstates, x, y, 1.0,
                                                        jax.random.PRNGKey(step))
        params, states, loss, norm = tt.train_step(params, states, torch.from_numpy(x).long(),
                                                   torch.from_numpy(y).long(), 1.0)
        np.testing.assert_allclose(float(loss), float(jloss), **FWD_TOL, err_msg=f"step {step}")
        np.testing.assert_allclose(float(norm), float(jnorm), **GRAD_TOL, err_msg=f"step {step}")
        norms.append(float(jnorm))
    assert max(norms) > LARGE["max_grad_norm"]  # the clip acted
    leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jparams))
    for p, pj in zip(jax.tree_util.tree_leaves(params), leaves):
        np.testing.assert_allclose(p.detach().numpy(), pj, **GRAD_TOL)


# -- a witness for the course of the large LM's first steps at lr 1 under
# clip 10, run as a script (it takes minutes):
#
#     JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_wide_plans.py [STEPS] [OUT.json]
#
# Both packages train the dense "large" LM on the CPU from the same
# parameters and chunks (the synthetic corpus at PTB's vocabulary, 10000;
# T=35, B=20), STEPS steps (20 by default) at dropout 0, where they take
# the same steps and their losses agree up to float rounding (which lr 1
# may grow), and at 0.65, where each draws its own masks (a JAX key, a torch
# generator), so the losses are two samples of the same training. Prints
# each run's two loss sequences (per word) and their means as one JSON line.

def witness_run(dropout, chunks, steps, vocab=10000, t=35, b=20):
    """-> (the JAX trainer's losses, the port's), per word, over ``steps``."""
    from vmlmf_tpu.train.lm import LMTrainer as JaxLMTrainer
    from vmlmf_tpu_torch.train.lm import LMTrainer

    fields = dict(LARGE, dropout=dropout)
    jm, m = JaxLMConfig(**fields).build_model(vocab), LMConfig(**fields).build_model(vocab)
    kw = dict(batch_size=b, seq_length=t, learning_rate=1.0, max_grad_norm=LARGE["max_grad_norm"])
    jt, tt = JaxLMTrainer(jm, fuse_chunks=1, **kw), LMTrainer(m, device="cpu", **kw)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jstates, states = jt.state0(), tt.state0()
    key, generator = jax.random.PRNGKey(1), torch.Generator().manual_seed(1)
    jl, tl = [], []
    for i in range(steps):
        x, y = chunks[i % len(chunks)]
        key, sub = jax.random.split(key)
        jparams, jstates, jloss, _ = jt._train_step(jparams, jstates, x, y, 1.0, sub)
        params, states, loss, _ = tt.train_step(params, states, torch.from_numpy(x).long(),
                                                torch.from_numpy(y).long(), 1.0, generator)
        jl.append(float(jloss) / b)
        tl.append(float(loss) / b)
        print(f"dropout {dropout} step {i}: jax {jl[-1]:.6f} port {tl[-1]:.6f}", flush=True)
    return jl, tl


def witness_main(argv):
    import json

    from vmlmf_tpu_torch.data.ptb import load_or_synthesize, minibatch

    steps = int(argv[0]) if argv else 20
    chunks = minibatch(load_or_synthesize(None, vocab_size=10000, seed=0)[0], 20, 35)
    out = {}
    for dropout in (0.0, 0.65):
        jl, tl = witness_run(dropout, chunks, steps)
        out[f"dropout_{dropout}"] = dict(
            jax=jl, port=tl, max_abs_diff=max(abs(a - c) for a, c in zip(jl, tl)),
            # the means of steps 1-5, 16-20 and the last 5, each trainer's
            means={k: [sum(v[i:i + 5]) / 5 for i in (0, 15, len(v) - 5)]
                   for k, v in (("jax", jl), ("port", tl))})
    print(json.dumps(out))
    if len(argv) > 1:
        with open(argv[1], "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    import sys

    witness_main(sys.argv[1:])
