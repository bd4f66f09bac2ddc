"""The grid layout of the port's GRU scan kernels on the CPU
(`cuda_gru.gru_grid_plan`, `gru_grid_chunks`, `gru_layout`), and the HAR
GRU at its default width through the port and through JAX.

Where a GRU layer's recurrent weights do not fit in one CTA's shared
memory, `gru_plan`'s row layout reads them through L2 once a step per CTA.
The grid layout instead splits the units (and rank columns) over the CTAs
of a cooperative launch, each holding its slices in shared memory, as the
LSTM scans do (csrc/gru_grid.cuh). Here a sweep of shapes up to h = 4096
and B = 1024 is checked for plans that own every row, unit and rank column
once, fit the card and its shared memory, and place every weight row in
shared memory or in the streamed scratch; every shape whose weights sit in
registers or shared memory keeps the parent's `GRUPlan` (a frozen table);
and the two HAR GRU nets at h = 180 are held to the JAX package's on the
CPU, where the wrappers run their plain versions.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu import config as jconfig  # noqa: E402
from vmlmf_tpu_torch import config  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_gru  # noqa: E402
from vmlmf_tpu_torch.ops.cuda_scan import (  # noqa: E402
    GRID_THREADS,
    MAX_SLICES,
    MIN_SLICE_DEPTH,
    RING_STAGES,
    SMEM_LIMIT,
)
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

SMS = 132  # an H100 SXM
FWD_TOL = dict(atol=2e-5, rtol=2e-5)   # tests/test_pallas.py:57, f32 forward
GRAD_TOL = dict(atol=3e-4, rtol=3e-4)  # tests/test_pallas.py:74, f32 gradients
LOWRANK, DENSE_PRE, POST = cuda_gru.LOWRANK_PRE, cuda_gru.DENSE_PRE, cuda_gru.DENSE_POST

WIDTHS = (1, 7, 33, 64, 137, 180, 197, 256, 512, 1000, 1500, 3200, 4096)
BATCHES = (1, 5, 37, 81, 256, 512, 1024)


def ranks(h, form):
    return sorted({1, max(1, h // 4), h}) if form == LOWRANK else [0]


def cover(ranges, n):
    """Whether the [a, b) ranges, in order, tile [0, n)."""
    at = 0
    for a, b in ranges:
        if a != at or b < a:
            return False
        at = b
    return at == n


def smem_floats(plan, kernel):
    """Floats of a kernel's shared memory as csrc/gru_grid.cuh carves it:
    the resident rows of its two slices, its slabs, stage (on a ring plan
    the ring, RING_STAGES stages of `piece` floats and their two 8-byte
    barriers each) and red."""
    (da, ca), (db, cb) = plan.slices(kernel)
    res_a, res_b = plan.resident(kernel)
    jwp = -(-(-(-plan.h // plan.ctas)) // 4) * 4
    weights = -(-(res_a * ca + res_b * cb) // 4) * 4
    slabs = {"fwd": 7 if plan.form == POST else 5, "bwd": 7 if plan.form == POST else 6}[kernel]
    stage, red = ((plan.stage_fwd, plan.red_fwd) if kernel == "fwd"
                  else (plan.stage_bwd, plan.red_bwd))
    piece = plan.piece(kernel)
    staged = RING_STAGES * (piece + 4) if piece else stage
    return weights + slabs * jwp * plan.rpad + staged + red


def products(plan, kernel):
    """(depth, columns) of each product a kernel's step runs."""
    h, r = plan.h, plan.r
    jwp = -(-(-(-h // plan.ctas)) // 4) * 4
    kwp = -(-(-(-r // plan.ctas)) // 4) * 4 if plan.form == LOWRANK else 0
    return {("fwd", LOWRANK): [(h, kwp), (r, 2 * jwp), (r, jwp)],
            ("fwd", DENSE_PRE): [(h, 2 * jwp), (h, jwp)],
            ("fwd", POST): [(h, 3 * jwp)],
            ("bwd", LOWRANK): [(h, kwp), (r, jwp), (2 * h, kwp)],
            ("bwd", DENSE_PRE): [(h, jwp), (2 * h, jwp)],
            ("bwd", POST): [(3 * h, jwp)]}[kernel, plan.form]


def check_grid_plan(plan, b, h, r, form, sms=SMS):
    assert (plan.b, plan.h, plan.r, plan.form) == (b, h, r, form)
    # every batch row in one group, every unit and rank column on one CTA of it
    assert 1 <= plan.groups <= b and 1 <= plan.ctas <= h
    assert plan.n_ctas <= sms  # one CTA an SM: a cooperative launch's CTAs co-resident
    assert cover([plan.rows(g) for g in range(plan.groups)], b)
    # rows padded to a multiple of each kernel's items' rows R (4, 8 or 12), no further
    tiles = (plan.tile_fwd, plan.tile_bwd)
    assert set(tiles) <= {4, 8, 12} and plan.rpad % math.lcm(*tiles) == 0
    assert all(b1 - b0 <= plan.rpad for b0, b1 in (plan.rows(g) for g in range(plan.groups)))
    assert plan.rpad < max(b1 - b0 for b0, b1 in (plan.rows(g) for g in range(plan.groups))) + \
        math.lcm(*tiles)
    assert cover([plan.j_range(q) for q in range(plan.ctas)], h)
    (_, ca), (_, cb) = plan.slices("fwd")
    jwp = cb // 3
    assert max(j1 - j0 for j0, j1 in map(plan.j_range, range(plan.ctas))) <= jwp
    assert jwp % 4 == 0 and plan.slices("bwd")[1][1] == jwp
    if form == LOWRANK:
        assert cover([plan.k_range(q) for q in range(plan.ctas)], r)
        assert max(k1 - k0 for k0, k1 in map(plan.k_range, range(plan.ctas))) <= ca
        assert ca % 4 == 0 and plan.slices("bwd")[0][1] == ca
    else:
        assert plan.slices("fwd")[0] == plan.slices("bwd")[0] == (0, 0)
    for kernel in ("fwd", "bwd"):
        smem = plan.smem_fwd if kernel == "fwd" else plan.smem_bwd
        assert smem % 16 == 0 and smem <= SMEM_LIMIT
        assert 4 * smem_floats(plan, kernel) == smem
        # every weight element of a slice is resident or streamed, once
        slices, resident = plan.slices(kernel), plan.resident(kernel)
        assert all(0 <= res <= d for (d, _), res in zip(slices, resident))
        total = sum(d * c for d, c in slices)
        assert sum(res * c for (_, c), res in zip(slices, resident)) + \
            plan.streamed_elems(kernel) == total
        assert cuda_gru.grid_stream_floats(plan, kernel) >= plan.n_ctas * \
            plan.streamed_elems(kernel)
        # the staging buffer and the slice partials that each product takes
        stage, red = ((plan.stage_fwd, plan.red_fwd) if kernel == "fwd"
                      else (plan.stage_bwd, plan.red_bwd))
        assert stage % plan.rpad == 0 and stage // plan.rpad >= min(
            2, max(d for d, _ in products(plan, kernel)))
        for depth, cols in products(plan, kernel):
            items = cols // 4 * (plan.rpad // plan.tile(kernel))
            most = 1 if items >= GRID_THREADS else min(MAX_SLICES, GRID_THREADS // items)
            slices_ = max(1, min(most, depth // MIN_SLICE_DEPTH))
            assert slices_ == 1 or red >= slices_ * items * 16
    # the exchange buffers of each kernel
    pre, lowrank = form != POST, form == LOWRANK
    assert plan.xchg_fwd == plan.groups * plan.rpad * (2 * h + pre * h + lowrank * r)
    assert plan.xchg_bwd == plan.groups * plan.rpad * (6 * h + lowrank * r)


@pytest.mark.parametrize("form", [LOWRANK, DENSE_PRE, POST], ids=["lowrank_pre", "dense_pre",
                                                                 "dense_post"])
@pytest.mark.parametrize("h", WIDTHS)
def test_grid_chunks_cover_every_row_unit_and_rank_and_fit_the_card(h, form):
    for r in ranks(h, form):
        one = cuda_gru.gru_grid_plan(24, 1, 77, 9, h, r, form)
        for b in BATCHES:
            chunks = cuda_gru.gru_grid_chunks(24, b, 77, 9, h, r, form)
            assert cover([(b0, b0 + n) for b0, n, _ in chunks], b)
            assert max(n for _, n, _ in chunks) - min(n for _, n, _ in chunks) <= 1
            for _, n, plan in chunks:
                check_grid_plan(plan, n, h, r, form)
                # a width streams only where one row's weights do not fit
                assert plan.streamed == one.streamed
                if plan.streamed:
                    assert plan.groups == 1 and plan.ctas == min(SMS, h)
            # the x side does not change the layout
            for f, rx, gi in ((77, 0, False), (0, 0, True)):
                assert cuda_gru.gru_grid_chunks(24, b, f, rx, h, r, form, gi=gi) == chunks
            if len(chunks) == 1:
                assert chunks[0][2] == cuda_gru.gru_grid_plan(24, b, 77, 9, h, r, form)
            else:  # fewer chunks have no plan
                with pytest.raises(ValueError):
                    cuda_gru.gru_grid_plan(24, -(-b // (len(chunks) - 1)), 77, 9, h, r, form)


def test_grid_plans_at_the_shapes_the_card_runs():
    # the HAR GRU at its default width: 44 groups of 3 CTAs, every weight resident
    for form in (DENSE_PRE, POST):
        (_, _, plan), = cuda_gru.gru_grid_chunks(24, 81, 77, 0, 180, 0, form)
        assert (plan.groups, plan.ctas, plan.streamed) == (44, 3, False)
    # h=1000 at B=512: two chunks of 256 rows, one group over all SMs each
    chunks = cuda_gru.gru_grid_chunks(24, 512, 77, 0, 1000, 0, DENSE_PRE)
    assert [(b0, n, p.groups, p.ctas) for b0, n, p in chunks] == [(0, 256, 1, 132),
                                                                 (256, 256, 1, 132)]
    # h=3200: one group over all SMs, each slice streamed through a ring
    # whose two stages take the room that held a share of its rows
    for r, form in ((0, POST), (0, DENSE_PRE), (800, LOWRANK)):
        (_, _, plan), = cuda_gru.gru_grid_chunks(24, 81, 77, 9, 3200, r, form)
        assert plan.groups == 1 and plan.ctas == SMS and plan.streamed
        for kernel in ("fwd", "bwd"):
            assert all(0 <= res < d for (d, _), res in zip(plan.slices(kernel),
                                                           plan.resident(kernel)) if d)
            assert plan.piece(kernel) >= cuda_gru.ring_piece(plan.rpad) * 3 // 4


def test_a_forced_streamed_grid_plan_keeps_the_stage_and_the_partials():
    # the same groups and CTAs with fewer resident rows: the same products,
    # staged and reduced alike, so the same order of sums
    plan = cuda_gru.gru_grid_plan(6, 37, 20, 5, 197, 23, LOWRANK)
    part = tuple(tuple(d // 3 for d, _ in plan.slices(k)) for k in ("fwd", "bwd"))
    streamed = cuda_gru.grid_plan_layout(37, 197, 23, LOWRANK, plan.groups, plan.ctas,
                                         resident=part)
    assert streamed.streamed and not plan.streamed
    for k in ("stage_fwd", "red_fwd", "stage_bwd", "red_bwd", "rpad", "xchg_fwd", "xchg_bwd"):
        assert getattr(streamed, k) == getattr(plan, k), k
    check_grid_plan(streamed, 37, 197, 23, LOWRANK)


def test_grid_plan_raises_only_on_arguments_the_kernels_do_not_take():
    for bad in ((24, 0, 77, 9, 64, 0, POST), (24, 4, 77, 9, 64, 0, 3), (24, 4, 77, 9, 64, 5, POST),
                (24, 4, 77, 9, 64, 0, LOWRANK), (24, 4, 0, 9, 64, 0, POST)):
        with pytest.raises(ValueError):
            cuda_gru.gru_grid_plan(*bad)
    assert cuda_gru.gru_grid_plan(24, 4, 0, 0, 64, 0, POST, gi=True).b == 4


# gru_plan's layout of the parent commit at the shapes whose recurrent
# weights sit in registers or shared memory in both kernels, (B, rx, h,
# form, gi) -> (rows, threads, tblock, forward weights, x resident,
# smem_fwd, walk weights, smem_bwd, spill_fwd, spill_bwd), weights as
# WEIGHT_PLACES indices; T=24, F=77 (0 in gi mode), r = 9 low-rank, else 0
PARENT_PLANS = {
    (1, 9, 5, 0, 0): (1, 64, 24, 2, 1, 14096, 2, 448, 0, 0),
    (1, 0, 5, 0, 0): (1, 64, 24, 2, 1, 14144, 2, 448, 0, 0),
    (1, 0, 5, 0, 1): (1, 64, 24, 2, 0, 1664, 2, 448, 0, 0),
    (1, 9, 5, 1, 0): (1, 32, 24, 2, 1, 14000, 2, 352, 0, 0),
    (1, 0, 5, 1, 0): (1, 32, 24, 2, 1, 14048, 2, 352, 0, 0),
    (1, 0, 5, 1, 1): (1, 32, 24, 2, 0, 1568, 2, 352, 0, 0),
    (1, 9, 5, 2, 0): (1, 32, 24, 2, 1, 13936, 2, 432, 0, 0),
    (1, 0, 5, 2, 0): (1, 32, 24, 2, 1, 13984, 2, 432, 0, 0),
    (1, 0, 5, 2, 1): (1, 32, 24, 2, 0, 1504, 2, 432, 0, 0),
    (81, 9, 5, 0, 0): (1, 64, 24, 2, 1, 14096, 2, 448, 0, 0),
    (81, 0, 5, 0, 0): (1, 64, 24, 2, 1, 14144, 2, 448, 0, 0),
    (81, 0, 5, 0, 1): (1, 64, 24, 2, 0, 1664, 2, 448, 0, 0),
    (81, 9, 5, 1, 0): (1, 32, 24, 2, 1, 14000, 2, 352, 0, 0),
    (81, 0, 5, 1, 0): (1, 32, 24, 2, 1, 14048, 2, 352, 0, 0),
    (81, 0, 5, 1, 1): (1, 32, 24, 2, 0, 1568, 2, 352, 0, 0),
    (81, 9, 5, 2, 0): (1, 32, 24, 2, 1, 13936, 2, 432, 0, 0),
    (81, 0, 5, 2, 0): (1, 32, 24, 2, 1, 13984, 2, 432, 0, 0),
    (81, 0, 5, 2, 1): (1, 32, 24, 2, 0, 1504, 2, 432, 0, 0),
    (256, 9, 5, 0, 0): (2, 64, 24, 2, 1, 24576, 2, 848, 0, 0),
    (256, 0, 5, 0, 0): (2, 64, 24, 2, 1, 23472, 2, 848, 0, 0),
    (256, 0, 5, 0, 1): (2, 64, 24, 2, 0, 3312, 2, 848, 0, 0),
    (256, 9, 5, 1, 0): (2, 32, 24, 2, 1, 24384, 2, 656, 0, 0),
    (256, 0, 5, 1, 0): (2, 32, 24, 2, 1, 23280, 2, 656, 0, 0),
    (256, 0, 5, 1, 1): (2, 32, 24, 2, 0, 3120, 2, 656, 0, 0),
    (256, 9, 5, 2, 0): (2, 32, 24, 2, 1, 24272, 2, 848, 0, 0),
    (256, 0, 5, 2, 0): (2, 32, 24, 2, 1, 23168, 2, 848, 0, 0),
    (256, 0, 5, 2, 1): (2, 32, 24, 2, 0, 3008, 2, 848, 0, 0),
    (600, 9, 5, 0, 0): (4, 64, 24, 2, 1, 45536, 2, 1664, 0, 0),
    (600, 0, 5, 0, 0): (4, 64, 24, 2, 1, 42128, 2, 1664, 0, 0),
    (600, 0, 5, 0, 1): (4, 64, 24, 2, 0, 6608, 2, 1664, 0, 0),
    (600, 9, 5, 1, 0): (4, 32, 24, 2, 1, 45152, 2, 1280, 0, 0),
    (600, 0, 5, 1, 0): (4, 32, 24, 2, 1, 41744, 2, 1280, 0, 0),
    (600, 0, 5, 1, 1): (4, 32, 24, 2, 0, 6224, 2, 1280, 0, 0),
    (600, 9, 5, 2, 0): (4, 32, 24, 2, 1, 44944, 2, 1680, 0, 0),
    (600, 0, 5, 2, 0): (4, 32, 24, 2, 1, 41536, 2, 1680, 0, 0),
    (600, 0, 5, 2, 1): (4, 32, 24, 2, 0, 6016, 2, 1680, 0, 0),
    (1, 9, 37, 0, 0): (1, 160, 24, 2, 1, 28432, 2, 2368, 0, 0),
    (1, 0, 37, 0, 0): (1, 160, 24, 2, 1, 54592, 2, 2368, 0, 0),
    (1, 0, 37, 0, 1): (1, 160, 24, 2, 0, 11392, 2, 2368, 0, 0),
    (1, 9, 37, 1, 0): (1, 160, 24, 2, 1, 28336, 2, 2272, 0, 0),
    (1, 0, 37, 1, 0): (1, 160, 24, 2, 1, 54496, 2, 2272, 0, 0),
    (1, 0, 37, 1, 1): (1, 160, 24, 2, 0, 11296, 2, 2272, 0, 0),
    (1, 9, 37, 2, 0): (1, 160, 24, 2, 1, 28016, 2, 2864, 0, 0),
    (1, 0, 37, 2, 0): (1, 160, 24, 2, 1, 54176, 2, 2864, 0, 0),
    (1, 0, 37, 2, 1): (1, 160, 24, 2, 0, 10976, 2, 2864, 0, 0),
    (81, 9, 37, 0, 0): (1, 160, 24, 2, 1, 28432, 2, 2368, 0, 0),
    (81, 0, 37, 0, 0): (1, 160, 24, 2, 1, 54592, 2, 2368, 0, 0),
    (81, 0, 37, 0, 1): (1, 160, 24, 2, 0, 11392, 2, 2368, 0, 0),
    (81, 9, 37, 1, 0): (1, 160, 24, 2, 1, 28336, 2, 2272, 0, 0),
    (81, 0, 37, 1, 0): (1, 160, 24, 2, 1, 54496, 2, 2272, 0, 0),
    (81, 0, 37, 1, 1): (1, 160, 24, 2, 0, 11296, 2, 2272, 0, 0),
    (81, 9, 37, 2, 0): (1, 160, 24, 2, 1, 28016, 2, 2864, 0, 0),
    (81, 0, 37, 2, 0): (1, 160, 24, 2, 1, 54176, 2, 2864, 0, 0),
    (81, 0, 37, 2, 1): (1, 160, 24, 2, 0, 10976, 2, 2864, 0, 0),
    (256, 9, 37, 0, 0): (2, 160, 24, 2, 1, 48640, 2, 4688, 0, 0),
    (256, 0, 37, 0, 0): (2, 160, 24, 2, 1, 73648, 2, 4688, 0, 0),
    (256, 0, 37, 0, 1): (2, 160, 24, 2, 0, 22768, 2, 4688, 0, 0),
    (256, 9, 37, 1, 0): (2, 160, 24, 2, 1, 48448, 2, 4496, 0, 0),
    (256, 0, 37, 1, 0): (2, 160, 24, 2, 1, 73456, 2, 4496, 0, 0),
    (256, 0, 37, 1, 1): (2, 160, 24, 2, 0, 22576, 2, 4496, 0, 0),
    (256, 9, 37, 2, 0): (2, 160, 24, 2, 1, 47824, 2, 5712, 0, 0),
    (256, 0, 37, 2, 0): (2, 160, 24, 2, 1, 72832, 2, 5712, 0, 0),
    (256, 0, 37, 2, 1): (2, 160, 24, 2, 0, 21952, 2, 5712, 0, 0),
    (600, 9, 37, 0, 0): (4, 160, 24, 2, 1, 89056, 2, 9344, 0, 0),
    (600, 0, 37, 0, 0): (4, 160, 24, 2, 1, 111760, 2, 9344, 0, 0),
    (600, 0, 37, 0, 1): (4, 160, 24, 2, 0, 45520, 2, 9344, 0, 0),
    (600, 9, 37, 1, 0): (4, 160, 24, 2, 1, 88672, 2, 8960, 0, 0),
    (600, 0, 37, 1, 0): (4, 160, 24, 2, 1, 111376, 2, 8960, 0, 0),
    (600, 0, 37, 1, 1): (4, 160, 24, 2, 0, 45136, 2, 8960, 0, 0),
    (600, 9, 37, 2, 0): (4, 160, 24, 2, 1, 87440, 2, 11408, 0, 0),
    (600, 0, 37, 2, 0): (4, 160, 24, 2, 1, 110144, 2, 11408, 0, 0),
    (600, 0, 37, 2, 1): (4, 160, 24, 2, 0, 43904, 2, 11408, 0, 0),
    (1, 9, 64, 0, 0): (1, 256, 24, 2, 1, 40480, 2, 3936, 0, 0),
    (1, 0, 64, 0, 0): (1, 256, 24, 2, 1, 88672, 2, 3936, 0, 0),
    (1, 0, 64, 0, 1): (1, 256, 24, 2, 0, 19552, 2, 3936, 0, 0),
    (1, 9, 64, 1, 0): (1, 256, 24, 2, 1, 40384, 2, 3840, 0, 0),
    (1, 0, 64, 1, 0): (1, 256, 24, 2, 1, 88576, 2, 3840, 0, 0),
    (1, 0, 64, 1, 1): (1, 256, 24, 2, 0, 19456, 2, 3840, 0, 0),
    (1, 9, 64, 2, 0): (1, 256, 24, 2, 1, 39872, 2, 4864, 0, 0),
    (1, 0, 64, 2, 0): (1, 256, 24, 2, 1, 88064, 2, 4864, 0, 0),
    (1, 0, 64, 2, 1): (1, 256, 24, 2, 0, 18944, 2, 4864, 0, 0),
    (81, 9, 64, 0, 0): (1, 256, 24, 2, 1, 40480, 2, 3936, 0, 0),
    (81, 0, 64, 0, 0): (1, 256, 24, 2, 1, 88672, 2, 3936, 0, 0),
    (81, 0, 64, 0, 1): (1, 256, 24, 2, 0, 19552, 2, 3936, 0, 0),
    (81, 9, 64, 1, 0): (1, 256, 24, 2, 1, 40384, 2, 3840, 0, 0),
    (81, 0, 64, 1, 0): (1, 256, 24, 2, 1, 88576, 2, 3840, 0, 0),
    (81, 0, 64, 1, 1): (1, 256, 24, 2, 0, 19456, 2, 3840, 0, 0),
    (81, 9, 64, 2, 0): (1, 256, 24, 2, 1, 39872, 2, 4864, 0, 0),
    (81, 0, 64, 2, 0): (1, 256, 24, 2, 1, 88064, 2, 4864, 0, 0),
    (81, 0, 64, 2, 1): (1, 256, 24, 2, 0, 18944, 2, 4864, 0, 0),
    (256, 9, 64, 0, 0): (2, 256, 24, 2, 1, 68864, 2, 7872, 0, 0),
    (256, 0, 64, 0, 0): (2, 256, 24, 2, 1, 115904, 2, 7872, 0, 0),
    (256, 0, 64, 0, 1): (2, 256, 24, 2, 0, 39104, 2, 7872, 0, 0),
    (256, 9, 64, 1, 0): (2, 256, 24, 2, 1, 68672, 2, 7680, 0, 0),
    (256, 0, 64, 1, 0): (2, 256, 24, 2, 1, 115712, 2, 7680, 0, 0),
    (256, 0, 64, 1, 1): (2, 256, 24, 2, 0, 38912, 2, 7680, 0, 0),
    (256, 9, 64, 2, 0): (2, 256, 24, 2, 1, 67648, 2, 9728, 0, 0),
    (256, 0, 64, 2, 0): (2, 256, 24, 2, 1, 114688, 2, 9728, 0, 0),
    (256, 0, 64, 2, 1): (2, 256, 24, 2, 0, 37888, 2, 9728, 0, 0),
    (600, 9, 64, 0, 0): (4, 256, 24, 2, 1, 125632, 2, 15744, 0, 0),
    (600, 0, 64, 0, 0): (4, 256, 24, 2, 1, 170368, 2, 15744, 0, 0),
    (600, 0, 64, 0, 1): (4, 256, 24, 2, 0, 78208, 2, 15744, 0, 0),
    (600, 9, 64, 1, 0): (4, 256, 24, 2, 1, 125248, 2, 15360, 0, 0),
    (600, 0, 64, 1, 0): (4, 256, 24, 2, 1, 169984, 2, 15360, 0, 0),
    (600, 0, 64, 1, 1): (4, 256, 24, 2, 0, 77824, 2, 15360, 0, 0),
    (600, 9, 64, 2, 0): (4, 256, 24, 2, 1, 123200, 2, 19456, 0, 0),
    (600, 0, 64, 2, 0): (4, 256, 24, 2, 1, 167936, 2, 19456, 0, 0),
    (600, 0, 64, 2, 1): (4, 256, 24, 2, 0, 75776, 2, 19456, 0, 0),
    (1, 9, 96, 0, 0): (1, 384, 24, 1, 1, 72096, 1, 21120, 0, 0),
    (1, 0, 96, 0, 0): (1, 384, 24, 1, 1, 146400, 1, 21120, 0, 0),
    (1, 0, 96, 0, 1): (1, 384, 24, 1, 0, 46560, 1, 21120, 0, 0),
    (1, 9, 96, 1, 0): (1, 384, 24, 1, 1, 165312, 1, 119424, 0, 0),
    (1, 0, 96, 1, 0): (1, 384, 12, 1, 1, 221952, 1, 119424, 0, 0),
    (1, 0, 96, 1, 1): (1, 384, 24, 1, 0, 139776, 1, 119424, 0, 0),
    (1, 9, 96, 2, 0): (1, 384, 24, 1, 1, 164544, 1, 120960, 0, 0),
    (1, 0, 96, 2, 0): (1, 384, 12, 1, 1, 221184, 1, 120960, 0, 0),
    (1, 0, 96, 2, 1): (1, 384, 24, 1, 0, 139008, 1, 120960, 0, 0),
    (81, 9, 96, 0, 0): (1, 384, 24, 1, 1, 72096, 1, 21120, 0, 0),
    (81, 0, 96, 0, 0): (1, 384, 24, 1, 1, 146400, 1, 21120, 0, 0),
    (81, 0, 96, 0, 1): (1, 384, 24, 1, 0, 46560, 1, 21120, 0, 0),
    (81, 9, 96, 1, 0): (1, 384, 24, 1, 1, 165312, 1, 119424, 0, 0),
    (81, 0, 96, 1, 0): (1, 384, 12, 1, 1, 221952, 1, 119424, 0, 0),
    (81, 0, 96, 1, 1): (1, 384, 24, 1, 0, 139776, 1, 119424, 0, 0),
    (81, 9, 96, 2, 0): (1, 384, 24, 1, 1, 164544, 1, 120960, 0, 0),
    (81, 0, 96, 2, 0): (1, 384, 12, 1, 1, 221184, 1, 120960, 0, 0),
    (81, 0, 96, 2, 1): (1, 384, 24, 1, 0, 139008, 1, 120960, 0, 0),
    (256, 9, 96, 0, 0): (2, 384, 24, 1, 1, 110208, 1, 26976, 0, 0),
    (256, 0, 96, 0, 0): (2, 384, 24, 1, 1, 183360, 1, 26976, 0, 0),
    (256, 0, 96, 0, 1): (2, 384, 24, 1, 0, 75840, 1, 26976, 0, 0),
    (256, 9, 96, 1, 0): (2, 384, 24, 1, 1, 203328, 1, 125184, 0, 0),
    (256, 0, 96, 1, 0): (2, 384, 6, 1, 1, 223488, 1, 125184, 0, 0),
    (256, 0, 96, 1, 1): (2, 384, 24, 1, 0, 168960, 1, 125184, 0, 0),
    (256, 9, 96, 2, 0): (2, 384, 24, 1, 1, 201792, 1, 128256, 0, 0),
    (256, 0, 96, 2, 0): (2, 384, 6, 1, 1, 221952, 1, 128256, 0, 0),
    (256, 0, 96, 2, 1): (2, 384, 24, 1, 0, 167424, 1, 128256, 0, 0),
    (600, 9, 96, 0, 0): (4, 384, 24, 1, 1, 186432, 1, 38688, 0, 0),
    (600, 0, 96, 0, 0): (4, 384, 12, 1, 1, 186624, 1, 38688, 0, 0),
    (600, 0, 96, 0, 1): (4, 384, 24, 1, 0, 134400, 1, 38688, 0, 0),
    (600, 9, 96, 1, 0): (4, 384, 12, 1, 1, 206400, 1, 136704, 0, 0),
    (600, 0, 96, 1, 0): (4, 384, 3, 1, 1, 226560, 1, 136704, 0, 0),
    (600, 0, 96, 1, 1): (4, 384, 24, 1, 0, 227328, 1, 136704, 0, 0),
    (600, 9, 96, 2, 0): (4, 384, 12, 1, 1, 203328, 1, 142848, 0, 0),
    (600, 0, 96, 2, 0): (4, 384, 3, 1, 1, 223488, 1, 142848, 0, 0),
    (600, 0, 96, 2, 1): (4, 384, 24, 1, 0, 224256, 1, 142848, 0, 0),
    (1, 9, 135, 0, 0): (1, 512, 24, 1, 1, 96640, 1, 29680, 0, 0),
    (1, 0, 135, 0, 0): (1, 512, 24, 1, 1, 202768, 1, 29680, 0, 0),
    (1, 0, 135, 0, 1): (1, 512, 24, 1, 0, 65488, 1, 29680, 0, 0),
    (81, 9, 135, 0, 0): (1, 512, 24, 1, 1, 96640, 1, 29680, 0, 0),
    (81, 0, 135, 0, 0): (1, 512, 24, 1, 1, 202768, 1, 29680, 0, 0),
    (81, 0, 135, 0, 1): (1, 512, 24, 1, 0, 65488, 1, 29680, 0, 0),
    (256, 9, 135, 0, 0): (2, 512, 24, 1, 1, 146624, 1, 37888, 0, 0),
    (256, 0, 135, 0, 0): (2, 512, 12, 1, 1, 205040, 1, 37888, 0, 0),
    (256, 0, 135, 0, 1): (2, 512, 24, 1, 0, 106640, 1, 37888, 0, 0),
    (600, 9, 135, 0, 0): (4, 512, 12, 1, 1, 151152, 1, 54288, 0, 0),
    (600, 0, 135, 0, 0): (4, 512, 6, 1, 1, 209568, 1, 54288, 0, 0),
    (600, 0, 135, 0, 1): (4, 512, 24, 1, 0, 188928, 1, 54288, 0, 0),
    (1, 9, 136, 0, 0): (1, 512, 24, 1, 1, 97216, 1, 29760, 0, 0),
    (1, 0, 136, 0, 0): (1, 512, 24, 1, 1, 204160, 1, 29760, 0, 0),
    (1, 0, 136, 0, 1): (1, 512, 24, 1, 0, 65920, 1, 29760, 0, 0),
    (81, 9, 136, 0, 0): (1, 512, 24, 1, 1, 97216, 1, 29760, 0, 0),
    (81, 0, 136, 0, 0): (1, 512, 24, 1, 1, 204160, 1, 29760, 0, 0),
    (81, 0, 136, 0, 1): (1, 512, 24, 1, 0, 65920, 1, 29760, 0, 0),
    (256, 9, 136, 0, 0): (2, 512, 24, 1, 1, 147488, 1, 38016, 0, 0),
    (256, 0, 136, 0, 0): (2, 512, 12, 1, 1, 206432, 1, 38016, 0, 0),
    (256, 0, 136, 0, 1): (2, 512, 24, 1, 0, 107360, 1, 38016, 0, 0),
    (600, 9, 136, 0, 0): (4, 512, 12, 1, 1, 152032, 1, 54528, 0, 0),
    (600, 0, 136, 0, 0): (4, 512, 6, 1, 1, 210976, 1, 54528, 0, 0),
    (600, 0, 136, 0, 1): (4, 512, 24, 1, 0, 190240, 1, 54528, 0, 0),
    (1, 9, 144, 0, 0): (1, 512, 24, 1, 1, 102240, 1, 31488, 0, 0),
    (1, 0, 144, 0, 0): (1, 512, 24, 1, 1, 215712, 1, 31488, 0, 0),
    (1, 0, 144, 0, 1): (1, 512, 24, 1, 0, 69792, 1, 31488, 0, 0),
    (81, 9, 144, 0, 0): (1, 512, 24, 1, 1, 102240, 1, 31488, 0, 0),
    (81, 0, 144, 0, 0): (1, 512, 24, 1, 1, 215712, 1, 31488, 0, 0),
    (81, 0, 144, 0, 1): (1, 512, 24, 1, 0, 69792, 1, 31488, 0, 0),
    (256, 9, 144, 0, 0): (2, 512, 24, 1, 1, 154944, 1, 40224, 0, 0),
    (256, 0, 144, 0, 0): (2, 512, 12, 1, 1, 218112, 1, 40224, 0, 0),
    (256, 0, 144, 0, 1): (2, 512, 24, 1, 0, 113664, 1, 40224, 0, 0),
    (600, 9, 144, 0, 0): (4, 512, 12, 1, 1, 159744, 1, 57696, 0, 0),
    (600, 0, 144, 0, 0): (4, 512, 6, 1, 1, 222912, 1, 57696, 0, 0),
    (600, 0, 144, 0, 1): (4, 512, 24, 1, 0, 201408, 1, 57696, 0, 0),
    (1, 9, 180, 0, 0): (1, 512, 24, 1, 1, 124848, 1, 39120, 0, 0),
    (1, 0, 180, 0, 0): (1, 512, 6, 1, 1, 223056, 1, 39120, 0, 0),
    (1, 0, 180, 0, 1): (1, 512, 24, 1, 0, 87216, 1, 39120, 0, 0),
    (81, 9, 180, 0, 0): (1, 512, 24, 1, 1, 124848, 1, 39120, 0, 0),
    (81, 0, 180, 0, 0): (1, 512, 6, 1, 1, 223056, 1, 39120, 0, 0),
    (81, 0, 180, 0, 1): (1, 512, 24, 1, 0, 87216, 1, 39120, 0, 0),
    (256, 9, 180, 0, 0): (2, 512, 24, 1, 1, 188496, 1, 50016, 0, 0),
    (256, 0, 180, 0, 0): (2, 512, 3, 1, 1, 226032, 1, 50016, 0, 0),
    (256, 0, 180, 0, 1): (2, 512, 24, 1, 0, 142032, 1, 50016, 0, 0),
    (600, 9, 180, 0, 0): (4, 512, 12, 1, 1, 194448, 1, 71808, 0, 0),
    (600, 0, 180, 0, 0): (4, 512, 1, 1, 1, 227024, 1, 71808, 0, 0),
    (600, 0, 180, 0, 1): (4, 512, 12, 1, 0, 147984, 1, 71808, 0, 0),
}


def test_layout_keeps_the_row_plan_wherever_the_weights_sit_in_registers_or_shared():
    places = cuda_gru.WEIGHT_PLACES
    for (b, rx, h, form, gi), want in PARENT_PLANS.items():
        f, r = 0 if gi else 77, 9 if form == LOWRANK else 0
        layout = cuda_gru.gru_layout(24, b, f, rx, h, r, form, gi=bool(gi))
        assert isinstance(layout, cuda_gru.GRUPlan)
        assert layout == cuda_gru.gru_plan(24, b, f, rx, h, r, form, gi=bool(gi))
        assert cuda_gru.gru_layout(24, b, f, rx, h, r, form, kernel="bwd", gi=bool(gi)) == layout
        got = (layout.rows, layout.threads, layout.tblock, places.index(layout.rec_weights),
               int(layout.x_resident), layout.smem_fwd, places.index(layout.bwd_rec_weights),
               layout.smem_bwd, layout.spill_fwd, layout.spill_bwd)
        assert got == want, (b, rx, h, form, gi)


@pytest.mark.parametrize("form", [LOWRANK, DENSE_PRE, POST], ids=["lowrank_pre", "dense_pre",
                                                                 "dense_post"])
def test_each_kernel_takes_the_grid_where_its_row_plan_reads_through_l2(form):
    taken = set()
    for h in (64, 135, 136, 137, 180, 256, 1000, 3200):
        for b in (1, 81, 256):
            r = 9 if form == LOWRANK else 0
            row = cuda_gru.gru_plan(24, b, 77, 0, h, r, form)
            for kernel, place in (("fwd", row.rec_weights), ("bwd", row.bwd_rec_weights)):
                layout = cuda_gru.gru_layout(24, b, 77, 0, h, r, form, kernel=kernel)
                if place == "L2":
                    assert layout == cuda_gru.gru_grid_chunks(24, b, 77, 0, h, r, form)
                else:
                    assert layout == row
                taken.add((kernel, place == "L2"))
    assert taken == {(k, grid) for k in ("fwd", "bwd") for grid in (False, True)}
    if form != LOWRANK:  # a dense h of 135-136: the forward on rows, the walk on the grid
        row = cuda_gru.gru_plan(24, 81, 77, 0, 136, 0, form)
        assert row.rec_weights == "shared" and row.bwd_rec_weights == "L2"


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# the HAR GRU nets at h=180 (HARConfig fields): `har_main --model mygru` at
# its defaults (dense "pre", dense x side) and the group GRU (dense "post",
# u_ranks (12, 6))
HAR180 = {"mygru": dict(model="mygru"),
          "mygru_group": dict(model="mygru_group", u_ranks=(12, 6))}


@pytest.mark.parametrize("case", list(HAR180))
def test_har_gru_at_h180_matches_jax_outputs_and_gradients(case):
    kw = dict(HAR180[case], layer_sizes=(180,))
    jm = jconfig.HARConfig(**kw, backend="pallas").build_model()
    m = config.HARConfig(**kw).build_model()
    jparams = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 24, 77)).astype(np.float32)
    w = rng.standard_normal((8, 18)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jm.apply(p, jnp.asarray(x)) * w)

    want, jgrads = jax.value_and_grad(jloss)(jparams)
    params = params_from_jax(to_np(jparams), device="cpu")
    leaves = [p for p in jax.tree_util.tree_leaves(params) if isinstance(p, torch.Tensor)]
    for p in leaves:
        p.requires_grad_(True)
    out = m.apply(params, torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jm.apply(jparams, jnp.asarray(x))),
                               **FWD_TOL)
    loss = (out * torch.from_numpy(w)).sum()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    loss.backward()
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda p: p.grad.numpy(), params))}
    for k, g in jax.tree_util.tree_leaves_with_path(to_np(jgrads)):
        np.testing.assert_allclose(got[jax.tree_util.keystr(k)], g,
                                   err_msg=jax.tree_util.keystr(k), **GRAD_TOL)
