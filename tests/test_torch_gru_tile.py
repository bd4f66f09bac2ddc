"""The GRU grid kernels' product items of R batch rows, on the CPU
(`cuda_gru.grid_tiles`, `GRUGridPlan.tile`).

A consumer thread of csrc/scan_grid.cuh's products sums an item of 4
columns by R rows (4, 8 or 12): R/4 float4 of the exchange and one float4
of W a depth row for 4R FMAs. The plan picks R for each kernel
(`grid_tiles`), pads a group's rows to a multiple of both and cuts each
kernel's items, depth slices and slices' partials (`red`) by its own.
Here the plans at the grid shapes that `chip_smoke.py` runs are held to
the rule's choice and to the kernels' carve, and the loop's order of
sums is emulated in numpy (each thread's
rows, chunk by chunk and piece by piece, the slices' partials added in
slice order through `red` in R/4 passes of 16 sums) against a float64
product; at R = 4 each thread's rows are the parent's ring mirror's
(`test_torch_wide_plans.ring_walk`).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_gru_ring import CARD_SHAPES, carve_floats, chunks_of  # noqa: E402
from test_torch_wide_plans import ring_walk  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_gru  # noqa: E402
from vmlmf_tpu_torch.ops.cuda_scan import (  # noqa: E402
    GRID_THREADS,
    MAX_SLICES,
    MIN_SLICE_DEPTH,
    SMEM_LIMIT,
    ring_chunk,
)

SMS = 132  # an H100 SXM
EMU_RTOL = 1e-5  # f32 sums in the kernel's order against float64, relative to the largest

# the rows R of a product item, (forward, walk), that the rule gives each of
# CARD_SHAPES: on the ring only the "post" forward takes a taller item (the
# others spill more at 8 and 12 than at 4), 12 in groups of 84 rows; every
# row resident, dense "pre" groups of 256 rows take 8
CHOSEN_TILE = {"h3200_post": (12, 4), "h3200_pre": (4, 4), "h3200_lowrank": (4, 4),
               "h1000_b512": (8, 8), "h180_pre_b81": (4, 4), "h180_post_b256": (4, 4),
               "odd_lowrank": (4, 4), "odd_dense_pre": (4, 4), "odd_dense_post": (4, 4)}


def item_slices(depth, cols, rpad, tile, red):
    """The depth slices of a product of items of ``tile`` rows
    (scan_grid.cuh: slice_product, Ring::walk)."""
    items = cols // 4 * (rpad // tile)
    most = 1 if items >= GRID_THREADS else min(MAX_SLICES, GRID_THREADS // items)
    return items, max(1, min(most, depth // MIN_SLICE_DEPTH, red // (16 * items)))


def units(plan, kernel):
    """The threads each product of ``kernel``'s step keeps busy: its items
    times its depth slices, a pass of at most the 512 consumers."""
    red = 16 * GRID_THREADS
    return [min(GRID_THREADS, math.prod(item_slices(depth, cols, plan.rpad, plan.tile(kernel),
                                                    red)))
            for depth, cols in cuda_gru._grid_phases(plan.h, plan.r, plan.form,
                                                     plan.ctas)[kernel]]


def products(plan, kernel):
    """(depth, columns, the ring's pieces over one pass or the whole depth,
    slice_product's chunk) of each product of ``kernel``'s step."""
    stage = plan.stage_fwd if kernel == "fwd" else plan.stage_bwd
    walk = plan.walk(kernel)
    out = []
    for i, (depth, cols) in enumerate(cuda_gru._grid_phases(plan.h, plan.r, plan.form,
                                                            plan.ctas)[kernel]):
        pieces = walk[i][3] if walk else ((0, depth),)
        out.append((depth, cols, pieces, ring_chunk(depth, plan.rpad, stage)))
    return out


def thread_rows(pieces, chunk, slices, s):
    """The depth rows that thread s of an item sums, in its order, as
    Ring::consume walks the pieces (one piece: slice_product's chunks): the
    next row carried from piece to piece, the next chunk's row c0 + s where
    a chunk ends; the whole depth as one chunk where the slices divide it."""
    depth = pieces[-1][1]
    chunk = depth if chunk % slices == 0 else chunk
    rows, c0, d = [], 0, s
    for _, e1 in pieces:
        while True:
            end = min(e1, c0 + chunk)
            rows.extend(range(d, end, slices))
            d += -(-(end - d) // slices) * slices if d < end else 0
            if end < c0 + chunk:
                break
            c0 += chunk
            d = c0 + s
            if c0 >= e1:
                break
    return rows


def emulate(a, w, tile, red, pieces, chunk):
    """out[row][col] = sum over d of a[d][row] * w[d][col] in f32 as the
    grid kernels sum it with items of ``tile`` rows: each slice's thread
    over its rows in order, then the slices' partials through ``red`` in
    tile / 4 passes of 16 sums an item, added in slice order -> (out, the
    floats of red a pass takes)."""
    depth, rpad = a.shape
    cols = w.shape[1]
    items, slices = item_slices(depth, cols, rpad, tile, red)
    parts = np.zeros((slices, rpad, cols), np.float32)
    for s in range(slices):
        for d in thread_rows(pieces, chunk, slices, s):
            parts[s] += np.outer(a[d], w[d]).astype(np.float32)
    out = parts[0].copy()
    for z in range(1, slices):  # each pass's 16 sums an item, in slice order
        out += parts[z]
    return out, (16 * items * slices if slices > 1 else 0), slices


@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_plans_at_the_card_shapes_take_the_rule_s_tile_and_fit(name):
    """Each chunk's plan: the rule's R in each kernel, rows padded to a
    multiple of both (no more than their multiple less one past the group's
    rows), every product's units (items of 4 columns by R rows, times their
    slices) no more than the 512 consumer threads where the depth is
    sliced, `red` 16 x items x slices floats of the largest sliced product,
    and the carve within the card's 227 KB."""
    for _, n, plan in chunks_of(CARD_SHAPES[name]):
        assert (plan.tile_fwd, plan.tile_bwd) == CHOSEN_TILE[name]
        both = math.lcm(plan.tile_fwd, plan.tile_bwd)
        assert plan.rpad % both == 0 and plan.rpad - both < -(-n // plan.groups) <= plan.rpad
        for kernel in ("fwd", "bwd"):
            tile = plan.tile(kernel)
            red = plan.red_fwd if kernel == "fwd" else plan.red_bwd
            smem = plan.smem_fwd if kernel == "fwd" else plan.smem_bwd
            want = 0
            for depth, cols, _, _ in products(plan, kernel):
                items, slices = item_slices(depth, cols, plan.rpad, tile, 16 * GRID_THREADS)
                assert slices == 1 or items * slices <= GRID_THREADS
                want = max(want, 16 * items * slices if slices > 1 else 0)
            assert red == want
            assert 4 * carve_floats(plan, kernel) == smem <= SMEM_LIMIT


@pytest.mark.parametrize("name", ["h3200_post", "h3200_pre", "h3200_lowrank", "h1000_b512",
                                  "odd_lowrank", "odd_dense_post"])
def test_four_row_items_walk_the_ring_mirror_s_rows(name):
    """At R = 4 each thread of each product walks the rows of the parent's
    mirror of the ring (`ring_walk`), for the plan's slices and every
    slice count."""
    t, b, f, rx, h, r, form = CARD_SHAPES[name]
    for _, n, chosen in chunks_of(CARD_SHAPES[name]):
        plan = (cuda_gru.grid_streamed_plan(n, h, r, form, SMS, tile=4) if chosen.streamed
                else cuda_gru.grid_plan_layout(n, h, r, form, chosen.groups, chosen.ctas,
                                               tile=4))
        for kernel in ("fwd", "bwd"):
            red = plan.red_fwd if kernel == "fwd" else plan.red_bwd
            for depth, cols, pieces, chunk in products(plan, kernel):
                _, used = item_slices(depth, cols, plan.rpad, 4, red)
                for slices in sorted({1, 2, 3, used, MAX_SLICES}):
                    for s in range(slices):
                        assert thread_rows(pieces, chunk, slices, s) == ring_walk(
                            pieces, chunk, slices, s)


def tile_plan(name, tile):
    """The first chunk's plan of CARD_SHAPES[name] with items of ``tile``
    rows in both kernels (its groups and CTAs; its ring where it streams)."""
    t, b, f, rx, h, r, form = CARD_SHAPES[name]
    (_, n, chosen), *_ = chunks_of(CARD_SHAPES[name])
    if chosen.streamed:
        return cuda_gru.grid_streamed_plan(n, h, r, form, SMS, tile=tile)
    return cuda_gru.grid_plan_layout(n, h, r, form, chosen.groups, chosen.ctas, tile=tile)


@pytest.mark.parametrize("tile", [8, 12])
@pytest.mark.parametrize("name", ["h3200_post", "h3200_pre", "h3200_lowrank", "h1000_b512",
                                  "odd_lowrank"])
def test_the_loop_s_order_of_sums_holds_to_float64(name, tile):
    """Every product of both kernels at items of 8 and 12 rows, emulated
    in f32 in the kernels' order (`emulate`) on seeded operands of its
    depth, padded rows and columns: within 1e-5 of the float64 product
    (relative to its largest value); its slices' partials, 16 sums an item
    a pass, fit the plan's `red`; and each thread's rows cover the depth
    once over the slices."""
    plan = tile_plan(name, tile)
    assert plan.tile_fwd == plan.tile_bwd == tile and plan.rpad % tile == 0
    rng = np.random.default_rng(7)
    for kernel in ("fwd", "bwd"):
        red = plan.red_fwd if kernel == "fwd" else plan.red_bwd
        for depth, cols, pieces, chunk in products(plan, kernel):
            a = rng.standard_normal((depth, plan.rpad)).astype(np.float32)
            w = (rng.standard_normal((depth, cols)) / np.sqrt(depth)).astype(np.float32)
            got, floats, slices = emulate(a, w, tile, red, pieces, chunk)
            assert floats <= red
            rows = sorted(d for s in range(slices) for d in thread_rows(pieces, chunk, slices, s))
            assert rows == list(range(depth))
            want = a.astype(np.float64).T @ w.astype(np.float64)
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= EMU_RTOL, (kernel, depth, cols, err)


def test_the_rule_keeps_four_row_items_where_the_parent_s_bits_are_kept():
    """The HAR widths (h=180, whose groups pad to 4 or 8 rows) keep R = 4
    in both kernels, so their plans are the parent's; elsewhere a kernel
    takes a taller item only from its entry of GRID_TILES, within its
    bounds of rows, where its padding is small and its products keep the
    consumer warps busy."""
    for b in (1, 20, 81, 128, 256):
        for h, r, form in ((180, 0, cuda_gru.DENSE_PRE), (180, 0, cuda_gru.DENSE_POST),
                           (180, 6, cuda_gru.LOWRANK_PRE), (197, 23, cuda_gru.LOWRANK_PRE)):
            for _, _, plan in cuda_gru.gru_grid_chunks(24, b, 77, 0, h, r, form, sms=SMS):
                assert plan.tile_fwd == plan.tile_bwd == 4
                assert plan.rpad == -(-(-(-plan.b // plan.groups)) // 4) * 4
    for b in (81, 128, 256, 512, 1024):
        for h, r, form in ((500, 0, cuda_gru.DENSE_PRE), (1000, 0, cuda_gru.DENSE_PRE),
                           (2000, 0, cuda_gru.DENSE_POST), (3200, 0, cuda_gru.DENSE_POST),
                           (3200, 800, cuda_gru.LOWRANK_PRE)):
            for _, n, plan in cuda_gru.gru_grid_chunks(24, b, 77, 0, h, r, form, sms=SMS):
                base = -(-(-(-n // plan.groups)) // 4) * 4
                assert plan.rpad - base <= base * cuda_gru.TILE_PAD
                four = cuda_gru.grid_plan_layout(n, h, r, form, plan.groups, plan.ctas, tile=4)
                for kernel in ("fwd", "bwd"):
                    tile = plan.tile(kernel)
                    if tile == 4:
                        continue
                    allowed = cuda_gru.GRID_TILES[plan.streamed, kernel, form]
                    assert any(t == tile and lo <= base <= (hi or base) for t, lo, hi in allowed)
                    assert min(units(plan, kernel)) >= min([cuda_gru.TILE_MIN_UNITS]
                                                           + units(four, kernel))
