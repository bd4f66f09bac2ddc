"""The GRU grid kernels on the TMA ring, and the GRU BPTT's products on the
Hopper tile, on the CPU (`cuda_gru.grid_plan_layout`, `GRUGridPlan.walk`,
`gru_bwd_partial_floats`, `gru_tc_products`, `gru_tc_stage_floats`,
`ops/tc_check.py`'s GRU sources).

A grid plan runs its products on csrc/scan_grid.cuh's ring where a kernel
streams weight rows: two stages of `piece` floats in the staging buffer's
place, each product's streamed rows in a block of its own columns, in
slice_product's order of sums (a ring over resident rows, which the
checks force, keeps it too). Here the plans at the shapes `chip_smoke.py` runs are held to the
card's shared memory, to 16-byte streamed rows and to the order of sums of
the plan without a ring; which BPTT products take the Hopper tile
(csrc/gemm_tc.cuh's rule) is listed, the staged bytes counted by hand, and
the composites that the tile stages through a gated source are read as the
kernel lays them out and held to the plain BPTT's intermediates.
"""

import pytest

torch = pytest.importorskip("torch")

from vmlmf_tpu_torch.ops import cuda_gru, tc_check  # noqa: E402
from vmlmf_tpu_torch.ops.cuda_scan import (  # noqa: E402
    GRID_THREADS,
    MAX_SLICES,
    MIN_SLICE_DEPTH,
    RING_STAGES,
    SMEM_LIMIT,
    STAGE_ALIGN,
    tc_route,
)
from vmlmf_tpu_torch.tools.gru_phases import ring_in_stage  # noqa: E402

SMS = 132  # an H100 SXM
LOWRANK, DENSE_PRE, POST = cuda_gru.LOWRANK_PRE, cuda_gru.DENSE_PRE, cuda_gru.DENSE_POST
FORMS = {"lowrank_pre": LOWRANK, "dense_pre": DENSE_PRE, "dense_post": POST}

# (T, B, F, rx, h, r, form) of the grid shapes chip_smoke.py runs: the HAR
# GRU nets at h=3200, the h=1000 layer at B=512 (two chunks), the HAR GRU's
# default width h=180 at the train and evaluate batches, and GRU_GRID_ODD
CARD_SHAPES = {
    "h3200_post": (24, 81, 77, 9, 3200, 0, POST),
    "h3200_pre": (24, 81, 77, 9, 3200, 0, DENSE_PRE),
    "h3200_lowrank": (24, 81, 77, 9, 3200, 800, LOWRANK),
    "h1000_b512": (24, 512, 77, 0, 1000, 0, DENSE_PRE),
    "h180_pre_b81": (24, 81, 77, 0, 180, 0, DENSE_PRE),
    "h180_post_b256": (24, 256, 77, 0, 180, 0, POST),
    "odd_lowrank": (6, 37, 20, 5, 197, 23, LOWRANK),
    "odd_dense_pre": (6, 37, 20, 0, 197, 0, DENSE_PRE),
    "odd_dense_post": (6, 37, 20, 5, 197, 0, POST),
}


def chunks_of(shape):
    t, b, f, rx, h, r, form = shape
    return cuda_gru.gru_grid_chunks(t, b, f, rx, h, r, form, sms=SMS)


def carve_floats(plan, kernel):
    """Floats of a kernel's shared memory as gru_grid.cuh::grid_smem_floats
    carves it: resident rows, slabs, the ring (or the staging buffer), red."""
    (_, ca), (_, cb) = plan.slices(kernel)
    res_a, res_b = plan.resident(kernel)
    jwp = -(-(-(-plan.h // plan.ctas)) // 4) * 4
    slabs = cuda_gru.GRID_SLABS[kernel][plan.form] * jwp * plan.rpad
    stage, red = ((plan.stage_fwd, plan.red_fwd) if kernel == "fwd"
                  else (plan.stage_bwd, plan.red_bwd))
    piece = plan.piece(kernel)
    ring = RING_STAGES * (piece + 4) if piece else stage
    return -(-(res_a * ca + res_b * cb) // 4) * 4 + slabs + ring + red


def operands(plan, kernel):
    """(slice, d0, depth, col0, ncols, resident rows among them) of each
    product of a step."""
    res = dict(zip("ab", plan.resident(kernel)))
    return [(sl, d0, depth, col0, ncols, min(depth, max(0, res[sl] - d0)))
            for sl, d0, depth, col0, ncols in
            cuda_gru._grid_operands(plan.h, plan.r, plan.form, plan.ctas)[kernel]]


def item_slices(depth, cols, rpad, red):
    """slice_product's slices of a product (and the ring's: Ring::walk)."""
    items = cols // 4 * (rpad // 4)
    most = 1 if items >= GRID_THREADS else min(MAX_SLICES, GRID_THREADS // items)
    return max(1, min(most, depth // MIN_SLICE_DEPTH, red // (16 * items) if red else 1))


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


@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_ring_plans_at_the_card_shapes_fit_and_stream_16_byte_rows(name):
    """Each kernel of each chunk: its carve (resident rows, slabs, ring or
    staging buffer, red) is its shared memory and fits the card's 227 KB; a
    ring exactly where rows stream, each stage holding one depth row of
    every product (its exchange and its streamed row); every streamed block
    a whole number of 16-byte units, the blocks filling the CTA's region."""
    for _, n, plan in chunks_of(CARD_SHAPES[name]):
        for kernel in ("fwd", "bwd"):
            smem = plan.smem_fwd if kernel == "fwd" else plan.smem_bwd
            assert 4 * carve_floats(plan, kernel) == smem <= SMEM_LIMIT
            ops = operands(plan, kernel)
            streams = any(res < d for (d, _), res in zip(plan.slices(kernel),
                                                         plan.resident(kernel)))
            piece = plan.piece(kernel)
            assert bool(piece) == streams, (kernel, piece)
            if not piece:
                continue
            assert piece % 4 == 0 and piece >= plan.rpad
            for _, _, depth, _, ncols, held in ops:
                assert (4 * ncols) % 16 == 0  # each streamed row of the block: whole 16 bytes
                if held < depth:
                    assert piece >= plan.rpad + ncols
            # slice B of the "pre" forward streams its r, z columns, then its n columns
            (da, ca), (db, cb) = plan.slices(kernel)
            res_a, res_b = plan.resident(kernel)
            blocks = [(sl, c) for sl, _, _, c0, c, _ in ops if c0 == 0 or sl == "b"]
            widths_b = sorted({c for sl, c in blocks if sl == "b"})
            if kernel == "fwd" and plan.form != POST:
                assert widths_b == sorted({2 * cb // 3, cb // 3})
            else:
                assert widths_b == [cb]
            assert cuda_gru.grid_stream_floats(plan, kernel) == plan.n_ctas * -(-(
                (da - res_a) * ca + (db - res_b) * cb) // 4) * 4


def test_rings_where_the_card_needs_them():
    """h=180, h=1000 and the odd shapes, every row resident: no ring, so the
    kernels run as before (at h=1000 the staging buffer takes each exchange
    in chunks); h=3200: every kernel on a ring of stages near 80 KB; a ring
    forced into h=1000's staging buffer fits its room."""
    for name in ("h180_pre_b81", "h180_post_b256", "h1000_b512", "odd_lowrank",
                 "odd_dense_pre", "odd_dense_post"):
        for _, _, plan in chunks_of(CARD_SHAPES[name]):
            assert (plan.piece_fwd, plan.piece_bwd) == (0, 0) and not plan.streamed
            assert plan.walk("fwd") == plan.walk("bwd") == ()
    for name in ("h3200_post", "h3200_pre", "h3200_lowrank"):
        (_, _, plan), = chunks_of(CARD_SHAPES[name])
        assert plan.streamed and min(plan.piece_fwd, plan.piece_bwd) >= 3 * 20480 // 4
    chunks = chunks_of(CARD_SHAPES["h1000_b512"])
    assert [n for _, n, _ in chunks] == [256, 256]
    plan = chunks[0][2]
    ring = ring_in_stage(plan)
    for kernel in ("fwd", "bwd"):
        stage = plan.stage_fwd if kernel == "fwd" else plan.stage_bwd
        assert any(d * plan.rpad > stage for _, _, d, _, _, _ in operands(plan, kernel))
        assert plan.rpad <= ring.piece(kernel) and RING_STAGES * (ring.piece(kernel) + 4) <= stage
        assert 4 * carve_floats(ring, kernel) == (ring.smem_fwd if kernel == "fwd"
                                                  else ring.smem_bwd)


@pytest.mark.parametrize("name", ["h3200_post", "h3200_pre", "h3200_lowrank", "h1000_b512"])
def test_ring_walk_keeps_slice_product_s_order_of_sums(name):
    """Each product's pieces tile its depth: the exchange alone over its
    resident rows, then the exchange and its streamed rows, each within a
    stage; the chunks are slice_product's of the plan's staging buffer, and
    for the product's slices (and every slice count) each thread walks the
    rows in slice_product's order; h=1000 on a ring forced into its staging
    buffer, whose exchange comes in chunks, alike."""
    for _, _, plan in chunks_of(CARD_SHAPES[name]):
        plan = ring_in_stage(plan)  # h=1000: a ring forced over resident rows
        for kernel in ("fwd", "bwd"):
            stage = plan.stage_fwd if kernel == "fwd" else plan.stage_bwd
            red = plan.red_fwd if kernel == "fwd" else plan.red_bwd
            piece = plan.piece(kernel)
            for (depth, chunk, rows, pieces), (_, _, d, _, ncols, held) in zip(
                    plan.walk(kernel), operands(plan, kernel)):
                assert depth == d
                assert chunk == (depth if depth * plan.rpad <= stage else stage // 2 // plan.rpad)
                assert pieces[0][0] == 0 and pieces[-1][1] == depth
                assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
                for e0, e1 in pieces:
                    if e1 <= held:
                        assert (e1 - e0) * plan.rpad <= piece
                    else:
                        assert e0 >= held and e1 - e0 <= rows
                        assert rows * (plan.rpad + ncols) <= piece
                used = item_slices(depth, ncols, plan.rpad, red)
                for slices in sorted({1, 2, 3, used, MAX_SLICES}):
                    for s in range(slices):
                        assert ring_walk(pieces, chunk, slices, s) == parent_walk(
                            depth, chunk, slices, s)


@pytest.mark.parametrize("form", [LOWRANK, DENSE_PRE, POST], ids=list(FORMS))
def test_forced_rings_keep_the_resident_plan_s_groups_ctas_and_stage(form):
    """A third of each slice streamed at the odd shape (chip_smoke.py's
    forced plan) and rings of other stage sizes at h=3200 move only the
    ring and the resident depths: the groups, CTAs, rows, staging buffer
    (the chunks of the order of sums) and red stay."""
    t, b, f, rx, h, r, _ = CARD_SHAPES[f"odd_{'lowrank' if form == LOWRANK else 'dense_pre'}"]
    r = r if form == LOWRANK else 0
    plan = cuda_gru.gru_grid_plan(t, b, f, rx, h, r, form, sms=SMS)
    part = tuple(tuple(d // 3 for d, _ in plan.slices(k)) for k in ("fwd", "bwd"))
    forced = cuda_gru.grid_plan_layout(b, h, r, form, plan.groups, plan.ctas, resident=part)
    assert forced.streamed and forced.piece_fwd and forced.piece_bwd and not plan.piece_fwd
    fields = ("groups", "ctas", "rpad", "stage_fwd", "red_fwd", "stage_bwd", "red_bwd",
              "xchg_fwd", "xchg_bwd")
    for field in fields:
        assert getattr(forced, field) == getattr(plan, field), field
    assert max(forced.smem_fwd, forced.smem_bwd) <= SMEM_LIMIT
    r = 800 if form == LOWRANK else 0
    base = cuda_gru.gru_grid_plan(24, 81, 77, 9, 3200, r, form, sms=SMS)
    resident = []
    for piece in (4096, 6144, 12288, None):
        other = cuda_gru.grid_streamed_plan(81, 3200, r, form, SMS, piece)
        for field in fields:
            assert getattr(other, field) == getattr(base, field), field
        assert max(other.smem_fwd, other.smem_bwd) <= SMEM_LIMIT
        resident.append(sum(other.resident_fwd) + sum(other.resident_bwd))
    assert other == base
    assert resident == sorted(resident, reverse=True) and resident[0] > resident[-1]


def routed(shape, gi=False):
    t, b, f, rx, h, r, form = shape
    products = cuda_gru.gru_bwd_products(t, b, f, rx, h, r, form, gi=gi)
    return cuda_gru._routed(products, 3 if form == LOWRANK else 2)


# the HAR nets' BPTT shapes: their training batch, B=81 (evaluate's B=256
# runs the no-grad forward alone)
HAR_SHAPES = [(24, 81, f, rx, h, r, form) for f, rx in ((77, 9), (77, 0), (64, 9))
              for h, r, form in ((180, 6, LOWRANK), (180, 0, DENSE_PRE), (180, 0, POST),
                                 (64, 9, LOWRANK), (64, 0, POST), (64, 0, DENSE_PRE))]


@pytest.mark.parametrize("gi", [False, True], ids=["x", "gi"])
def test_which_bptt_products_take_the_hopper_tile(gi):
    """None at h <= 180 nor at a HAR width; the recurrent weight gradients
    (never the x side's) at h=3200 and at h=1000; the recompute pre-pass's
    recurrent products alike at h=3200."""
    for shape in HAR_SHAPES + [CARD_SHAPES[k] for k in ("h180_pre_b81", "odd_lowrank",
                                                        "odd_dense_pre", "odd_dense_post")]:
        assert not any(routed(shape, gi)), shape
        t, b, f, rx, h, r, form = shape
        for rc in (False, True):
            assert cuda_gru.gru_tc_stage_floats(t, b, f, rx, h, r, form, gi=gi,
                                                recompute=rc and not gi) == 0
            assert not any(tc_route(m, n, k) for m, n, k, *_ in cuda_gru.gru_tc_products(
                t, b, f, rx, h, r, form, gi=gi, recompute=rc and not gi))
    for name in ("h3200_post", "h3200_pre", "h3200_lowrank"):
        shape = CARD_SHAPES[name]
        nrec = 3 if shape[-1] == LOWRANK else 2
        assert routed(shape, gi) == [True] * nrec + ([] if gi else [False] * (3 + (shape[3] > 0)))
        t, b, f, rx, h, r, form = shape
        assert all(tc_route(m, n, k) for m, n, k, *_ in cuda_gru.gru_tc_products(
            t, b, f, rx, h, r, form, gi=gi, recompute=not gi))
    # h=1000 at B=256 (one chunk of B=512): dPrz and dPn
    assert routed((24, 256, 77, 0, 1000, 0, DENSE_PRE), gi) == [True, True] + (
        [] if gi else [False] * 3)
    # the rule goes by the shape alone: an h=180 BPTT at B=256 has a dPrz
    # [180, 360] over k = 6144, 398 M multiply-adds
    assert routed(CARD_SHAPES["h180_post_b256"], gi)[:2] == [True, False]


def test_stage_floats_by_hand_at_h3200_post():
    """The staged copies of the "post" BPTT at h=3200, T=24, B=81 (M = 1944,
    rows padded to 4 floats, each copy hi and lo, 256-byte aligned):
    Hprev^T [3200][1944] (dPrz and dPn share it), [dR dZ]^T [6400][1944],
    (dN * R)^T [3200][1944]. Under recompute each pre-pass product stages
    alone from the scratch's start, and the weight gradients reuse it: the
    r and the z halves, Hprev [1944][3200], a half of Prz^T [3200][3200]
    and its raw sums [1944][3200], and recn's product alike with Pn^T, each
    in less room than the weight gradients'."""
    M, h = 24 * 81, 3200

    def split(rows, cols):
        return 2 * -(-rows * -(-cols // 4) * 4 * 4 // STAGE_ALIGN) * STAGE_ALIGN

    def raw(m, n):
        return -(-m * n * 4 // STAGE_ALIGN) * STAGE_ALIGN

    grads = split(h, M) + split(2 * h, M) + split(h, M)
    assert 4 * cuda_gru.gru_tc_stage_floats(24, 81, 77, 9, h, 0, POST) == grads == 199065600
    assert 4 * cuda_gru.gru_tc_stage_floats(24, 81, 0, 0, h, 0, POST, gi=True) == grads
    rebuild = split(M, h) + split(h, h) + raw(M, h)
    assert rebuild < grads
    assert 4 * cuda_gru.gru_tc_stage_floats(24, 81, 77, 9, h, 0, POST, recompute=True) == grads
    assert [p[:3] for p in cuda_gru.gru_tc_products(24, 81, 77, 9, h, 0, POST,
                                                    recompute=True)[:3]] == [(M, h, h)] * 3
    # no split-k scratch for these products: 25 x 50 and 25 x 25 tiles fill a wave
    assert cuda_gru.gru_bwd_partial_floats(24, 81, 0, 0, h, 0, POST, gi=True) == 0


@pytest.mark.parametrize("name", ["h3200_post", "h3200_pre", "h3200_lowrank", "h1000_b512"])
def test_recompute_stages_no_more_than_the_saved_gates(name):
    """The recompute policy is there to save memory: its pre-pass's staged
    copies, one product at a time, take no more room than the weight
    gradients' that reuse the scratch after them, so the policy's BPTT
    stages exactly what the saved-gates BPTT does."""
    t, b, f, rx, h, r, form = CARD_SHAPES[name]
    b = min(b, 256)  # h=1000 runs in chunks of 256 rows
    saved = cuda_gru.gru_tc_stage_floats(t, b, f, rx, h, r, form)
    assert saved > 0
    assert cuda_gru.gru_tc_stage_floats(t, b, f, rx, h, r, form, recompute=True) == saved


@pytest.mark.parametrize("name", sorted(CARD_SHAPES))
def test_gemm_ops_count_the_products_on_the_hopper_tile(name):
    """Row 4's bound prices at the 3xTF32 rate the operations of the
    products that take the Hopper tile: the recurrent weight gradients'
    (one recurrent product's multiply-adds a row, 3h^2 dense or 5hr
    low-rank) and, under recompute, as many again for the pre-pass; none
    where no product passes the rule; always within the BPTT's operations."""
    t, b, f, rx, h, r, form = CARD_SHAPES[name]
    rec = 5 * h * r if form == LOWRANK else 3 * h * h
    for save in (True, False):
        ops = cuda_gru.gru_gemm_ops(t, b, f, rx, h, r, form, save_gates=save)
        routed = [tc_route(m, n, k) for m, n, k, *_ in cuda_gru.gru_tc_products(
            t, b, f, rx, h, r, form, recompute=not save)]
        if h >= 1000:
            assert all(routed) and ops == 2 * t * b * rec * (1 if save else 2)
        elif not any(routed):
            assert ops == 0
        assert ops <= cuda_gru.gru_scan_bwd_cost(t, b, f, rx, h, r, form, save_gates=save)[0]


def har_residuals(mode, lowrank, t=3, b=5, h=7, r=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    n = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    uf = n(h, r) if lowrank else None
    prz, pn = (n(r, 2 * h), n(r, h)) if lowrank else (n(h, 2 * h), n(h, h))
    xs, ux, bias, h0 = n(t, b, 6), n(6, 3 * h), n(3 * h), n(b, h)
    ys, gates, hu, rhu, recn, _ = cuda_gru.gru_scan_xin_fwd_res_plain(
        xs, ux, None, bias, uf, prz, pn, h0, mode=mode)
    dys = n(t, b, h)
    dpre, duf, dprz, dpn, _ = cuda_gru.gru_scan_bwd_plain(uf, prz, pn, h0, ys, gates, hu, rhu,
                                                          recn, dys, mode=mode)
    return dict(h0=h0, ys=ys, gates=gates, dpre=dpre.reshape(t * b, 3 * h), uf=uf, prz=prz,
                pn=pn, hu=hu, rhu=rhu, duf=duf, dprz=dprz, dpn=dpn)


@pytest.mark.parametrize("form", [LOWRANK, DENSE_PRE, POST], ids=list(FORMS))
def test_staged_composites_read_as_the_plain_bptt_s_intermediates(form):
    """`tc_check.gru_sources` reads each operand of the GRU's Hopper-tile
    products as gru_scan_xin_bwd.cu's sources lay it out (first, rest and
    the seam after B rows, the gate's rows 3h apart, [Hprev; R * Hprev]
    gated from row T*B on): each is the plain BPTT's intermediate (Hprev,
    R * Hprev, dN * R, [dHU; dRHU]), and each product is its weight
    gradient."""
    mode = "post" if form == POST else "pre"
    v = har_residuals(mode, form == LOWRANK)
    t, b, h = v["ys"].shape
    M = t * b
    hprev = torch.cat([v["h0"][None], v["ys"][:-1]]).reshape(M, h)
    r_gate = v["gates"].reshape(M, 3 * h)[:, :h]
    dpre = v["dpre"]
    kw = {}
    if form == LOWRANK:
        dhu, drhu = dpre[:, :2 * h] @ v["prz"].T, dpre[:, 2 * h:] @ v["pn"].T
        kw = dict(hu=v["hu"].reshape(M, -1), rhu=v["rhu"].reshape(M, -1), dhu=dhu, drhu=drhu)
        a, bb = tc_check.gru_sources(5, v["h0"], v["ys"], v["gates"], dpre, **kw)
        assert torch.equal(a, torch.cat([hprev, r_gate * hprev]).T)
        assert torch.equal(bb, torch.cat([dhu, drhu]))
        want = {3: v["dprz"], 4: v["dpn"], 5: v["duf"]}
    else:
        a, bb = tc_check.gru_sources(0, v["h0"], v["ys"], v["gates"], dpre)
        assert torch.equal(a, hprev.T) and torch.equal(bb, dpre[:, :2 * h])
        if form == DENSE_PRE:
            a, bb = tc_check.gru_sources(1, v["h0"], v["ys"], v["gates"], dpre)
            assert torch.equal(a, (r_gate * hprev).T) and torch.equal(bb, dpre[:, 2 * h:])
        else:
            a, bb = tc_check.gru_sources(2, v["h0"], v["ys"], v["gates"], dpre)
            assert torch.equal(a, hprev.T) and torch.equal(bb, dpre[:, 2 * h:] * r_gate)
        want = {0: v["dprz"], 1 if form == DENSE_PRE else 2: v["dpn"]}
    for product, grad in want.items():
        got = tc_check.gru_product(product, tc_check.GRU_HOPPER, v["h0"], v["ys"], v["gates"],
                                   dpre, **kw)
        torch.testing.assert_close(got, grad, atol=1e-5, rtol=1e-5)
    # the recompute pre-pass's (R * Hprev) @ w
    w = torch.randn(h, 3, generator=torch.Generator().manual_seed(1))
    got = tc_check.gru_product(6, tc_check.GRU_HOPPER, v["h0"], v["ys"], v["gates"], dpre, w=w)
    torch.testing.assert_close(got, (r_gate * hprev) @ w, atol=1e-5, rtol=1e-5)


def test_gru_check_scratch_mirrors_the_tiles():
    """gru_tc_check's scratch: on the Hopper tile its own k slices and the
    two staged copies of the product; on gemm_tile.cuh the group of one."""
    m, n, k = 3200, 3200, 1944
    floats, staged = tc_check.gru_scratch_floats(2, tc_check.GRU_HOPPER, 24, 81, 3200, 0, 0)
    assert floats == 0
    assert 4 * staged == 2 * 2 * -(-m * k * 4 // STAGE_ALIGN) * STAGE_ALIGN
    floats, staged = tc_check.gru_scratch_floats(2, tc_check.GRU_TILE, 24, 81, 3200, 0, 0)
    assert staged == 0 and floats == cuda_gru._group_floats([(m, n, k)])
