"""The bf16 walk of the LSTM scan kernels on the tensor cores
(`cuda_scan.ScanPlan.mma`, csrc/scan_grid.cuh::mma_product and
``Ring::mma_product``), on the CPU.

Where a bf16 plan's batch groups pad to 24 rows or more, each step's
products run as mma.sync m16n8k16 tiles: the slice's columns on M, the
group's rows on N, the depth in blocks of 16 rows, over 16 warps
(`cuda_scan.mma_split`), on the ring (`cuda_scan.mma_pieces`). Here: which
plans take that walk; a mirror of the warps' partition, every output tile
and block owned once and walked in the same order whatever the ring's
pieces and whatever depth lies in shared memory; the order of sums
emulated (`mma_check.mma_emulate`) against a float64 product at the dense
h=1500 layer's and the PTB LM layer's products.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vmlmf_tpu_torch.ops import cuda_scan  # noqa: E402
from vmlmf_tpu_torch.ops.mma_check import (  # noqa: E402
    mma_emulate, mma_walk_product, relative_error)

SMS = 132  # an H100 SXM
# f32 sums of exact bf16 products, in blocks of 16, against float64: the
# bound the tensor-core tile is held to (tests/test_torch_cuda.py)
EMU_TOL = 1e-5
# the bf16 plans of the main path and the sweeps: (B, h, r)
MAIN = [(20, 1500, 0), (128, 1500, 0), (53, 1500, 0), (20, 1600, 0), (128, 1600, 0),
        (20, 1500, 750), (128, 1500, 750), (256, 650, 300), (128, 650, 0), (201, 1100, 0)]
# (depth, cols, rpad): odd products, a depth short of a block, columns
# short of a tile, one n-tile, more tiles than warps hold in one pass
ODD = [(37, 12, 8), (1, 4, 8), (16, 4, 8), (300, 200, 16), (720, 720, 8), (6, 720, 32)]


def products(b, h, r):
    """(depth, cols, rpad) of each product of the bf16 chunks' mma plans."""
    out = set()
    for _, _, plan in cuda_scan.scan_chunks(b, h, r, SMS, 2):
        assert plan.mma
        for kernel in ("fwd", "bwd"):
            out.update((d, c, plan.rpad) for d, c in plan.slices(kernel) if d)
    return sorted(out)


ALL_PRODUCTS = sorted({p for shape in MAIN for p in products(*shape)} | set(ODD))


@pytest.mark.parametrize("h,r", [(650, 300), (650, 0), (1500, 0), (1500, 750), (180, 6)])
def test_bf16_plans_of_24_rows_or_more_take_the_tensor_core_walk(h, r):
    """A bf16 plan is an mma plan where its groups pad to 24 rows or more
    in 8-row tiles and that layout fits (else the FMA loop's, as before);
    its rows are padded to 8 and its exchange rows to 8 mod 16, and each
    kernel runs on a ring of MMA_MIN_PIECE floats a stage or more; f32
    plans never are."""
    for b in (1, 2, 4, 5, 8, 16, 17, 20, 33, 128, 256):
        for _, n, plan in cuda_scan.scan_chunks(b, h, r, SMS, 2):
            rows = -(-n // plan.groups)
            if plan.mma:
                assert plan.rpad == -(-rows // 8) * 8 >= cuda_scan.MMA_MIN_ROWS
                assert plan.xld % 16 == 8 and plan.xld in (plan.rpad, plan.rpad + 8)
                assert plan.ints("fwd")[-1] == plan.ints("bwd")[-1] == 1
                assert min(plan.piece_fwd, plan.piece_bwd) >= cuda_scan.MMA_MIN_PIECE
                assert plan.stage_fwd == plan.stage_bwd == 0
            else:  # groups of fewer rows, or an mma layout that does not fit
                assert plan.rpad == -(-rows // 4) * 4 and plan.xld == plan.rpad
                assert -(-rows // 8) * 8 < cuda_scan.MMA_MIN_ROWS or (
                    plan.smem_bytes <= cuda_scan.SMEM_LIMIT < cuda_scan.plan_layout(
                        n, h, r, plan.groups, plan.ctas, 2, mma=True).smem_bytes)
        f32 = cuda_scan.scan_chunks(b, h, r, SMS, 4)
        assert not any(plan.mma for _, _, plan in f32)
    with pytest.raises(ValueError, match="bf16"):
        cuda_scan.plan_layout(20, h, r, 1, 4, 4, mma=True)


def warp_tiles(depth, cols, rpad):
    """The mirror of MmaTiles: {(warp, pass): (k-group, [(m-tile, n-tile), ...])}."""
    s = cuda_scan.mma_split(depth, cols, rpad)
    out = {}
    for warp in range(cuda_scan.CONSUMER_WARPS):
        j = warp // s.tw
        for p in range(s.passes):
            wt = warp % s.tw + s.tw * p
            mt, nt0 = wt // s.nbs, wt % s.nbs * s.nper
            n = min(s.nper, s.nts - nt0) if j < s.kw and wt < s.tws else 0
            out[warp, p] = (j, [(mt, nt0 + x) for x in range(n)])
    return out


def first(kb0, kw, j):
    """The first block at or after kb0 of k-group j (MmaTiles::first)."""
    return kb0 + ((j - kb0 % kw) % kw + kw) % kw


def walked(spans, kw, j):
    """The blocks k-group j walks over the ring's pieces [e0, e1) of whole
    blocks (Ring::mma_consume, MmaTiles::walk)."""
    return [kb for e0, e1 in spans for kb in range(first(e0 // 16, kw, j), e1 // 16, kw)]


@pytest.mark.parametrize("depth,cols,rpad", ALL_PRODUCTS, ids=str)
def test_every_output_tile_and_block_is_owned_once(depth, cols, rpad):
    s = cuda_scan.mma_split(depth, cols, rpad)
    assert (s.blocks, s.mts, s.nts) == (-(-depth // 16), -(-cols // 16), rpad // 8)
    assert s.kw * s.tw <= cuda_scan.CONSUMER_WARPS and 1 <= s.kw <= min(s.blocks,
                                                                       cuda_scan.MMA_GROUPS)
    assert s.kw == 1 or s.passes == 1  # k-groups only where one pass holds every warp tile
    owned = np.zeros((s.mts, s.nts, s.blocks), int)
    for (warp, p), (j, held) in warp_tiles(depth, cols, rpad).items():
        assert len(held) <= cuda_scan.MMA_TILES and len({mt for mt, _ in held}) <= 1
        for mt, nt in held:
            owned[mt, nt, j::s.kw] += 1
    assert (owned == 1).all()
    # the sums [rpad][ldo]: the columns made 4 mod 8
    ldo = cuda_scan.mma_ldo(cols)
    assert ldo >= cols and ldo % 8 == 4 and cuda_scan.mma_red_floats(depth, cols, rpad) == (
        rpad * ldo)


@pytest.mark.parametrize("depth,cols,rpad", ALL_PRODUCTS, ids=str)
def test_the_order_does_not_depend_on_the_pieces_or_the_resident_depth(depth, cols, rpad):
    """Each k-group walks its blocks in block order whatever the ring's
    pieces, for every resident depth (whole blocks, or all of them) and
    stages from the least that holds a block to 104 KB."""
    s = cuda_scan.mma_split(depth, cols, rpad)
    d16 = 16 * s.blocks
    want = [list(range(j, s.blocks, s.kw)) for j in range(s.kw)]
    least = cuda_scan._ring_need(rpad, [(depth, cols)], 2, mma=True)
    assert least >= cuda_scan.MMA_MIN_PIECE
    residents = sorted({0, depth, *range(16, d16, max(16, d16 // 64 * 16))})
    for piece in sorted({least, least + 4, 6144, 12288, cuda_scan.RING_PIECE_FLOATS, 26624}):
        if piece < least:
            continue
        for res in residents:
            rows, pieces = cuda_scan.mma_pieces(depth, cols, rpad, piece, res)
            assert pieces[0][0] == 0 and pieces[-1][1] == d16
            assert all(e0 % 16 == 0 and e1 % 16 == 0 and e1 > e0 for e0, e1 in pieces)
            assert [walked(pieces, s.kw, j) for j in range(s.kw)] == want, (piece, res)


@pytest.mark.parametrize("depth,cols,rpad", [
    (1500, 48, 24), (6000, 12, 24), (1500, 48, 128), (6000, 12, 128),  # dense h=1500
    (650, 24, 16), (300, 200, 16), (2600, 24, 16), (300, 52, 16)],     # the LM layer, B=128
    ids=str)
def test_the_emulated_order_matches_float64(depth, cols, rpad):
    """The walk's order of sums (bf16-rounded operands, each block's 16
    products summed exactly and rounded to f32, f32 sums per k-group in
    block order, the k-groups added in order) within 1e-5 of a float64
    product of the same bf16 operands, at the dense h=1500 layer's and the
    LM layer's products; the check kernel's CPU version is that emulation."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((depth, cols)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((depth, rpad)).astype(np.float32))
    got = mma_emulate(w, a, rpad)
    assert got.dtype == torch.float32 and got.shape == (cols, rpad)
    assert relative_error(got, w, a) < EMU_TOL
    assert torch.equal(mma_walk_product(w, a, rpad), got)
    assert torch.equal(mma_walk_product(w, a, rpad, ncols=cols - 4), got[:cols - 4])
