"""The arithmetic of csrc/gemm_tc.cuh on the CPU.

The LSTM scan kernels run their time-parallel products on the tensor cores:
f32 as 3xTF32 (each operand a = hi + lo, hi = tf32(a), lo = tf32(a - hi),
and a product lo*hi + hi*lo + hi*hi with f32 sums), bf16 as bf16 products
with f32 sums. The card is not here, so this file emulates the f32 scheme
in plain PyTorch at the products of the dense h=1500 layer: with TF32
rounding as the low 13 mantissa bits masked off, where it keeps each
product within 1e-5 of float64 (max abs error over max abs output) and
one-pass TF32 does not (the reason the kernels meet the card's f32
tolerances, 1e-4 for outputs and 1e-3 for gradients); and as the Hopper
tile builds it (hi and lo by cvt.rna, the tensor core's sums rounded
toward zero within each k8 step, the steps joined by an f32 add) at B=20
and B=128. It holds the constants and the tile rule that
ops/cuda_scan.py mirrors to the header's own at every product shape of
the HAR, PTB medium and dense h=1500 layers, the staged copies' bytes,
and the bf16 cast pass's rounding (to nearest even, as bf16_pair's). No
JAX.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vmlmf_tpu_torch.ops import cuda_scan  # noqa: E402

HEADER = Path(cuda_scan.__file__).resolve().parent.parent / "csrc" / "gemm_tc.cuh"
T, B, H = 35, 20, 1500   # the PTB "large" LM's dense layer at its batch
M, G4 = T * B, 4 * H
# each product of the layer's GEMM phase: (A's shape, B's shape)
PRODUCTS = {
    "projection": ((M, H), (H, G4)),   # gi = x @ Ux (and recompute's Hprev @ U)
    "du": ((H, M), (M, G4)),           # dU = Hprev^T dPre (and dUx = X^T dPre)
    "dx": ((M, G4), (G4, H)),          # dx = dPre Ux^T, k = 6000
}


def tf32(a):
    """a with the low 13 of its 23 mantissa bits cleared."""
    return (a.view(torch.int32) & ~0x1FFF).view(torch.float32)


def rel_err(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_3xtf32_keeps_f32_precision_where_tf32_does_not(name):
    (m, k), (_, n) = PRODUCTS[name]
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
    want = a.double() @ b.double()
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    three = (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi   # the small terms first
    one = a_hi @ b_hi
    assert rel_err(three, want) < 1e-5
    assert rel_err(one, want) > 1e-5


def test_the_mirrored_plan_constants_are_the_header_s():
    text = HEADER.read_text()
    tile_text = (HEADER.parent / "gemm_tile.cuh").read_text()

    def const(name, tile=False):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             tile_text if tile else text).group(1))

    assert const("kK") == cuda_scan.TC_DEPTH
    assert const("kSplitTarget", tile=True) == cuda_scan.SPLIT_TARGET
    assert const("kWave") == cuda_scan.WAVE
    assert "using BigTile = Shape<128, 128, 64, 32>;" in text
    assert "using SmallTile = Shape<64, 64, 32, 32>;" in text
    # the Hopper tile
    assert f"constexpr int kBM = {cuda_scan.WG_TILE}, kBN = {cuda_scan.WG_TILE};" in text
    assert (f"static constexpr int kBK = Bf16 ? {cuda_scan.WG_BK[True]} : "
            f"{cuda_scan.WG_BK[False]};") in text
    assert (f"static constexpr int kStages = Bf16 ? {cuda_scan.WG_STAGES[True]} : "
            f"{cuda_scan.WG_STAGES[False]};") in text
    assert f"static constexpr int kFlush = {cuda_scan.WG_FLUSH};" in text
    assert const("kMinSliceStages") == cuda_scan.WG_MIN_SLICE_STAGES
    assert const("kMaxSplits") == cuda_scan.WG_MAX_SPLITS
    assert 1 << int(re.search(r"kWgMinWork = 1ll << (\d+);", text).group(1)) == \
        cuda_scan.WG_MIN_WORK
    assert const("kWgMinDim") == cuda_scan.WG_MIN_DIM
    assert int(re.search(r"kStageAlign = (\d+);", text).group(1)) == cuda_scan.STAGE_ALIGN
    assert f"Copy copies[{cuda_scan.STAGE_COPIES}];" in text
    assert f"count == {cuda_scan.STAGE_COPIES} ||" in text
    # staged rows padded to 16 bytes: 8 bf16, 4 f32
    assert "c.ld = round_to(c.cols, form == kBf16 ? 8 : 4);" in text


@pytest.mark.parametrize("a_kind, b_kind", [(0, 0), (0, 1), (1, 0), (2, 0), (3, 0)])
@pytest.mark.parametrize("bf16", [False, True])
def test_tc_check_reads_each_view_on_the_cpu(a_kind, b_kind, bf16):
    """`ops/tc_check.py`, the tile's check export, reads each operand view
    as csrc/gemm_tc_check.cu does (PrevRows's seam after row nfirst), and on
    CPU tensors gives the plain product of those operands."""
    from vmlmf_tpu_torch.ops.tc_check import operands, relative_error, tc_product

    m, n, k, nfirst = 9, 7, 11, 3
    rng = np.random.default_rng(a_kind + 5 * b_kind)

    def t(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    a0, a1, lda = {0: (t(m, k), None, k), 1: (t(k, m), None, m),
                   2: (t(nfirst, k), t(m - nfirst, k), k),
                   3: (t(nfirst, m), t(k - nfirst, m), m)}[a_kind]
    b0, ldb = (t(k, n), n) if b_kind == 0 else (t(n, k), k)
    a, b = operands(a_kind, b_kind, a0, a1, b0)
    stacked = a0 if a1 is None else torch.cat([a0, a1])
    whole_a = stacked.T if a_kind in (1, 3) else stacked
    assert torch.equal(a, whole_a) and a.shape == (m, k) and b.shape == (k, n)
    got = tc_product(a_kind, b_kind, a0, a1, nfirst, lda, b0, ldb, m, n, k, bf16)
    if bf16:
        a, b = a.bfloat16().float(), b.bfloat16().float()
    assert got.shape == (m, n) and relative_error(got, a, b) < 1e-6


def tf32_rna(a):
    """a rounded to tf32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero (on the magnitude bits), the low 13 mantissa bits cleared."""
    bits = a.view(torch.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    return ((bits & ~0x7FFFFFFF) | (mag & ~0x1FFF)).view(torch.float32)


def add_toward_zero(acc, step):
    """acc + step (f64 sums of exact tf32 products) into f32, rounded toward
    zero as the tensor core rounds what it adds to its accumulator."""
    s = acc.double() + step
    near = s.float()
    over = near.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(near, torch.zeros_like(near)), near)


def emulate_hopper_3xtf32(a, b):
    """The Hopper tile's f32 product as built: hi and lo by cvt.rna, each k8
    step's lo*hi, hi*lo, hi*hi from zero (each 8 products summed exactly,
    then added to the step's sum rounded toward zero), the step's sum
    joining the running sum by an f32 add (round to nearest)."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        part = torch.zeros_like(acc)
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            part = add_toward_zero(part, x[:, s].double() @ y[s].double())
        acc = acc + part
    return acc


# the dense h=1500 layer's products at B=20 and 128: (m, n, k); the emulation
# takes 48 rows of A and 96 columns of B, and all of k
HOPPER_PRODUCTS = {f"{name}_b{b}": shape for b in (20, 128) for name, shape in (
    ("gi", (35 * b, G4, H)), ("du", (H, G4, 35 * b)), ("dx", (35 * b, H, G4)))}


@pytest.mark.parametrize("name", list(HOPPER_PRODUCTS))
def test_hopper_3xtf32_as_built_keeps_f32_precision(name):
    """hi and lo by cvt.rna, the three terms small first, the tensor core's
    truncating sums within each k8 step, each step joined by an f32 add:
    within 1e-5 of float64 at k = 1500, 4480 and 6000."""
    m, n, k = HOPPER_PRODUCTS[name]
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((48, k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 96), dtype=np.float32))
    want = a.double() @ b.double()
    assert rel_err(emulate_hopper_3xtf32(a, b), want) < 1e-5


def test_tf32_rna_rounds_to_nearest_ties_away():
    vals = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                         1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23, 1e-40])
    got = tf32_rna(vals)
    assert got.tolist() == pytest.approx([1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10),
                                          1.0 + 2.0 ** -9, 1.0, got[5].item()])
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()


def rne_bf16_bits(x):
    """The bf16 bits of float32 x, rounded to nearest even as
    __float2bfloat16_rn (the cast pass) and __floats2bfloat162_rn
    (bf16_pair) round: on the bits, NaN aside."""
    u = x.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def test_cast_pass_rounds_as_bf16_pair():
    """The cast pass's rounding (tc_check.tc_cast on the CPU: torch's) equals
    round-to-nearest-even on the bits, bf16_pair's rounding, on ties of
    both parities, subnormals of f32 and of bf16, zeros, the largest
    finite values and infinities, at an odd row length."""
    from vmlmf_tpu_torch.ops.tc_check import tc_cast

    ties = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000, 0x00008000, 0x00018000,
                     0x00000001, 0x007FFFFF, 0x0000FFFF, 0x00000000, 0x80000000, 0x7F800000,
                     0xFF800000, 0x7F7F0000, 0x0080FFFF], dtype=np.uint32)
    rand = np.random.default_rng(4).integers(0, 2 ** 32, 4 * 29 - 15, dtype=np.uint64)
    bits = np.concatenate([ties, rand.astype(np.uint32)])
    bits[np.isnan(bits.view(np.float32))] = 0x3F800000
    x = bits.view(np.float32).reshape(4, 29)
    got = tc_cast(torch.from_numpy(x.copy())).view(torch.int16).numpy().view(np.uint16)
    assert (got == rne_bf16_bits(x)).all()


# every product shape of the HAR, PTB medium and dense h=1500 layers at
# B = 1, 20, 81, 128: (T, F, h, rx, r) by layer
LAYERS = {"har": (24, 77, 180, 8, 6), "har_dense": (24, 77, 180, 0, 0),
          "lm": (35, 650, 650, 300, 300), "lm_dense": (35, 650, 650, 0, 0),
          "dense1500": (35, 1500, 1500, 0, 0), "lowrank1500": (35, 1500, 1500, 750, 750)}


def every_product():
    for layer, (t, f, h, rx, r) in LAYERS.items():
        for b in (1, 20, 81, 128):
            for entry, extra in (("fwd", {}), ("bwd", {}), ("bwd", {"recompute": True}),
                                 ("bwd", {"gi": True})):
                for m, n, k, _, _, split, _ in cuda_scan.gemm_products(t, b, f, rx, h, r, entry,
                                                                       **extra):
                    yield layer, b, (m, n, k, split)


@pytest.mark.parametrize("layer", list(LAYERS))
def test_the_tile_rule_and_slices_at_every_product_shape(layer):
    """At each product of the layer at B = 1, 20, 81, 128: the rule sends
    the product to the Hopper tile by its multiply-adds and its smallest
    side alone (the HAR layers' products stay on the Ampere tile at their
    batch, 81, and every layer's at B=1); the Hopper tile's slices are
    whole stages that cover k once, at least WG_MIN_SLICE_STAGES deep, no
    more than a wave of units, and split only where the tiles fill less
    than a wave; the split-k scratch holds every split product's slices."""
    for name, b, (m, n, k, split) in every_product():
        if name != layer:
            continue
        for bf16 in (False, True):
            wg, big, splits, kslice = cuda_scan.tc_plan(m, n, k, cuda_scan.WG_MAX_SPLITS, bf16)
            assert wg == (m * n * k >= cuda_scan.WG_MIN_WORK
                          and min(m, n, k) >= cuda_scan.WG_MIN_DIM)
            if layer.startswith("har") and b <= 81 or b == 1:
                assert not wg
            if not wg:
                assert (big, splits, kslice) == cuda_scan.mma_plan(m, n, k,
                                                                   cuda_scan.WG_MAX_SPLITS)
                continue
            bk, tiles = cuda_scan.WG_BK[bf16], -(-m // 128) * -(-n // 128)
            assert big
            if splits == 1:
                assert kslice == k
                continue
            assert kslice % bk == 0 and kslice >= bk * cuda_scan.WG_MIN_SLICE_STAGES
            assert (splits - 1) * kslice < k <= splits * kslice
            assert tiles < cuda_scan.WAVE and tiles * splits <= cuda_scan.WAVE + tiles
            assert splits <= cuda_scan.WG_MAX_SPLITS
            if split:
                t_, f, h, rx, r = LAYERS[layer]
                assert splits * m * n <= cuda_scan.bwd_partial_floats(
                    t_, b, f, rx, h, r, recompute=True, bf16=bf16)


def test_staged_copies_are_one_a_source_and_form():
    """A call stages each source once in each form a Hopper-tile product
    reads: the dense h=1500 BPTT at B=128 casts dPre once in bf16 (read by
    dU, dx and dUx), and in f32 splits it twice (dx reads it K-major as
    stored, dU and dUx transposed); an unsplit product whose epilogue reads
    keeps its raw sums there too; rows pad to 16 bytes; copies start
    STAGE_ALIGN bytes apart; the HAR layer stages nothing."""
    m, f, h, g4 = 35 * 128, 1500, 1500, 6000
    products = cuda_scan.gemm_products(35, 128, f, 0, h, 0, "bwd")
    bf16 = cuda_scan.staged_copies(products, True)
    # dx's epilogue reads (the xdvec term): its raw sums go through scratch
    assert [c[:4] for c in bf16] == [("hprev", m, h, "bf16"), ("dpre", m, g4, "bf16"),
                                     ("ux", f, g4, "bf16"), ("product", m, f, "raw"),
                                     ("x", m, f, "bf16")]
    def align(nbytes):
        return -(-nbytes // cuda_scan.STAGE_ALIGN) * cuda_scan.STAGE_ALIGN

    assert [c[4] for c in bf16] == [align(m * 1504 * 2), align(m * g4 * 2), align(f * g4 * 2),
                                     align(m * f * 4), align(m * 1504 * 2)]
    f32 = cuda_scan.staged_copies(products, False)
    assert [c[:4] for c in f32] == [("hprev", m, h, "split_t"), ("dpre", m, g4, "split_t"),
                                    ("dpre", m, g4, "split"), ("ux", f, g4, "split"),
                                    ("product", m, f, "raw"), ("x", m, f, "split_t")]
    assert f32[0][4] == 2 * align(h * m * 4) and f32[2][4] == 2 * align(m * g4 * 4)
    # h=650: bf16 rows of 650 pad to 656, f32 ones to 652
    lm = cuda_scan.staged_copies(cuda_scan.gemm_products(35, 20, 650, 0, 650, 0, "fwd"), True)
    assert lm[0][4] == align(700 * 656 * 2)
    assert cuda_scan.tc_stage_floats(35, 20, 650, 0, 650, 0, "fwd", False) == sum(
        c[4] for c in cuda_scan.staged_copies(
            cuda_scan.gemm_products(35, 20, 650, 0, 650, 0, "fwd"), False)) // 4
    assert cuda_scan.tc_stage_floats(24, 81, 77, 8, 180, 6, "bwd", True, recompute=True) == 0
