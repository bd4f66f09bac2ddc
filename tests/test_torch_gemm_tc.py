"""The arithmetic of csrc/gemm_tc.cuh on the CPU.

The LSTM scan kernels run their time-parallel products on the tensor cores:
f32 as 3xTF32 (each operand a = hi + lo, hi = tf32(a), lo = tf32(a - hi),
and a product lo*hi + hi*lo + hi*hi with f32 sums), bf16 as one bf16 mma. The
card is not here, so this file emulates the f32 scheme in plain PyTorch,
with TF32 rounding as the low 13 mantissa bits masked off, at the products
of the dense h=1500 layer at B=20, and shows that it keeps each product
within 1e-5 of float64 (max abs error over max abs output) where one-pass
TF32 does not: the reason the kernels meet the card's f32 tolerances (1e-4
for outputs, 1e-3 for gradients). It also holds the constants that
ops/cuda_scan.py mirrors to the header's own. No JAX.
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
    assert "using BigTile = Shape<128, 128, 64, 32>;" in text
    assert "using SmallTile = Shape<64, 64, 32, 32>;" in text


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
