"""The wavefront stack's weight gradients on csrc/gemm_tc.cuh, on the CPU.

Once its reverse walk ends, the stack's BPTT (csrc/lstm_stack_bwd.cu) runs
each layer's weight gradients on the tensor-core tiles: dV = HUᵀ dPre and
dU = Hprevᵀ dHU, and for a layer l >= 1 dUx = Xᵀ dXU and dVx = XUᵀ dPre,
each over k = T*B rows, where X = ys_{l-1} * mask_l is written once into
the staging scratch. The card is not here, so this file holds what the
wrapper computes for it at the PTB LM stack (L=2, T=35, h=650, r=rx=300)
at B = 1, 20, 128 and 256: the products and the tile that gemm_tc.cuh's
rule gives each, the staging scratch against a count by hand and against
one per-layer BPTT's, the split-k scratch, the bound's operations, and the
masked x-side product emulated as the tiles build 3xTF32, against float64.
No JAX: `tests/test_torch_stack.py` holds the stack's BPTT to JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_gemm_tc import emulate_hopper_3xtf32, rel_err  # noqa: E402

from vmlmf_tpu_torch.ops import cuda_scan, cuda_stack  # noqa: E402

T, H, R = 35, 650, 300
RANKS, XRANKS = (R, R), (R,)
G4 = 4 * H
BATCHES = (1, 20, 128, 256)
MIB = 2 ** 20


def align(nbytes):
    return -(-nbytes // cuda_scan.STAGE_ALIGN) * cuda_scan.STAGE_ALIGN


def round_to(v, q):
    return -(-v // q) * q


# the sources each product reads, (name, rows, cols) as stored: A of dV is
# HU [M, r], of dU Hprev [M, h], of dUx X [M, h], of dVx XU [M, rx]; B of
# dV and dVx dPre [M, 4h], of dU dHU [M, r], of dUx dXU [M, rx]
def sources(m):
    return {"dV": (("hu", m, R), ("dpre", m, G4)), "dU": (("hprev", m, H), ("dhu", m, R)),
            "dUx": (("x", m, H), ("dxu", m, R)), "dVx": (("xu", m, R), ("dpre", m, G4))}


# which products gemm_tc.cuh's rule sends to the Hopper tile, by batch: at
# B=1 (k = 35) none; at B=20 (k = 700) dV and dVx, 546M multiply-adds,
# while dU and dUx [650, 300] have 137M; at B >= 128 all four
HOPPER = {1: (), 20: ("dV", "dVx"), 128: ("dV", "dU", "dUx", "dVx"),
          256: ("dV", "dU", "dUx", "dVx")}


def hand_count(b, bf16, masks):
    """Bytes of the largest layer's staging by hand: each source that a
    Hopper-tile product reads, once (dPre serves dV and dVx), bf16 in its
    stored layout with rows padded to 8, or 3xTF32's hi and lo of its
    transpose (every weight gradient reads both operands along M, k) with
    rows padded to 4 floats; X [M, h] in f32 first where there is a mask."""
    m = T * b
    most = 0
    for l, names in enumerate((("dV", "dU"), ("dV", "dU", "dUx", "dVx"))):
        seen, total = set(), align(4 * m * H) if l and masks else 0
        for name in names:
            if name not in HOPPER[b]:
                continue
            for src, rows, cols in sources(m)[name]:
                if src in seen:
                    continue
                seen.add(src)
                total += (align(rows * round_to(cols, 8) * 2) if bf16
                          else 2 * align(cols * round_to(rows, 4) * 4))
        most = max(most, total)
    return most


@pytest.mark.parametrize("masks", [True, False], ids=["masks", "no_masks"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", BATCHES)
def test_stack_tc_stage_floats_by_hand(b, bf16, masks):
    got = cuda_stack.stack_tc_stage_floats(T, b, H, RANKS, XRANKS, bf16, masks)
    assert 4 * got == hand_count(b, bf16, masks)


@pytest.mark.parametrize("masks", [True, False], ids=["masks", "no_masks"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", BATCHES)
def test_stack_staging_is_no_larger_than_one_per_layer_bptt(b, bf16, masks):
    """The stack's layers stage one at a time, each from the scratch's
    start, so the scratch is one layer's: no larger than one per-layer LSTM
    BPTT's at the same shape (292.0 MiB in f32 at B=128), which stages dXU
    and dx too. Where the stage holds the masked input X, the per-layer
    path ("fused") has the same X outside its scratch (its caller
    multiplies the layer's input by the mask), and counted with it the
    stack's is no larger; from B=128 on, no larger even without it."""
    stack = 4 * cuda_stack.stack_tc_stage_floats(T, b, H, RANKS, XRANKS, bf16, masks)
    layer = 4 * cuda_scan.tc_stage_floats(T, b, H, R, H, R, "bwd", bf16)
    x = align(4 * T * b * H) if masks else 0
    assert stack <= layer + x
    if not masks or b >= 128:
        assert stack <= layer
    if b == 128 and not bf16:
        assert round(layer / MIB, 1) == 292.0
        assert round(stack / MIB, 1) == (185.4 if masks else 174.3)


# gemm_tc.cuh's plan of each product, f32 and bf16 alike but for the
# Hopper tile's k a stage (32 f32, 64 bf16): (wg, big, splits, kslice) of
# dV and dVx [300, 2600] and of dU and dUx [650, 300], by batch
PLANS = {1: ((False, False, 2, 32), (False, False, 2, 32)),
         20: ((True, True, 2, {False: 352, True: 384}), (False, False, 5, 160)),
         128: ((True, True, 2, 2240), (True, True, 7, 640)),
         256: ((True, True, 2, 4480), (True, True, 7, 1280))}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", BATCHES)
def test_each_weight_gradient_s_route_and_plan(b, bf16):
    """Layer 0 has dV and dU, layer 1 dV, dU, dUx and dVx, each over k =
    T*B, in launch order; `cuda_scan.tc_route` sends them where HOPPER
    says, and `cuda_scan.tc_plan`, with the split-k room the wrapper gives
    the call, slices k as PLANS says: whole stages or TC_DEPTH steps that
    cover k once; the scratch holds every product's slices."""
    m = T * b
    layers = cuda_stack.stack_tc_products(T, b, H, RANKS, XRANKS)
    assert [[name for name, _ in layer] for layer in layers] == [["dV", "dU"],
                                                                  list(cuda_stack.STACK_PRODUCTS)]
    floats = cuda_stack.stack_partial_floats(T, b, H, RANKS, XRANKS, bf16)
    for l, layer in enumerate(layers):
        for name, (pm, pn, pk, (a, a_along), (b_src, b_along), split, store) in layer:
            want = {"dV": (R, G4), "dU": (H, R), "dUx": (H, R), "dVx": (R, G4)}[name]
            assert (pm, pn, pk) == (*want, m) and split and store
            assert not a_along and b_along  # A read transposed, B along its rows
            assert (a, b_src) == {"dV": ("hu", "dpre"), "dU": ("hprev", "dhu"),
                                  "dUx": ("x", "dxu"), "dVx": ("xu", "dpre")}[name]
            assert cuda_scan.tc_route(pm, pn, pk) == (name in HOPPER[b])
            plan = cuda_scan.tc_plan(pm, pn, pk, floats // (pm * pn), bf16)
            wg, big, splits, kslice = PLANS[b][name in ("dU", "dUx")]
            kslice = kslice[bf16] if isinstance(kslice, dict) else kslice
            assert plan == (wg, big, splits, kslice), (l, name)
            assert (splits - 1) * kslice < pk <= splits * kslice
            assert splits * pm * pn <= floats
    # the largest split: dV [300, 2600] in two slices
    assert floats == 2 * R * G4


def test_weight_gradient_operations_price_the_tensor_cores():
    """`stack_gemm_ops` counts two operations a multiply-add of the six
    products, equal to `stack_mm_ops` (each a forward product's transpose
    over the same rows) and under half of `stack_bwd_cost`'s operations
    (the walk has as many, and the elementwise work)."""
    for b in BATCHES:
        m = T * b
        want = 2 * m * (2 * (R * G4 + H * R) + H * R + R * G4)
        gemm = cuda_stack.stack_gemm_ops(T, b, H, list(RANKS), list(XRANKS))
        assert gemm == want == cuda_stack.stack_mm_ops(T, b, H, list(RANKS), list(XRANKS))
        ops, _ = cuda_stack.stack_bwd_cost(T, b, H, list(RANKS), list(XRANKS), masks=True)
        assert 2 * gemm < ops < 2 * gemm + 40 * T * b * H * 2


@pytest.mark.parametrize("b", (20, 128))
def test_masked_x_side_product_in_3xtf32_keeps_f32_precision(b):
    """dUx = Xᵀ dXU with X = ys * mask (dropout at rate 0.5: 0 or 2), as the
    tiles read the materialised X: hi and lo by cvt.rna, each k8 step's
    lo*hi, hi*lo, hi*hi from zero with the tensor core's truncating sums,
    the steps joined by f32 adds (both tiles sum so). Within 1e-5 of
    float64 at k = 700 and 4480 (48 units of h and 96 of rx, all of k), as
    the LM layer's products are; the same X from y and the mask in one f32
    multiply, the value the plain version and MaskedRows compute."""
    m = T * b
    rng = np.random.default_rng(2)
    ys = torch.from_numpy(np.tanh(rng.standard_normal((m, H))).astype(np.float32))
    mask = torch.from_numpy((rng.random((m, H)) < 0.5).astype(np.float32) / 0.5)
    dxu = torch.from_numpy(0.1 * rng.standard_normal((m, R)).astype(np.float32))
    x = ys * mask
    assert torch.equal(x, (ys.double() * mask.double()).float())  # one rounding, exact here
    a, bm = x.T[:48].contiguous(), dxu[:, :96].contiguous()
    want = a.double() @ bm.double()
    assert rel_err(emulate_hopper_3xtf32(a, bm), want) < 1e-5


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_tc_check_reads_the_masked_view_on_the_cpu(bf16):
    """`ops/tc_check.py`'s masked view (a_kind MASKED, read on the card by
    csrc/gemm_tc_check.cu as the stack's BPTT reads it) is (y * mask)ᵀ, and
    its staging scratch holds X before the product's copies, on either
    tile."""
    from vmlmf_tpu_torch.ops.tc_check import (AMPERE_BIG, HOPPER, MASKED, PLAN, operands,
                                              relative_error, scratch_floats, tc_product)

    m, n, k = 9, 7, 11
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal((k, m)).astype(np.float32))
    mask = torch.from_numpy((rng.random((k, m)) < 0.5).astype(np.float32) / 0.5)
    dxu = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    a, b = operands(MASKED, 0, y, mask, dxu)
    assert torch.equal(a, (y * mask).T) and torch.equal(b, dxu)
    got = tc_product(MASKED, 0, y, mask, 0, m, dxu, n, m, n, k, bf16)
    if bf16:
        a, b = a.bfloat16().float(), b.bfloat16().float()
    assert relative_error(got, a, b) < 1e-6
    x = align(4 * k * m) // 4
    assert scratch_floats(MASKED, 0, m, n, k, bf16, tile=AMPERE_BIG) == (0, x)
    assert scratch_floats(MASKED, 0, m, n, k, bf16, tile=PLAN)[1] == x  # the Ampere tile's
    _, staged = scratch_floats(MASKED, 0, m, n, k, bf16, tile=HOPPER)
    _, plain = scratch_floats(1, 0, m, n, k, bf16, tile=HOPPER)
    assert staged == x + plain
