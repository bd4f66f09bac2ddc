"""The layout of the port's GRU scan kernels (`cuda_gru.gru_plan`), the
split-k scratch of their BPTT (`cuda_gru.gru_bwd_partial_floats`), and the
order of their sums, on the CPU.

Each kernel CTA owns a few batch rows for all T steps, with four lanes per
output unit of a product, each summing a strided quarter of the depth
quads. Here every shape that `chip_smoke.py` and the config builders give
the kernels, and ragged ones, is checked for a layout that fits the card
and covers every row, unit and depth quad once. A torch emulation of the
kernels' steps (the time block's projection, each unit's four slices, the
walk's phases in their order) is held against the plain walks,
`gru_recurrence_plain` and `gru_scan_bwd_plain`, and against the JAX
package's `gru_scan_fused_xin` and its VJP (Pallas in interpret mode).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from vmlmf_tpu.ops.pallas_gru import gru_scan_fused_xin as jax_gru  # noqa: E402
from vmlmf_tpu_torch import config  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_gru  # noqa: E402
from vmlmf_tpu_torch.ops.cuda_scan import (  # noqa: E402
    SMEM_LIMIT,
    SPLIT_TARGET,
    tc_route,
    tc_splitk_floats,
)

SMS = 132  # an H100 SXM
EMU_TOL = dict(atol=1e-9, rtol=1e-9)  # float64: only the order of sums differs
FWD_TOL = dict(atol=2e-5, rtol=2e-5)  # f32 against the JAX kernel (tests/test_pallas_gru.py)
GRAD_TOL = dict(atol=3e-4, rtol=3e-4)
FORMS = {"lowrank_pre": cuda_gru.LOWRANK_PRE, "dense_pre": cuda_gru.DENSE_PRE,
         "dense_post": cuda_gru.DENSE_POST}

# (T, B, F, rx, h, r, form): the HAR GRU layers at the train batch and at
# evaluate's, one row, a batch past four rows a CTA, and the h=256 layers
# whose weights are read through L2
HAR = [(24, b, f, rx, 64, r, form) for b in (1, 81, 256, 600) for f in (77, 64)
       for rx in (9, 0) for r, form in ((9, 0), (0, 1), (0, 2))]
WIDE = [(24, b, 77, rx, 256, r, form) for b in (81, 256) for rx in (9, 0)
        for r, form in ((64, 0), (0, 1), (0, 2))]
# ragged B, h, r and rx
RAGGED = [(t, b, f, rx, h, r, form) for t in (1, 5) for b in (1, 3, 133, 530)
          for f, rx in ((13, 3), (7, 0)) for h, r, form in ((37, 5, 0), (21, 0, 1), (33, 0, 2))]


def check_plan(t, b, f, rx, h, r, form, gi=False, sms=SMS):
    plan = cuda_gru.gru_plan(t, b, f, rx, h, r, form, gi=gi, sms=sms)
    assert plan.smem_fwd <= SMEM_LIMIT and plan.smem_bwd <= SMEM_LIMIT
    assert plan.smem_fwd % 16 == 0 and plan.smem_bwd % 16 == 0  # float4 regions
    # every batch row on exactly one CTA; the grid no larger than the batch needs
    assert 1 <= plan.rows <= cuda_gru.GRU_MAX_ROWS
    assert (plan.ctas - 1) * plan.rows < b <= plan.ctas * plan.rows
    if b <= cuda_gru.GRU_MAX_ROWS * sms:
        assert plan.ctas <= sms
    # four lanes per unit, whole warps, every unit in some pass
    assert plan.threads % 32 == 0 and plan.threads <= cuda_gru.GRU_MAX_THREADS
    per_pass = plan.threads // cuda_gru.GRU_SLICES
    assert per_pass >= min(max(h, r), cuda_gru.GRU_MAX_THREADS // cuda_gru.GRU_SLICES)
    # every step in one time block
    assert 1 <= plan.tblock <= t and plan.blocks * plan.tblock >= t
    return plan


@pytest.mark.parametrize("shape", HAR + WIDE + RAGGED)
def test_plan_fits_the_card_and_covers_every_row(shape):
    check_plan(*shape)
    check_plan(*shape[:2], 0, 0, *shape[4:], gi=True)


def test_har_plan_keeps_every_weight_and_step_in_shared_memory():
    for t, b, f, rx, h, r, form in HAR:
        plan = check_plan(t, b, f, rx, h, r, form)
        # each lane's share of the recurrent weights in registers
        assert plan.rec_weights == plan.bwd_rec_weights == "registers" and plan.x_resident
        assert plan.tblock == t and plan.threads == 256
    # a CTA per row at the train batch; two rows at evaluate's
    assert check_plan(24, 81, 77, 9, 64, 9, 0).ctas == 81
    assert check_plan(24, 256, 77, 9, 64, 0, 2).rows == 2


def test_wide_plan_reads_its_weights_through_l2_and_takes_time_blocks():
    for t, b, f, rx, h, r, form in WIDE:
        plan = check_plan(t, b, f, rx, h, r, form)
        assert plan.rec_weights == plan.bwd_rec_weights == "L2"  # 256 or 768 KB
        assert plan.threads == cuda_gru.GRU_MAX_THREADS  # two passes of 128 units
    # a long sequence at h=256: the gi block of 3h floats a row and step is cut
    plan = check_plan(400, 256, 77, 9, 256, 0, 2)
    assert plan.tblock < 400 and plan.blocks > 1
    gi_plan = check_plan(400, 256, 0, 0, 256, 0, 2, gi=True)
    assert gi_plan.tblock < 400
    # the x side's 245 KB dense Ux does not fit beside the block: through L2
    assert not check_plan(24, 81, 77, 0, 256, 0, 2).x_resident


def test_plan_prefers_resident_recurrent_weights_to_a_long_time_block():
    # dense "post" at h=128: 192 KB of Prz and Pn leave room for half of T
    plan = check_plan(24, 81, 77, 0, 128, 0, 2)
    assert plan.rec_weights == "shared" and not plan.x_resident and plan.tblock == 12
    # past REG_H the lanes' shares no longer fit in registers
    assert check_plan(24, 81, 77, 9, 65, 0, 2).rec_weights == "shared"
    assert check_plan(24, 81, 77, 9, 64, 17, 0).rec_weights == "shared"


def test_plan_raises_only_on_arguments_the_kernels_do_not_take():
    # fault 11: one step's gi and carry at h=20000 (400 KB) do not fit in
    # shared memory; the plan keeps the leading regions in device memory
    wide = cuda_gru.gru_plan(24, 81, 77, 9, 20000, 0, 2)
    assert wide.rows == 1 and wide.spill_fwd > 0 and wide.spill_bwd > 0
    with pytest.raises(ValueError, match="no GRU plan"):
        cuda_gru.gru_plan(24, 81, 77, 9, 64, 0, 0)  # low-rank form without a rank
    with pytest.raises(ValueError, match="no GRU plan"):
        cuda_gru.gru_plan(24, 81, 77, 9, 64, 9, 2)  # "post" is dense only
    with pytest.raises(ValueError, match="no GRU plan"):
        cuda_gru.gru_plan(0, 81, 77, 9, 64, 9, 0)


# fault 10: dense "post", dense "pre" and low-rank "pre" (r = h/2) with a
# dense x side at T=24, F=77, where ceil(B / SMs) rows a CTA do not fit
FEWER_ROWS = [(24, b, 77, 0, h, r, form) for b, h in ((512, 1000), (256, 2000))
              for r, form in ((0, 2), (0, 1), (h // 2, 0))]


@pytest.mark.parametrize("shape", FEWER_ROWS, ids=str)
def test_plan_takes_fewer_rows_a_cta_where_the_batch_s_share_does_not_fit(shape):
    t, b, f, rx, h, r, form = shape
    for gi in (False, True):
        plan = cuda_gru.gru_plan(t, b, f * (not gi), rx, h, r, form, gi=gi, sms=SMS)
        assert plan.smem_fwd <= SMEM_LIMIT and plan.smem_bwd <= SMEM_LIMIT
        assert plan.rows in cuda_gru.ROW_BOUNDS
        assert plan.rows < min(cuda_gru.GRU_MAX_ROWS, -(-b // SMS))
        assert (plan.ctas - 1) * plan.rows < b <= plan.ctas * plan.rows  # every row once
        assert plan.ctas > SMS  # no grid barrier: more CTAs than SMs run in waves
        # the same layer at B=81 gets the same layout with one row a CTA
        one = cuda_gru.gru_plan(t, 81, f * (not gi), rx, h, r, form, gi=gi, sms=SMS)
        assert one.rows == 1
        if plan.rows == 1:
            assert (plan.tblock, plan.smem_fwd, plan.smem_bwd) == (
                one.tblock, one.smem_fwd, one.smem_bwd)
    assert check_plan(t, SMS, f, rx, h, r, form).rows == 1


def test_every_shape_with_a_plan_keeps_ceil_b_over_sms_rows():
    # the rows a CTA that the plan took before fault 10's repair, wherever
    # they fit: every shape the tests above and chip_smoke.py drive
    for t, b, f, rx, h, r, form in HAR + WIDE + RAGGED + chip_smoke_shapes():
        for gi in (False, True):
            plan = cuda_gru.gru_plan(t, b, f, rx, h, r, form, gi=gi, sms=SMS)
            assert plan.rows == min(cuda_gru.GRU_MAX_ROWS, -(-b // SMS))


def test_plan_spills_only_where_one_row_does_not_fit():
    # dense "post" at B=512: h=764 still takes 4 rows a CTA, 765 takes fewer
    assert cuda_gru.gru_plan(24, 512, 77, 0, 764, 0, 2, sms=SMS).rows == 4
    assert cuda_gru.gru_plan(24, 512, 77, 0, 765, 0, 2, sms=SMS).rows == 2
    widest = cuda_gru.gru_plan(24, 512, 77, 0, 3000, 0, 2, sms=SMS)
    assert widest.rows == 1 and widest.rec_weights == widest.bwd_rec_weights == "L2"
    assert widest.spill_fwd == widest.spill_bwd == 0
    # fault 11: past one row's fit the walk's staged inputs go to device memory
    spilled = cuda_gru.gru_plan(24, 1, 77, 0, 20000, 0, 2, sms=SMS)
    assert spilled.rows == 1 and spilled.spill_bwd > 0
    assert spilled.smem_fwd <= SMEM_LIMIT and spilled.smem_bwd <= SMEM_LIMIT


def test_plan_counts_the_regions_the_kernels_lay_out():
    # low-rank x, low-rank "pre", h=64, one row, T=24 (gru_scan_xin_fwd.cu::fwd_layout);
    # the recurrent weights in registers take no shared memory
    x_weights = 80 * 9 + 12 * 192
    block = 24 * 192 + 24 * 80 + 24 * 12
    state = 2 * 64 + 64 + 12 + 12 + 64
    assert cuda_gru.gru_plan(24, 81, 77, 9, 64, 9, 0).smem_fwd == 4 * (x_weights + block + state)
    # its walk (gru_scan_xin_bwd.cu::walk_layout)
    walk = 2 * 5 * 64 + 64 + 128 + 64 + 64 + 12 + 12
    assert cuda_gru.gru_plan(24, 81, 77, 9, 64, 9, 0).smem_bwd == 4 * walk
    # held in shared memory at r = 17: Uf [64][ldt 20], Prz [17][132], Pn [17][68]
    walk17 = 64 * 20 + 17 * 132 + 17 * 68 + 2 * 5 * 64 + 64 + 128 + 64 + 64 + 20 + 20
    assert cuda_gru.gru_plan(24, 81, 77, 9, 64, 17, 0).smem_bwd == 4 * walk17
    # the strides hold an odd number of float4s
    for n in range(1, 300):
        ld = cuda_gru._ldt(n)
        assert ld >= n and ld % 4 == 0 and (ld // 4) % 2 == 1


def chip_smoke_shapes():
    shapes = [(t, b, f, rx, h, r, cuda_gru.form_of(object() if low else None, mode))
              for _, (t, b, f, h, rx, r), mode, low, _, _ in chip_smoke.gru_kernel_shapes()]
    shapes += [(t, b, f, rx, h, r, cuda_gru.form_of(object() if low else None, mode))
               for _, (t, b, f, h, rx, r), mode, low, _ in chip_smoke.gru_variant_shapes()]
    return shapes


def test_plan_fits_every_shape_chip_smoke_drives():
    for shape in chip_smoke_shapes():
        check_plan(*shape)
        check_plan(*shape[:2], 0, 0, *shape[4:], gi=True)


GRU_CONFIGS = {
    "mygru": dict(model="mygru", layer_sizes=(64, 64), w_rank=9, u_ranks=(9,)),
    "mygru_group": dict(model="mygru_group", layer_sizes=(64, 64), w_rank=9, u_ranks=(12, 6)),
    "mygru_dense": dict(model="mygru", layer_sizes=(64, 64)),
    "mygru_w9": dict(model="mygru", layer_sizes=(64, 64), w_rank=9),
}


@pytest.mark.parametrize("name", list(GRU_CONFIGS))
def test_plan_fits_every_gru_shape_the_config_builders_make(name, monkeypatch):
    seen = []
    real = cuda_gru.gru_scan_fused_xin_plain

    def spy(xs, ux, vx, bias, uf, prz, pn, h0, *, mode="pre"):
        seen.append((xs.shape[-1], 0 if vx is None else ux.shape[-1], h0.shape[-1],
                     0 if uf is None else uf.shape[-1], cuda_gru.form_of(uf, mode)))
        return real(xs, ux, vx, bias, uf, prz, pn, h0, mode=mode)

    monkeypatch.setattr(cuda_gru, "gru_scan_fused_xin_plain", spy)
    model = config.HARConfig(**GRU_CONFIGS[name]).build_model()
    with torch.no_grad():
        model.apply(model.init(torch.Generator().manual_seed(0), device="cpu"),
                    torch.zeros(2, 24, 77))
    assert seen
    for f, rx, h, r, form in seen:
        for b in (81, 256):
            check_plan(24, b, f, rx, h, r, form)


def gemm_splits(products, sized_by=None):
    """The slices gemm_tile.cuh::gemm_splitk_group cuts each product's k
    into: one length of whole 16-row steps, the products ``sized_by`` near
    528 CTAs."""
    work = sum(-(-n // 64) * -(-m // 64) * k for m, n, k in sized_by or products)
    kslice = -(-(-(-work // (2 * SPLIT_TARGET))) // 16) * 16
    return [-(-k // kslice) for _, _, k in products]


@pytest.mark.parametrize("gi", [False, True], ids=["x", "gi"])
@pytest.mark.parametrize("shape", HAR + WIDE + RAGGED[:12])
def test_bwd_partial_floats_holds_every_product_s_slices_at_once(shape, gi):
    t, b, f, rx, h, r, form = shape
    if gi:
        f = rx = 0
    for dx in (True, False):
        products = cuda_gru.gru_bwd_products(t, b, f, rx, h, r, form, gi=gi, dx=dx)
        # every weight gradient of the form and x side, and dx where it is wanted
        low, post = form == cuda_gru.LOWRANK_PRE, form == cuda_gru.DENSE_POST
        assert len(products) == 2 + low + (0 if gi else 2 + (rx > 0) + dx)
        weights = products[:-1] if dx and not gi else products  # dx's k is rx or 3h
        assert all(k in (t * b, 2 * t * b) for _, _, k in weights)
        splits = gemm_splits(products, weights)
        assert splits == cuda_gru.group_splits(products, weights)
        # the weight gradients' slices do not depend on dx
        assert splits[:len(weights)] == gemm_splits(weights)
        # the group's regions lie one after another: the scratch is their sum;
        # a recurrent product that the Hopper tile takes (tc_route: 2^28
        # multiply-adds, m, n, k >= 128) runs before the group, in its own k
        # slices, and keeps no region there
        routed = [i < 2 + low and tc_route(m, n, k) for i, (m, n, k) in enumerate(products)]
        assert not any(routed[2 + low:])
        group = sum(s * m * n for s, (m, n, _), go in zip(splits, products, routed) if not go)
        hopper = [tc_splitk_floats(m, n, k, False) for (m, n, k), go in zip(products, routed)
                  if go]
        dxu = sum(s * m * n for s, (m, n, _) in zip(gemm_splits([(t * b, rx, 3 * h)]),
                                                    [(t * b, rx, 3 * h)])) if rx else 0
        assert cuda_gru.gru_bwd_partial_floats(t, b, f, rx, h, r, form, gi=gi, dx=dx) == max(
            group, dxu, *hopper)
        # one slice length: each CTA walks about the same k, the weight gradients
        # near 528 CTAs
        ctas = sum(s * -(-n // 64) * -(-m // 64) for s, (m, n, _) in zip(splits, weights))
        assert ctas <= 2 * SPLIT_TARGET + sum(-(-n // 64) * -(-m // 64) for m, n, _ in weights)
        assert all(1 <= s <= -(-k // 16) for s, (_, _, k) in zip(splits, products))
        assert not post or products[1] == (h, h, t * b)


def test_bwd_partial_floats_at_the_har_layer():
    # "post", low-rank x, second layer: dPrz, dPn, dUx, dVx, dbias, dx
    products = cuda_gru.gru_bwd_products(24, 81, 64, 9, 64, 0, 2)
    assert products == [(64, 128, 1944), (64, 64, 1944), (64, 9, 1944), (9, 192, 1944),
                        (1, 192, 1944), (1944, 64, 9)]
    # ten tiles over 1,944 rows: slices of 48 rows, 41 of them; dx's k = 9 takes one
    assert gemm_splits(products, products[:-1]) == [41, 41, 41, 41, 41, 1]
    want = 41 * (64 * 128 + 64 * 64 + 64 * 9 + 9 * 192 + 192) + 1944 * 64
    assert cuda_gru.gru_bwd_partial_floats(24, 81, 64, 9, 64, 0, 2) == want
    # dXU [1944, 9] = dPre Vx^T alone: 31 tiles over k = 192, 12 slices of 16
    assert gemm_splits([(1944, 9, 192)]) == [12]
    # dUf [64, 9] over [Hprev | R*Hprev], low-rank "pre": 3,888 rows
    assert (64, 9, 2 * 1944) in cuda_gru.gru_bwd_products(24, 81, 77, 9, 64, 9, 0)
    # gi mode: the recurrent products alone, slices of 16 rows
    assert gemm_splits(cuda_gru.gru_bwd_products(24, 81, 0, 0, 64, 0, 2, gi=True)) == [
        122, 122]


# -- a torch emulation of the kernels' order of sums --------------------------

def slice_dot(src, w):
    """src [R, D] @ w [D, N] as the kernels sum it: D padded to quads, lane
    slice s of four summing quads s, s+4, .. in order, the slices added
    as ((s0 + s1) + (s2 + s3))."""
    d = src.shape[1]
    pad = -d % 4
    src = torch.nn.functional.pad(src, (0, pad))
    w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    nq = (d + pad) // 4
    parts = []
    for s in range(cuda_gru.GRU_SLICES):
        acc = torch.zeros(src.shape[0], w.shape[1], dtype=src.dtype)
        for q in range(s, nq, cuda_gru.GRU_SLICES):
            for e in range(4 * q, 4 * q + 4):
                acc = acc + src[:, e:e + 1] * w[e]
        parts.append(acc)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def emulate_fwd(gi, uf, prz, pn, h0, rows, form):
    """The forward kernel's steps, CTA by CTA -> (ys, gates, hu, rhu, recn)."""
    t, b, g3 = gi.shape
    h = g3 // 3
    out = {k: [] for k in ("ys", "gates", "hu", "rhu", "recn")}
    for b0 in range(0, b, rows):
        hc = h0[b0:b0 + rows]
        ys, gates, hus, rhus, recns = [], [], [], [], []
        for step in range(t):
            g = gi[step, b0:b0 + rows]
            if form == cuda_gru.DENSE_POST:
                acc = slice_dot(hc, torch.cat([prz, pn], dim=1))
                r_ = torch.sigmoid(g[:, :h] + acc[:, :h])
                z = torch.sigmoid(g[:, h:2 * h] + acc[:, h:2 * h])
                recns.append(acc[:, 2 * h:])
                n = torch.tanh(g[:, 2 * h:] + r_ * acc[:, 2 * h:])
            else:
                src = hc
                if form == cuda_gru.LOWRANK_PRE:
                    src = slice_dot(hc, uf)
                    hus.append(src)
                acc = slice_dot(src, prz)
                r_ = torch.sigmoid(g[:, :h] + acc[:, :h])
                z = torch.sigmoid(g[:, h:2 * h] + acc[:, h:])
                nsrc = r_ * hc
                if form == cuda_gru.LOWRANK_PRE:
                    nsrc = slice_dot(nsrc, uf)
                    rhus.append(nsrc)
                n = torch.tanh(g[:, 2 * h:] + slice_dot(nsrc, pn))
            hc = z * hc + (1 - z) * n
            ys.append(hc)
            gates.append(torch.cat([r_, z, n], dim=1))
        for k, v in zip(out, (ys, gates, hus, rhus, recns)):
            out[k].append(torch.stack(v) if v else None)
    return tuple(None if v[0] is None else torch.cat(v, dim=1) for v in out.values())


def emulate_walk(uf, prz, pn, h0, ys, gates, hu, rhu, recn, dys, rows, form):
    """The walk kernel's phases, CTA by CTA -> (dpre, dh0); the weight
    gradients are the split-k GEMMs' (any fixed order), left out."""
    t, b, h = ys.shape
    hprev = torch.cat([h0[None], ys[:-1]])
    dpres, dh0s = [], []
    for b0 in range(0, b, rows):
        sl = slice(b0, b0 + rows)
        dh = torch.zeros_like(h0[sl])
        dpre = [None] * t
        for s in range(t - 1, -1, -1):
            r_, z, n = gates[s, sl].split(h, dim=1)
            hp = hprev[s, sl]
            dh = dh + dys[s, sl]
            dz_pre = dh * (hp - n) * z * (1 - z)
            dn_pre = dh * (1 - z) * (1 - n * n)
            carry = dh * z
            if form == cuda_gru.DENSE_POST:
                dr_pre = dn_pre * recn[s, sl] * r_ * (1 - r_)
                rz = torch.cat([dr_pre, dz_pre], dim=1)
                # one product over [dr, dz] then (dn*r), in each slice's order
                carry = carry + slice_dot(torch.cat([rz, dn_pre * r_], dim=1),
                                          torch.cat([prz, pn], dim=1).T)
            else:
                src = dn_pre
                if form == cuda_gru.LOWRANK_PRE:
                    src = slice_dot(dn_pre, pn.T)  # drhu
                    drh = slice_dot(src, uf.T)
                else:
                    drh = slice_dot(dn_pre, pn.T)
                dr_pre = drh * hp * r_ * (1 - r_)
                carry = carry + drh * r_
                rz = torch.cat([dr_pre, dz_pre], dim=1)
                if form == cuda_gru.LOWRANK_PRE:
                    carry = carry + slice_dot(slice_dot(rz, prz.T), uf.T)
                else:
                    carry = carry + slice_dot(rz, prz.T)
            dpre[s] = torch.cat([rz, dn_pre], dim=1)
            dh = carry
        dpres.append(torch.stack(dpre))
        dh0s.append(dh)
    return torch.cat(dpres, dim=1), torch.cat(dh0s)


# (T, B, F, rx, h, r, mode, low-rank): small, with ragged h, r and rows
EMU_CASES = {
    "lowrank_pre": (4, 5, 7, 3, 10, 5, "pre", True),
    "dense_pre": (3, 6, 5, 0, 9, 0, "pre", False),
    "dense_post": (4, 7, 6, 2, 11, 0, "post", False),
}


def emu_inputs(t, b, f, rx, h, r, mode, lowrank, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale):
        return (scale * rng.standard_normal(shape)).astype(dtype)

    k = r if lowrank else h
    return (n(t, b, f, scale=1.0), n(f, rx or 3 * h, scale=f ** -0.5),
            n(rx, 3 * h, scale=rx ** -0.5) if rx else None, n(3 * h, scale=0.1),
            n(h, r, scale=h ** -0.5) if lowrank else None, n(k, 2 * h, scale=k ** -0.5),
            n(k, h, scale=k ** -0.5), n(b, h, scale=0.5))


def as_torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("rows", [1, 2, 4])
@pytest.mark.parametrize("case", list(EMU_CASES))
def test_emulated_kernel_steps_match_the_plain_walks(case, rows):
    t, b, f, rx, h, r, mode, lowrank = EMU_CASES[case]
    xs, ux, vx, bias, uf, prz, pn, h0 = as_torch(emu_inputs(*EMU_CASES[case]))
    form = cuda_gru.form_of(uf, mode)
    gi = cuda_gru._x_side(xs, ux, vx, bias)[1]
    got = emulate_fwd(gi, uf, prz, pn, h0, rows, form)
    want = cuda_gru.gru_recurrence_plain(gi, uf, prz, pn, h0, mode=mode)
    for name, g, w in zip(("ys", "gates", "hu", "rhu", "recn"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            torch.testing.assert_close(g, w, msg=name, **EMU_TOL)
    dys = torch.from_numpy(np.random.default_rng(1).standard_normal((t, b, h)))
    dpre, dh0 = emulate_walk(uf, prz, pn, h0, *want, dys, rows, form)
    dpre_p, *_, dh0_p = cuda_gru.gru_scan_bwd_plain(uf, prz, pn, h0, *want, dys, mode=mode)
    torch.testing.assert_close(dpre, dpre_p, **EMU_TOL)
    torch.testing.assert_close(dh0, dh0_p, **EMU_TOL)


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_emulated_kernel_steps_match_the_jax_kernel_and_its_vjp(case):
    t, b, f, rx, h, r, mode, lowrank = EMU_CASES[case]
    arrays = emu_inputs(*EMU_CASES[case], dtype=np.float32)
    xs, ux, vx, bias, uf, prz, pn, h0 = as_torch(arrays)
    form = cuda_gru.form_of(uf, mode)
    plan = cuda_gru.gru_plan(t, b, f, rx, h, r, form, sms=2)  # several rows a CTA
    assert plan.rows > 1
    gi = cuda_gru._x_side(xs, ux, vx, bias)[1]
    ys, gates, hu, rhu, recn = emulate_fwd(gi, uf, prz, pn, h0, plan.rows, form)
    dys_np = np.random.default_rng(1).standard_normal((t, b, h)).astype(np.float32)
    dpre, dh0 = emulate_walk(uf, prz, pn, h0, ys, gates, hu, rhu, recn,
                             torch.from_numpy(dys_np), plan.rows, form)

    def run(x, u, v, bi, ufj, pz, pnj, h0j):
        return jax_gru(x, u, v, bi, ufj, pz, pnj, h0j, mode=mode, interpret=True)

    jargs = [None if a is None else jnp.asarray(a) for a in arrays]
    want, vjp = jax.vjp(run, *jargs)
    torch.testing.assert_close(ys, torch.from_numpy(np.asarray(want)), **FWD_TOL)
    grads = vjp(jnp.asarray(dys_np))
    # dbias is the column sum of dpre; dh0 is the carry at the end
    torch.testing.assert_close(dpre.reshape(-1, 3 * h).sum(0),
                               torch.from_numpy(np.asarray(grads[3])), **GRAD_TOL)
    torch.testing.assert_close(dh0, torch.from_numpy(np.asarray(grads[7])), **GRAD_TOL)
