"""The layout of the port's LSTM scan kernels (`cuda_scan.scan_plan`) and the
phase split it implies, on the CPU.

The kernels spread a scan over the card: batch groups, each on CTAs that hold
slices of the recurrent weights. Here every shape that `chip_smoke.py` and
the config builders give the kernels, and ragged ones, is checked for a
layout that covers every row, gate column and rank column exactly once and
fits the card. A torch emulation of the kernels' phases (each CTA's slice
products, then their assembly) is held against the plain walks,
`lstm_recurrence_plain` and `lstm_bptt_plain`, and against the JAX
package's `lstm_scan_fused_xin` and its VJP (Pallas in interpret mode).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from vmlmf_tpu.ops.pallas_scan import lstm_scan_fused_xin as jax_scan  # noqa: E402
from vmlmf_tpu_torch import config  # noqa: E402
from vmlmf_tpu_torch.cells.base import pad_features  # noqa: E402
from vmlmf_tpu_torch.nn import recurrence  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_scan  # noqa: E402

SMS = 132  # an H100 SXM
EMU_TOL = dict(atol=1e-6, rtol=1e-6)  # float64: only the order of sums differs
FWD_TOL = dict(atol=2e-5, rtol=2e-5)  # f32 against the JAX kernel (tests/test_pallas.py)
GRAD_TOL = dict(atol=3e-4, rtol=3e-4)
# f32 sums of bf16-rounded operands in another order: the same roundings
BF16_EMU_TOL = dict(atol=1e-5, rtol=1e-5)

# (B, h, r) at ragged edges: r = 0 is a dense U [h, 4h]
RAGGED = [(b, h, r) for b in (1, 3, 5, 257) for h in (7, 650) for r in (1, 300, 0)]
# HAR and LM models that the config builders make (fields of HARConfig /
# LMConfig), with the batches their kernels run at: HAR training (81) and
# `evaluate` (256); LM serving (1, 20, 128) and training (20, 128)
HAR_BATCHES, LM_BATCHES = (81, 256), (1, 20, 128)
CONFIGS = {
    "har_default": ("har", dict()),
    "har_vmlmf": ("har", dict(model="vmmodel", w_rank=8, u_ranks=(6,))),
    "har_vmgroup": ("har", dict(model="vmgroup", w_rank=8, u_ranks=(2, 4))),
    "har_vmgroup_novm": ("har", dict(model="vmgroup_novm", w_rank=8, u_ranks=(2, 4))),
    "har_dualdiag": ("har", dict(model="dualdiag")),
    "har_mylstm_group": ("har", dict(model="mylstm_group", u_ranks=(2, 4))),
    "har_lmf": ("har", dict(model="mylstm", w_rank=8, u_ranks=(6,))),
    "har_dense_x": ("har", dict(model="mylstm", u_ranks=(6,))),
    "har_deepconv": ("har", dict(model="mylstm", deepconv=True, layer_sizes=(128, 128))),
    "lm_vmlmf": ("lm", dict()),
    "lm_dense": ("lm", dict(lstm_type="custom")),
    "lm_vmgroup": ("lm", dict(lstm_type="vmgroup", u_ranks=(200, 100))),
}


def check_plan(b, h, r, sms=SMS, elsize=4):
    """Every row in one group; in each group, every gate column and rank
    column on exactly one CTA; shared memory within a block's 227 KB; the
    grid within the SMs at one CTA each. ``elsize`` 2: the bf16 kernels'
    plan, whose weight slices take two bytes an element."""
    plan = cuda_scan.scan_plan(b, h, r, sms, elsize)
    assert plan.elsize == elsize
    assert plan.n_ctas <= sms
    assert plan.smem_bytes <= cuda_scan.SMEM_LIMIT == 227 * 1024
    assert plan.rpad % 4 == 0
    rows = np.zeros(b, int)
    for g in range(plan.groups):
        b0, b1 = plan.rows(g)
        assert 0 < b1 - b0 <= plan.rpad
        rows[b0:b1] += 1
    assert (rows == 1).all()
    gate_cols, rank_cols = np.zeros(4 * h, int), np.zeros(r, int)
    for q in range(plan.ctas):
        j0, j1 = plan.j_range(q)
        for g in range(4):
            gate_cols[g * h + j0:g * h + j1] += 1
        k0, k1 = plan.k_range(q)
        rank_cols[k0:k1] += 1
    assert (gate_cols == 1).all() and (rank_cols == 1).all()
    return plan


def chip_smoke_shapes():
    return sorted({(s["b"], s["h"], s["r"]) for _, s, *_ in chip_smoke.lstm_kernel_shapes()})


@pytest.mark.parametrize("shape", sorted(set(chip_smoke_shapes() + RAGGED)), ids=str)
def test_plan_covers_every_column_once_and_fits_the_card(shape):
    check_plan(*shape)


def test_plan_groups_the_batch_where_the_weights_fit_many_times():
    har = check_plan(81, 180, 6)           # 21.6 KB of weights: one CTA per group
    assert (har.groups, har.ctas) == (81, 1)
    lm = check_plan(20, 650, 300)          # 3.9 MB: a few groups over all SMs
    assert 1 < lm.groups < 20 and lm.n_ctas > 100
    assert check_plan(1, 650, 300).groups == 1
    # a dense U of 41 MB does not fit (fault 11): one group over all SMs,
    # the rows that do not fit streamed through L2
    wide = check_plan(20, 1600, 0)
    assert (wide.groups, wide.ctas) == (1, SMS) and wide.streamed


@pytest.mark.parametrize("shape", sorted(set(chip_smoke_shapes() + RAGGED)), ids=str)
def test_bf16_plan_covers_every_column_once_and_fits_the_card(shape):
    plan, f32 = check_plan(*shape, elsize=2), cuda_scan.scan_plan(*shape)
    # half the bytes a weight slice: at least as many copies of the weights
    assert plan.groups >= f32.groups


def test_bf16_plan_fits_wider_layers():
    """The widest dense h and the widest low-rank h (r = h/2) whose weights a
    plan holds all in shared memory on 132 SMs, at B in 1, 20 and 128:
    about 1.2-1.9 times the f32 kernels' (dense h about 1,050). Past them a
    plan streams some weight rows, or the batch runs in chunks."""
    def widest(b, lowrank, elsize):
        lo, hi = 8, 8192
        while hi - lo > 1:
            mid = (lo + hi) // 2
            try:
                resident = not cuda_scan.scan_plan(b, mid, mid // 2 if lowrank else 0, SMS,
                                                   elsize).streamed
            except ValueError:
                resident = False
            lo, hi = (mid, hi) if resident else (lo, mid)
        return lo

    got = {(b, lowrank): (widest(b, lowrank, 4), widest(b, lowrank, 2))
           for b in (1, 20, 128) for lowrank in (False, True)}
    print("widest h (f32, bf16) by (B, low-rank):", got)
    assert got == {(1, False): (1056, 1584), (1, True): (1262, 2064),
                   (20, False): (1056, 1584), (20, True): (1068, 1958),
                   (128, False): (1015, 1278), (128, True): (1057, 1466)}
    for (b, lowrank), (f32, bf16) in got.items():
        check_plan(b, bf16, bf16 // 2 if lowrank else 0, elsize=2)
        assert bf16 > 1.2 * f32


def config_shapes(name, monkeypatch):
    """The (h, r) of every scan that a config builder's model runs."""
    kind, fields = CONFIGS[name]
    seen = set()
    plain = recurrence.lstm_scan_fused_xin

    def spy(*args):
        h0, u, v = args[8], args[5], args[6]
        seen.add((h0.shape[-1], 0 if v is None else u.shape[-1]))
        return plain(*args)

    monkeypatch.setattr(recurrence, "lstm_scan_fused_xin", spy)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        if kind == "har":
            model = config.HARConfig(**fields).build_model()
            params = model.init(gen, device="cpu")
            model.apply(params, torch.zeros(2, 17, 77))  # DeepConvNet needs 17 steps
        else:
            model = config.LMConfig(**fields).build_model(30)
            params = model.init(gen, device="cpu")
            model.apply(params, torch.zeros(2, 1, dtype=torch.long), model.state0(1, "cpu"))
    assert seen
    return kind, seen


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plan_fits_every_shape_the_config_builders_make(name, monkeypatch):
    kind, seen = config_shapes(name, monkeypatch)
    for h, r in seen:
        for b in HAR_BATCHES if kind == "har" else LM_BATCHES:
            check_plan(b, h, r)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_plan_fits_every_shape_the_config_builders_make(name, monkeypatch):
    kind, seen = config_shapes(name, monkeypatch)
    for h, r in seen:
        for b in HAR_BATCHES if kind == "har" else LM_BATCHES:
            check_plan(b, h, r, elsize=2)


def emulate_recurrence(plan, gi, u, v, dvec, h0, c0, bf16=False):
    """The forward kernel's phases in torch ops, group by group and CTA by
    CTA: (A) each CTA's rank columns of hu = h @ U, assembled; (B) each
    CTA's hidden units: the gate columns of gi + hu @ V (dense: h @ U) + h *
    dvec, the gates and the update. -> as `lstm_recurrence_plain`. With
    ``bf16`` each CTA's slices and the exchanged h and hu are rounded to
    bf16 (f32 inputs)."""
    rb = rounder(bf16)
    t, b, g4 = gi.shape
    h = g4 // 4
    dvec = dvec.reshape(-1)
    ys, cs, gates = gi.new_empty(t, b, h), gi.new_empty(t, b, h), gi.new_empty(t, b, g4)
    hus = None if v is None else gi.new_empty(t, b, u.shape[1])
    for grp in range(plan.groups):
        b0, b1 = plan.rows(grp)
        h_t, c_t = h0[b0:b1], c0[b0:b1]
        for s in range(t):
            if v is not None:
                hu = gi.new_empty(b1 - b0, u.shape[1])
                for q in range(plan.ctas):
                    k0, k1 = plan.k_range(q)
                    hu[:, k0:k1] = rb(h_t) @ rb(u[:, k0:k1])
                hus[s, b0:b1] = hu
            src, w = (rb(h_t), u) if v is None else (rb(hu), v)
            h_n, c_n = torch.empty_like(h_t), torch.empty_like(c_t)
            for q in range(plan.ctas):
                j0, j1 = plan.j_range(q)
                cols = torch.cat([torch.arange(g * h + j0, g * h + j1) for g in range(4)])
                pre = (gi[s, b0:b1][:, cols] + src @ rb(w[:, cols])
                       + h_t[:, j0:j1].repeat(1, 4) * dvec[cols])
                i, f, g, o = pre.chunk(4, dim=1)
                i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
                c_n[:, j0:j1] = f * c_t[:, j0:j1] + i * g
                h_n[:, j0:j1] = o * torch.tanh(c_n[:, j0:j1])
                gates[s, b0:b1, cols] = torch.cat([i, f, g, o], dim=1)
            h_t, c_t = h_n, c_n
            ys[s, b0:b1], cs[s, b0:b1] = h_t, c_t
    return ys, cs, gates, hus


def rounder(bf16):
    return (lambda a: a.bfloat16().float()) if bf16 else (lambda a: a)


def emulate_bptt(plan, u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dc_last, bf16=False):
    """The BPTT kernel's walk in torch ops, group by group and CTA by CTA:
    (A) each CTA's hidden units of dpre, from its (dh, dc) carry; (B) each
    CTA's rank columns of dhu = dpre @ V^T; (C) each CTA's hidden units of
    dh = sum_g dpre_g dvec_g + dhu @ U^T (dense: dpre @ U^T); then the
    weight gradients over all rows. -> as `lstm_bptt_plain`. With ``bf16``
    the exchanged dpre and dhu, the slices and the GEMM operands are
    rounded to bf16 (f32 inputs)."""
    rb = rounder(bf16)
    t, b, h = ys.shape
    dvec = dvec.reshape(-1)
    dpre = ys.new_empty(t, b, 4 * h)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
    for grp in range(plan.groups):
        b0, b1 = plan.rows(grp)
        dh = torch.zeros_like(h0[b0:b1])
        dc = torch.zeros_like(dh) if dc_last is None else dc_last[b0:b1].clone()
        for s in range(t - 1, -1, -1):
            c_prev = c0[b0:b1] if s == 0 else cs[s - 1, b0:b1]
            d_t = dpre[s, b0:b1]
            dh_part = torch.empty_like(dh)
            for q in range(plan.ctas):
                j = slice(*plan.j_range(q))
                i, f, g, o = (gates[s, b0:b1, k * h:(k + 1) * h][:, j] for k in range(4))
                dh_j = dh[:, j] + (0 if dys is None else dys[s, b0:b1, j])
                tc = torch.tanh(cs[s, b0:b1, j])
                dc_j = dc[:, j] + dh_j * o * (1 - tc * tc)
                p = (dc_j * g * i * (1 - i), dc_j * c_prev[:, j] * f * (1 - f),
                     dc_j * i * (1 - g * g), dh_j * tc * o * (1 - o))
                dc[:, j] = dc_j * f
                dh_part[:, j] = 0
                for k in range(4):
                    d_t[:, k * h:(k + 1) * h][:, j] = p[k]
                    dh_part[:, j] += p[k] * dvec[k * h:(k + 1) * h][j]
            if v is not None:
                dhu = d_t.new_empty(b1 - b0, v.shape[0])
                for q in range(plan.ctas):
                    k0, k1 = plan.k_range(q)
                    dhu[:, k0:k1] = rb(d_t) @ rb(v[k0:k1]).T
            src = rb(d_t if v is None else dhu)
            for q in range(plan.ctas):
                j0, j1 = plan.j_range(q)
                dh[:, j0:j1] = dh_part[:, j0:j1] + src @ rb(u[j0:j1]).T
        dh0[b0:b1], dc0[b0:b1] = dh, dc
    hprev = torch.cat([h0[None], ys[:-1]]).reshape(t * b, h)
    d2 = dpre.reshape(t * b, 4 * h)
    if v is None:
        du, dv = rb(hprev).T @ rb(d2), None
    else:
        du = rb(hprev).T @ rb(rb(d2) @ rb(v).T)
        dv = rb(hu.reshape(t * b, -1)).T @ rb(d2)
    ddvec = (d2 * hprev.repeat(1, 4)).sum(0)
    return dpre, du, dv, ddvec, dh0, dc0


# (T, B, F, h, rx, r, groups, ctas): several groups and CTAs per group, CTAs
# that own no rank column (r < ctas), ragged splits, T = 1 and 2, each form
EMU_CASES = {
    "lowrank_r_lt_ctas": (4, 5, 6, 7, 3, 1, 2, 3),
    "lowrank_ragged": (3, 7, 9, 13, 4, 5, 3, 4),
    "lowrank_t1": (1, 3, 5, 6, 2, 4, 1, 5),
    "dense_both": (3, 5, 7, 9, 0, 0, 2, 4),
    "dense_x": (2, 4, 5, 6, 0, 3, 1, 6),
    "dense_rec_t2": (2, 6, 4, 5, 3, 0, 3, 2),
}


def make_inputs(t, b, f, h, rx, r, dtype, seed=0):
    """Seeded scan inputs (numpy), then as torch tensors of ``dtype``; rx = 0
    or r = 0 give a dense side (vx or v None)."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    arrs = (n(t, b, f, scale=1.0), n(f, rx or 4 * h), n(rx, 4 * h) if rx else None, n(4, h),
            n(4 * h), n(h, r or 4 * h), n(r, 4 * h) if r else None, n(4 * h), n(b, h), n(b, h))
    return arrs, [None if a is None else torch.from_numpy(a).to(dtype) for a in arrs]


def gi_of(xs, ux, vx, xdvec, bias, h):
    """The input contribution, as `lstm_scan_xin_fwd_res_plain` builds it."""
    xp = xs @ ux if vx is None else xs @ ux @ vx
    return xp + pad_features(xs, h).repeat(1, 1, 4) * xdvec.reshape(-1) + bias


def emulated(case, dtype):
    t, b, f, h, rx, r, groups, ctas = EMU_CASES[case]
    arrs, a = make_inputs(t, b, f, h, rx, r, dtype)
    xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0 = a
    plan = cuda_scan.plan_layout(b, h, r, groups, ctas)
    assert (plan.groups, plan.ctas) == (groups, ctas)
    gi = gi_of(xs, ux, vx, xdvec, bias, h)
    rng = np.random.default_rng(3)
    dys = torch.from_numpy(rng.standard_normal((t, b, h))).to(dtype)
    dc_last = torch.from_numpy(rng.standard_normal((b, h))).to(dtype)
    return plan, arrs, a, gi, dys, dc_last


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_emulated_phases_match_the_plain_forward(case):
    plan, _, a, gi, _, _ = emulated(case, torch.float64)
    u, v, dvec, h0, c0 = a[5:]
    got = emulate_recurrence(plan, gi, u, v, dvec, h0, c0)
    want = cuda_scan.lstm_recurrence_plain(gi, u, v, dvec, h0, c0)
    for name, g, w in zip(("ys", "cs", "gates", "hu"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            torch.testing.assert_close(g, w, msg=name, **EMU_TOL)


@pytest.mark.parametrize("given", ["both", "dys", "dc_last"])
@pytest.mark.parametrize("case", list(EMU_CASES))
def test_emulated_phases_match_the_plain_bptt(case, given):
    plan, _, a, gi, dys, dc_last = emulated(case, torch.float64)
    u, v, dvec, h0, c0 = a[5:]
    dys = dys if given != "dc_last" else None
    dc_last = dc_last if given != "dys" else None
    ys, cs, gates, hu = cuda_scan.lstm_recurrence_plain(gi, u, v, dvec, h0, c0)
    got = emulate_bptt(plan, u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dc_last)
    want = cuda_scan.lstm_bptt_plain(u, v, dvec, h0, c0, ys, cs, gates, hu, dys, None, dc_last)
    for name, g, w in zip(("dpre", "du", "dv", "ddvec", "dh0", "dc0"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            torch.testing.assert_close(g, w, msg=name, **EMU_TOL)


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_emulated_phases_match_the_jax_kernel_and_its_vjp(case):
    plan, arrs, a, gi, dys, dc_last = emulated(case, torch.float32)
    u, v, dvec, h0, c0 = a[5:]
    ys, cs, gates, hu = emulate_recurrence(plan, gi, u, v, dvec, h0, c0)

    def f(u_, v_, dvec_, h0_, c0_):
        j = list(map(lambda x: None if x is None else jnp.asarray(x), arrs))
        return jax_scan(*j[:5], u_, v_, dvec_, h0_, c0_, interpret=True)

    prim = [None if x is None else jnp.asarray(x) for x in arrs[5:]]
    (ys_j, c_j), vjp = jax.vjp(f, *prim)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), **FWD_TOL)
    np.testing.assert_allclose(cs[-1].numpy(), np.asarray(c_j), **FWD_TOL)

    dys32, dc32 = dys.float(), dc_last.float()
    _, du, dv, ddvec, dh0, dc0 = emulate_bptt(plan, u, v, dvec, h0, c0, ys, cs, gates, hu,
                                              dys32, dc32)
    g_j = vjp((jnp.asarray(dys32.numpy()), jnp.asarray(dc32.numpy())))
    for name, got, want in zip(("du", "dv", "ddvec", "dh0", "dc0"), (du, dv, ddvec, dh0, dc0), g_j):
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(got.shape),
                                       err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_emulated_phases_at_bf16_rounding_match_the_plain_bf16_walks(case):
    # the kernels round the exchanged h, hu, dpre and dhu where they write
    # them, and hold bf16 slices: the same roundings as the plain versions'
    plan, _, a, gi, dys, dc_last = emulated(case, torch.float32)
    u, v, dvec, h0, c0 = a[5:]
    got = emulate_recurrence(plan, gi, u, v, dvec, h0, c0, bf16=True)
    want = cuda_scan.lstm_recurrence_plain(gi, u, v, dvec, h0, c0, "bf16")
    for name, g, w in zip(("ys", "cs", "gates", "hu"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            torch.testing.assert_close(g, w, msg=name, **BF16_EMU_TOL)
    ys, cs, gates, hu = want
    got = emulate_bptt(plan, u, v, dvec, h0, c0, ys, cs, gates, hu, dys, dc_last, bf16=True)
    want = cuda_scan.lstm_bptt_plain(u, v, dvec, h0, c0, ys, cs, gates, hu, dys, None, dc_last,
                                     "bf16")
    for name, g, w in zip(("dpre", "du", "dv", "ddvec", "dh0", "dc0"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            torch.testing.assert_close(g, w, msg=name, **BF16_EMU_TOL)


def test_bwd_partial_floats_covers_each_split_k_product():
    """gemm_tc.cuh's plan: below 264 64x64 tiles, slices of whole 32-deep
    steps near 264 CTAs."""
    # the LM layer: dV [300, 2600] over 700 rows wants 2 slices, dU [650, 300] 5
    assert cuda_scan.bwd_partial_floats(35, 20, 650, 300, 650, 300) == max(
        2 * 300 * 2600, 5 * 650 * 300)
    # the same at B=128: dXU [4480, 300] over k = 2600 has 350 small tiles, no split
    assert cuda_scan.bwd_partial_floats(35, 128, 650, 300, 650, 300) == 2 * 300 * 2600
    # the HAR layer's dU [180, 6] has one tile and 1,944 rows: 61 slices of 32;
    # dXU [1944, 8] over k = 720, 31 tiles, the most: 8 slices of 96
    assert cuda_scan.bwd_partial_floats(24, 81, 77, 8, 180, 6) == 8 * 1944 * 8
    assert cuda_scan.bwd_partial_floats(24, 81, 77, 8, 180, 6, gi=True) == 21 * 6 * 720
    # the dense LM layer: dx [700, 650] = dPre Ux^T over k = 2600 wants 3 slices
    assert cuda_scan.bwd_partial_floats(35, 20, 650, 0, 650, 0) == 3 * 700 * 650
    # the dense h=1500 layer: dU and dUx [1500, 6000] fill a wave of large
    # tiles, dx [700, 1500] over k = 6000 has 264 small tiles: no split at B=20
    # or 128, recompute's pre-pass neither
    for b in (20, 128):
        assert cuda_scan.bwd_partial_floats(35, b, 1500, 0, 1500, 0, recompute=True) == 0
    # r = rx = 750 at h=1500: dXU [700, 750] over k = 6000 wants 2 slices
    assert cuda_scan.bwd_partial_floats(35, 20, 1500, 750, 1500, 750) == 2 * 700 * 750
    # products that a single tile pass covers want none
    assert cuda_scan.bwd_partial_floats(1, 1, 4, 0, 4, 0) == 0


def test_tile_partial_floats_keeps_the_stack_s_scratch():
    """The stack's weight gradients stay on gemm_tile.cuh (16-deep slices),
    so their scratch, and so their slices, are what they were."""
    assert cuda_scan.tile_partial_floats(35, 20, 650, 300, 650, 300) == 2 * 300 * 2600
    assert cuda_scan.tile_partial_floats(24, 81, 77, 8, 180, 6) == 9 * 1944 * 8
    assert cuda_scan.tile_partial_floats(35, 20, 650, 0, 650, 0, gi=True) == 0
