"""The port's GRU path (`cells.gru`, `ops.cuda_gru`, the GRU branch of
`scan_layer`, `BDNet`) against the JAX package's, on the same numpy inputs
and transplanted parameters.

The JAX side runs as its own tests run it on the CPU: `pallas_gru` in
Pallas interpret mode, and `scan_layer(..., backend="pallas")`, which
interprets off the TPU. On CPU tensors the port's `GRUScanXin` runs the plain
residual forward and the plain backward, so the scan tests hold the port's
own backward arithmetic to the TPU kernel's VJP. The CUDA kernels are held
to the plain versions in tests/test_torch_cuda.py, where a CUDA device exists.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from vmlmf_tpu.cells import GRUCell as JaxGRUCell  # noqa: E402
from vmlmf_tpu.cells import GRUGroupCell as JaxGRUGroupCell  # noqa: E402
from vmlmf_tpu.cells.group import _group_rec as jax_group_rec  # noqa: E402
from vmlmf_tpu.data.batching import batch_iterator as jax_batch_iterator  # noqa: E402
from vmlmf_tpu.nn.models import BDNet as JaxBDNet  # noqa: E402
from vmlmf_tpu.nn.models import HARNet as JaxHARNet  # noqa: E402
from vmlmf_tpu.nn.recurrence import scan_layer as jax_scan_layer  # noqa: E402
from vmlmf_tpu.ops import lowrank as jax_lowrank  # noqa: E402
from vmlmf_tpu.ops.pallas_gru import gru_scan_fused_xin as jax_gru_scan  # noqa: E402
from vmlmf_tpu.train.har import HARTrainer as JaxHARTrainer  # noqa: E402
from vmlmf_tpu_torch.cells import GRUCell, GRUGroupCell  # noqa: E402
from vmlmf_tpu_torch.cells.gru import _group_rec  # noqa: E402
from vmlmf_tpu_torch.data.batching import batch_iterator  # noqa: E402
from vmlmf_tpu_torch.nn.models import BDNet, HARNet  # noqa: E402
from vmlmf_tpu_torch.nn.recurrence import scan_layer  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_gru, lowrank  # noqa: E402
from vmlmf_tpu_torch.train.har import HARTrainer  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

FWD_TOL = dict(atol=2e-5, rtol=2e-5)    # tests/test_pallas.py, f32 forward
GRAD_TOL = dict(atol=3e-4, rtol=3e-4)   # tests/test_pallas.py, f32 gradients
STEP_TOL = dict(atol=1e-5, rtol=1e-5)   # tests/test_torch_train.py
HAR_PARAM_TOL = dict(atol=1e-4, rtol=1e-4)

# (T, B, F, h, rx, r): F = h, F < h, F > h; no T or B is a multiple of 4
CASES = {"f_eq_h": (5, 3, 12, 12, 4, 3), "f_lt_h": (6, 5, 9, 15, 3, 5),
         "f_gt_h": (7, 9, 20, 10, 5, 4)}
FORMS = {"lowrank_pre": ("pre", True), "dense_pre": ("pre", False),
         "dense_post": ("post", False)}

CELLS = {
    "lowrank": (lambda n, h: JaxGRUCell(n, h, w_rank=4, u_rank=3),
                lambda n, h: GRUCell(n, h, w_rank=4, u_rank=3)),
    "dense": (lambda n, h: JaxGRUCell(n, h), lambda n, h: GRUCell(n, h)),
    "group2": (lambda n, h: JaxGRUGroupCell(n, h, w_rank=4, u_ranks=(3, 2), groups=2),
               lambda n, h: GRUGroupCell(n, h, w_rank=4, u_ranks=(3, 2), groups=2)),
    "group3": (lambda n, h: JaxGRUGroupCell(n, h, u_ranks=(2, 3, 4), groups=3),
               lambda n, h: GRUGroupCell(n, h, u_ranks=(2, 3, 4), groups=3)),
}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def transplant(jparams):
    return params_from_jax(to_np(jparams), device="cpu")


def scan_inputs(t, b, f, h, rx, r, lowrank_rec, seed=0):
    """Seeded (xs, ux, vx, bias, uf, prz, pn, h0) as numpy; uf None when dense."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    k = r if lowrank_rec else h
    return (n(t, b, f, scale=1.0), n(f, rx), n(rx, 3 * h), n(3 * h),
            n(h, r) if lowrank_rec else None, n(k, 2 * h), n(k, h), n(b, h))


@pytest.fixture
def bwd_spy(monkeypatch):
    """Records the ``dx`` flag of each call of the plain backward."""
    calls = []
    plain = cuda_gru.gru_scan_xin_bwd_plain

    def spy(*args, **kw):
        calls.append(kw["dx"])
        return plain(*args, **kw)

    monkeypatch.setattr(cuda_gru, "gru_scan_xin_bwd_plain", spy)
    return calls


@pytest.mark.parametrize("kind", list(CELLS))
def test_cell_inp_and_step_match_jax(kind):
    jfac, fac = CELLS[kind]
    n, h, b = 7, 12, 5
    jcell, cell = jfac(n, h), fac(n, h)
    jparams = jcell.init(jax.random.PRNGKey(0))
    params = transplant(jparams)
    own = cell.init(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in to_np(jparams).items()}
    assert torch.equal(own["b"], torch.ones(3 * h))
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((3, b, n)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((b, h))).astype(np.float32)
    gi_j = jcell.inp(jcell.prepare(jparams), jnp.asarray(xs))
    gi = cell.inp(cell.prepare(params), torch.from_numpy(xs))
    np.testing.assert_allclose(gi.numpy(), np.asarray(gi_j), **FWD_TOL)
    s_j, y_j = jcell.step(jcell.prepare(jparams), gi_j[0], jnp.asarray(h0))
    s, y = cell.step(cell.prepare(params), gi[0], torch.from_numpy(h0))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **FWD_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD_TOL)
    assert tuple(cell.state0(b, "cpu").shape) == (b, h)


@pytest.mark.parametrize("g,ranks", [(2, (3, 2)), (3, (2, 3, 4))], ids=["g2", "g3"])
def test_dense_from_group_matches_jax_and_carries_gradients(g, ranks):
    h, k = 12, 12 // g
    rng = np.random.default_rng(2)
    us = [rng.standard_normal((g, k, r)).astype(np.float32) for r in ranks]
    vs = [rng.standard_normal((g, r, 3 * k)).astype(np.float32) for r in ranks]
    want = jax_lowrank.dense_from_group([jnp.asarray(u) for u in us],
                                        [jnp.asarray(v) for v in vs], 3, h)
    tu = [torch.from_numpy(u).requires_grad_() for u in us]
    tv = [torch.from_numpy(v).requires_grad_() for v in vs]
    w = lowrank.dense_from_group(tu, tv, 3, h)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(want), **FWD_TOL)
    # the dense matrix is the group product: h @ Wᵀ = Σ of the rotation tiers,
    # in values and in the gradients that reach every tier
    hb = torch.from_numpy(rng.standard_normal((4, h)).astype(np.float32))
    out = torch.from_numpy(rng.standard_normal((4, 3 * h)).astype(np.float32))
    g_dense = torch.autograd.grad(((hb @ w.T) * out).sum(), tu + tv)
    rec = _group_rec(hb, tu, tv, g, 3)
    g_group = torch.autograd.grad((rec * out).sum(), tu + tv)
    torch.testing.assert_close(hb @ w.T, rec, **FWD_TOL)
    np.testing.assert_allclose(rec.detach().numpy(), np.asarray(jax_group_rec(
        jnp.asarray(hb.numpy()), [jnp.asarray(u) for u in us], [jnp.asarray(v) for v in vs],
        g, 3)), **FWD_TOL)
    for a, b in zip(g_dense, g_group):
        assert float(a.abs().max()) > 0
        torch.testing.assert_close(a, b, **FWD_TOL)


def scan_loss(ys, w, np_):
    """Σ ys⊙w + Σ tanh(h_last) (tests/test_pallas.py)."""
    return np_.sum(ys * w) + np_.sum(np_.tanh(ys[-1]))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("form", list(FORMS))
def test_scan_forward_and_gradients_match_jax_vjp(form, case, bwd_spy):
    mode, lowrank_rec = FORMS[form]
    t, b, f, h, rx, r = CASES[case]
    arrs = scan_inputs(t, b, f, h, rx, r, lowrank_rec)
    w = np.random.default_rng(7).standard_normal((t, b, h)).astype(np.float32)
    which = [i for i, a in enumerate(arrs) if a is not None]

    def jloss(*a):
        full = list(arrs)
        for i, x in zip(which, a):
            full[i] = x
        return scan_loss(jax_gru_scan(*full, mode=mode, interpret=True), jnp.asarray(w), jnp)

    jin = [jnp.asarray(arrs[i]) for i in which]
    ys_j = jax_gru_scan(*[None if a is None else jnp.asarray(a) for a in arrs], mode=mode,
                        interpret=True)
    g_jax = jax.jit(jax.grad(jloss, argnums=tuple(range(len(which)))))(*jin)

    args = [None if a is None else torch.from_numpy(a).requires_grad_() for a in arrs]
    counts = (cuda_gru.gru_scan_fused_xin_res.launches, cuda_gru.gru_scan_xin_bwd.launches)
    ys = cuda_gru.GRUScanXin.apply(*args, mode)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j), **FWD_TOL)
    grads = torch.autograd.grad(scan_loss(ys, torch.from_numpy(w), torch),
                                [args[i] for i in which])
    assert counts == (cuda_gru.gru_scan_fused_xin_res.launches,
                      cuda_gru.gru_scan_xin_bwd.launches)  # CPU: no kernel
    assert bwd_spy == [True]  # the port's own backward, once
    for i, got, want in zip(which, grads, g_jax):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=cuda_gru._ARG_NAMES[i], **GRAD_TOL)


@pytest.mark.parametrize("form", list(FORMS))
def test_residuals_match_the_no_grad_forward_and_their_definitions(form):
    mode, lowrank_rec = FORMS[form]
    t, b, f, h, rx, r = CASES["f_lt_h"]
    args = [None if a is None else torch.from_numpy(a)
            for a in scan_inputs(t, b, f, h, rx, r, lowrank_rec)]
    xs, ux, vx, bias, uf, prz, pn, h0 = args
    ys, gates, hu, rhu, recn, xu = cuda_gru.gru_scan_xin_fwd_res_plain(*args, mode=mode)
    assert torch.equal(ys, cuda_gru.gru_scan_fused_xin_plain(*args, mode=mode))
    assert gates.shape == (t, b, 3 * h) and torch.equal(xu, xs @ ux)
    hprev = torch.cat([h0[None], ys[:-1]])
    rgate = gates[..., :h]
    if lowrank_rec:
        torch.testing.assert_close(hu, hprev @ uf, **FWD_TOL)
        torch.testing.assert_close(rhu, (rgate * hprev) @ uf, **FWD_TOL)
        assert recn is None
    else:
        assert hu is None and rhu is None
        assert (recn is None) == (mode == "pre")
        if mode == "post":
            torch.testing.assert_close(recn, hprev @ pn, **FWD_TOL)
    z, n = gates[..., h:2 * h], gates[..., 2 * h:]
    torch.testing.assert_close(ys, z * hprev + (1 - z) * n, **FWD_TOL)


def test_backward_skips_dx_for_an_input_without_gradient(bwd_spy):
    cell = GRUCell(6, 8, w_rank=2, u_rank=3)
    params = cell.init(torch.Generator().manual_seed(0), device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    xs = torch.randn(4, 2, 6, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ys, _ = scan_layer(cell, cell.prepare(params), xs, cell.state0(2, "cpu"))
    assert ys.grad_fn is None
    ys, h_last = scan_layer(cell, cell.prepare(params), xs, cell.state0(2, "cpu"))
    assert type(ys.grad_fn).__name__ == "GRUScanXinBackward"
    h_last.sum().backward()
    assert bwd_spy == [False]  # layer 1's raw input: no dx
    assert all(float(p.grad.abs().max()) > 0 for p in params.values())
    xs.requires_grad_(True)
    ys, _ = scan_layer(cell, cell.prepare(params), xs, cell.state0(2, "cpu"))
    (xs_grad,) = torch.autograd.grad(ys.sum(), xs)
    assert bwd_spy == [False, True] and float(xs_grad.abs().max()) > 0


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("kind", list(CELLS))
def test_scan_layer_fused_matches_loop_and_jax(kind, reverse):
    jfac, fac = CELLS[kind]
    n, h, t, b = 9, 12, 6, 3
    jcell, cell = jfac(n, h), fac(n, h)
    jparams = jcell.init(jax.random.PRNGKey(4))
    params = transplant(jparams)
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((t, b, n)).astype(np.float32)
    h0 = (0.4 * rng.standard_normal((b, h))).astype(np.float32)
    ys_j, hl_j = jax_scan_layer(jcell, jcell.prepare(jparams), jnp.asarray(xs),
                                jnp.asarray(h0), reverse=reverse, backend="pallas")
    out = {be: scan_layer(cell, cell.prepare(params), torch.from_numpy(xs), torch.from_numpy(h0),
                          reverse=reverse, backend=be) for be in ("fused", "loop")}
    for ys, hl in out.values():
        np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), **FWD_TOL)
        np.testing.assert_allclose(hl.numpy(), np.asarray(hl_j), **FWD_TOL)
    torch.testing.assert_close(out["fused"][1], out["fused"][0][0 if reverse else -1])


MODELS = [("HARNet", "lowrank", None), ("HARNet", "group2", None),
          ("BDNet", "lowrank", "concat"), ("BDNet", "group2", "sum"), ("BDNet", "dense", "avg")]


@pytest.mark.parametrize("model,kind,merge", MODELS, ids=[f"{m}-{k}" for m, k, _ in MODELS])
def test_models_apply_and_transplant_match_jax(model, kind, merge):
    jfac, fac = CELLS[kind]
    kw = dict(num_classes=5) if merge is None else dict(num_classes=5, merge=merge)
    jcls, cls = {"HARNet": (JaxHARNet, HARNet), "BDNet": (JaxBDNet, BDNet)}[model]
    jm = jcls(7, (12, 6), cell_factory=jfac, backend="pallas", **kw)
    jparams = jm.init(jax.random.PRNGKey(6))
    params = transplant(jparams)
    x = np.random.default_rng(8).standard_normal((5, 6, 7)).astype(np.float32)
    want = np.asarray(jm.apply(jparams, jnp.asarray(x)))
    for backend in ("fused", "loop"):
        m = cls(7, (12, 6), cell_factory=fac, backend=backend, **kw)
        with torch.no_grad():
            got = m.apply(params, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, err_msg=backend, **FWD_TOL)
    own = m.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), to_np(jparams))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), own) == shapes


def test_bdnet_rejects_an_unknown_merge():
    with pytest.raises(ValueError, match="merge"):
        BDNet(4, (6,), cell_factory=lambda n, h: GRUCell(n, h), merge="max")


@pytest.mark.parametrize("kind", ["lowrank", "group2"])
def test_har_train_steps_match_jax(kind):
    jfac, fac = CELLS[kind]
    n_feat, classes = 7, 5
    jm = JaxHARNet(n_feat, (12, 6), num_classes=classes, cell_factory=jfac, backend="pallas")
    m = HARNet(n_feat, (12, 6), num_classes=classes, cell_factory=fac)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((27, 6, n_feat)).astype(np.float32)
    y = rng.integers(0, classes, 27).astype(np.int32)
    jt = JaxHARTrainer(jm, batch_size=9, fuse_batches=1)
    t = HARTrainer(m, batch_size=9, device="cpu")
    jparams, jopt = jt.init()
    params = transplant(jparams)
    opt = t.optimizer(params)
    steps = zip(jax_batch_iterator(x, y, 9, shuffle=True, drop_last=True, seed=3),
                batch_iterator(x, y, 9, shuffle=True, drop_last=True, seed=3))
    n = 0
    for (jx, jy), (bx, by) in steps:
        jparams, jopt, jloss = jt._train_step(jparams, jopt, jx, jy)
        params, opt, loss = t.train_step(params, opt, bx, by)
        np.testing.assert_allclose(float(loss), float(jloss), **STEP_TOL)
        n += 1
    assert n == 3
    want = jax.tree_util.tree_leaves_with_path(to_np(jparams))
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda p: p.detach().numpy(), params))}
    assert len(got) == len(want)
    for k, w in want:
        np.testing.assert_allclose(got[jax.tree_util.keystr(k)], w,
                                   err_msg=jax.tree_util.keystr(k), **HAR_PARAM_TOL)


def meta_args(vx=True, **over):
    t, b, f, h, rx, r = CASES["f_lt_h"]
    shapes = dict(xs=(t, b, f), ux=(f, rx), vx=(rx, 3 * h), bias=(3 * h,), uf=(h, r),
                  prz=(r, 2 * h), pn=(r, h), h0=(b, h))
    args = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    if not vx:
        args["ux"], args["vx"] = torch.empty(f, 3 * h, device="meta"), None
    args.update(over)
    return [args[k] for k in cuda_gru._ARG_NAMES]


@pytest.mark.parametrize("why", ["dense_x", "gi_mode", "recompute", "f64", "strided"])
def test_wrappers_raise_on_forms_the_kernels_do_not_take(why, monkeypatch):
    # off the CPU a wrapper validates its call before it launches anything;
    # meta tensors reach that check on a machine without a card
    t, b, f, h, rx, r = CASES["f_lt_h"]
    # the forms that the kernels take pass validation and stop only at the
    # device check (meta is neither CPU nor CUDA): the dense x side, gi mode
    # and the recompute policy
    args, err, match = meta_args(), ValueError, "runs on CPU or CUDA"
    if why == "dense_x":
        args = meta_args(vx=False)
    elif why == "gi_mode":
        monkeypatch.setenv("VMLMF_PALLAS_XIN", "0")
        gi = torch.empty(t, b, 3 * h, device="meta")
        rec = args[4:]
        for fn in (cuda_gru.gru_scan_fused, cuda_gru.gru_scan_fused_res):
            with pytest.raises(err, match=match):
                fn(gi, *rec, mode="pre")
        res = [torch.empty(s, device="meta") for s in ((t, b, h), (t, b, 3 * h), (t, b, r),
                                                       (t, b, r))]
        with pytest.raises(err, match=match):
            cuda_gru.gru_scan_bwd(*rec, *res, None, torch.empty(t, b, h, device="meta"),
                                  mode="pre")
    elif why == "recompute":
        monkeypatch.setenv("VMLMF_PALLAS_SAVED_GATES", "0")
        ys, dys = (torch.empty(t, b, h, device="meta") for _ in range(2))
        with pytest.raises(err, match=match):
            cuda_gru.gru_scan_xin_bwd(*args[:3], *args[4:], ys, *[None] * 5, dys, mode="pre",
                                      bias=args[3])
    elif why == "f64":
        args = meta_args(h0=torch.empty(b, h, device="meta", dtype=torch.float64))
        err, match = TypeError, "float32"
    else:
        args = meta_args(xs=torch.empty(t, f, b, device="meta").transpose(1, 2))
        err, match = ValueError, "contiguous"
    for fn in (cuda_gru.gru_scan_fused_xin, cuda_gru.gru_scan_fused_xin_res):
        with pytest.raises(err, match=match):
            fn(*args, mode="pre")
    res = [torch.empty(s, device="meta") for s in ((t, b, h), (t, b, 3 * h), (t, b, r),
                                                   (t, b, r))]
    xu = None if args[2] is None else torch.empty(t, b, rx, device="meta")
    saved = (*args[:3], *args[4:], *res, None, xu, torch.empty(t, b, h, device="meta"))
    with pytest.raises(err, match=match):
        cuda_gru.gru_scan_xin_bwd(*saved, mode="pre")


def test_wrappers_raise_on_a_bad_mode_everywhere():
    arrs = [None if a is None else torch.from_numpy(a)
            for a in scan_inputs(*CASES["f_eq_h"], True)]
    with pytest.raises(ValueError, match="dense-only"):
        cuda_gru.gru_scan_fused_xin(*arrs, mode="post")
    with pytest.raises(ValueError, match="dense-only"):
        cuda_gru.gru_scan_fused_xin(*meta_args(), mode="post")
    with pytest.raises(ValueError, match="'pre' or 'post'"):
        cuda_gru.GRUScanXin.apply(*arrs, "mid")
    with pytest.raises(ValueError, match="runs on CPU or CUDA"):
        cuda_gru.gru_scan_fused_xin(*meta_args(), mode="pre")


@pytest.mark.parametrize("case", list(CASES))
def test_dense_gru_weights_give_the_post_scan_and_not_the_pre_scan(case):
    # torch.gru applies the reset gate after the recurrent product: on the
    # materialised weights it computes mode "post" (the library yardstick
    # that chip_smoke.py times), and not mode "pre"
    t, b, f, h, rx, r = CASES[case]
    for form, (mode, lowrank_rec) in FORMS.items():
        args = [None if a is None else torch.from_numpy(a)
                for a in scan_inputs(t, b, f, h, rx, r, lowrank_rec)]
        ys = cuda_gru.gru_scan_fused_xin_plain(*args, mode=mode)
        out, h_n = torch.gru(args[0], args[7][None], chip_smoke.dense_gru_weights(*args[1:7]),
                             True, 1, 0.0, False, False, False)
        if mode == "post":
            torch.testing.assert_close(out, ys, **FWD_TOL)
            torch.testing.assert_close(h_n[0], ys[-1], **FWD_TOL)
        else:
            assert float((out - ys).abs().max()) > 1e-2, form


def test_costs_count_the_main_layer():
    # the main HAR GRU layer 1: T=24, B=81, F=77, h=64, rx=r=9, low-rank pre:
    # 1,944 rows x 5,301 multiply-adds x 2, and about 1.1 MB of x and ys
    ops, nbytes = cuda_gru.gru_scan_cost(24, 81, 77, 9, 64, 9, cuda_gru.LOWRANK_PRE)
    assert 2 * 1944 * 5301 < ops < 1.1 * 2 * 1944 * 5301
    assert 4 * 1944 * (77 + 64) < nbytes < 1.05 * 4 * 1944 * (77 + 64)
    for form, extra, rec in ((cuda_gru.LOWRANK_PRE, 2 * 9, 5 * 64 * 9),
                             (cuda_gru.DENSE_PRE, 0, 3 * 64 * 64),
                             (cuda_gru.DENSE_POST, 64, 3 * 64 * 64)):
        fwd = cuda_gru.gru_scan_cost(24, 81, 77, 9, 64, 9, form)
        res = cuda_gru.gru_scan_res_cost(24, 81, 77, 9, 64, 9, form)
        assert res[0] == fwd[0] and res[1] == fwd[1] + 4 * 1944 * (3 * 64 + 9 + extra)
        bwd, bwd_nodx = (cuda_gru.gru_scan_bwd_cost(24, 81, 77, 9, 64, 9, form, dx=d)
                         for d in (True, False))
        # without dx: the recurrent side twice, dXU and dVx (rx·3h each), dUx (F·rx)
        assert bwd_nodx[0] == 1944 * (2 * (2 * rec + 2 * 9 * 3 * 64 + 77 * 9) + 20 * 64)
        assert bwd[0] - bwd_nodx[0] == 2 * 1944 * 77 * 9  # dx = dXU Uxᵀ
        assert bwd[1] - bwd_nodx[1] == 4 * (1944 * 77 + 77 * 9)  # dx written, ux read
        # with dx the backward's products are twice the forward's; the rest is
        # elementwise (20 per hidden unit backward, 2·3 + 8 forward)
        assert bwd[0] - 1944 * 20 * 64 == 2 * (fwd[0] - 1944 * (2 * 3 + 8) * 64)
