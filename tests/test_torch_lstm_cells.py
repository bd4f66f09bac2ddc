"""The port's LSTM-family cells (`cells.lstm`, `cells.legacy`, `cells.group`)
and the dense forms of its fused scans (`ops.cuda_scan`, and the dense x
side of `ops.cuda_gru`) against the JAX package's, on the same numpy inputs
and transplanted parameters.

The cells run through the port's `scan_layer(..., backend="fused")`, which
on CPU tensors runs the plain versions of the kernels and, under autograd,
`LSTMScanXin`'s plain forward and backward; the JAX side is its XLA scan,
as `tests/test_pallas.py` holds its Pallas scan to it. The dense forms'
plain versions are held to the JAX kernels in Pallas interpret mode. The
CUDA kernels are held to the plain versions in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu import cells as jcells  # noqa: E402
from vmlmf_tpu.nn.recurrence import scan_layer as jax_scan_layer  # noqa: E402
from vmlmf_tpu.ops import lowrank as jax_lowrank  # noqa: E402
from vmlmf_tpu.ops.pallas_gru import gru_scan_fused_xin as jax_gru_scan  # noqa: E402
from vmlmf_tpu.ops.pallas_scan import lstm_scan_fused_xin as jax_lstm_scan  # noqa: E402
from vmlmf_tpu_torch import cells  # noqa: E402
from vmlmf_tpu_torch.nn import recurrence  # noqa: E402
from vmlmf_tpu_torch.nn.recurrence import scan_layer  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_gru, cuda_scan, lowrank  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

FWD_TOL = dict(atol=2e-5, rtol=2e-5)    # tests/test_pallas.py, f32 forward
GRAD_TOL = dict(atol=3e-4, rtol=3e-4)   # tests/test_pallas.py, f32 gradients

# the cases of tests/test_pallas.py:27-39: (name, cell class, args, kwargs, T, B)
CASES = [
    ("vmlmf", "VMLMFCell", (77, 180), dict(w_rank=8, u_rank=6), 24, 9),
    ("vmlmf_sq", "VMLMFCell", (64, 64), dict(w_rank=16, u_rank=16), 7, 4),
    ("lstm_dense", "LSTMCell", (16, 40), {}, 5, 3),
    ("lstm_lowrank", "LSTMCell", (16, 40), dict(w_rank=8, u_rank=8), 5, 3),
    ("dualdiag", "DualDiagonalLSTMCell", (16, 40), dict(w_rank=8, u_rank=8), 5, 3),
    ("vmlmf_group", "VMLMFGroupCell", (9, 32), dict(w_rank=4, u_ranks=(2, 3), groups=2), 6, 3),
    ("vmlmf_group_novm", "VMLMFGroupCell", (9, 32),
     dict(w_rank=4, u_ranks=(2, 2), groups=2, use_vm=False), 5, 3),
    ("lstm_group", "LSTMGroupCell", (9, 30), dict(u_ranks=(2, 2, 2), groups=3), 5, 3),
]


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_pair(cls, args, kw):
    return getattr(jcells, cls)(*args, **kw), getattr(cells, cls)(*args, **kw)


def setup(jcell, t, b, seed=0):
    """JAX params, their transplant, and numpy xs, h0, c0."""
    jparams = jcell.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    xs = rng.standard_normal((t, b, jcell.input_size)).astype(np.float32)
    h0, c0 = (0.3 * rng.standard_normal((2, b, jcell.hidden_size))).astype(np.float32)
    return jparams, params_from_jax(to_np(jparams), device="cpu"), xs, h0, c0


@pytest.mark.parametrize("name,cls,args,kw,t,b", CASES, ids=[c[0] for c in CASES])
def test_init_matches_the_jax_tree(name, cls, args, kw, t, b):
    jcell, cell = make_pair(cls, args, kw)
    jparams = to_np(jcell.init(jax.random.PRNGKey(0)))
    own = cell.init(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in jparams.items()}
    for key, v in jparams.items():  # the biases that start at one
        if (v == 1).all():
            assert torch.equal(own[key], torch.ones_like(own[key])), key


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("name,cls,args,kw,t,b", CASES, ids=[c[0] for c in CASES])
def test_fused_scan_layer_matches_jax(name, cls, args, kw, t, b, reverse):
    jcell, cell = make_pair(cls, args, kw)
    jparams, params, xs, h0, c0 = setup(jcell, t, b)
    ys_j, (h_j, c_j) = jax_scan_layer(jcell, jcell.prepare(jparams), jnp.asarray(xs),
                                      (jnp.asarray(h0), jnp.asarray(c0)), reverse=reverse,
                                      backend="xla")
    ys, (h, c) = scan_layer(cell, cell.prepare(params), torch.from_numpy(xs),
                            (torch.from_numpy(h0), torch.from_numpy(c0)), reverse=reverse)
    for got, want in ((ys, ys_j), (h, h_j), (c, c_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("name,cls,args,kw,t,b", CASES, ids=[c[0] for c in CASES])
def test_fused_scan_layer_gradients_match_jax(name, cls, args, kw, t, b, monkeypatch):
    jcell, cell = make_pair(cls, args, kw)
    jparams, params, xs, h0, c0 = setup(jcell, t, b)
    w = np.random.default_rng(3).standard_normal((t, b, jcell.hidden_size)).astype(np.float32)

    def jloss(p, x, s0):
        ys, (h, c) = jax_scan_layer(jcell, jcell.prepare(p), x, s0, backend="xla")
        # ys, final h and final c, so that every cotangent path is live
        return jnp.sum(ys * w) + jnp.sum(jnp.tanh(h)) + 0.5 * jnp.sum(c * c)

    g_params, g_x, (g_h, g_c) = jax.grad(jloss, argnums=(0, 1, 2))(
        jparams, jnp.asarray(xs), (jnp.asarray(h0), jnp.asarray(c0)))
    calls = []
    plain = cuda_scan.lstm_scan_xin_bwd_plain
    monkeypatch.setattr(cuda_scan, "lstm_scan_xin_bwd_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    x, h0t, c0t = (torch.from_numpy(a).requires_grad_() for a in (xs, h0, c0))
    ys, (h, c) = scan_layer(cell, cell.prepare(leaves), x, (h0t, c0t))
    loss = (ys * torch.from_numpy(w)).sum() + torch.tanh(h).sum() + 0.5 * (c * c).sum()
    grads = torch.autograd.grad(loss, [*leaves.values(), x, h0t, c0t])
    assert calls == [1]  # the port's own backward, once
    for key, got in zip(leaves, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(g_params[key]), err_msg=key,
                                   **GRAD_TOL)
    for got, want in zip(grads[-3:], (g_x, g_h, g_c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


# the LSTM scan's dense forms: (T, B, F, h, rx, r), rx = 0 for a dense x
# side, r = 0 for a dense recurrent side
DENSE_FORMS = {"dense_rec": (6, 5, 9, 20, 3, 0), "dense_x": (7, 9, 24, 12, 0, 3),
               "dense": (5, 3, 16, 16, 0, 0), "dense_f_gt_h": (5, 3, 24, 12, 0, 0)}


def lstm_inputs(t, b, f, h, rx, r, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return (n(t, b, f, scale=1.0), n(f, rx or 4 * h), n(rx, 4 * h) if rx else None, n(4, h),
            n(4 * h), n(h, r or 4 * h), n(r, 4 * h) if r else None, n(4 * h), n(b, h), n(b, h))


@pytest.mark.parametrize("form", list(DENSE_FORMS))
def test_dense_form_plain_versions_match_the_jax_kernel(form):
    t, b, f, h, rx, r = DENSE_FORMS[form]
    arrs = lstm_inputs(t, b, f, h, rx, r)
    which = [i for i, a in enumerate(arrs) if a is not None]
    w = np.random.default_rng(7).standard_normal((t, b, h)).astype(np.float32)

    def jloss(*a):
        full = list(arrs)
        for i, x in zip(which, a):
            full[i] = x
        ys, c_last = jax_lstm_scan(*full, interpret=True)
        return jnp.sum(ys * w) + jnp.sum(jnp.tanh(ys[-1])) + 0.5 * jnp.sum(c_last * c_last)

    jin = [jnp.asarray(arrs[i]) for i in which]
    ys_j, c_j = jax_lstm_scan(*[None if a is None else jnp.asarray(a) for a in arrs],
                              interpret=True)
    g_jax = jax.jit(jax.grad(jloss, argnums=tuple(range(len(which)))))(*jin)

    args = [None if a is None else torch.from_numpy(a).requires_grad_() for a in arrs]
    with torch.no_grad():
        ys0, c0 = cuda_scan.lstm_scan_fused_xin(*args)
    ys, c_last = cuda_scan.LSTMScanXin.apply(*args)
    assert torch.equal(ys0, ys) and torch.equal(c0, c_last)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j), **FWD_TOL)
    np.testing.assert_allclose(c_last.detach().numpy(), np.asarray(c_j), **FWD_TOL)
    wt = torch.from_numpy(w)
    loss = (ys * wt).sum() + torch.tanh(ys[-1]).sum() + 0.5 * (c_last * c_last).sum()
    grads = torch.autograd.grad(loss, [args[i] for i in which])
    for i, got, want in zip(which, grads, g_jax):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=cuda_scan._ARG_NAMES[i], **GRAD_TOL)
    res = cuda_scan.lstm_scan_fused_xin_res(*[None if a is None else a.detach() for a in args])
    assert (res[3] is None) == (r == 0) and (res[4] is None) == (rx == 0)


@pytest.mark.parametrize("form", ["lowrank_pre", "dense_pre", "dense_post"])
def test_gru_dense_x_side_matches_the_jax_kernel(form):
    mode, lowrank_rec = {"lowrank_pre": ("pre", True), "dense_pre": ("pre", False),
                         "dense_post": ("post", False)}[form]
    t, b, f, h, r = 6, 5, 9, 15, 5
    rng = np.random.default_rng(2)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    k = r if lowrank_rec else h
    arrs = (n(t, b, f, scale=1.0), n(f, 3 * h), None, n(3 * h), n(h, r) if lowrank_rec else None,
            n(k, 2 * h), n(k, h), n(b, h))
    which = [i for i, a in enumerate(arrs) if a is not None]
    w = n(t, b, h, scale=1.0)

    def jloss(*a):
        full = list(arrs)
        for i, x in zip(which, a):
            full[i] = x
        return jnp.sum(jax_gru_scan(*full, mode=mode, interpret=True) * w)

    ys_j = jax_gru_scan(*[None if a is None else jnp.asarray(a) for a in arrs], mode=mode,
                        interpret=True)
    g_jax = jax.jit(jax.grad(jloss, argnums=tuple(range(len(which)))))(
        *[jnp.asarray(arrs[i]) for i in which])
    args = [None if a is None else torch.from_numpy(a).requires_grad_() for a in arrs]
    ys = cuda_gru.GRUScanXin.apply(*args, mode)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j), **FWD_TOL)
    grads = torch.autograd.grad((ys * torch.from_numpy(w)).sum(), [args[i] for i in which])
    for i, got, want in zip(which, grads, g_jax):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=cuda_gru._ARG_NAMES[i], **GRAD_TOL)


UNFUSED = [("diag", "DiagonalLSTMCell", (9, 32), {}),
           ("shuffle", "LSTMGroupCell", (9, 30), dict(u_ranks=(2, 2, 2), groups=3, shuffle=True))]


@pytest.mark.parametrize("name,cls,args,kw", UNFUSED, ids=[u[0] for u in UNFUSED])
def test_cells_without_a_fused_form_run_the_loop_under_fused(name, cls, args, kw, monkeypatch):
    jcell, cell = make_pair(cls, args, kw)
    jparams, params, xs, h0, c0 = setup(jcell, 5, 3)
    calls = []

    def spy(*a, **k):
        calls.append(1)
        raise AssertionError("a cell without a fused form reached a fused scan")

    for fn in ("lstm_scan_fused_xin", "gru_scan_fused_xin"):
        monkeypatch.setattr(recurrence, fn, spy)
    monkeypatch.setattr(recurrence.LSTMScanXin, "apply", spy)
    prep = cell.prepare(params)
    s0 = (torch.from_numpy(h0), torch.from_numpy(c0))
    out = {be: scan_layer(cell, prep, torch.from_numpy(xs), s0, backend=be)
           for be in ("fused", "loop")}
    assert calls == []
    x = torch.from_numpy(xs).requires_grad_()
    ys, _ = scan_layer(cell, prep, x, s0)  # grad mode, an input that needs a gradient
    assert calls == [] and ys.requires_grad
    (ys_f, (h_f, c_f)), (ys_l, (h_l, c_l)) = out["fused"], out["loop"]
    for got, want in ((ys_f, ys_l), (h_f, h_l), (c_f, c_l)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    ys_j, _ = jax_scan_layer(jcell, jcell.prepare(jparams), jnp.asarray(xs),
                             (jnp.asarray(h0), jnp.asarray(c0)), backend="pallas")
    np.testing.assert_allclose(ys_f.numpy(), np.asarray(ys_j), **FWD_TOL)


def test_lowrank_helpers_match_jax():
    rng = np.random.default_rng(4)
    u, v, d = (rng.standard_normal(s).astype(np.float32) for s in ((9, 3), (4 * 12, 3), (9,)))
    for kw in (dict(), dict(subtract_diag=False), dict(d=d)):
        jkw = {k: jnp.asarray(x) if k == "d" else x for k, x in kw.items()}
        tkw = {k: torch.from_numpy(x) if k == "d" else x for k, x in kw.items()}
        want = jax_lowrank.dense_from_lowrank(jnp.asarray(u), jnp.asarray(v), 4, 12, **jkw)
        got = lowrank.dense_from_lowrank(torch.from_numpy(u), torch.from_numpy(v), 4, 12, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    u0 = rng.standard_normal((3, 4, 2)).astype(np.float32)
    v0 = rng.standard_normal((3, 2, 4 * 4)).astype(np.float32)
    np.testing.assert_allclose(
        lowrank.group_diag_rowsum(torch.from_numpy(u0), torch.from_numpy(v0), 4).numpy(),
        np.asarray(jax_lowrank.group_diag_rowsum(jnp.asarray(u0), jnp.asarray(v0), 4)),
        **FWD_TOL)


def test_vmlmf_cell_is_the_dense_lstm_of_its_dense_from_lowrank():
    # dense_from_lowrank with the corrections is the matrix a VMLMF cell is
    cell = cells.VMLMFCell(7, 12, w_rank=3, u_rank=4)
    p = cell.init(torch.Generator().manual_seed(0), device="cpu")
    prep = cell.prepare(p)
    xs = torch.randn(2, 5, 7, generator=torch.Generator().manual_seed(1))
    w_x = lowrank.dense_from_lowrank(p["u_x"], p["v_x"], 4, 12, d=p["d_x"])
    torch.testing.assert_close(cell.inp(prep, xs), xs @ w_x.T + p["b_x"] + p["b_h"], **FWD_TOL)


def meta_lstm_args(dtype=torch.float32):
    t, b, f, h = 3, 2, 5, 4
    shapes = dict(xs=(t, b, f), ux=(f, 4 * h), vx=None, xdvec=(4, h), bias=(4 * h,),
                  u=(h, 4 * h), v=None, dvec=(4 * h,), h0=(b, h), c0=(b, h))
    return [None if s is None else torch.empty(s, device="meta", dtype=dtype if k == "u"
                                               else torch.float32)
            for k, s in shapes.items()]


def test_lstm_wrappers_validate_dense_forms_off_the_cpu():
    # off the CPU a wrapper validates its call before it launches anything;
    # meta tensors reach that check on a machine without a card
    for fn in (cuda_scan.lstm_scan_fused_xin, cuda_scan.lstm_scan_fused_xin_res):
        with pytest.raises(ValueError, match="runs on CPU or CUDA"):
            fn(*meta_lstm_args())  # the dense forms pass validation
        with pytest.raises(TypeError, match="float32"):
            fn(*meta_lstm_args(torch.bfloat16))
    args = meta_lstm_args()
    args[1] = torch.empty(5, 3, device="meta")  # a dense Ux must be [F, 4h]
    with pytest.raises(ValueError, match="shape"):
        cuda_scan.lstm_scan_fused_xin(*args)


def test_costs_count_the_dense_forms():
    t, b, f, h = 35, 20, 650, 650
    ops, nbytes = cuda_scan.scan_cost(t, b, f, 0, h, 0)
    # x @ Ux and h @ U, 650 x 2600 each, per row and step
    assert ops == t * b * (2 * 2 * 650 * 2600 + 6 * 2600 + 9 * 650)
    assert nbytes == 4 * (t * b * f + 2 * 650 * 2600 + 3 * 2600 + 2 * b * h + t * b * h + b * h)
    assert cuda_scan.scan_res_cost(t, b, f, 0, h, 0)[1] - nbytes == 4 * (t * b * 5 * h - b * h)
    bwd_ops, _ = cuda_scan.scan_bwd_cost(t, b, f, 0, h, 0)
    assert bwd_ops == t * b * (2 * 4 * 650 * 2600 + 30 * 650)
    lowrank_ops = cuda_scan.scan_bwd_cost(t, b, f, 300, h, 300)[0]
    assert lowrank_ops == t * b * (2 * (2 * 4 * h * 300 + 2 * h * 300 + 2 * 4 * h * 300
                                        + 2 * f * 300) + 30 * h)
    g_ops, g_bytes = cuda_gru.gru_scan_cost(24, 81, 77, 0, 64, 9, cuda_gru.LOWRANK_PRE)
    assert g_ops == 24 * 81 * (2 * (77 * 192 + 5 * 64 * 9) + 2 * 3 * 64 + 8 * 64)
    assert cuda_gru.gru_scan_res_cost(24, 81, 77, 0, 64, 9, cuda_gru.LOWRANK_PRE)[1] == \
        g_bytes + 4 * 24 * 81 * (3 * 64 + 2 * 9)
