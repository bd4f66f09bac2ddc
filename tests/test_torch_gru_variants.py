"""The GRU scan's variants in the port (`ops.cuda_gru`, the GRU branch of
`scan_layer`, `HARNet`, `BDNet`, `HARTrainer`) against the JAX package's,
on the same numpy inputs and transplanted parameters, under the same
switches: gi mode (``VMLMF_PALLAS_XIN=0``, `pallas_gru.gru_scan_fused`) and
the recompute policy (``VMLMF_PALLAS_SAVED_GATES=0``, x mode).

Each test sets the switch with monkeypatch on both sides; the JAX package
runs `pallas_gru` in Pallas interpret mode, as tests/test_pallas.py does,
and the port its plain versions on the CPU, which the CUDA kernels are held
to in tests/test_torch_cuda.py. Tolerances (atol = rtol) are those of
tests/test_torch_gru.py: 2e-5 on outputs and 3e-4 on gradients; the port
computes what the JAX kernels compute, so only the order of f32 sums
separates the two.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu.data.batching import batch_iterator as jax_batch_iterator  # noqa: E402
from vmlmf_tpu.nn.models import BDNet as JaxBDNet  # noqa: E402
from vmlmf_tpu.nn.models import HARNet as JaxHARNet  # noqa: E402
from vmlmf_tpu.nn.recurrence import scan_layer as jax_scan_layer  # noqa: E402
from vmlmf_tpu.ops.pallas_gru import gru_scan_fused as jax_gru_scan_gi  # noqa: E402
from vmlmf_tpu.ops.pallas_gru import gru_scan_fused_xin as jax_gru_scan  # noqa: E402
from vmlmf_tpu.train.har import HARTrainer as JaxHARTrainer  # noqa: E402
from vmlmf_tpu_torch.data.batching import batch_iterator  # noqa: E402
from vmlmf_tpu_torch.nn.models import BDNet, HARNet  # noqa: E402
from vmlmf_tpu_torch.nn.recurrence import scan_layer  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_gru  # noqa: E402
from vmlmf_tpu_torch.train.har import HARTrainer  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

from test_torch_gru import CASES, CELLS, FORMS, scan_inputs, scan_loss  # noqa: E402

FWD_TOL = dict(atol=2e-5, rtol=2e-5)    # tests/test_pallas.py, f32 forward
GRAD_TOL = dict(atol=3e-4, rtol=3e-4)   # tests/test_pallas.py, f32 gradients
STEP_TOL = dict(atol=1e-5, rtol=1e-5)   # tests/test_torch_train.py
HAR_PARAM_TOL = dict(atol=1e-4, rtol=1e-4)
SWITCHES = {"gi_mode": "VMLMF_PALLAS_XIN", "recompute": "VMLMF_PALLAS_SAVED_GATES"}


@pytest.fixture
def switch(monkeypatch):
    """Sets one of the JAX package's GRU switches to 0 (both sides read it)."""
    for k in (*SWITCHES.values(), "VMLMF_PALLAS_PRECISION", "VMLMF_PALLAS_RESIDUALS"):
        monkeypatch.delenv(k, raising=False)

    def set_(name):
        if name is not None:
            monkeypatch.setenv(SWITCHES[name], "0")

    return set_


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def transplant(jparams):
    return params_from_jax(to_np(jparams), device="cpu")


def gi_inputs(t, b, h, r, lowrank_rec, seed=0):
    """Seeded (gi, uf, prz, pn, h0) as numpy; uf None when dense."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    k = r if lowrank_rec else h
    return (n(t, b, 3 * h, scale=1.0), n(h, r) if lowrank_rec else None, n(k, 2 * h),
            n(k, h), n(b, h))


# -- the scan entries ------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("form", list(FORMS))
def test_gi_mode_scan_and_gradients_match_jax_vjp(form, case):
    mode, lowrank_rec = FORMS[form]
    t, b, _, h, _, r = CASES[case]
    arrs = gi_inputs(t, b, h, r, lowrank_rec)
    w = np.random.default_rng(7).standard_normal((t, b, h)).astype(np.float32)
    which = [i for i, a in enumerate(arrs) if a is not None]

    def jloss(*a):
        full = list(arrs)
        for i, x in zip(which, a):
            full[i] = x
        return scan_loss(jax_gru_scan_gi(*full, mode=mode, interpret=True), jnp.asarray(w), jnp)

    ys_j = jax_gru_scan_gi(*[None if a is None else jnp.asarray(a) for a in arrs], mode=mode,
                           interpret=True)
    g_jax = jax.grad(jloss, argnums=tuple(range(len(which))))(
        *[jnp.asarray(arrs[i]) for i in which])

    args = [None if a is None else torch.from_numpy(a).requires_grad_() for a in arrs]
    ys = cuda_gru.GRUScan.apply(*args, mode)
    assert type(ys.grad_fn).__name__ == "GRUScanBackward"
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j), **FWD_TOL)
    with torch.no_grad():
        torch.testing.assert_close(cuda_gru.gru_scan_fused(*args, mode=mode), ys, **FWD_TOL)
    grads = torch.autograd.grad(scan_loss(ys, torch.from_numpy(w), torch),
                                [args[i] for i in which])
    names = ("gi", "uf", "prz", "pn", "h0")
    for i, got, want in zip(which, grads, g_jax):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=names[i], **GRAD_TOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("x_side", ["lowrank_x", "dense_x"])
def test_recompute_scan_and_gradients_match_jax_vjp(x_side, form, case, switch, monkeypatch):
    switch("recompute")
    mode, lowrank_rec = FORMS[form]
    t, b, f, h, rx, r = CASES[case]
    arrs = list(scan_inputs(t, b, f, h, rx, r, lowrank_rec))
    if x_side == "dense_x":
        arrs[1] = (0.3 * np.random.default_rng(3).standard_normal((f, 3 * h))).astype(np.float32)
        arrs[2] = None
    w = np.random.default_rng(7).standard_normal((t, b, h)).astype(np.float32)
    which = [i for i, a in enumerate(arrs) if a is not None]

    def jloss(*a):
        full = list(arrs)
        for i, x in zip(which, a):
            full[i] = x
        return scan_loss(jax_gru_scan(*full, mode=mode, interpret=True), jnp.asarray(w), jnp)

    g_jax = jax.grad(jloss, argnums=tuple(range(len(which))))(
        *[jnp.asarray(arrs[i]) for i in which])

    calls = []
    plain = cuda_gru.gru_scan_xin_bwd_plain
    monkeypatch.setattr(cuda_gru, "gru_scan_xin_bwd_plain",
                        lambda *a, **kw: calls.append(a[8]) or plain(*a, **kw))
    args = [None if a is None else torch.from_numpy(a).requires_grad_() for a in arrs]
    ys = cuda_gru.GRUScanXin.apply(*args, mode)
    grads = torch.autograd.grad(scan_loss(ys, torch.from_numpy(w), torch),
                                [args[i] for i in which])
    assert calls == [None]  # the recompute policy: no gates reached the backward
    for i, got, want in zip(which, grads, g_jax):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=cuda_gru._ARG_NAMES[i], **GRAD_TOL)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("x_side", ["lowrank_x", "dense_x"])
def test_recompute_pre_pass_rebuilds_the_saved_residuals(x_side, form):
    mode, lowrank_rec = FORMS[form]
    t, b, f, h, rx, r = CASES["f_gt_h"]
    args = [None if a is None else torch.from_numpy(a)
            for a in scan_inputs(t, b, f, h, rx, r, lowrank_rec, seed=2)]
    if x_side == "dense_x":
        args[1], args[2] = torch.randn(f, 3 * h, generator=torch.Generator().manual_seed(3)), None
    saved = cuda_gru.gru_scan_xin_fwd_res_plain(*args, mode=mode)
    rc = cuda_gru.gru_scan_xin_fwd_res_plain(*args, mode=mode, save_gates=False)
    assert torch.equal(rc[0], saved[0]) and all(a is None for a in rc[1:])
    rebuilt = cuda_gru.gru_recompute_plain(*args, saved[0], mode=mode)
    for name, got, want in zip(("gates", "hu", "rhu", "recn", "xu"), rebuilt, saved[1:]):
        assert (got is None) == (want is None), name
        if got is not None:
            torch.testing.assert_close(got, want, **FWD_TOL, msg=name)


def test_gi_mode_takes_a_bad_mode_and_missing_cotangent_as_x_mode_does():
    gi, uf, prz, pn, h0 = (None if a is None else torch.from_numpy(a)
                           for a in gi_inputs(4, 2, 6, 3, True))
    with pytest.raises(ValueError, match="dense-only"):
        cuda_gru.gru_scan_fused(gi, uf, prz, pn, h0, mode="post")
    with pytest.raises(ValueError, match="'pre' or 'post'"):
        cuda_gru.GRUScan.apply(gi, uf, prz, pn, h0, "mid")
    res = cuda_gru.gru_scan_fused_res(gi, uf, prz, pn, h0, mode="pre")
    with pytest.raises(ValueError, match="cotangent"):
        cuda_gru.gru_scan_bwd(uf, prz, pn, h0, *res, None, mode="pre")


# -- the GRU path: scan_layer, HARNet, BDNet, HARTrainer -------------------------

@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("which", list(SWITCHES))
def test_scan_layer_and_its_gradients_match_jax(which, kind, reverse, switch):
    switch(which)
    jfac, fac = CELLS[kind]
    n, h, t, b = 9, 12, 6, 3
    jcell, cell = jfac(n, h), fac(n, h)
    jparams = jcell.init(jax.random.PRNGKey(4))
    params = transplant(jparams)
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((t, b, n)).astype(np.float32)
    h0 = (0.4 * rng.standard_normal((b, h))).astype(np.float32)
    w = rng.standard_normal((t, b, h)).astype(np.float32)

    def jloss(p, x0):
        ys, hl = jax_scan_layer(jcell, jcell.prepare(p), jnp.asarray(xs), x0, reverse=reverse,
                                backend="pallas")
        return jnp.sum(ys * w) + jnp.sum(jnp.tanh(hl)), (ys, hl)

    (_, (ys_j, hl_j)), (g_p, g_h0) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(h0))
    for p in params.values():
        p.requires_grad_(True)
    th0 = torch.from_numpy(h0).requires_grad_()
    ys, hl = scan_layer(cell, cell.prepare(params), torch.from_numpy(xs), th0, reverse=reverse)
    fn = ys.grad_fn
    if reverse:  # the scan's output, flipped back
        fn = fn.next_functions[0][0]
    assert type(fn).__name__ == ("GRUScanBackward" if which == "gi_mode" else
                                 "GRUScanXinBackward")
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j), **FWD_TOL)
    np.testing.assert_allclose(hl.detach().numpy(), np.asarray(hl_j), **FWD_TOL)
    ((ys * torch.from_numpy(w)).sum() + torch.tanh(hl).sum()).backward()
    np.testing.assert_allclose(th0.grad.numpy(), np.asarray(g_h0), **GRAD_TOL)
    for k, want in to_np(g_p).items():
        # in gi mode the x side's gradient reaches every parameter through inp
        assert float(params[k].grad.abs().max()) > 0, k
        np.testing.assert_allclose(params[k].grad.numpy(), want, err_msg=k, **GRAD_TOL)


MODELS = [("HARNet", "lowrank", None), ("HARNet", "group2", None),
          ("BDNet", "lowrank", "concat"), ("BDNet", "group2", "sum")]


@pytest.mark.parametrize("model,kind,merge", MODELS, ids=[f"{m}-{k}" for m, k, _ in MODELS])
@pytest.mark.parametrize("which", list(SWITCHES))
def test_models_apply_and_gradients_match_jax(which, model, kind, merge, switch):
    switch(which)
    jfac, fac = CELLS[kind]
    kw = dict(num_classes=5) if merge is None else dict(num_classes=5, merge=merge)
    jcls, cls = {"HARNet": (JaxHARNet, HARNet), "BDNet": (JaxBDNet, BDNet)}[model]
    jm = jcls(7, (12, 6), cell_factory=jfac, backend="pallas", **kw)
    m = cls(7, (12, 6), cell_factory=fac, **kw)
    jparams = jm.init(jax.random.PRNGKey(6))
    params = transplant(jparams)
    x = np.random.default_rng(8).standard_normal((5, 6, 7)).astype(np.float32)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x))
        return jnp.sum(jnp.tanh(out)), out

    (_, want), g_j = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = jax.tree_util.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    got = m.apply(params, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    torch.tanh(got).sum().backward()
    for i, (a, b) in enumerate(zip(leaves, jax.tree_util.tree_leaves(g_j))):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), err_msg=str(i), **GRAD_TOL)


@pytest.mark.parametrize("kind", ["lowrank", "group2"])
@pytest.mark.parametrize("which", list(SWITCHES))
def test_har_train_steps_match_jax(which, kind, switch):
    switch(which)
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


def test_costs_of_gi_mode_and_recompute():
    # the main HAR GRU layer 1: T=24, B=81, F=77, h=64, rx=r=9, low-rank pre
    size = (24, 81, 77, 9, 64, 9, cuda_gru.LOWRANK_PRE)
    rows = 24 * 81
    x_fwd, gi_fwd = cuda_gru.gru_scan_cost(*size), cuda_gru.gru_scan_cost(*size, gi=True)
    # gi mode: no x-side products (77·9 + 9·192 multiply-adds a row), one op
    # less per gate element; it reads gi [T,B,3h] instead of x and the x side
    assert x_fwd[0] - gi_fwd[0] == rows * (2 * (77 * 9 + 9 * 192) + 192)
    assert gi_fwd[1] == 4 * (rows * 192 + 64 * 9 + 3 * 64 * 9 + 81 * 64 + rows * 64)
    res, rc = (cuda_gru.gru_scan_res_cost(*size, save_gates=s) for s in (True, False))
    assert rc == x_fwd and res[1] - rc[1] == 4 * rows * (192 + 9 + 2 * 9)
    assert cuda_gru.gru_scan_res_cost(*size, gi=True)[1] == gi_fwd[1] + 4 * rows * (192 + 18)
    saved, recompute = (cuda_gru.gru_scan_bwd_cost(*size, save_gates=s) for s in (True, False))
    assert recompute[0] - saved[0] == x_fwd[0]  # the pre-pass does the forward's work again
    # recompute reads the bias in place of gates, hu, rhu and xu
    assert saved[1] - recompute[1] == 4 * (rows * (192 + 18 + 9) - 192)
    gi_bwd = cuda_gru.gru_scan_bwd_cost(*size, gi=True)
    assert gi_bwd[0] == rows * (2 * 2 * 5 * 64 * 9 + 20 * 64)


def test_low_rank_x_gru_har_learns_as_slowly_in_jax():
    # The main HAR GRU (77 -> 64 -> 64, GRUCell w9/u9) reaches a low accuracy
    # after two synthetic epochs on the card. The JAX package's trainer, from
    # the same transplanted parameters and data (its XLA scan computes what
    # its Pallas kernel does), learns the same way: a property of the model.
    from vmlmf_tpu import config as jconfig
    from vmlmf_tpu.data.har import synthetic_har as jax_synthetic_har
    from vmlmf_tpu.train.har import evaluate as jax_evaluate
    from vmlmf_tpu_torch import config
    from vmlmf_tpu_torch.train.har import evaluate

    kw = dict(model="mygru", layer_sizes=(64, 64), w_rank=9, u_ranks=(9,))
    jm = jconfig.HARConfig(**kw, backend="xla").build_model()
    m = config.HARConfig(**kw).build_model()
    x, y, xt, yt = jax_synthetic_har("opp", n_train=30 * 81, n_test=500, seed=0)
    jt = JaxHARTrainer(jm, batch_size=81)
    jparams, jopt = jt.init()
    params = transplant(jparams)
    jparams, _, jhist = jt.fit(jparams, jopt, x, y, epochs=2, log_fn=None)
    t = HARTrainer(m, batch_size=81, device="cpu")
    params, _, hist = t.fit(params, t.optimizer(params), x, y, epochs=2, log_fn=None)
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               **HAR_PARAM_TOL)
    want, got = jax_evaluate(jm, jparams, xt, yt), evaluate(m, params, xt, yt)
    assert abs(got["accuracy"] - want["accuracy"]) <= 0.01, (got, want)
    assert abs(got["macro_f1"] - want["macro_f1"]) <= 0.01, (got, want)


def test_group_gru_har_learns_as_slowly_in_jax():
    # The group HAR GRU (77 -> 64 -> 64, GRUGroupCell w9, u(12, 6), g=2)
    # reads accuracy 0.25 after two synthetic epochs on the card. The JAX
    # package's trainer, from the same transplanted parameters and data,
    # gives the same losses and accuracy: a property of the model.
    from vmlmf_tpu import config as jconfig
    from vmlmf_tpu.data.har import synthetic_har as jax_synthetic_har
    from vmlmf_tpu.train.har import evaluate as jax_evaluate
    from vmlmf_tpu_torch import config
    from vmlmf_tpu_torch.train.har import evaluate

    kw = dict(model="mygru_group", layer_sizes=(64, 64), w_rank=9, u_ranks=(12, 6))
    jm = jconfig.HARConfig(**kw, backend="xla").build_model()
    m = config.HARConfig(**kw).build_model()
    x, y, xt, yt = jax_synthetic_har("opp", n_train=30 * 81, n_test=500, seed=0)
    jt = JaxHARTrainer(jm, batch_size=81)
    jparams, jopt = jt.init()
    params = transplant(jparams)
    jparams, _, jhist = jt.fit(jparams, jopt, x, y, epochs=2, log_fn=None)
    t = HARTrainer(m, batch_size=81, device="cpu")
    params, _, hist = t.fit(params, t.optimizer(params), x, y, epochs=2, log_fn=None)
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               **HAR_PARAM_TOL)
    want, got = jax_evaluate(jm, jparams, xt, yt), evaluate(m, params, xt, yt)
    assert abs(got["accuracy"] - want["accuracy"]) <= 0.01, (got, want)
    assert abs(got["macro_f1"] - want["macro_f1"]) <= 0.01, (got, want)
