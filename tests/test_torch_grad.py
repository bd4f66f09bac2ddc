"""Gradients of the port's fused scan (`cuda_scan.LSTMScanXin`) against
`jax.grad` of the JAX package's `lstm_scan_fused_xin`, run in Pallas
interpret mode on the CPU.

On CPU tensors `LSTMScanXin` runs the plain residual forward and the plain
backward, so these tests hold the port's own backward arithmetic (not torch
autograd through a loop) to the TPU kernel's VJP, at the f32 gradient
tolerance of tests/test_pallas.py. The CUDA kernels are held to the plain
versions in tests/test_torch_cuda.py, where a CUDA device exists.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from vmlmf_tpu.cells import VMLMFCell as JaxVMLMFCell  # noqa: E402
from vmlmf_tpu.nn.recurrence import scan_layer as jax_scan_layer  # noqa: E402
from vmlmf_tpu.ops.pallas_scan import lstm_scan_fused_xin as jax_scan  # noqa: E402
from vmlmf_tpu_torch.cells import VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.cells.base import lstm_update  # noqa: E402
from vmlmf_tpu_torch.nn.recurrence import scan_layer  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_scan  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

GRAD_TOL = dict(atol=3e-4, rtol=3e-4)
FWD_TOL = dict(atol=2e-5, rtol=2e-5)

# (T, B, F, h, rx, r): F = h, F < h, F > h; B and T not multiples of 4
CASES = {
    "f_eq_h": (5, 3, 16, 16, 4, 4),
    "f_lt_h": (6, 5, 9, 20, 3, 5),
    "f_gt_h": (7, 9, 24, 12, 5, 3),
    "ragged": (9, 11, 13, 13, 6, 7),
}

# (case, which outputs the loss reads): both on every case, then c_last
# only (dys is None) and ys only (dc_last is None)
GRAD_CASES = [(c, "both") for c in CASES] + [("f_gt_h", "c_last"), ("f_gt_h", "ys")]


def make_inputs(t, b, f, h, rx, r, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return (n(t, b, f, scale=1.0), n(f, rx), n(rx, 4 * h), n(4, h), n(4 * h),
            n(h, r), n(r, 4 * h), n(4 * h), n(b, h), n(b, h))


def scan_loss(ys, c_last, w, reads, np_):
    """Σ ys⊙w + Σ tanh(h_last) + ½Σ c_last² (tests/test_pallas.py), or its
    c_last or ys part alone."""
    out = 0.0
    if reads in ("both", "ys"):
        out = out + np_.sum(ys * w) + np_.sum(np_.tanh(ys[-1]))
    if reads in ("both", "c_last"):
        out = out + 0.5 * np_.sum(c_last * c_last)
    return out


@pytest.fixture
def bwd_spy(monkeypatch):
    """Records, per call of the plain backward, whether dys and dc_last were given."""
    calls = []
    plain = cuda_scan.lstm_scan_xin_bwd_plain

    def spy(*args, **kw):
        calls.append((args[-2] is not None, args[-1] is not None))
        return plain(*args, **kw)

    monkeypatch.setattr(cuda_scan, "lstm_scan_xin_bwd_plain", spy)
    return calls


@pytest.mark.parametrize("case,reads", GRAD_CASES, ids=[f"{c}-{r}" for c, r in GRAD_CASES])
def test_scan_gradients_match_jax(case, reads, bwd_spy):
    t, b, f, h, rx, r = CASES[case]
    arrs = make_inputs(t, b, f, h, rx, r)
    w = np.random.default_rng(7).standard_normal((t, b, h)).astype(np.float32)

    def jloss(*a):
        ys, c = jax_scan(*a, interpret=True)
        return scan_loss(ys, c, jnp.asarray(w), reads, jnp)

    g_jax = jax.jit(jax.grad(jloss, argnums=tuple(range(10))))(*map(jnp.asarray, arrs))

    args = [torch.from_numpy(a).requires_grad_() for a in arrs]
    counts = (cuda_scan.lstm_scan_fused_xin_res.launches, cuda_scan.lstm_scan_xin_bwd.launches)
    ys, c_last = cuda_scan.LSTMScanXin.apply(*args)
    grads = torch.autograd.grad(scan_loss(ys, c_last, torch.from_numpy(w), reads, torch), args)
    assert counts == (cuda_scan.lstm_scan_fused_xin_res.launches,
                      cuda_scan.lstm_scan_xin_bwd.launches)  # CPU: no kernel
    assert bwd_spy == [(reads != "c_last", reads != "ys")]
    for name, got, want in zip(cuda_scan._ARG_NAMES, grads, g_jax):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_residual_forward_matches_no_grad_forward_exactly(case):
    args = [torch.from_numpy(a) for a in make_inputs(*CASES[case])]
    ys, c_last = cuda_scan.lstm_scan_fused_xin_plain(*args)
    ys_r, cs, gates, hu, xu = cuda_scan.lstm_scan_xin_fwd_res_plain(*args)
    assert torch.equal(ys_r, ys) and torch.equal(cs[-1], c_last)
    t, b, f, h, rx, r = CASES[case]
    assert (gates.shape, hu.shape, xu.shape) == ((t, b, 4 * h), (t, b, r), (t, b, rx))
    torch.testing.assert_close(xu, args[0] @ args[1], **FWD_TOL)


@pytest.mark.parametrize("n,h", [(9, 20), (24, 12)], ids=["f_lt_h", "f_gt_h"])
def test_residual_gates_and_hu_match_cell_step(n, h):
    cell = VMLMFCell(n, h, w_rank=3, u_rank=5)
    prep = cell.prepare(cell.init(torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(1)
    xs = torch.from_numpy(rng.standard_normal((6, 4, n)).astype(np.float32))
    h0, c0 = (torch.from_numpy(0.3 * rng.standard_normal((4, h)).astype(np.float32))
              for _ in range(2))
    ys, cs, gates, hu, _ = cuda_scan.lstm_scan_xin_fwd_res_plain(
        xs, *cell.fused_x_inputs(prep), *cell.fused_rec_inputs(prep), h0, c0)
    gi = cell.inp(prep, xs)
    state = (h0, c0)
    for t in range(xs.shape[0]):
        h_prev, c_prev = state
        u_h, v_h = prep["u_h"], prep["v_h"]
        rec = ((h_prev @ u_h) @ v_h.T).reshape(4, 4, h) + h_prev[:, None, :] * (
            prep["d_h"] - prep["dcorr_h"])
        pre = gi[t] + rec.reshape(4, 4 * h)
        state, y = cell.step(prep, gi[t], state)
        torch.testing.assert_close(lstm_update(pre, c_prev)[0], y, **FWD_TOL)
        i, f, g, o = pre.chunk(4, dim=-1)
        want = torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)],
                         dim=-1)
        torch.testing.assert_close(gates[t], want, **FWD_TOL)
        torch.testing.assert_close(hu[t], h_prev @ u_h, **FWD_TOL)
        torch.testing.assert_close(ys[t], y, **FWD_TOL)
        torch.testing.assert_close(cs[t], state[1], **FWD_TOL)


@pytest.mark.parametrize("n,h", [(9, 20), (24, 12)], ids=["f_lt_h", "f_gt_h"])
def test_cell_parameter_gradients_match_jax(n, h, bwd_spy):
    t, b = 7, 5
    jcell = JaxVMLMFCell(n, h, w_rank=3, u_rank=5)
    jparams = jcell.init(jax.random.PRNGKey(2))
    cell = VMLMFCell(n, h, w_rank=3, u_rank=5)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((t, b, n)).astype(np.float32)
    s0 = [(0.3 * rng.standard_normal((b, h))).astype(np.float32) for _ in range(2)]
    w = rng.standard_normal((t, b, h)).astype(np.float32)

    def jloss(p):
        ys, (hl, cl) = jax_scan_layer(jcell, jcell.prepare(p), jnp.asarray(xs),
                                      tuple(map(jnp.asarray, s0)), backend="pallas")
        return jnp.sum(ys * w) + jnp.sum(jnp.tanh(hl)) + 0.5 * jnp.sum(cl * cl)

    g_jax = jax.jit(jax.grad(jloss))(jparams)
    for p in params.values():
        p.requires_grad_(True)
    ys, (hl, cl) = scan_layer(cell, cell.prepare(params), torch.from_numpy(xs),
                              tuple(map(torch.from_numpy, s0)), backend="fused")
    loss = (ys * torch.from_numpy(w)).sum() + torch.tanh(hl).sum() + 0.5 * (cl * cl).sum()
    loss.backward()
    assert len(bwd_spy) == 1  # the port's own backward, not autograd through a loop
    for k in jparams:
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(g_jax[k]), err_msg=k,
                                   **GRAD_TOL)


def test_no_grad_path_skips_the_autograd_function(bwd_spy):
    cell = VMLMFCell(6, 8, w_rank=2, u_rank=3)
    params = cell.init(torch.Generator().manual_seed(0), device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    xs = torch.randn(4, 2, 6, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ys, _ = scan_layer(cell, cell.prepare(params), xs, cell.state0(2, "cpu"))
    assert ys.grad_fn is None
    ys, _ = scan_layer(cell, cell.prepare(params), xs, cell.state0(2, "cpu"))
    assert type(ys.grad_fn).__name__ == "LSTMScanXinBackward"


@pytest.mark.parametrize("case", ["f_lt_h", "f_gt_h", "ragged"])
def test_dense_lstm_weights_give_the_same_scan(case):
    # the scan is a dense LSTM: one torch.lstm call on the materialised
    # weights computes it (the library yardstick that chip_smoke.py times)
    args = [torch.from_numpy(a) for a in make_inputs(*CASES[case])]
    ys, c_last = cuda_scan.lstm_scan_fused_xin_plain(*args)
    weights = chip_smoke.dense_lstm_weights(*args[1:8])
    out, h_n, c_n = torch.lstm(args[0], (args[8][None], args[9][None]), weights,
                               True, 1, 0.0, False, False, False)
    torch.testing.assert_close(out, ys, **FWD_TOL)
    torch.testing.assert_close(h_n[0], ys[-1], **FWD_TOL)
    torch.testing.assert_close(c_n[0], c_last, **FWD_TOL)


def test_bwd_cost_counts_each_residual_and_gradient_once():
    t, b, f, h, rx, r = CASES["f_lt_h"]
    arrs = make_inputs(t, b, f, h, rx, r)
    residuals = t * b * (h + h + 4 * h + r + rx)          # ys, cs, gates, hu, xu
    ops, nbytes = cuda_scan.scan_bwd_cost(t, b, f, rx, h, r)
    inputs = sum(a.size for a in arrs) - arrs[4].size + residuals + t * b * h   # + dys
    outputs = sum(a.size for a in arrs)
    assert nbytes == 4 * (inputs + outputs)
    assert ops > 2 * t * b * (2 * 4 * h * r + 2 * h * r + 2 * 4 * h * rx + 2 * f * rx)
    # the LM layer at B=20: about 5.5 GFLOP, about 0.08 ms at 67 TFLOP/s f32
    ops, _ = cuda_scan.scan_bwd_cost(35, 20, 650, 300, 650, 300)
    assert 5.0e9 < ops < 6.0e9
    ops_res, bytes_res = cuda_scan.scan_res_cost(t, b, f, rx, h, r)
    ops_fwd, bytes_fwd = cuda_scan.scan_cost(t, b, f, rx, h, r)
    assert ops_res == ops_fwd and bytes_res == bytes_fwd + 4 * (residuals - t * b * h - b * h)
