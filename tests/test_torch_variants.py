"""The LSTM scan's variants in the port (`ops.cuda_scan`, `nn.recurrence`,
the LM's bf16 head) against the JAX package's, on the same numpy inputs and
transplanted parameters, under the same switches.

The JAX package selects compiled variants of its Pallas scan through
``precision`` / VMLMF_PALLAS_PRECISION (bf16 product operands, f32 sums),
VMLMF_PALLAS_RESIDUALS=bf16 (bf16 gates and hu saved for the backward),
VMLMF_PALLAS_SAVED_GATES=0 (the recompute policy) and VMLMF_PALLAS_XIN=0 (gi
mode). Each test sets the switch with monkeypatch on both sides and runs
the JAX kernels in Pallas interpret mode (as tests/test_pallas.py does); the
port runs its plain versions on the CPU, which the CUDA kernels are held to
in tests/test_torch_cuda.py. Tolerances (atol = rtol), with the largest
absolute error seen on the CPU over the four forms beside each: bf16
outputs 5e-3 (1.2e-7), gradients 5e-2 (4.5e-6; tests/test_pallas.py:97,
:114); bf16 residuals 2e-5 on outputs (1.8e-7) and 2e-2 on gradients
(9.5e-7; test_pallas.py:209-213); recompute 2e-5 and 3e-4 (1.8e-7,
1.4e-6); gi mode 2e-5 and 3e-4 (1.2e-7, 3.0e-7), in bf16 5e-3 and 5e-2
(1.5e-7, 1.8e-7). The port rounds where the JAX kernels round, so only the
order of f32 sums separates the two.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu import config as jconfig  # noqa: E402
from vmlmf_tpu.cells import VMLMFCell as JaxVMLMFCell  # noqa: E402
from vmlmf_tpu.nn.models import LMModel as JaxLMModel  # noqa: E402
from vmlmf_tpu.nn.recurrence import RNN as JaxRNN  # noqa: E402
from vmlmf_tpu.nn.recurrence import scan_layer as jax_scan_layer  # noqa: E402
from vmlmf_tpu.ops.pallas_scan import lstm_scan_fused as jax_scan_gi  # noqa: E402
from vmlmf_tpu.ops.pallas_scan import lstm_scan_fused_xin as jax_scan  # noqa: E402
from vmlmf_tpu.train.lm import LMTrainer as JaxLMTrainer  # noqa: E402
from vmlmf_tpu_torch import config  # noqa: E402
from vmlmf_tpu_torch.cells import GRUCell, VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.nn import recurrence  # noqa: E402
from vmlmf_tpu_torch.nn.layers import Bf16Product  # noqa: E402
from vmlmf_tpu_torch.nn.models import LMModel  # noqa: E402
from vmlmf_tpu_torch.nn.recurrence import RNN, run_wavefront, scan_layer  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_gru, cuda_scan, cuda_stack  # noqa: E402
from vmlmf_tpu_torch.train.lm import LMTrainer  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

FWD_TOL = dict(atol=2e-5, rtol=2e-5)     # f32 (tests/test_pallas.py)
GRAD_TOL = dict(atol=3e-4, rtol=3e-4)
BF16_FWD_TOL = dict(atol=5e-3, rtol=5e-3)    # tests/test_pallas.py:97
BF16_GRAD_TOL = dict(atol=5e-2, rtol=5e-2)   # tests/test_pallas.py:114
RES_GRAD_TOL = dict(atol=2e-2, rtol=2e-2)    # tests/test_pallas.py:209-213
TIGHT = dict(atol=1e-5, rtol=1e-5)       # the port against itself: f32 sums in another order

# the four forms of tests/test_pallas.py:27-39, (T, B, F, h, rx, r): rx = 0
# is a dense x side, r = 0 a dense recurrent side
FORMS = {"lowrank": (5, 3, 9, 20, 3, 5), "dense_rec": (6, 5, 9, 20, 3, 0),
         "dense_x": (6, 4, 24, 12, 0, 3), "dense": (5, 3, 16, 16, 0, 0)}
# the switches of each variant: (precision, environment)
VARIANTS = {
    "bf16": ("bf16", {}),
    "bf16_res": ("f32", {"VMLMF_PALLAS_RESIDUALS": "bf16"}),
    "recompute": ("f32", {"VMLMF_PALLAS_SAVED_GATES": "0"}),
    "bf16+recompute": ("bf16", {"VMLMF_PALLAS_SAVED_GATES": "0"}),
}
VARIANT_TOL = {"bf16": (BF16_FWD_TOL, BF16_GRAD_TOL), "bf16_res": (FWD_TOL, RES_GRAD_TOL),
               "recompute": (FWD_TOL, GRAD_TOL),
               "bf16+recompute": (BF16_FWD_TOL, BF16_GRAD_TOL)}
SWITCHES = ("VMLMF_PALLAS_PRECISION", "VMLMF_PALLAS_RESIDUALS", "VMLMF_PALLAS_SAVED_GATES",
            "VMLMF_PALLAS_XIN")


@pytest.fixture
def env(monkeypatch):
    """Sets the JAX package's kernel switches (both sides read them), from a
    clean slate."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)

    def set_(switches):
        for k, v in switches.items():
            monkeypatch.setenv(k, v)
    return set_


def scan_inputs(t, b, f, h, rx, r, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return (n(t, b, f, scale=1.0), n(f, rx or 4 * h), n(rx, 4 * h) if rx else None, n(4, h),
            n(4 * h), n(h, r or 4 * h), n(r, 4 * h) if r else None, n(4 * h), n(b, h), n(b, h))


def loss_of(ys, c_last, w, np_):
    """Σ ys⊙w + Σ tanh(h_last) + ½Σ c_last² (tests/test_pallas.py)."""
    return np_.sum(ys * w) + np_.sum(np_.tanh(ys[-1])) + 0.5 * np_.sum(c_last * c_last)


def jax_value_and_grads(fn, arrs, w):
    """(ys, c_last, grads of the given inputs) of a JAX scan ``fn``."""
    which = [i for i, a in enumerate(arrs) if a is not None]

    def jloss(*a):
        full = list(arrs)
        for i, x in zip(which, a):
            full[i] = x
        ys, c = fn(*full)
        return loss_of(ys, c, jnp.asarray(w), jnp), (ys, c)

    (_, (ys, c)), g = jax.value_and_grad(jloss, argnums=tuple(range(len(which))), has_aux=True)(
        *[jnp.asarray(arrs[i]) for i in which])
    return np.asarray(ys), np.asarray(c), [np.asarray(x) for x in g]


def port_value_and_grads(apply, arrs, w, *extra):
    args = [None if a is None else torch.from_numpy(a).requires_grad_() for a in arrs]
    ys, c = apply(*args, *extra)
    grads = torch.autograd.grad(loss_of(ys, c, torch.from_numpy(w), torch),
                                [a for a in args if a is not None])
    return ys.detach().numpy(), c.detach().numpy(), [g.numpy() for g in grads]


def assert_all_close(got, want, tol, names=None):
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=str(names[k] if names else k), **tol)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("name", list(VARIANTS))
def test_xin_variant_matches_the_jax_kernel_and_its_vjp(name, form, env):
    precision, switches = VARIANTS[name]
    env(switches)
    t, b, f, h, rx, r = FORMS[form]
    arrs = scan_inputs(t, b, f, h, rx, r)
    w = np.random.default_rng(7).standard_normal((t, b, h)).astype(np.float32)
    want = jax_value_and_grads(
        lambda *a: jax_scan(*a, interpret=True, precision=precision), arrs, w)
    got = port_value_and_grads(cuda_scan.LSTMScanXin.apply, arrs, w, precision)
    fwd_tol, grad_tol = VARIANT_TOL[name]
    assert_all_close(got[:2], want[:2], fwd_tol)
    names = [n for n, a in zip(cuda_scan._ARG_NAMES, arrs) if a is not None]
    assert_all_close(got[2], want[2], grad_tol, names)


@pytest.mark.parametrize("form", list(FORMS))
def test_recompute_and_bf16_residuals_against_the_saved_f32_gates(form, env):
    # the primal never changes; recompute rebuilds the saved gates, so its
    # gradients are the saved-gates ones but for the order of f32 sums
    t, b, f, h, rx, r = FORMS[form]
    arrs = scan_inputs(t, b, f, h, rx, r)
    w = np.random.default_rng(7).standard_normal((t, b, h)).astype(np.float32)
    saved = port_value_and_grads(cuda_scan.LSTMScanXin.apply, arrs, w)
    env({"VMLMF_PALLAS_SAVED_GATES": "0"})
    recompute = port_value_and_grads(cuda_scan.LSTMScanXin.apply, arrs, w)
    env({"VMLMF_PALLAS_SAVED_GATES": "1", "VMLMF_PALLAS_RESIDUALS": "bf16"})
    bf16_res = port_value_and_grads(cuda_scan.LSTMScanXin.apply, arrs, w)
    for other in (recompute, bf16_res):
        assert np.array_equal(other[0], saved[0]) and np.array_equal(other[1], saved[1])
    assert_all_close(recompute[2], saved[2], TIGHT)
    args = [None if a is None else torch.from_numpy(a) for a in arrs]
    ys, cs, gates, hu, xu = cuda_scan.lstm_scan_xin_fwd_res_plain(*args)
    g_re, hu_re, xu_re = cuda_scan.lstm_recompute_plain(*args[:8], args[8], ys)
    torch.testing.assert_close(g_re, gates, **TIGHT)
    for got, want in ((hu_re, hu), (xu_re, xu)):
        assert (got is None) == (want is None)
        if want is not None:
            torch.testing.assert_close(got, want, **TIGHT)
    res = cuda_scan.lstm_scan_fused_xin_res(*args, residuals="bf16")
    assert res[2].dtype == torch.bfloat16 and (res[3] is None or res[3].dtype == torch.bfloat16)
    assert res[0].dtype == res[1].dtype == torch.float32
    assert cuda_scan.lstm_scan_fused_xin_res(*args, save_gates=False)[2:] == (None, None, None)


GI_FORMS = {"lowrank": (5, 3, 20, 5), "dense": (6, 4, 12, 0)}  # (T, B, h, r)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("form", list(GI_FORMS))
def test_gi_mode_matches_lstm_scan_fused_and_its_vjp(form, precision, env):
    env({"VMLMF_PALLAS_RESIDUALS": "bf16"} if precision == "bf16" else {})
    t, b, h, r = GI_FORMS[form]
    rng = np.random.default_rng(4)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    arrs = (n(t, b, 4 * h, scale=1.0), n(h, r or 4 * h), n(r, 4 * h) if r else None, n(4 * h),
            n(b, h), n(b, h))
    w = n(t, b, h, scale=1.0)
    want = jax_value_and_grads(
        lambda *a: jax_scan_gi(*a, interpret=True, precision=precision), arrs, w)
    got = port_value_and_grads(cuda_scan.LSTMScan.apply, arrs, w, precision)
    fwd_tol, grad_tol = ((FWD_TOL, GRAD_TOL) if precision == "f32"
                         else (BF16_FWD_TOL, BF16_GRAD_TOL))
    assert_all_close(got[:2], want[:2], fwd_tol)
    assert_all_close(got[2], want[2], grad_tol)
    args = [None if a is None else torch.from_numpy(a) for a in arrs]
    ys, c_last = cuda_scan.lstm_scan_fused(*args, precision)
    np.testing.assert_array_equal(ys.numpy(), got[0])
    dgi = cuda_scan.lstm_scan_bwd(*args[1:], *cuda_scan.lstm_scan_fused_res(*args, precision),
                                  torch.from_numpy(w), None, precision)[0]
    assert dgi.shape == (t, b, 4 * h)


def vmlmf_pair(n=16, h=24, w_rank=4, u_rank=5, seed=0):
    jcell = JaxVMLMFCell(n, h, w_rank=w_rank, u_rank=u_rank)
    jparams = jcell.init(jax.random.PRNGKey(seed))
    cell = VMLMFCell(n, h, w_rank=w_rank, u_rank=u_rank)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcell, jparams, cell, params


def layer_case(jcell, t, b, seed=1):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((t, b, jcell.input_size)).astype(np.float32)
    s0 = tuple((0.3 * rng.standard_normal((b, jcell.hidden_size))).astype(np.float32)
               for _ in range(2))
    w = rng.standard_normal((t, b, jcell.hidden_size)).astype(np.float32)
    return xs, s0, w


def layer_values_and_grads(jcell, jparams, cell, params, xs, s0, w, precision=None):
    """(JAX, port) forward outputs and parameter gradients of one layer
    through the JAX "pallas" and the port's "fused" scan_layer."""
    def jloss(p):
        ys, (hl, cl) = jax_scan_layer(jcell, jcell.prepare(p), jnp.asarray(xs),
                                      tuple(map(jnp.asarray, s0)), backend="pallas",
                                      precision=precision)
        return jnp.sum(ys * w) + jnp.sum(jnp.tanh(hl)) + 0.5 * jnp.sum(cl * cl), (ys, hl, cl)

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    ys, (hl, cl) = scan_layer(cell, cell.prepare(leaves), torch.from_numpy(xs),
                              tuple(map(torch.from_numpy, s0)), backend="fused",
                              precision=precision)
    loss = (ys * torch.from_numpy(w)).sum() + torch.tanh(hl).sum() + 0.5 * (cl * cl).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    port = [a.detach().numpy() for a in (ys, hl, cl)]
    return ([np.asarray(a) for a in jout], [np.asarray(jg[k]) for k in leaves], port,
            [g.numpy() for g in grads], list(leaves))


# Fault 7: the port's LSTM path ignored the JAX package's switches and
# computed f32 where JAX computed bf16. At the HAR layer below, JAX's own
# bf16 and f32 results part by 1.1e-3 (outputs) and 1.8e-2 (gradients,
# relative), and under bf16 residuals its gradients by 1.3e-2: these
# tolerances sit below those gaps, so the f32 port fails them.
FAULT7_FWD_TOL = dict(atol=2e-4, rtol=2e-4)
FAULT7_GRAD_TOL = dict(atol=2e-3, rtol=2e-3)


def test_fault7_bf16_precision_from_the_environment_matches_jax(env):
    env({"VMLMF_PALLAS_PRECISION": "bf16"})
    jcell, jparams, cell, params = vmlmf_pair(77, 180, 8, 6)
    xs, s0, w = layer_case(jcell, 6, 5)
    jout, jg, out, g, _ = layer_values_and_grads(jcell, jparams, cell, params, xs, s0, w)
    assert_all_close(out, jout, FAULT7_FWD_TOL, ("ys", "h", "c"))
    assert_all_close(g, jg, FAULT7_GRAD_TOL)


def test_fault7_bf16_residuals_from_the_environment_match_jax_gradients(env):
    env({"VMLMF_PALLAS_RESIDUALS": "bf16"})
    jcell, jparams, cell, params = vmlmf_pair(77, 180, 8, 6)
    xs, s0, w = layer_case(jcell, 6, 5)
    jout, jg, out, g, names = layer_values_and_grads(jcell, jparams, cell, params, xs, s0, w)
    assert_all_close(out, jout, FWD_TOL, ("ys", "h", "c"))
    assert_all_close(g, jg, FAULT7_GRAD_TOL, names)


@pytest.mark.parametrize("switches", [
    {"VMLMF_PALLAS_SAVED_GATES": "0"}, {"VMLMF_PALLAS_XIN": "0"},
    {"VMLMF_PALLAS_XIN": "0", "VMLMF_PALLAS_PRECISION": "bf16"}],
    ids=["recompute", "gi", "gi_bf16"])
def test_scan_layer_follows_the_environment_as_jax(switches, env, monkeypatch):
    env(switches)
    calls = []
    for name in ("LSTMScan", "LSTMScanXin"):
        fn = getattr(recurrence, name).apply
        monkeypatch.setattr(getattr(recurrence, name), "apply",
                            lambda *a, f=fn, k=name: calls.append(k) or f(*a))
    jcell, jparams, cell, params = vmlmf_pair()
    xs, s0, w = layer_case(jcell, 5, 3)
    jout, jg, out, g, names = layer_values_and_grads(jcell, jparams, cell, params, xs, s0, w)
    assert calls == ["LSTMScan" if "VMLMF_PALLAS_XIN" in switches else "LSTMScanXin"]
    bf16 = switches.get("VMLMF_PALLAS_PRECISION") == "bf16"
    assert_all_close(out, jout, BF16_FWD_TOL if bf16 else FWD_TOL)
    assert_all_close(g, jg, BF16_GRAD_TOL if bf16 else GRAD_TOL, names)


def test_rnn_precision_argument_overrides_the_environment(env):
    env({"VMLMF_PALLAS_PRECISION": "f32"})
    cells, jcells, params, jparams = [], [], [], []
    for seed, n in enumerate((16, 24)):
        jc, jp, c, p = vmlmf_pair(n, 24, seed=seed)
        cells.append(c), jcells.append(jc), params.append(p), jparams.append(jp)
    x = np.random.default_rng(5).standard_normal((3, 5, 16)).astype(np.float32)
    want, _ = JaxRNN(tuple(jcells), backend="pallas", precision="bf16")(jparams, jnp.asarray(x))
    f32, _ = JaxRNN(tuple(jcells), backend="pallas")(jparams, jnp.asarray(x))
    got, _ = RNN(tuple(cells), precision="bf16")(params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_FWD_TOL)
    gap = np.abs(np.asarray(want) - np.asarray(f32)).max()
    assert np.abs(got.numpy() - np.asarray(want)).max() < gap / 4  # bf16, not f32
    with pytest.raises(ValueError, match="precision"):
        RNN(tuple(cells), precision="fp8")(params, torch.from_numpy(x))


def test_the_stack_raises_under_bf16_on_either_wavefront_backend(env, monkeypatch):
    # neither raises any more: "pipelined" computes f32 under bf16, as the
    # JAX package's XLA wavefront does, and "fused_pipelined" runs the bf16
    # stack; only a precision that is neither raises
    monkeypatch.setenv("VMLMF_EXPERIMENTAL_WAVEFRONT", "1")
    cells = tuple(VMLMFCell(8, 8, w_rank=3, u_rank=3) for _ in range(2))
    params = [c.init(torch.Generator().manual_seed(0), device="cpu") for c in cells]
    preps = [c.prepare(p) for c, p in zip(cells, params)]
    xs = torch.randn(3, 2, 8, generator=torch.Generator().manual_seed(1))
    states = [c.state0(2, "cpu") for c in cells]
    out = {(be, p): run_wavefront(be, cells, preps, xs, states, precision=p)[0]
           for be in ("fused_pipelined", "pipelined") for p in ("f32", "bf16")}
    assert torch.equal(out["pipelined", "bf16"], out["pipelined", "f32"])
    gap = float((out["fused_pipelined", "bf16"] - out["fused_pipelined", "f32"]).abs().max())
    assert 0 < gap < BF16_FWD_TOL["atol"]
    grouped = cuda_stack.run_stack_grouped(cells, preps, xs, states, precision="bf16")[0]
    assert torch.equal(grouped, out["fused_pipelined", "bf16"])
    rnn = RNN(cells, backend="fused_pipelined", precision="bf16")(params, xs, time_major=True)[0]
    assert torch.equal(rnn, out["fused_pipelined", "bf16"])
    env({"VMLMF_PALLAS_PRECISION": "bf16"})
    assert torch.equal(RNN(cells, backend="fused_pipelined")(params, xs, time_major=True)[0],
                       out["fused_pipelined", "bf16"])
    with pytest.raises(ValueError, match="precision"):
        run_wavefront("fused_pipelined", cells, preps, xs, states, precision="fp8")
    # reverse=True runs the per-layer fused scans, which take bf16
    ys, _ = RNN(cells, backend="fused_pipelined")(params, xs, time_major=True, reverse=True)
    assert ys.shape == (3, 2, 8)


def test_pipelined_rnn_under_bf16_computes_jax_s_f32_result(env, monkeypatch):
    # the JAX package's XLA wavefront takes no precision (recurrence.py:287-296,
    # ops/pipeline.py:86): under "bf16" it computes f32, and so does the port's
    monkeypatch.setenv("VMLMF_EXPERIMENTAL_WAVEFRONT", "1")
    jcells = tuple(JaxVMLMFCell(n, 12, w_rank=4, u_rank=4) for n in (7, 12))
    cells = tuple(VMLMFCell(n, 12, w_rank=4, u_rank=4) for n in (7, 12))
    jparams = [c.init(jax.random.PRNGKey(i)) for i, c in enumerate(jcells)]
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    xs = np.random.default_rng(4).standard_normal((5, 3, 7)).astype(np.float32)
    want, wfin = JaxRNN(jcells, backend="pipelined", precision="bf16")(
        jparams, jnp.asarray(xs), time_major=True)
    for precision, switches in (("bf16", {}), (None, {"VMLMF_PALLAS_PRECISION": "bf16"})):
        env(switches)
        got, fin = RNN(cells, backend="pipelined", precision=precision)(
            params, torch.from_numpy(xs), time_major=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
        for (h, c), (hj, cj) in zip(fin, wfin):
            np.testing.assert_allclose(h.numpy(), np.asarray(hj), **FWD_TOL)
            np.testing.assert_allclose(c.numpy(), np.asarray(cj), **FWD_TOL)


@pytest.mark.parametrize("switch", ["VMLMF_PALLAS_XIN", "VMLMF_PALLAS_SAVED_GATES"])
def test_gru_kernels_still_refuse_gi_mode_and_recompute(switch, env, monkeypatch):
    # the GRU kernels take both switches now (nothing refuses them); each
    # computes the default's function, through its own route
    assert not hasattr(cuda_gru, "_unported")
    env({switch: "0"})
    cell = GRUCell(6, 8, w_rank=3, u_rank=3)
    params = cell.init(torch.Generator().manual_seed(0), device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    xs = torch.randn(3, 2, 6, generator=torch.Generator().manual_seed(1))
    ys, _ = scan_layer(cell, cell.prepare(params), xs, cell.state0(2, "cpu"))
    assert type(ys.grad_fn).__name__ == ("GRUScanBackward" if switch == "VMLMF_PALLAS_XIN"
                                         else "GRUScanXinBackward")
    grads = torch.autograd.grad(ys.sum(), list(params.values()))
    monkeypatch.delenv(switch)
    want = scan_layer(cell, cell.prepare(params), xs, cell.state0(2, "cpu"))[0]
    torch.testing.assert_close(ys, want, **TIGHT)
    for got, w in zip(grads, torch.autograd.grad(want.sum(), list(params.values()))):
        torch.testing.assert_close(got, w, **TIGHT)


LM_KW = dict(vocab_size=40, hidden_size=24, num_layers=2, dropout_rate=0.0, winit=0.3)


def lm_pair():
    jm = JaxLMModel(cell_factory=lambda n, h: JaxVMLMFCell(n, h, w_rank=5, u_rank=4),
                    backend="pallas", head_bf16=True, **LM_KW)
    m = LMModel(cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=5, u_rank=4), head_bf16=True,
                **LM_KW)
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, m, jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                           device="cpu")


def test_mixed_precision_lm_apply_and_train_step_match_jax(env):
    # the PTB LM's "bf16+head" configuration (scripts/bench_lm_b128_precision.py)
    env({"VMLMF_PALLAS_PRECISION": "bf16"})
    jm, m, jparams, params = lm_pair()
    ids = np.random.default_rng(2).integers(0, 40, (6, 4)).astype(np.int32)
    want, _ = jm.apply(jparams, jnp.asarray(ids), jm.state0(4))
    with torch.no_grad():
        got, _ = m.apply(params, torch.from_numpy(ids).long(), m.state0(4, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_FWD_TOL)
    jt = JaxLMTrainer(jm, batch_size=4, seq_length=6, fuse_chunks=1)
    t = LMTrainer(m, batch_size=4, seq_length=6, device="cpu")
    y = np.roll(ids, -1, axis=0)
    jparams, _, jloss, jgnorm = jt._train_step(jparams, jt.state0(), jnp.asarray(ids),
                                               jnp.asarray(y), jnp.float32(1.0),
                                               jax.random.PRNGKey(1))
    params, _, loss, gnorm = t.train_step(params, t.state0(), ids, y, 1.0)
    np.testing.assert_allclose(float(loss), float(jloss), **BF16_FWD_TOL)
    np.testing.assert_allclose(float(gnorm), float(jgnorm), **BF16_GRAD_TOL)
    for k, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(params),
                                   jax.tree_util.tree_leaves(jparams))):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=str(k),
                                   **BF16_GRAD_TOL)


def test_bf16_head_product_and_gradients_are_jax_s():
    rng = np.random.default_rng(3)
    x, w, g = (rng.standard_normal(s).astype(np.float32) for s in ((3, 4, 16), (16, 9), (3, 4, 9)))
    f = lambda a, b: jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),  # noqa: E731
                             preferred_element_type=jnp.float32)
    y_j, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    y = Bf16Product.apply(xt, wt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TIGHT)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    for got, want in zip((dx, dw), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


def test_lm_config_head_bf16_builds_the_jax_model():
    kw = dict(hidden_size=12, layer_num=2, winit=0.5, head_bf16=True, w_rank=5, u_ranks=(4,))
    jm = jconfig.LMConfig(**kw, backend="pallas").build_model(30)
    m = config.LMConfig(**kw).build_model(30)
    assert m.head_bf16 and jm.head_bf16
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    ids = np.random.default_rng(2).integers(0, 30, (5, 3)).astype(np.int32)
    want, _ = jm.apply(jparams, jnp.asarray(ids), jm.rnn.state0(3))
    with torch.no_grad():
        got, _ = m.apply(params, torch.from_numpy(ids).long(), m.state0(3, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_FWD_TOL)


def test_variant_names_and_launch_counters():
    assert cuda_scan.variant() == "f32"
    assert cuda_scan.variant("bf16", "bf16") == "bf16+bf16_res"
    assert cuda_scan.variant("f32", "bf16", False) == "recompute"
    for fn in (cuda_scan.lstm_scan_fused_xin, cuda_scan.lstm_scan_fused_xin_res,
               cuda_scan.lstm_scan_xin_bwd, cuda_scan.lstm_scan_fused,
               cuda_scan.lstm_scan_fused_res, cuda_scan.lstm_scan_bwd):
        assert isinstance(fn.launches, int) and fn.variants is not None
    with pytest.raises(ValueError, match="precision"):
        cuda_scan.lstm_scan_fused_xin(*[None] * 10, precision="fp16")
