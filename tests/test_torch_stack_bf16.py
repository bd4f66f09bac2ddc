"""The port's wavefront stack with bf16 products (`ops.cuda_stack` under
``precision="bf16"``, backend "fused_pipelined") against the JAX package's
`pallas_pipeline.lstm_stack_scan_fused(..., precision="bf16")` (backend
"pallas_pipelined"), run in Pallas interpret mode on the CPU, on the same
numpy inputs and transplanted parameters.

The port rounds each product's operands where the JAX kernel's `_cast`
rounds them, so only the order of f32 sums separates the two. Tolerances
(atol = rtol) are tests/test_pallas.py's for bf16: 5e-3 on outputs (:97) and
5e-2 on gradients (:114). As tests/test_torch_variants.py does for the
scans, each forward must also lie at least 4x nearer the JAX bf16 result
than that lies to the JAX f32 one: a port that ignored the precision would
sit at the gap, inside the bf16 tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu.cells import VMLMFCell as JaxVMLMFCell  # noqa: E402
from vmlmf_tpu.nn.models import LMModel as JaxLMModel  # noqa: E402
from vmlmf_tpu.ops import pallas_pipeline as jpp  # noqa: E402
from vmlmf_tpu_torch.cells import VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.nn.models import LMModel  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_stack  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

from test_torch_stack import STACK_CASES, stack_inputs, stack_loss  # noqa: E402

BF16_FWD_TOL = dict(atol=5e-3, rtol=5e-3)    # tests/test_pallas.py:97
BF16_GRAD_TOL = dict(atol=5e-2, rtol=5e-2)   # tests/test_pallas.py:114
TIGHT = dict(atol=1e-5, rtol=1e-5)           # the port against itself


@pytest.fixture(autouse=True)
def wavefront(monkeypatch):
    monkeypatch.setenv("VMLMF_EXPERIMENTAL_WAVEFRONT", "1")
    for k in ("VMLMF_PALLAS_PRECISION", "VMLMF_PALLAS_RESIDUALS", "VMLMF_PALLAS_SAVED_GATES",
              "VMLMF_PALLAS_XIN"):
        monkeypatch.delenv(k, raising=False)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def nearer_bf16(got, want_bf16, want_f32):
    """The port's result lies 4x nearer JAX's bf16 result than JAX's f32 one."""
    gap = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(want_bf16, want_f32))
    err = max(np.abs(a - np.asarray(b)).max() for a, b in zip(got, want_bf16))
    assert 0 < gap and err < gap / 4, (err, gap)


@pytest.mark.parametrize("case", list(STACK_CASES), ids=list(STACK_CASES))
def test_bf16_stack_scan_and_gradients_match_jax(case, monkeypatch):
    n, t, b, h, ranks, xranks, masks = STACK_CASES[case]
    gi0, layers, h0s, c0s, mk = stack_inputs(n, t, b, h, ranks, xranks, masks)
    w = np.random.default_rng(9).standard_normal((t, b, h)).astype(np.float32)
    jmk = None if mk is None else [jnp.asarray(m) for m in mk]

    def jloss(gi0, layers, h0s, c0s, precision="bf16"):
        ys, hl, cl = jpp.lstm_stack_scan_fused(gi0, layers, h0s, c0s, jmk, interpret=True,
                                               precision=precision)
        return stack_loss(ys, hl, cl, jnp.asarray(w), jnp), (ys, hl, cl)

    jargs = jax.tree_util.tree_map(jnp.asarray, (gi0, layers, h0s, c0s))
    (_, out_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(*jargs)
    _, out_f32 = jloss(*jargs, precision="f32")

    calls = []
    plain_bwd = cuda_stack.lstm_stack_bwd_plain
    monkeypatch.setattr(cuda_stack, "lstm_stack_bwd_plain",
                        lambda *a: calls.append(a[-1]) or plain_bwd(*a))
    targs = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).requires_grad_(),
                                   (gi0, layers, h0s, c0s))
    tmk = None if mk is None else [torch.from_numpy(m) for m in mk]
    ys, hl, cl = cuda_stack.stack_scan(*targs, tmk, precision="bf16")
    assert type(ys.grad_fn).__name__ == "LSTMStackScanBackward"
    got = [a.detach().numpy() for a in (ys, *hl, *cl)]
    want = [out_j[0], *out_j[1], *out_j[2]]
    for a, a_j in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(a_j), **BF16_FWD_TOL)
    nearer_bf16(got, want, (out_f32[0], *out_f32[1], *out_f32[2]))
    stack_loss(ys, hl, cl, torch.from_numpy(w), torch).backward()
    assert calls == ["bf16"]  # the port's own backward, in bf16
    grads = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a: a.grad.numpy(), targs))
    for i, (a, want_g) in enumerate(zip(grads, jax.tree_util.tree_leaves(g_j))):
        np.testing.assert_allclose(a, np.asarray(want_g), err_msg=str(i), **BF16_GRAD_TOL)


@pytest.mark.parametrize("case", ["l2_t7_mask", "l3_t9"])
def test_bf16_entries_agree_and_round_where_jax_rounds(case):
    gi0, layers, h0s, c0s, mk = stack_inputs(*STACK_CASES[case], seed=3)
    args = jax.tree_util.tree_map(torch.from_numpy, (gi0, layers, h0s, c0s, mk))
    ys, hl, cl = cuda_stack.lstm_stack_scan_fused(*args, precision="bf16")
    res = cuda_stack.lstm_stack_scan_fused_res(*args, precision="bf16")
    assert torch.equal(ys, res[0][-1])
    for l in range(len(layers)):
        assert torch.equal(hl[l], res[0][l][-1]) and torch.equal(cl[l], res[1][l][-1])
    # the residuals stay f32: hu and xu are the products before any rounding
    hprev = torch.cat([args[2][0][None], res[0][0][:-1]])
    torch.testing.assert_close(res[3][0], hprev.bfloat16().float() @ args[1][0]["u"].bfloat16()
                               .float(), **TIGHT)
    assert any(float((a - a.bfloat16().float()).abs().max()) > 0 for a in res[3])
    f32 = cuda_stack.lstm_stack_scan_fused(*args)
    assert float((f32[0] - ys).abs().max()) > 0
    with pytest.raises(ValueError, match="precision"):
        cuda_stack.lstm_stack_scan_fused(*args, precision="fp16")


def grouped_case(layers):
    sizes = (5,) + (32,) * layers
    jcells = tuple(JaxVMLMFCell(n, h, w_rank=4, u_rank=4) for n, h in zip(sizes, sizes[1:]))
    cells = tuple(VMLMFCell(n, h, w_rank=4, u_rank=4) for n, h in zip(sizes, sizes[1:]))
    jparams = [c.init(jax.random.PRNGKey(i)) for i, c in enumerate(jcells)]
    params = params_from_jax(to_np(jparams), device="cpu")
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((6, 3, 5)).astype(np.float32)
    states = [tuple((0.3 * rng.standard_normal((3, 32))).astype(np.float32) for _ in range(2))
              for _ in range(layers)]
    masks = [((rng.random((6, 3, 32)) < 0.5) / 0.5).astype(np.float32)
             for _ in range(layers - 1)]
    return jcells, jparams, cells, params, xs, states, masks


@pytest.mark.parametrize("layers,groups", [(2, [(0, 2)]), (4, [(0, 2), (2, 4)])],
                         ids=["l2", "l4_forced_2+2"])
def test_run_stack_grouped_in_bf16_matches_jax(layers, groups, monkeypatch):
    jcells, jparams, cells, params, xs, states, masks = grouped_case(layers)
    # group both stacks alike, 2+2 at four layers; the grouping does not
    # depend on the precision in either package
    monkeypatch.setattr(jpp, "stack_fits", lambda lys: lys is not None and len(lys) <= 2)
    monkeypatch.setattr(cuda_stack, "stack_fits", lambda lys: lys is not None and len(lys) <= 2)
    preps = [c.prepare(p) for c, p in zip(cells, params)]
    assert cuda_stack.stack_groups(cuda_stack.stack_units(cells, preps)) == groups
    jpreps = [c.prepare(p) for c, p in zip(jcells, jparams)]
    jstates = [tuple(map(jnp.asarray, s)) for s in states]

    def jrun(precision):
        return jpp.run_stack_grouped(jcells, jpreps, jnp.asarray(xs), jstates,
                                     [jnp.asarray(m) for m in masks], interpret=True,
                                     precision=precision)

    ys_j, fin_j = jrun("bf16")
    ys_f, fin_f = jrun("f32")
    ys, fin = cuda_stack.run_stack_grouped(cells, preps, torch.from_numpy(xs),
                                           [tuple(map(torch.from_numpy, s)) for s in states],
                                           [torch.from_numpy(m) for m in masks], "bf16")
    got = [ys.numpy(), *(a.numpy() for s in fin for a in s)]
    want = [ys_j, *(a for s in fin_j for a in s)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **BF16_FWD_TOL)
    nearer_bf16(got, want, [ys_f, *(a for s in fin_f for a in s)])


def lm_pair(head_bf16=True):
    kw = dict(vocab_size=40, hidden_size=24, num_layers=2, dropout_rate=0.0, winit=0.3,
              head_bf16=head_bf16)
    jm = JaxLMModel(cell_factory=lambda n, h: JaxVMLMFCell(n, h, w_rank=5, u_rank=4),
                    backend="pallas_pipelined", **kw)
    m = LMModel(cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=5, u_rank=4),
                backend="fused_pipelined", **kw)
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, m, jparams, params_from_jax(to_np(jparams), device="cpu")


def test_mixed_precision_lm_on_the_wavefront_matches_jax(monkeypatch):
    # the PTB LM's "bf16+head": VMLMF_PALLAS_PRECISION=bf16 and head_bf16
    jm, m, jparams, params = lm_pair()
    ids = np.random.default_rng(2).integers(0, 40, (6, 4)).astype(np.int32)
    y = np.random.default_rng(3).integers(0, 40, (6, 4))

    def jloss(p):
        logits, _ = jm.apply(p, jnp.asarray(ids), jm.state0(4), train=False)
        lp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(lp, jnp.asarray(y)[..., None], -1).mean(), logits

    f32_logits = jm.apply(jparams, jnp.asarray(ids), jm.state0(4), train=False)[0]
    monkeypatch.setenv("VMLMF_PALLAS_PRECISION", "bf16")
    (_, want), g_j = jax.value_and_grad(jloss, has_aux=True)(jparams)
    with torch.no_grad():
        got, _ = m.apply(params, torch.from_numpy(ids).long(), m.state0(4, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_FWD_TOL)
    # the head is bf16 in both runs of the JAX LM: the gap is the stack's own
    nearer_bf16([got.numpy()], [want], [f32_logits])
    leaves = jax.tree_util.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    logits, _ = m.apply(params, torch.from_numpy(ids).long(), m.state0(4, "cpu"))
    nll = -torch.log_softmax(logits, -1).gather(-1, torch.from_numpy(y)[..., None]).mean()
    nll.backward()
    for i, (a, b) in enumerate(zip(leaves, jax.tree_util.tree_leaves(g_j))):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), err_msg=str(i), **BF16_GRAD_TOL)
