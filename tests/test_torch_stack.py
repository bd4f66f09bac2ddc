"""The port's wavefront stack (`vmlmf_tpu_torch.ops.cuda_stack`, backend
"fused_pipelined") against the JAX package's `ops.pallas_pipeline` (backend
"pallas_pipelined"), run in Pallas interpret mode on the CPU, with inputs
made by numpy from a seed and parameters transplanted with `params_from_jax`.

On CPU tensors the stack's wrappers run their plain versions, and
`LSTMStackScan` its plain forward and its plain backward, so these tests
hold the port's own backward arithmetic to the TPU kernel's VJP. The CUDA
kernels are held to the plain versions in tests/test_torch_cuda.py, where a
CUDA device exists. Both wavefront backends sit behind
VMLMF_EXPERIMENTAL_WAVEFRONT=1, which each test sets.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu.cells import LSTMCell as JaxLSTMCell  # noqa: E402
from vmlmf_tpu.cells import VMLMFCell as JaxVMLMFCell  # noqa: E402
from vmlmf_tpu.nn.models import LMModel as JaxLMModel  # noqa: E402
from vmlmf_tpu.nn.recurrence import RNN as JaxRNN  # noqa: E402
from vmlmf_tpu.ops import pallas_pipeline as jpp  # noqa: E402
from vmlmf_tpu.serve import Decoder as JaxDecoder  # noqa: E402
from vmlmf_tpu_torch.cells import LSTMCell, VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.config import HARConfig, LMConfig  # noqa: E402
from vmlmf_tpu_torch.nn import recurrence  # noqa: E402
from vmlmf_tpu_torch.nn.models import LMModel  # noqa: E402
from vmlmf_tpu_torch.nn.recurrence import RNN  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_stack  # noqa: E402
from vmlmf_tpu_torch.ops import pipeline as port_pipeline  # noqa: E402
from vmlmf_tpu_torch.serve import Decoder  # noqa: E402
from vmlmf_tpu_torch.train.lm import LMTrainer  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def wavefront(monkeypatch):
    monkeypatch.setenv("VMLMF_EXPERIMENTAL_WAVEFRONT", "1")


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def cells_pair(kind, sizes, **kw):
    """The same stack in both packages: (JAX cells, port cells)."""
    jcls, cls = {"vmlmf": (JaxVMLMFCell, VMLMFCell), "lstm": (JaxLSTMCell, LSTMCell)}[kind]
    pairs = [(jcls(n, h, **kw), cls(n, h, **kw)) for n, h in zip(sizes[:-1], sizes[1:])]
    return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)


def transplant(jcells, seed=0):
    jparams = [c.init(jax.random.PRNGKey(seed + i)) for i, c in enumerate(jcells)]
    return jparams, params_from_jax(to_np(jparams), device="cpu")


# -- pipeline_units and stack_units ------------------------------------------

@pytest.mark.parametrize("kind,kw", [("vmlmf", dict(w_rank=3, u_rank=5)),
                                     ("lstm", dict(w_rank=4, u_rank=2))], ids=["vmlmf", "lmf"])
def test_pipeline_and_stack_units_match_jax(kind, kw):
    jcells, cells = cells_pair(kind, (12, 12, 12), **kw)
    jparams, params = transplant(jcells)
    jpreps = [c.prepare(p) for c, p in zip(jcells, jparams)]
    preps = [c.prepare(p) for c, p in zip(cells, params)]
    for jc, c, jp, p in zip(jcells, cells, jpreps, preps):
        want, got = jc.pipeline_units(jp), c.pipeline_units(p)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **FWD_TOL)
    want, got = jpp.stack_units(jcells, jpreps), cuda_stack.stack_units(cells, preps)
    assert [sorted(d) for d in got] == [sorted(d) for d in want]
    for l, (gd, wd) in enumerate(zip(got, want)):
        for k in wd:
            assert gd[k].is_contiguous()
            np.testing.assert_allclose(gd[k].numpy(), np.asarray(wd[k]), err_msg=f"{l} {k}",
                                       **FWD_TOL)


def test_stack_units_refuse_what_the_jax_package_refuses():
    gen = torch.Generator().manual_seed(0)

    def units(cells):
        preps = [c.prepare(c.init(gen, device="cpu")) for c in cells]
        return cuda_stack.stack_units(cells, preps)

    dense = (LSTMCell(8, 8), LSTMCell(8, 8))
    assert dense[0].pipeline_units(dense[0].init(gen, device="cpu")) is None
    assert units(dense) is None
    lmf_dense_u = (LSTMCell(8, 8, w_rank=2, u_rank=None), LSTMCell(8, 8, w_rank=2, u_rank=3))
    assert units(lmf_dense_u) is None
    assert units((VMLMFCell(8, 8, w_rank=2, u_rank=2),)) is None          # a single layer
    assert units((VMLMFCell(8, 8, w_rank=2, u_rank=2),
                  VMLMFCell(8, 12, w_rank=2, u_rank=2))) is None         # unequal hidden sizes
    assert units((VMLMFCell(5, 8, w_rank=2, u_rank=2),
                  VMLMFCell(8, 8, w_rank=3, u_rank=4))) is not None      # unequal ranks


# -- the stack entry against the JAX kernel ----------------------------------

# (layers, T, B, h, ranks r_l, x ranks rx_l for l >= 1, masks)
STACK_CASES = {
    "l2_t5": (2, 5, 3, 12, (4, 6), (5,), False),
    "l2_t7_mask": (2, 7, 4, 10, (3, 5), (4,), True),
    "l3_t6_mask": (3, 6, 2, 12, (5, 3, 4), (6, 2), True),
    "l3_t9": (3, 9, 3, 8, (2, 4, 3), (3, 5), False),
}


def stack_inputs(n, t, b, h, ranks, xranks, masks, seed=0):
    rng = np.random.default_rng(seed)

    def g(*shape, scale=0.4):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    layers = []
    for l in range(n):
        d = {"u": g(h, ranks[l]), "v": g(ranks[l], 4 * h), "dvec": g(4 * h, scale=0.2)}
        if l:
            rx = xranks[l - 1]
            d.update(ux=g(h, rx), vx=g(rx, 4 * h), dxvec=g(4 * h, scale=0.2), bias=g(4 * h))
        layers.append(d)
    mk = None
    if masks:
        mk = [((rng.random((t, b, h)) < 0.6) / 0.6).astype(np.float32) for _ in range(n - 1)]
    return (g(t, b, 4 * h, scale=1.0), layers, [g(b, h) for _ in range(n)],
            [g(b, h) for _ in range(n)], mk)


def stack_loss(ys, hl, cl, w, np_):
    """Σ ys⊙w + Σ tanh(hlast) + ½Σ clast²: reads every output of the stack."""
    return (np_.sum(ys * w) + sum(np_.sum(np_.tanh(h)) for h in hl)
            + 0.5 * sum(np_.sum(c * c) for c in cl))


@pytest.mark.parametrize("case", list(STACK_CASES), ids=list(STACK_CASES))
def test_stack_scan_and_gradients_match_jax(case, monkeypatch):
    n, t, b, h, ranks, xranks, masks = STACK_CASES[case]
    gi0, layers, h0s, c0s, mk = stack_inputs(n, t, b, h, ranks, xranks, masks)
    w = np.random.default_rng(9).standard_normal((t, b, h)).astype(np.float32)
    jmk = None if mk is None else [jnp.asarray(m) for m in mk]

    def jloss(gi0, layers, h0s, c0s):
        ys, hl, cl = jpp.lstm_stack_scan_fused(gi0, layers, h0s, c0s, jmk, interpret=True)
        return stack_loss(ys, hl, cl, jnp.asarray(w), jnp), (ys, hl, cl)

    jargs = jax.tree_util.tree_map(jnp.asarray, (gi0, layers, h0s, c0s))
    (_, (ys_j, hl_j, cl_j)), g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                                       has_aux=True)(*jargs)

    calls = []
    plain_bwd = cuda_stack.lstm_stack_bwd_plain
    monkeypatch.setattr(cuda_stack, "lstm_stack_bwd_plain",
                        lambda *a: calls.append(1) or plain_bwd(*a))
    targs = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).requires_grad_(),
                                   (gi0, layers, h0s, c0s))
    tmk = None if mk is None else [torch.from_numpy(m) for m in mk]
    ys, hl, cl = cuda_stack.stack_scan(*targs, tmk)
    assert type(ys.grad_fn).__name__ == "LSTMStackScanBackward"
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j), **FWD_TOL)
    for a, a_j in zip(hl + cl, list(hl_j) + list(cl_j)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(a_j), **FWD_TOL)
    stack_loss(ys, hl, cl, torch.from_numpy(w), torch).backward()
    assert calls == [1]  # the port's own backward, not autograd through a loop
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a: a.grad.numpy(), targs))
    for i, (a, want) in enumerate(zip(got, jax.tree_util.tree_leaves(g_j))):
        np.testing.assert_allclose(a, np.asarray(want), err_msg=str(i), **GRAD_TOL)


@pytest.mark.parametrize("case", ["l2_t7_mask", "l3_t9"])
def test_no_grad_entry_matches_the_residual_forward(case):
    gi0, layers, h0s, c0s, mk = stack_inputs(*STACK_CASES[case], seed=3)
    conv = lambda tree: jax.tree_util.tree_map(torch.from_numpy, tree)  # noqa: E731
    args = conv((gi0, layers, h0s, c0s, mk))
    before = cuda_stack.lstm_stack_scan_fused.launches
    ys, hl, cl = cuda_stack.stack_scan(*args)
    assert cuda_stack.lstm_stack_scan_fused.launches == before  # CPU: no kernel
    ys_r, cs_r, gates, hu, xu = cuda_stack.lstm_stack_scan_fused_res(*args)
    assert torch.equal(ys, ys_r[-1])
    for l in range(len(layers)):
        assert torch.equal(hl[l], ys_r[l][-1]) and torch.equal(cl[l], cs_r[l][-1])
    n, t, b, h, ranks, xranks, _ = STACK_CASES[case]
    assert [tuple(a.shape) for a in gates] == [(t, b, 4 * h)] * n
    assert [tuple(a.shape) for a in hu] == [(t, b, r) for r in ranks]
    assert [tuple(a.shape) for a in xu] == [(t, b, r) for r in xranks]


# -- grouping ------------------------------------------------------------------

def test_stack_groups_partitions(monkeypatch):
    layers = [{"u": torch.zeros(64, 16), "v": torch.zeros(16, 256)}] * 4
    assert cuda_stack.stack_fits(layers)
    assert cuda_stack.stack_groups(layers) == [(0, 4)]
    monkeypatch.setattr(cuda_stack, "stack_fits", lambda lys: len(lys) <= 2)
    assert cuda_stack.stack_groups(layers) == [(0, 2), (2, 4)]
    monkeypatch.setattr(cuda_stack, "stack_fits", lambda lys: False)
    assert cuda_stack.stack_groups(layers) == [(0, 1), (1, 2), (2, 3), (3, 4)]


def test_stack_fits_is_the_l2_and_depth_criterion():
    """`stack_fits` is the plan's criterion: a `stack_plan` at f32 for one
    row of the group, within the kernels' depth (the name is older than the
    criterion: the factors now live in the SMs' shared memory); a larger
    batch runs in chunks of rows (`stack_chunks`)."""
    def lm_layers(n, h=650, r=300):
        one = {"u": torch.empty(h, r), "v": torch.empty(r, 4 * h)}
        return [one] + [dict(one, ux=one["u"], vx=one["v"]) for _ in range(n - 1)]

    assert cuda_stack.stack_fits(lm_layers(2))        # 11.7 MB of factors over 132 SMs
    assert cuda_stack.stack_fits(lm_layers(3))        # 19.5 MB
    assert not cuda_stack.stack_fits(lm_layers(4))    # 27.3 MB: no plan even for one row
    assert cuda_stack.stack_groups(lm_layers(2)) == [(0, 2)]
    assert cuda_stack.stack_groups(lm_layers(3)) == [(0, 3)]
    assert cuda_stack.stack_groups(lm_layers(4)) == [(0, 3), (3, 4)]
    for n in (2, 3):
        plan = cuda_stack.stack_plan(1, 650, (300,) * n, (300,) * (n - 1))
        assert plan.smem_bytes <= cuda_stack.SMEM_LIMIT
    # 3x650 takes B=20 in one launch, B=128 in four chunks of 32 rows
    assert len(cuda_stack.stack_chunks(20, 650, (300,) * 3, (300,) * 2)) == 1
    assert len(cuda_stack.stack_chunks(128, 650, (300,) * 3, (300,) * 2)) == 4
    small = lm_layers(9, h=16, r=2)
    assert not cuda_stack.stack_fits(small)           # past the kernels' depth
    assert cuda_stack.stack_groups(small) == [(0, 8), (8, 9)]
    assert not cuda_stack.stack_fits(None)


def jax_grouping(monkeypatch):
    """Make the port's stack_fits answer as the JAX package's under the
    VMEM budget the test sets, so that both group the stack alike."""
    def fits(layers):
        return jpp.stack_fits([{k: jnp.asarray(a.detach().numpy()) for k, a in lay.items()}
                               for lay in layers])

    monkeypatch.setattr(cuda_stack, "stack_fits", fits)


@pytest.mark.parametrize("vmem_mb,groups", [(16, [(0, 2), (2, 4)]), (4, [(0, 1), (1, 2), (2, 3),
                                                                         (3, 4)])])
def test_grouped_stack_matches_jax(vmem_mb, groups, monkeypatch):
    jcells, cells = cells_pair("vmlmf", (5, 64, 64, 64, 64), w_rank=8, u_rank=8)
    jparams, params = transplant(jcells)
    xs = np.random.default_rng(1).standard_normal((6, 3, 5)).astype(np.float32)
    ys_seq, fin_seq = RNN(cells, backend="fused")(params, torch.from_numpy(xs), time_major=True)
    monkeypatch.setenv("VMLMF_VMEM_BYTES", str(vmem_mb << 20))
    jax_grouping(monkeypatch)
    preps = [c.prepare(p) for c, p in zip(cells, params)]
    assert cuda_stack.stack_groups(cuda_stack.stack_units(cells, preps)) == groups
    ys_j, fin_j = JaxRNN(jcells, backend="pallas_pipelined")(jparams, jnp.asarray(xs),
                                                             time_major=True)
    ys, fin = RNN(cells, backend="fused_pipelined")(params, torch.from_numpy(xs), time_major=True)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), **FWD_TOL)
    torch.testing.assert_close(ys, ys_seq, **FWD_TOL)
    for (h, c), (hj, cj), (hs, cs) in zip(fin, fin_j, fin_seq):
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), **FWD_TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), **FWD_TOL)
        torch.testing.assert_close(c, cs, **FWD_TOL)


def test_grouped_gradients_and_boundary_masks_match(monkeypatch):
    """A 2+2 grouping with inter-layer masks (inside each group, and at the
    boundary on the handoff) against the ungrouped stack, and its gradients
    against the JAX package's grouped run (without masks: its RNN has none)."""
    jcells, cells = cells_pair("vmlmf", (8, 32, 32, 32, 32), w_rank=4, u_rank=4)
    jparams, params = transplant(jcells)
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((5, 2, 8)).astype(np.float32)
    w = rng.standard_normal((5, 2, 32)).astype(np.float32)

    def jloss(p):
        ys, _ = JaxRNN(jcells, backend="pallas_pipelined")(p, jnp.asarray(xs), time_major=True)
        return jnp.sum(ys * w)

    monkeypatch.setenv("VMLMF_VMEM_BYTES", str(8 << 20))
    g_j = jax.grad(jloss)(jparams)
    jax_grouping(monkeypatch)
    for p in jax.tree_util.tree_leaves(params):
        p.requires_grad_(True)
    ys, _ = RNN(cells, backend="fused_pipelined")(params, torch.from_numpy(xs), time_major=True)
    (ys * torch.from_numpy(w)).sum().backward()
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(params),
                                   jax.tree_util.tree_leaves(g_j))):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), err_msg=str(i), **GRAD_TOL)

    preps = [c.prepare({k: v.detach() for k, v in p.items()}) for c, p in zip(cells, params)]
    masks = [torch.from_numpy(((rng.random((5, 2, 32)) < 0.5) / 0.5).astype(np.float32))
             for _ in range(3)]
    states = [c.state0(2, "cpu") for c in cells]
    monkeypatch.setattr(cuda_stack, "stack_fits", lambda lys: len(lys) <= 2)
    assert cuda_stack.stack_groups(cuda_stack.stack_units(cells, preps)) == [(0, 2), (2, 4)]
    grouped = cuda_stack.run_stack_grouped(cells, preps, torch.from_numpy(xs), states, masks)
    monkeypatch.setattr(cuda_stack, "stack_fits", lambda lys: True)
    whole = cuda_stack.run_stack_grouped(cells, preps, torch.from_numpy(xs), states, masks)
    for a, b in zip(jax.tree_util.tree_leaves(grouped), jax.tree_util.tree_leaves(whole)):
        torch.testing.assert_close(a, b, **FWD_TOL)


# -- the LM, serving and training ----------------------------------------------

VOCAB, HIDDEN, T, B = 40, 16, 7, 3


def lm_pair(backend, jax_backend, layers=2, dropout_rate=0.0, winit=0.3, **kw):
    common = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=layers,
                  dropout_rate=dropout_rate, winit=winit)
    # equal ranks: the "pipelined" schedule stacks the layers' units
    jm = JaxLMModel(cell_factory=lambda n, h: JaxVMLMFCell(n, h, w_rank=5, u_rank=5),
                    backend=jax_backend, **common)
    m = LMModel(cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=5, u_rank=5),
                backend=backend, **common, **kw)
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, jparams, m, params_from_jax(to_np(jparams), device="cpu")


def lm_inputs(layers, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (T, B)).astype(np.int32)
    states = [tuple((0.2 * rng.standard_normal((B, HIDDEN))).astype(np.float32)
                    for _ in range(2)) for _ in range(layers)]
    return ids, states


@pytest.mark.parametrize("layers", [2, 3])
@pytest.mark.parametrize("backend,jax_backend", [("fused_pipelined", "pallas_pipelined"),
                                                 ("pipelined", "pipelined")])
def test_lm_eval_and_gradients_match_jax(backend, jax_backend, layers):
    jm, jparams, m, params = lm_pair(backend, jax_backend, layers)
    ids, states = lm_inputs(layers)
    jstates = [tuple(map(jnp.asarray, s)) for s in states]
    tstates = [tuple(map(torch.from_numpy, s)) for s in states]
    y = np.random.default_rng(2).integers(0, VOCAB, (T, B))

    def jloss(p):
        logits, st = jm.apply(p, jnp.asarray(ids), jstates, train=False)
        lp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(lp, jnp.asarray(y)[..., None], -1).mean()
        return nll + sum(jnp.sum(h * c) for h, c in st), (logits, st)

    (_, (logits_j, st_j)), g_j = jax.value_and_grad(jloss, has_aux=True)(jparams)
    launches = cuda_stack.lstm_stack_scan_fused_res.launches
    for p in jax.tree_util.tree_leaves(params):
        p.requires_grad_(True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the wavefront runs: no fallback warning
        logits, st = m.apply(params, torch.from_numpy(ids).long(), tstates, train=False)
    nll = -torch.log_softmax(logits, -1).gather(-1, torch.from_numpy(y)[..., None]).mean()
    (nll + sum((h * c).sum() for h, c in st)).backward()
    assert cuda_stack.lstm_stack_scan_fused_res.launches == launches  # CPU: no kernel
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), **FWD_TOL)
    for (h, c), (hj, cj) in zip(st, st_j):
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(hj), **FWD_TOL)
        np.testing.assert_allclose(c.detach().numpy(), np.asarray(cj), **FWD_TOL)
    leaves = jax.tree_util.tree_leaves(params)
    for i, (a, b) in enumerate(zip(leaves, jax.tree_util.tree_leaves(g_j))):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), err_msg=str(i), **GRAD_TOL)


def test_train_mode_equals_the_per_layer_path_under_equal_seeds():
    """fused_pipelined draws the masks that fused draws from the same
    generator: the same logits in train mode, and the same parameters after a
    few LMTrainer steps at dropout 0.5."""
    kw = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=3, dropout_rate=0.5, winit=0.3,
              cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=6, u_rank=5))
    models = {be: LMModel(backend=be, **kw) for be in ("fused", "fused_pipelined")}
    params = models["fused"].init(torch.Generator().manual_seed(0), device="cpu")
    ids = torch.from_numpy(lm_inputs(3)[0]).long()
    logits = {be: m.apply(params, ids, m.state0(B, "cpu"), train=True,
                          generator=torch.Generator().manual_seed(5))[0]
              for be, m in models.items()}
    torch.testing.assert_close(logits["fused_pipelined"], logits["fused"], **FWD_TOL)
    assert not torch.allclose(logits["fused"], models["fused"].apply(
        params, ids, models["fused"].state0(B, "cpu"), train=False)[0])

    rng = np.random.default_rng(4)
    chunks = [(rng.integers(0, VOCAB, (T, B)), rng.integers(0, VOCAB, (T, B))) for _ in range(3)]
    trained = {}
    for be, m in models.items():
        tr = LMTrainer(m, batch_size=B, seq_length=T, device="cpu")
        p, states = tr.init(), tr.state0()
        gen = torch.Generator().manual_seed(7)
        for x, y in chunks:
            p, states, _, _ = tr.train_step(p, states, x, y, 1.0, gen)
        trained[be] = p
    for a, b in zip(jax.tree_util.tree_leaves(trained["fused_pipelined"]),
                    jax.tree_util.tree_leaves(trained["fused"])):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_prefill_matches_jax():
    jm, jparams, m, params = lm_pair("fused_pipelined", "pallas_pipelined", winit=1.0)
    ids, states = lm_inputs(2, seed=3)
    lj, sj = JaxDecoder(jm).prefill(jparams, jnp.asarray(ids),
                                    [tuple(map(jnp.asarray, s)) for s in states])
    before = cuda_stack.lstm_stack_scan_fused.launches
    lt, st = Decoder(m).prefill(params, torch.from_numpy(ids).long(),
                                [tuple(map(torch.from_numpy, s)) for s in states])
    assert cuda_stack.lstm_stack_scan_fused.launches == before
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **FWD_TOL)
    for (h, c), (hj, cj) in zip(st, sj):
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), **FWD_TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), **FWD_TOL)


# -- the knob, the builders, the fallbacks -------------------------------------

@pytest.mark.parametrize("backend", ["pipelined", "fused_pipelined"])
def test_wavefront_backends_require_the_knob(backend, monkeypatch):
    monkeypatch.delenv("VMLMF_EXPERIMENTAL_WAVEFRONT")
    with pytest.raises(ValueError, match="VMLMF_EXPERIMENTAL_WAVEFRONT=1"):
        RNN((VMLMFCell(4, 4), VMLMFCell(4, 4)), backend=backend)
    with pytest.raises(ValueError, match="VMLMF_EXPERIMENTAL_WAVEFRONT=1"):
        LMConfig(hidden_size=8, w_rank=2, u_ranks=(2,), backend=backend).build_model(20)
    monkeypatch.setenv("VMLMF_EXPERIMENTAL_WAVEFRONT", "1")
    assert RNN((VMLMFCell(4, 4), VMLMFCell(4, 4)), backend=backend).backend == backend


@pytest.mark.parametrize("backend", ["pipelined", "fused_pipelined"])
def test_config_builders_take_the_wavefront_backends(backend):
    lm = LMConfig(hidden_size=8, w_rank=2, u_ranks=(2,), backend=backend).build_model(20)
    assert lm.backend == lm.rnn.backend == backend
    har = HARConfig(model="vmmodel", layer_sizes=(8, 8), w_rank=2, u_ranks=(2,), backend=backend)
    net = har.build_model()
    assert net.rnn.backend == backend
    params = net.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(3, 6, har.input_size, generator=torch.Generator().manual_seed(1))
    ref = HARConfig(model="vmmodel", layer_sizes=(8, 8), w_rank=2, u_ranks=(2,),
                    backend="loop").build_model()
    torch.testing.assert_close(net.apply(params, x), ref.apply(params, x), **FWD_TOL)


def test_non_uniform_stack_warns_and_still_matches():
    jcells, cells = cells_pair("vmlmf", (8, 8, 12), w_rank=2, u_rank=2)
    jparams, params = transplant(jcells)
    xs = np.random.default_rng(1).standard_normal((4, 2, 8)).astype(np.float32)
    ys_j, _ = JaxRNN(jcells, backend="xla")(jparams, jnp.asarray(xs), time_major=True)
    for backend in ("fused_pipelined", "pipelined"):
        port_pipeline._warned.clear()
        with pytest.warns(UserWarning, match="uniform LSTM-family stack"):
            ys, _ = RNN(cells, backend=backend)(params, torch.from_numpy(xs), time_major=True)
        np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), **FWD_TOL)


@pytest.mark.parametrize("backend", ["pipelined", "fused_pipelined"])
def test_lm_fallback_in_train_mode_draws_the_per_layer_masks(backend):
    """A dense LSTM stack has no units: both wavefront backends run the
    per-layer schedule with the per-layer path's dropout draws."""
    kw = dict(vocab_size=30, hidden_size=8, num_layers=2, dropout_rate=0.5, winit=0.5,
              cell_factory=lambda n, h: LSTMCell(n, h))
    wave, ref = LMModel(backend=backend, **kw), LMModel(backend="loop", **kw)
    params = ref.init(torch.Generator().manual_seed(0), device="cpu")
    ids = torch.randint(0, 30, (6, 3), generator=torch.Generator().manual_seed(1))
    port_pipeline._warned.clear()
    with pytest.warns(UserWarning, match="uniform LSTM-family stack"):
        got, sg = wave.apply(params, ids, wave.state0(3, "cpu"),
                             generator=torch.Generator().manual_seed(2), train=True)
    want, sw = ref.apply(params, ids, ref.state0(3, "cpu"),
                         generator=torch.Generator().manual_seed(2), train=True)
    torch.testing.assert_close(got, want, **FWD_TOL)
    for a, b in zip(sg, sw):
        torch.testing.assert_close(a, b, **FWD_TOL)


def reverse_case():
    jcells, cells = cells_pair("vmlmf", (6, 10, 10), w_rank=3, u_rank=3)
    jparams, params = transplant(jcells)
    xs = np.random.default_rng(2).standard_normal((2, 5, 6)).astype(np.float32)
    return jcells, cells, jparams, params, xs


def route_spy(monkeypatch):
    """Counts of the calls that reach the per-layer no-grad scan, the stack
    and the plain per-layer step."""
    calls = {"scan": 0, "stack": 0, "step": 0}

    def counted(key, fn):
        def spy(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return spy

    monkeypatch.setattr(recurrence, "lstm_scan_fused_xin",
                        counted("scan", recurrence.lstm_scan_fused_xin))
    monkeypatch.setattr(cuda_stack, "stack_scan", counted("stack", cuda_stack.stack_scan))
    monkeypatch.setattr(VMLMFCell, "step", counted("step", VMLMFCell.step))
    return calls


def test_reverse_runs_the_loop_on_the_wavefront_backends(monkeypatch):
    jcells, cells, jparams, params, xs = reverse_case()
    ys_j, _ = JaxRNN(jcells, backend="pipelined")(jparams, jnp.asarray(xs), reverse=True)
    calls = route_spy(monkeypatch)
    with torch.no_grad():
        ys, _ = RNN(cells, backend="pipelined")(params, torch.from_numpy(xs), reverse=True)
    assert calls == {"scan": 0, "stack": 0, "step": 2 * 5}  # "pipelined" has no kernel
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), **FWD_TOL)


def test_reverse_runs_the_fused_scans_on_fused_pipelined(monkeypatch):
    jcells, cells, jparams, params, xs = reverse_case()
    ys_j, _ = JaxRNN(jcells, backend="pallas_pipelined")(jparams, jnp.asarray(xs), reverse=True)
    calls = route_spy(monkeypatch)
    with torch.no_grad():
        ys, _ = RNN(cells, backend="fused_pipelined")(params, torch.from_numpy(xs), reverse=True)
    assert calls == {"scan": 2, "stack": 0, "step": 0}  # one fused scan per layer
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), **FWD_TOL)


def test_stack_costs_count_each_tensor_once():
    t, b, h, ranks, xranks = 7, 3, 10, [3, 5], [4]
    gi0, layers, h0s, c0s, mk = stack_inputs(2, t, b, h, ranks, xranks, True)
    weights = sum(a.size for lay in layers for a in lay.values())
    ops, nbytes = cuda_stack.stack_cost(t, b, h, ranks, xranks, masks=True)
    assert nbytes == 4 * (gi0.size + weights + mk[0].size + 4 * b * h + t * b * h + 4 * b * h)
    assert ops > t * b * 2 * sum(h * r + r * 4 * h for r in ranks + xranks)
    ys, cs, gates, hu, xu = cuda_stack.lstm_stack_fwd_res_plain(
        *jax.tree_util.tree_map(torch.from_numpy, (gi0, layers, h0s, c0s, mk)))
    res = sum(a.numel() for a in [*ys[:-1], *cs, *gates, *hu, *xu])
    _, res_bytes = cuda_stack.stack_res_cost(t, b, h, ranks, xranks, masks=True)
    assert res_bytes == nbytes + 4 * (res - 4 * b * h)
    ops_b, bytes_b = cuda_stack.stack_bwd_cost(t, b, h, ranks, xranks, masks=True)
    assert ops_b > 2 * t * b * 2 * sum(h * r + r * 4 * h for r in ranks + xranks)
    grads = gi0.size + weights + 4 * b * h
    inputs = weights + 4 * b * h + sum(a.numel() for a in [*ys, *cs, *gates, *hu, *xu])
    assert bytes_b == 4 * (inputs + mk[0].size + t * b * h + grads)
    # the LM stack (2x650, r = rx = 300) at B=20: about 8.2 GFLOP a BPTT, a
    # layer's 5.5 of the single-layer scan (x side included) and layer 0's 2.7
    ops_lm, _ = cuda_stack.stack_bwd_cost(35, 20, 650, [300, 300], [300], masks=True)
    assert 8.0e9 < ops_lm < 8.5e9
