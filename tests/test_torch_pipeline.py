"""The port's plain wavefront schedule (`vmlmf_tpu_torch.ops.pipeline`,
backend "pipelined") against the JAX package's `ops.pipeline`, with inputs
made by numpy from a seed and parameters transplanted with `params_from_jax`.
Both sit behind VMLMF_EXPERIMENTAL_WAVEFRONT=1, which each test sets."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu.cells import LSTMCell as JaxLSTMCell  # noqa: E402
from vmlmf_tpu.cells import VMLMFCell as JaxVMLMFCell  # noqa: E402
from vmlmf_tpu.ops import pipeline as jpipe  # noqa: E402
from vmlmf_tpu_torch.cells import LSTMCell, VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.nn.layers import dropout_mask  # noqa: E402
from vmlmf_tpu_torch.nn.recurrence import RNN  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_stack, pipeline  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def wavefront(monkeypatch):
    monkeypatch.setenv("VMLMF_EXPERIMENTAL_WAVEFRONT", "1")


def stack(kind, sizes, seed=0, **kw):
    """(JAX cells, JAX params, port cells, port params) of one stack."""
    jcls, cls = {"vmlmf": (JaxVMLMFCell, VMLMFCell), "lstm": (JaxLSTMCell, LSTMCell)}[kind]
    jcells = tuple(jcls(n, h, **kw) for n, h in zip(sizes[:-1], sizes[1:]))
    cells = tuple(cls(n, h, **kw) for n, h in zip(sizes[:-1], sizes[1:]))
    jparams = [c.init(jax.random.PRNGKey(seed + i)) for i, c in enumerate(jcells)]
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcells, jparams, cells, params


def inputs(t, b, n, h, layers, seed=1):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((t, b, n)).astype(np.float32)
    states = [tuple((0.3 * rng.standard_normal((b, h))).astype(np.float32) for _ in range(2))
              for _ in range(layers)]
    return xs, states


CASES = {  # (kind, sizes, T, B, ranks)
    "vmlmf_l2": ("vmlmf", (5, 12, 12), 7, 3, dict(w_rank=4, u_rank=4)),
    "vmlmf_l3": ("vmlmf", (12, 12, 12, 12), 6, 2, dict(w_rank=3, u_rank=3)),
    "lmf_l2": ("lstm", (12, 12, 12), 5, 4, dict(w_rank=4, u_rank=4)),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_pipelined_scan_and_gradients_match_jax(case):
    kind, sizes, t, b, kw = CASES[case]
    jcells, jparams, cells, params = stack(kind, sizes, **kw)
    xs, states = inputs(t, b, sizes[0], sizes[-1], len(cells))
    w = np.random.default_rng(3).standard_normal((t, b, sizes[-1])).astype(np.float32)

    def jloss(p):
        preps = [c.prepare(q) for c, q in zip(jcells, p)]
        ys, fin = jpipe.pipelined_lstm_scan(jcells, preps, jnp.asarray(xs),
                                            [tuple(map(jnp.asarray, s)) for s in states])
        return jnp.sum(ys * w) + sum(jnp.sum(h * c) for h, c in fin), (ys, fin)

    (_, (ys_j, fin_j)), g_j = jax.value_and_grad(jloss, has_aux=True)(jparams)
    for p in jax.tree_util.tree_leaves(params):
        p.requires_grad_(True)
    preps = [c.prepare(p) for c, p in zip(cells, params)]
    assert pipeline.pipelined_available(cells, preps)
    ys, fin = pipeline.pipelined_lstm_scan(cells, preps, torch.from_numpy(xs),
                                           [tuple(map(torch.from_numpy, s)) for s in states])
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j), **FWD_TOL)
    for (h, c), (hj, cj) in zip(fin, fin_j):
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(hj), **FWD_TOL)
        np.testing.assert_allclose(c.detach().numpy(), np.asarray(cj), **FWD_TOL)
    ((ys * torch.from_numpy(w)).sum() + sum((h * c).sum() for h, c in fin)).backward()
    for i, (a, b_) in enumerate(zip(jax.tree_util.tree_leaves(params),
                                    jax.tree_util.tree_leaves(g_j))):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b_), err_msg=str(i), **GRAD_TOL)


def test_rnn_pipelined_matches_the_per_layer_loop():
    _, _, cells, params = stack("vmlmf", (5, 12, 12, 12), w_rank=4, u_rank=4)
    x = torch.from_numpy(inputs(6, 3, 5, 12, 3)[0]).transpose(0, 1)  # batch-major
    ys, fin = RNN(cells, backend="pipelined")(params, x)
    ys_l, fin_l = RNN(cells, backend="loop")(params, x)
    torch.testing.assert_close(ys, ys_l, **FWD_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(fin), jax.tree_util.tree_leaves(fin_l)):
        torch.testing.assert_close(a, b, **FWD_TOL)


def test_unequal_ranks_do_not_pipeline_in_either_package():
    jcells, jparams, cells, params = stack("vmlmf", (10, 10, 10), w_rank=3, u_rank=5)
    jpreps = [c.prepare(p) for c, p in zip(jcells, jparams)]
    preps = [c.prepare(p) for c, p in zip(cells, params)]
    assert not jpipe.pipelined_available(jcells, jpreps)
    assert not pipeline.pipelined_available(cells, preps)
    assert cuda_stack.stack_units(cells, preps) is not None  # the stack kernels take them
    assert not pipeline.pipelined_available(cells[:1], preps[:1])
    with pytest.raises(ValueError, match="pipelineable"):
        pipeline.pipelined_lstm_scan(cells, preps, torch.zeros(3, 2, 10),
                                     [c.state0(2, "cpu") for c in cells])


def test_dropout_draws_a_fresh_mask_per_step_from_the_generator():
    """With a generator, the output of layer l at time t feeding layer l+1 is
    dropped out by slice l of the mask drawn at wavefront step t + l: the
    stack's plain version with those masks gives the same result."""
    _, _, cells, params = stack("vmlmf", (5, 12, 12, 12), w_rank=4, u_rank=4)
    xs, states = inputs(6, 3, 5, 12, 3, seed=4)
    xs = torch.from_numpy(xs)
    states = [tuple(map(torch.from_numpy, s)) for s in states]
    preps = [c.prepare(p) for c, p in zip(cells, params)]
    n, (t, b, h) = len(cells), (6, 3, 12)

    def run(seed, rate=0.4):
        gen = torch.Generator().manual_seed(seed)
        return pipeline.pipelined_lstm_scan(cells, preps, xs, states, dropout_rate=rate,
                                            generator=gen)

    ys, fin = run(11)
    assert torch.equal(ys, run(11)[0]) and not torch.equal(ys, run(12)[0])
    torch.testing.assert_close(run(11, rate=0.0)[0],
                               pipeline.pipelined_lstm_scan(cells, preps, xs, states)[0])
    gen = torch.Generator().manual_seed(11)
    draws = [dropout_mask((n - 1, b, h), 0.4, gen, "cpu") for _ in range(t + n - 1)]
    masks = [torch.stack([draws[s + l][l] for s in range(t)]) for l in range(n - 1)]
    layers = cuda_stack.stack_units(cells, preps)
    gi0 = cells[0].inp(preps[0], xs)
    ys_s, hl, cl = cuda_stack.lstm_stack_scan_fused_plain(
        gi0, cuda_stack._group_layers(layers, 0, n), [s[0] for s in states],
        [s[1] for s in states], masks)
    torch.testing.assert_close(ys, ys_s, **FWD_TOL)
    for (hf, cf), hs, cs in zip(fin, hl, cl):
        torch.testing.assert_close(hf, hs, **FWD_TOL)
        torch.testing.assert_close(cf, cs, **FWD_TOL)
