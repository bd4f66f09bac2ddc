"""The port's recurrence and LM (`vmlmf_tpu_torch.nn`) against the JAX
package's, with parameters transplanted from a JAX init."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu.cells import VMLMFCell as JaxVMLMFCell  # noqa: E402
from vmlmf_tpu.nn.models import LMModel as JaxLMModel  # noqa: E402
from vmlmf_tpu.nn.recurrence import RNN as JaxRNN  # noqa: E402
from vmlmf_tpu_torch.cells import VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.nn.layers import dropout  # noqa: E402
from vmlmf_tpu_torch.nn.models import LMModel  # noqa: E402
from vmlmf_tpu_torch.nn.recurrence import RNN, scan_layer  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_scan  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
VOCAB, HIDDEN, LAYERS, T, B = 40, 24, 2, 7, 3
BACKENDS = {"fused": "pallas", "loop": "xla"}  # port backend -> JAX backend


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def models(backend, **kw):
    def make(cls, cell, be):
        return cls(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
                   cell_factory=lambda n, h: cell(n, h, w_rank=5, u_rank=4),
                   dropout_rate=0.5, winit=0.3, backend=be, **kw)
    return make(JaxLMModel, JaxVMLMFCell, BACKENDS[backend]), make(LMModel, VMLMFCell, backend)


def lm_inputs(seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (T, B)).astype(np.int32)
    states = [tuple((0.2 * rng.standard_normal((B, HIDDEN))).astype(np.float32)
                    for _ in range(2)) for _ in range(LAYERS)]
    return ids, states


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_lm_apply_matches_jax(backend, tied):
    jm, m = models(backend, tie_embeddings=tied)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(to_np(jparams), device="cpu")
    assert ("w" in params["fc"]) != tied
    ids, states = lm_inputs()
    logits_j, st_j = jm.apply(jparams, jnp.asarray(ids),
                              [tuple(map(jnp.asarray, s)) for s in states], train=False)
    before = cuda_scan.lstm_scan_fused_xin.launches
    logits, st = m.apply(params, torch.from_numpy(ids).long(),
                         [tuple(map(torch.from_numpy, s)) for s in states], train=False)
    assert cuda_scan.lstm_scan_fused_xin.launches == before
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)
    for (h, c), (hj, cj) in zip(st, st_j):
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), **TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), **TOL)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_rnn_matches_jax(backend, reverse):
    sizes = ((9, 20), (20, 12))  # F < h, then F > h
    jrnn = JaxRNN(tuple(JaxVMLMFCell(n, h, w_rank=3, u_rank=5) for n, h in sizes),
                  backend=BACKENDS[backend])
    rnn = RNN(tuple(VMLMFCell(n, h, w_rank=3, u_rank=5) for n, h in sizes), backend=backend)
    jparams = jrnn.init(jax.random.PRNGKey(4))
    params = params_from_jax(to_np(jparams), device="cpu")
    x = np.random.default_rng(5).standard_normal((B, T, 9)).astype(np.float32)  # batch-major
    ys_j, fin_j = jrnn(jparams, jnp.asarray(x), reverse=reverse)
    ys, fin = rnn(params, torch.from_numpy(x), reverse=reverse)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), **TOL)
    for (h, c), (hj, cj) in zip(fin, fin_j):
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), **TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), **TOL)


def test_unknown_backend_and_cell_without_kernel_raise():
    with pytest.raises(ValueError, match="backend"):
        RNN((VMLMFCell(4, 4),), backend="pallas")
    cell = VMLMFCell(4, 4)
    prep = cell.prepare(cell.init(torch.Generator().manual_seed(0), device="cpu"))

    class NoKernel:
        hidden_size = 4

    # a cell with no fused form runs the loop under "fused", as the JAX package
    # runs it on its XLA scan: one without the loop's `inp` raises there
    with pytest.raises(AttributeError, match="inp"):
        scan_layer(NoKernel(), prep, torch.zeros(2, 1, 4), cell.state0(1, "cpu"))


def test_init_matches_jax_tree_and_winit():
    jm, m = models("fused")
    jparams = jm.init(jax.random.PRNGKey(0))
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), to_np(jparams))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), params) == shapes
    leaves = jax.tree_util.tree_leaves(params)
    assert all(float(p.abs().max()) <= m.winit for p in leaves)
    again = m.init(torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(leaves, jax.tree_util.tree_leaves(again)):
        assert torch.equal(a, b)


def test_train_mode_dropout_uses_the_generator():
    _, m = models("loop")
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    ids = torch.from_numpy(lm_inputs()[0]).long()

    def run(seed):
        return m.apply(params, ids, m.state0(B, "cpu"), train=True,
                       generator=torch.Generator().manual_seed(seed))[0]

    eval_logits, _ = m.apply(params, ids, m.state0(B, "cpu"), train=False)
    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert not torch.equal(run(3), eval_logits)
    x = torch.ones(1000)
    y = dropout(x, 0.5, generator=torch.Generator().manual_seed(0), train=True)
    assert set(y.unique().tolist()) == {0.0, 2.0}
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, train=True)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    _, m = models("fused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.state0(B)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"w": np.zeros(2, np.float32)})
