"""The port's one-dispatch-per-many-steps paths (`utils.graphs.StepGraph` and
its users) on the CPU: the JAX package's defaults of ``fuse_chunks`` and
``fuse_batches``, `LMTrainer.fit` and `HARTrainer.fit` in blocks against the
JAX package's fused ``fit``, and each graphed path's plumbing (static
inputs, carried states, the learning-rate tensor, the decoder's graph
cache) held bit for bit to the step loop.

A CUDA graph captures only on the card. Here the graphed paths run with
`EagerGraph` (from `tests/torch_parallel_worker.py`) in place of
`StepGraph`: the same contract (inputs copied into static tensors, one step
a call), the step run eagerly. The capture itself
and its launch counters are checked with CUDA's graph calls replaced by
stand-ins that run nothing (`test_step_graph_counts_the_launches_that_ran`).
"""

import contextlib
import dataclasses
import gc
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from vmlmf_tpu.cells import VMLMFCell as JaxVMLMFCell  # noqa: E402
from vmlmf_tpu.data.ptb import minibatch, synthetic_corpus  # noqa: E402
from vmlmf_tpu.nn.models import HARNet as JaxHARNet  # noqa: E402
from vmlmf_tpu.nn.models import LMModel as JaxLMModel  # noqa: E402
from vmlmf_tpu.serve import ranker as jr  # noqa: E402
from vmlmf_tpu.train.har import HARTrainer as JaxHARTrainer  # noqa: E402
from vmlmf_tpu.train.lm import LMTrainer as JaxLMTrainer  # noqa: E402
from vmlmf_tpu_torch.cells import VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.data.har import synthetic_har  # noqa: E402
from vmlmf_tpu_torch.nn.models import HARNet, LMModel  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_scan  # noqa: E402
from vmlmf_tpu_torch.serve import Decoder, decoder  # noqa: E402
from vmlmf_tpu_torch.serve import ranker as tr  # noqa: E402
from vmlmf_tpu_torch.train.har import HARTrainer  # noqa: E402
from vmlmf_tpu_torch.train.lm import LMTrainer  # noqa: E402
from vmlmf_tpu_torch.utils import graphs  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402
from vmlmf_tpu_torch.utils.tree import tree_leaves  # noqa: E402

from torch_parallel_worker import EagerGraph  # noqa: E402
from torch_parallel_worker import graphed as graphed_paths  # noqa: E402

# the tolerances of tests/test_torch_train.py
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
HAR_PARAM_TOL = dict(atol=1e-4, rtol=1e-4)

VOCAB, HIDDEN, LAYERS, T, B = 48, 24, 2, 8, 5


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_default(cls, name):
    return {f.name: f.default for f in dataclasses.fields(cls)}[name]


def equal_trees(a, b):
    return all(torch.equal(x.detach(), y.detach()) for x, y in zip(tree_leaves(a),
                                                                   tree_leaves(b)))


@pytest.fixture
def graphed():
    """The graphed paths on the CPU, through `EagerGraph`."""
    with graphed_paths():
        yield EagerGraph


def test_fields_have_the_jax_defaults():
    assert LMTrainer(None).fuse_chunks == jax_default(JaxLMTrainer, "fuse_chunks") == 256
    assert HARTrainer(None).fuse_batches == jax_default(JaxHARTrainer, "fuse_batches") == 64
    assert tr.SparseSampledTrainer(None).fuse_chunks == jax_default(
        jr.SparseSampledTrainer, "fuse_chunks") == 8
    ours = inspect.signature(tr.SessionRanker.sparse_trainer).parameters["fuse_chunks"]
    theirs = inspect.signature(jr.SessionRanker.sparse_trainer).parameters["fuse_chunks"]
    assert ours.default == theirs.default == 8


def lm_pair(dropout=0.0):
    kw = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS, dropout_rate=dropout,
              winit=0.3)
    jm = JaxLMModel(cell_factory=lambda n, h: JaxVMLMFCell(n, h, w_rank=5, u_rank=4),
                    backend="pallas", **kw)
    m = LMModel(cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=5, u_rank=4),
                backend="fused", **kw)
    return jm, m


def lm_data(n_train=7):
    """(train, valid, test) chunks; ``n_train`` training chunks."""
    cut, eval_len = B * (T * n_train + 2), B * (T * 2 + 2)
    corpus = synthetic_corpus(vocab_size=VOCAB, length=cut + 2 * eval_len, seed=2)
    return tuple(minibatch(part, B, T) for part in
                 (corpus[:cut], corpus[cut : cut + eval_len], corpus[cut + eval_len :]))


def test_lm_fit_in_blocks_matches_jax_fit():
    """fuse_chunks=3 over 7 chunks: two blocks and a chunk left over, two epochs."""
    jm, m = lm_pair()
    data = lm_data()
    assert len(data[0]) == 7
    jt = JaxLMTrainer(jm, batch_size=B, seq_length=T, fuse_chunks=3, factor_epoch=0)
    t = LMTrainer(m, batch_size=B, seq_length=T, fuse_chunks=3, factor_epoch=0, device="cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(to_np(jparams), device="cpu")
    _, jhist = jt.fit(jparams, data, epochs=2, log_fn=None)
    logs = []
    _, hist = t.fit(params, data, epochs=2, log_every=1, log_fn=logs.append)
    for got, want in zip(hist, jhist):
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], **STEP_TOL, err_msg=k)
    assert [line.split(",")[0] for line in logs if line.startswith("chunks")] == [
        "chunks 3/7", "chunks 6/7"] * 2


def test_har_fit_in_blocks_matches_jax_fit():
    """fuse_batches=3 over 4 batches an epoch: a block and a batch left over."""
    n_feat, hidden, classes = 12, 20, 5
    jmodel = JaxHARNet(n_feat, (hidden,), num_classes=classes, backend="pallas",
                       cell_factory=lambda n, h: JaxVMLMFCell(n, h, w_rank=4, u_rank=3))
    model = HARNet(n_feat, (hidden,), num_classes=classes, backend="fused",
                   cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=4, u_rank=3))
    x_tr, y_tr, _, _ = synthetic_har("opp", n_train=40, n_test=2, seed=1, channels=n_feat,
                                     num_classes=classes)
    x_tr = x_tr[:, :8]
    jt = JaxHARTrainer(jmodel, batch_size=9, fuse_batches=3)
    t = HARTrainer(model, batch_size=9, fuse_batches=3, device="cpu")
    jparams, jopt = jt.init()
    params = params_from_jax(to_np(jparams), device="cpu")
    jparams, _, jhist = jt.fit(jparams, jopt, x_tr, y_tr, epochs=2, log_fn=None)
    params, _, hist = t.fit(params, t.optimizer(params), x_tr, y_tr, epochs=2, log_fn=None)
    for got, want in zip(hist, jhist):
        np.testing.assert_allclose(got["loss"], want["loss"], **STEP_TOL)
    want = jax.tree_util.tree_leaves(to_np(jparams))
    for got, w in zip(tree_leaves(params), want):
        np.testing.assert_allclose(got.detach().numpy(), w, **HAR_PARAM_TOL)


def lm_chunks(k, seed=3):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, VOCAB, (k, T, B))).long(),
            torch.from_numpy(rng.integers(0, VOCAB, (k, T, B))).long())


def step_loop(t, params, states, xs, ys, lr, generator):
    losses, gnorms = [], []
    for x, y in zip(xs, ys):
        params, states, loss, gnorm = t.train_step(params, states, x, y, lr, generator)
        losses.append(loss)
        gnorms.append(gnorm)
    return params, states, torch.stack(losses), torch.stack(gnorms)


@pytest.mark.parametrize("path", ["eager", "graphed"])
def test_lm_fused_and_eval_chunks_equal_the_step_loop(request, path):
    """With dropout drawn from a generator; twice, so that the second call
    reuses the first's graph with its states and learning rate refreshed."""
    if path == "graphed":
        request.getfixturevalue("graphed")
    _, m = lm_pair(dropout=0.3)
    t = LMTrainer(m, batch_size=B, seq_length=T, device="cpu")
    xs, ys = lm_chunks(4)
    pa, pb = t.init(), t.init()
    sa, sb = t.state0(), t.state0()
    ga, gb = (torch.Generator().manual_seed(9) for _ in range(2))
    for lr in (0.7, 0.4):
        pa, sa, la, na = t._fused_chunks(pa, sa, xs, ys, lr, ga)
        pb, sb, lb, nb = step_loop(t, pb, sb, xs, ys, lr, gb)
        assert torch.equal(la, lb) and torch.equal(na, nb)
        assert equal_trees(pa, pb) and equal_trees(sa, sb)
    losses, s_eval = t._eval_chunks(pa, t.state0(), xs, ys)
    s_loop, want = t.state0(), []
    for x, y in zip(xs, ys):
        loss, s_loop = t._eval_step(pb, x, y, s_loop)
        want.append(loss)
    assert torch.equal(losses, torch.stack(want)) and equal_trees(s_eval, s_loop)
    if path == "graphed":  # one train graph, one eval graph: the second call captured nothing
        assert [g.calls for g in EagerGraph.made] == [8, 4]


def test_lm_fit_graphed_equals_fit_stepping(graphed):
    _, m = lm_pair(dropout=0.3)
    data = lm_data(n_train=5)
    hists = []
    for fuse in (2, 1):
        t = LMTrainer(m, batch_size=B, seq_length=T, fuse_chunks=fuse, device="cpu")
        params, hist = t.fit(t.init(), data, epochs=2, log_fn=None)
        hists.append((params, hist))
    (pa, ha), (pb, hb) = hists
    assert ha == hb and equal_trees(pa, pb)
    # the first trainer's train blocks (2 epochs of 2 blocks of 2), then each
    # trainer's eval graph (2 chunks of valid an epoch, 2 of test)
    assert [g.calls for g in graphed.made] == [8, 6, 6]


@pytest.mark.parametrize("path", ["eager", "graphed"])
def test_har_fused_steps_equal_the_step_loop(request, path):
    if path == "graphed":
        request.getfixturevalue("graphed")
    model = HARNet(6, (10,), num_classes=4, backend="fused",
                   cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=3, u_rank=2))
    t = HARTrainer(model, batch_size=5, device="cpu")
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((3, 5, 7, 6)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 4, (3, 5)))
    (pa, oa), (pb, ob) = t.init(), t.init()
    pa, oa, la = t._fused_steps(pa, oa, xs, ys)
    lb = []
    for x, y in zip(xs, ys):
        pb, ob, loss = t.train_step(pb, ob, x, y)
        lb.append(loss)
    assert torch.equal(la, torch.stack(lb)) and equal_trees(pa, pb)


def test_har_fit_graphed_equals_fit_stepping(graphed):
    model = HARNet(6, (10,), num_classes=4, backend="fused",
                   cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=3, u_rank=2))
    x, y, _, _ = synthetic_har("opp", n_train=27, n_test=2, seed=1, channels=6, num_classes=4)
    out = []
    for fuse in (2, 1):
        t = HARTrainer(model, batch_size=5, fuse_batches=fuse, device="cpu")
        params, opt = t.init()
        params, _, hist = t.fit(params, opt, x[:, :7], y, epochs=2, log_fn=None)
        out.append((params, [h["loss"] for h in hist]))
    assert out[0][1] == out[1][1] and equal_trees(out[0][0], out[1][0])
    assert [g.calls for g in graphed.made] == [2 * 4]  # 5 batches an epoch: 2 blocks of 2


@pytest.mark.parametrize("given", [False, True], ids=["drawn", "given_negatives"])
def test_ranker_fused_chunks_graphed_equal_stepping(graphed, given):
    prk = tr.SessionRanker.create(128, hidden_size=16, num_layers=1, w_rank=4, u_rank=4,
                                  dropout_rate=0.2)
    t = prk.sparse_trainer(batch_size=4, seq_length=5, sampled_softmax=16, device="cpu")
    xs = np.random.RandomState(1).randint(0, 128, (3, 5, 4))
    ys = (xs * 3 + 7) % 128
    negs = np.random.RandomState(2).randint(0, 128, (3, 16)) if given else None
    pa, pb = t.init(), t.init()
    sa, sb = t.state0(), t.state0()
    ga, gb = (torch.Generator().manual_seed(4) for _ in range(2))
    pa, sa, la, na = t.fused_chunks(pa, sa, xs, ys, 0.5, ga, negatives=negs)
    for i in range(3):
        pb, sb, loss, gnorm = t.train_step(pb, sb, xs[i], ys[i], 0.5, gb,
                                           None if negs is None else negs[i])
        assert torch.equal(la[i], loss) and torch.equal(na[i], gnorm)
    assert equal_trees(pa, pb) and equal_trees(sa, sb)
    assert [g.calls for g in graphed.made] == [3]


def test_lr_as_a_tensor_gives_the_bits_of_the_float():
    _, m = lm_pair()
    t = LMTrainer(m, batch_size=B, seq_length=T, device="cpu")
    xs, ys = lm_chunks(2)
    out = []
    for lr in (0.7, torch.tensor(0.7, dtype=torch.float32)):
        p, s = t.init(), t.state0()
        for x, y in zip(xs, ys):
            p, s, _, _ = t.train_step(p, s, x, y, lr)
        out.append(p)
    assert equal_trees(*out)
    prk = tr.SessionRanker.create(64, hidden_size=16, num_layers=1, w_rank=4, u_rank=4)
    st = prk.sparse_trainer(batch_size=4, seq_length=5, sampled_softmax=8, device="cpu")
    x = np.random.RandomState(0).randint(0, 64, (5, 4))
    out = []
    for lr in (0.3, torch.tensor(0.3, dtype=torch.float32)):
        p = st.init()
        p, _, _, _ = st.train_step(p, st.state0(), x, (x + 1) % 64, lr,
                                   negatives=np.arange(8))
        out.append(p)
    assert equal_trees(*out)


def serve_model(head_bf16=False):
    return LMModel(vocab_size=VOCAB, hidden_size=16, num_layers=2, dropout_rate=0.0, winit=1.0,
                   head_bf16=head_bf16, backend="fused",
                   cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=4, u_rank=3))


def prompt(b=3):
    return torch.from_numpy(np.random.default_rng(1).integers(0, VOCAB, (6, b))).long()


@pytest.mark.parametrize("head_bf16", [False, True], ids=["f32", "bf16_head"])
def test_decode_equals_the_per_token_loop(head_bf16):
    """The decode step (the head weight made once a call) against the loop it
    replaces: the head through `LMModel._logits`, cast at every token."""
    m = serve_model(head_bf16)
    dec = Decoder(m)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    logits, states = dec.prefill(params, prompt(), m.state0(3, "cpu"))
    tokens, got_states, got_logits = dec.decode(params, logits, states, steps=5,
                                                return_logits=True)
    preps = dec._preps(params)
    want = []
    with torch.inference_mode():
        for _ in range(5):
            tok = torch.argmax(logits, -1)
            x = m.embed(params["embed"], tok)
            new = []
            for cell, prep, s in zip(m.rnn.cells, preps, states):
                s, x = cell.step(prep, cell.inp(prep, x), s)
                new.append(s)
            logits, states = m._logits(params, x), new
            want.append(tok)
    assert torch.equal(tokens, torch.stack(want)) and torch.equal(got_logits, logits)
    assert equal_trees(got_states, states)


@pytest.mark.parametrize("mode", ["greedy", "top_k", "beam"])
def test_decoder_graphs_equal_eager_and_are_cached(graphed, mode):
    m = serve_model()
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    eager, cached = Decoder(m), Decoder(m)

    def run(dec, p, seed=2):
        if mode == "beam":
            return dec.beam_search(p, prompt(), steps=5, beams=3)
        logits, states = dec.prefill(p, prompt(), m.state0(3, "cpu"))
        kw = {} if mode == "greedy" else dict(temperature=0.8, top_k=5,
                                              generator=torch.Generator().manual_seed(seed))
        return dec.decode(p, logits, states, steps=6, return_logits=True, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decoder, "on_card", lambda device: False)
        want = run(eager, params)
    got = run(cached, params)
    assert all(equal_trees(a, b) for a, b in zip(got, want))
    # one graph of the token step, one of the prefill, each in its own cache
    assert len(graphed.made) == 2 and len(cached._graphs) == len(cached._prefills) == 1
    if mode != "beam":  # a second call (top-k: a new generator) captures nothing
        assert all(equal_trees(a, b) for a, b in zip(run(cached, params), want))
        assert len(graphed.made) == 2
    other = m.init(torch.Generator().manual_seed(0), device="cpu")  # new tensors, same values
    again = run(cached, other)
    assert all(equal_trees(a, b) for a, b in zip(again, want)) and len(graphed.made) == 4


def test_step_graph_raises_on_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        graphs.StepGraph(lambda x: (x,), (torch.zeros(2),), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        graphs.StepGraph(lambda x: (x,), (torch.zeros(2),), device="cuda")


class _FakeGraph:
    """`torch.cuda.CUDAGraph` where capture records and a replay runs nothing."""

    def register_generator_state(self, generator):
        pass

    def replay(self):
        pass


class _FakeStream:
    def wait_stream(self, other):
        pass


def test_step_graph_counts_the_launches_that_ran(monkeypatch):
    """Warm-up steps ran their launches; capture counts none; each replay
    adds the captured step's. The garbage collector is off during capture."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", lambda g, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    fwd, bwd = cuda_scan.lstm_scan_fused_xin_res, cuda_scan.lstm_scan_xin_bwd

    collecting = []

    def step():
        collecting.append(gc.isenabled())
        cuda_scan._counted(fwd, "f32")
        cuda_scan._counted(bwd, "f32")
        cuda_scan._counted(bwd, "f32")
        return ()

    before = (fwd.launches, bwd.launches, fwd.variants["f32"])
    g = graphs.StepGraph(step, device="cuda")
    assert graphs.WARMUP == 2
    for _ in range(2):
        g()
    assert not g.captured
    assert (fwd.launches, bwd.launches) == (before[0] + 2, before[1] + 4)
    for _ in range(3):
        g()
    assert g.captured
    assert (fwd.launches, bwd.launches) == (before[0] + 5, before[1] + 10)
    assert fwd.variants["f32"] == before[2] + 5
    # no collection during capture (a graph freed then would end it)
    assert collecting == [True, True, False] and gc.isenabled()
