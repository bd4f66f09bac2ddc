"""Fault 12: the port's training on the CPU repeats from run to run.

An embedding lookup ``w[ids]`` backpropagates through
``index_put_(accumulate=True)``, which on a CPU tensor adds the rows of one
id with atomics across threads, so two equal steps could end at different
bits. The port gathers and scatters CPU rows through ``index_select`` and
``index_add_`` (`vmlmf_tpu_torch.utils.rows`), which sum each row's
contributions in one order. Each test here runs one step from equal
parameters and generators five times in one process, with several intra-op
threads, and asks for equal bits every time. No JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vmlmf_tpu_torch.config import LMConfig  # noqa: E402
from vmlmf_tpu_torch.serve import ranker as tr  # noqa: E402
from vmlmf_tpu_torch.train.lm import LMTrainer  # noqa: E402
from vmlmf_tpu_torch.utils import rows  # noqa: E402
from vmlmf_tpu_torch.utils.tree import tree_leaves  # noqa: E402

T, B = 35, 20      # PTB's chunk
REPEATS = 5


@pytest.fixture
def threads():
    """Eight intra-op threads for the test's duration, the count restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(8)
    yield
    torch.set_num_threads(before)


def chunk(vocab, seed):
    """Token ids drawn as words are, by a Zipf law (PTB's frequent words
    repeat within a chunk): the repeats are where the sums could race."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.zipf(1.3, (T, B)) - 1) % vocab).long()
                 for _ in range(2))


def digests(run):
    """The bytes of every tensor ``run()`` returns, over REPEATS calls."""
    return [b"".join(t.detach().contiguous().numpy().tobytes() for t in run())
            for _ in range(REPEATS)]


def test_lm_train_step_repeats_bit_for_bit(threads):
    vocab = 1000
    model = LMConfig(lstm_type="custom", hidden_size=64, layer_num=2, dropout=0.5,
                     winit=0.1).build_model(vocab)
    trainer = LMTrainer(model, batch_size=B, seq_length=T, device="cpu")
    x, y = chunk(vocab, 0)

    def run():
        params = trainer.init()
        params, _, loss, gnorm = trainer.train_step(params, trainer.state0(), x, y, 1.0,
                                                    torch.Generator().manual_seed(3))
        return [*tree_leaves(params), loss, gnorm]

    got = digests(run)
    assert got.count(got[0]) == REPEATS


def test_sparse_ranker_step_repeats_bit_for_bit(threads):
    items = 1000
    ranker = tr.SessionRanker.create(items, hidden_size=64, num_layers=1, w_rank=16,
                                     u_rank=16, tie_items=True, backend="fused")
    trainer = ranker.sparse_trainer(batch_size=B, seq_length=T, sampled_softmax=128,
                                    device="cpu")
    x, y = chunk(items, 1)

    def run():
        params = trainer.init()
        params, _, loss, gnorm = trainer.train_step(params, trainer.state0(), x, y, 0.5,
                                                    torch.Generator().manual_seed(4))
        return [*tree_leaves(params), loss, gnorm]

    got = digests(run)
    assert got.count(got[0]) == REPEATS


@pytest.mark.parametrize("shape", [(1000,), (1000, 48)])
def test_take_rows_and_add_rows_equal_indexing(threads, shape):
    """The CPU routes compute what ``w[ids]`` and ``index_put_(accumulate=
    True)`` compute, and repeat."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(shape, generator=gen)
    ids = torch.randint(0, shape[0], (T, B), generator=gen)
    assert torch.equal(rows.take_rows(w, ids), w[ids])
    upd = torch.randn((T * B,) + shape[1:], generator=gen)
    flat = ids.reshape(-1)
    want = torch.zeros_like(w).index_put_((flat,), upd, accumulate=True)
    got = [rows.add_rows(torch.zeros_like(w), flat, upd) for _ in range(REPEATS)]
    torch.testing.assert_close(got[0], want, atol=1e-5, rtol=1e-5)
    assert all(torch.equal(g, got[0]) for g in got)
    cot = torch.randn((T, B) + shape[1:], generator=gen)
    grads = []
    for _ in range(REPEATS):
        leaf = w.clone().requires_grad_()
        (rows.take_rows(leaf, ids) * cot).sum().backward()
        grads.append(leaf.grad)
    assert all(torch.equal(g, grads[0]) for g in grads)
