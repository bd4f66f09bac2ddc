"""The port's copies of the JAX package's host-side data helpers
(`vmlmf_tpu_torch.data`) give the same arrays."""

import numpy as np
import pytest

pytest.importorskip("torch")

from vmlmf_tpu.data import batching as jax_batching  # noqa: E402
from vmlmf_tpu.data import har as jax_har  # noqa: E402
from vmlmf_tpu.data import ptb as jax_ptb  # noqa: E402
from vmlmf_tpu_torch.data import batching, har, ptb  # noqa: E402


@pytest.mark.parametrize("shuffle,drop_last,epoch", [(True, True, 0), (True, True, 3),
                                                     (False, False, 0)])
def test_batch_iterator_gives_the_same_batches(shuffle, drop_last, epoch):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 6, 3)).astype(np.float32)
    y = rng.integers(0, 5, 50).astype(np.int32)
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=3, epoch=epoch)
    want = list(jax_batching.batch_iterator(x, y, 8, **kw))
    got = list(batching.batch_iterator(x, y, 8, **kw))
    assert len(got) == len(want) == (6 if drop_last else 7)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype


@pytest.mark.parametrize("n", [40, 37])
def test_pad_last_batch_is_a_copy(n):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    y = np.arange(n, dtype=np.int32)
    for got, want in zip(batching.pad_last_batch(x, y, 8), jax_batching.pad_last_batch(x, y, 8)):
        np.testing.assert_array_equal(got, want)


def test_ptb_chunks_and_corpus_are_copies(tmp_path):
    corpus = ptb.synthetic_corpus(vocab_size=50, length=3000, seed=4)
    np.testing.assert_array_equal(corpus, jax_ptb.synthetic_corpus(vocab_size=50, length=3000,
                                                                   seed=4))
    got, want = ptb.minibatch(corpus, 7, 9), jax_ptb.minibatch(corpus, 7, 9)
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    for split_g, split_w in zip(ptb.load_or_synthesize(None, vocab_size=30, seed=1),
                                jax_ptb.load_or_synthesize(None, vocab_size=30, seed=1)):
        np.testing.assert_array_equal(split_g, split_w)
    for name, text in (("train", " a b c a"), ("valid", " b a"), ("test", " c c")):
        (tmp_path / f"ptb.{name}.txt").write_text(text)
    for got, want in zip(ptb.data_init(tmp_path), jax_ptb.data_init(tmp_path)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,kw", [("opp", {}), ("opp", dict(channels=12, num_classes=5)),
                                     ("uci", {})])
def test_synthetic_har_is_a_copy(kind, kw):
    got = har.synthetic_har(kind, n_train=30, n_test=10, seed=2, **kw)
    want = jax_har.synthetic_har(kind, n_train=30, n_test=10, seed=2, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert (har.OPP_WINDOW, har.OPP_NUM_FEATURES, har.OPP_NUM_CLASSES) == (
        jax_har.OPP_WINDOW, jax_har.OPP_NUM_FEATURES, jax_har.OPP_NUM_CLASSES)
    with pytest.raises(ValueError, match="UCI"):
        har.synthetic_har("uci", channels=3)
