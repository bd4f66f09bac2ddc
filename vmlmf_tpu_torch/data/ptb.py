"""Penn Treebank word-level LM pipeline: vocabulary, ids, TBPTT chunks, and a
synthetic corpus for runs without the dataset (counterpart of
`vmlmf_tpu.data.ptb`).

The vocabulary comes from the training split only (sorted unique tokens);
the leading character of each file is dropped before splitting on spaces;
ids are cut into ``[T, B]`` (x, y) chunks with y = x shifted by one, and
only full-length chunks are kept, since perplexity depends on it.
"""

from __future__ import annotations

import os

import numpy as np


def tokenize(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    return text[1:].split(" ")


def data_init(data_dir):
    """-> (train_ids, valid_ids, test_ids, vocab_size) as int32 arrays."""
    trn = tokenize(os.path.join(data_dir, "ptb.train.txt"))
    vld = tokenize(os.path.join(data_dir, "ptb.valid.txt"))
    tst = tokenize(os.path.join(data_dir, "ptb.test.txt"))
    words = sorted(set(trn))
    table = {w: i for i, w in enumerate(words)}

    def to_ids(toks):
        return np.array([table[t] for t in toks], np.int32)

    return to_ids(trn), to_ids(vld), to_ids(tst), len(words)


def minibatch(ids, batch_size, seq_length):
    """-> list of (x [T, B], y [T, B]) int32 pairs (full chunks only)."""
    ids = np.asarray(ids, np.int32).reshape(-1)
    num_batches = len(ids) // batch_size
    data = ids[: num_batches * batch_size].reshape(batch_size, -1)
    out = []
    n = data.shape[1]
    for i in range(0, n - 1, seq_length):
        seqlen = min(seq_length, n - 1 - i)
        if seqlen < n - 1 - i:  # the final partial chunk is dropped
            x = data[:, i : i + seqlen].T
            y = data[:, i + 1 : i + seqlen + 1].T
            out.append((np.ascontiguousarray(x), np.ascontiguousarray(y)))
    return out


def synthetic_corpus(vocab_size=1000, length=120_000, seed=0):
    """Markov corpus with Zipf unigrams: learnable structure for smoke runs."""
    rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, vocab_size + 1) ** 1.1
    base /= base.sum()
    # sparse transition structure: each token prefers a few successors
    succ = rng.integers(0, vocab_size, size=(vocab_size, 4))
    ids = np.empty(length, np.int32)
    ids[0] = 0
    u = rng.random(length)
    jump = rng.integers(0, 4, size=length)
    background = rng.choice(vocab_size, size=length, p=base)
    for i in range(1, length):
        ids[i] = succ[ids[i - 1], jump[i]] if u[i] < 0.7 else background[i]
    return ids


def load_or_synthesize(data_dir=None, vocab_size=1000, seed=0):
    """Real PTB when present, the synthetic corpus (split 80/10/10) otherwise.

    -> (trn, vld, tst, vocab_size)
    """
    if data_dir and os.path.isfile(os.path.join(data_dir, "ptb.train.txt")):
        return data_init(data_dir)
    corpus = synthetic_corpus(vocab_size=vocab_size, seed=seed)
    n = len(corpus)
    return (corpus[: int(n * 0.8)], corpus[int(n * 0.8) : int(n * 0.9)],
            corpus[int(n * 0.9) :], vocab_size)
