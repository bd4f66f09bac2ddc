"""Seeded shuffling, drop-last batching and padded evaluation batches
(counterpart of `vmlmf_tpu.data.batching`)."""

from __future__ import annotations

import numpy as np


def batch_iterator(x, y, batch_size, *, shuffle, drop_last, seed=None, epoch=0):
    """Yield (x_batch, y_batch) numpy pairs.

    With ``shuffle``, the permutation comes from ``np.random.default_rng(seed *
    100003 + epoch)``, the JAX package's, so both give the same batches.
    ``drop_last`` keeps every batch the same shape.
    """
    n = len(x)
    idx = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(None if seed is None else seed * 100003 + epoch)
        rng.shuffle(idx)
    end = (n // batch_size) * batch_size if drop_last else n
    for s in range(0, end, batch_size):
        b = idx[s : s + batch_size]
        yield np.ascontiguousarray(x[b]), np.ascontiguousarray(y[b])


def pad_last_batch(x, y, batch_size):
    """Pad the tail batch to full size with copies of the last row -> (x, y,
    mask), where the mask marks the real rows, so that evaluation keeps one
    batch shape."""
    n = len(x)
    rem = n % batch_size
    if rem == 0:
        return x, y, np.ones(n, bool)
    pad = batch_size - rem
    xp = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
    yp = np.concatenate([y, np.repeat(y[-1:], pad, axis=0)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return xp, yp, mask
