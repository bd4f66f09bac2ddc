"""Seeded shuffling, drop-last batching, padded evaluation batches and
prefetching to the device (counterpart of `vmlmf_tpu.data.batching`)."""

from __future__ import annotations

import collections

import numpy as np
import torch

from vmlmf_tpu_torch.utils.device import resolve_device


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


def prefetch_to_device(iterator, size=2, device="cuda"):
    """Yield the batches of ``iterator`` (tuples or lists of numpy arrays or
    tensors) as tensors on ``device``, up to ``size`` batches ahead.

    On a CUDA device each batch is copied from pinned host memory with
    ``non_blocking`` copies on a side stream, so the copy of batch k+1
    overlaps the step on batch k; the current stream waits on each batch's
    copy event before the batch is yielded, and each tensor is recorded on
    that stream so that its memory is not reused too early. On the CPU the
    batches are converted in order.
    """
    dev = resolve_device(device)
    queue = collections.deque()
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(batch):
        kind = tuple if isinstance(batch, tuple) else list
        if side is None:
            return kind(torch.as_tensor(a) for a in batch), None
        with torch.cuda.stream(side):
            moved = kind(torch.as_tensor(a).pin_memory().to(dev, non_blocking=True)
                         for a in batch)
            done = torch.cuda.Event()
            done.record(side)
        return moved, done

    def take():
        moved, done = queue.popleft()
        if done is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(done)
            for a in moved:
                a.record_stream(stream)
        return moved

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) > size:
            yield take()
    while queue:
        yield take()
