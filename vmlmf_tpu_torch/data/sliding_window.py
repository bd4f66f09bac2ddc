"""Strided sliding windows over NumPy arrays (counterpart of
`vmlmf_tpu.data.sliding_window`): `sliding_window` is the one-axis case the
pipelines use (the native library's copy, or a zero-copy view), and
`sliding_window_nd` the general form with a window size and a step per
dimension.
"""

from __future__ import annotations

import numpy as np


def norm_shape(shape):
    """Normalize an int or iterable of ints to a shape tuple
    (`sliding_window.py:34-55` parity)."""
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    try:
        return tuple(int(s) for s in shape)
    except (TypeError, ValueError):
        raise TypeError("shape must be an int, or a tuple of ints") from None


def sliding_window_nd(a: np.ndarray, ws, ss=None, flatten: bool = True) -> np.ndarray:
    """n-dimensional sliding windows: per-dimension window sizes ``ws`` and
    steps ``ss`` (defaults to non-overlapping, ss=ws).

    Semantics match the reference utility (`sliding_window.py:57-110`): the
    result has one leading axis per input dimension — the number of window
    positions, ``(shape - ws) // ss + 1`` — followed by the window shape
    ``ws``.  ``flatten=True`` squeezes singleton axes (the reference's
    "flatten" is an ``np.squeeze``, it does not merge slice axes).
    """
    ws = norm_shape(ws)
    ss = norm_shape(ss if ss is not None else ws)
    if not (a.ndim == len(ws) == len(ss)):
        raise ValueError(
            f"a.shape, ws and ss must all have the same length: "
            f"{[a.ndim, len(ws), len(ss)]}")
    if any(w > s for w, s in zip(ws, a.shape)):
        raise ValueError(
            f"ws cannot be larger than a in any dimension: a.shape "
            f"{a.shape}, ws {ws}")
    view = np.lib.stride_tricks.sliding_window_view(a, ws)
    out = view[tuple(slice(None, None, s) for s in ss)]
    if flatten:
        return np.squeeze(out)
    return out


def sliding_window(a: np.ndarray, window: int, step: int) -> np.ndarray:
    """Windows of length `window` every `step` rows along axis 0.

    [N, ...] -> [num_windows, window, ...]; trailing remainder is dropped
    (matching the reference's truncating behavior).
    """
    if len(a) < window:
        return np.empty((0, window) + a.shape[1:], a.dtype)
    if a.ndim == 2 and a.dtype == np.float32 and a.flags.c_contiguous:
        from vmlmf_tpu_torch.data import _native

        if _native.get_lib() is not None:  # native memcpy path
            return _native.sliding_window_f32(a, window, step)
    view = np.lib.stride_tricks.sliding_window_view(a, window, axis=0)
    # sliding_window_view puts the window axis last; move next to batch
    view = np.moveaxis(view, -1, 1)
    return np.ascontiguousarray(view[::step])


def window_series(x: np.ndarray, y: np.ndarray, window: int, step: int):
    """Segment a labelled sensor stream: features get full windows, the label
    of a window is its last row's label (`preprocess_opp.py:357-368`)."""
    xw = sliding_window(x, window, step)
    yw = sliding_window(y, window, step)[:, -1]
    return xw.astype(np.float32), yw.astype(np.int32)
