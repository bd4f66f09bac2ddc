"""Synthetic HAR windows with the real datasets' shapes (counterpart of
`vmlmf_tpu.data.har.synthetic_har`). The file loaders of Opportunity and
UCI-HAR come with the port's host-side slice."""

from __future__ import annotations

import numpy as np

OPP_NUM_FEATURES = 77
OPP_WINDOW = 24
OPP_NUM_CLASSES = 18
UCI_NUM_FEATURES = 9
UCI_WINDOW = 128
UCI_NUM_CLASSES = 6


def synthetic_har(kind="opp", n_train=600, n_test=200, seed=0, channels=None,
                  num_classes=None):
    """Class-separable synthetic sensor windows -> (x_train [N, T, F] f32,
    y_train [N] i32, x_test, y_test).

    Each class gets a random prototype smoothed over time plus noise, so short
    runs show real learning signal. ``channels`` and ``num_classes`` override
    the OPP feature count and label space; UCI shapes are fixed.
    """
    if kind.lower() == "opp":
        t, f, c = OPP_WINDOW, OPP_NUM_FEATURES, OPP_NUM_CLASSES
        f = channels or f
        c = num_classes or c
    else:
        if channels is not None or num_classes is not None:
            raise ValueError(
                "channels/num_classes overrides are OPP legacy-variant knobs "
                "(113-ch / locomotion); UCI shapes are fixed at 128x9, 6 classes")
        t, f, c = UCI_WINDOW, UCI_NUM_FEATURES, UCI_NUM_CLASSES
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(c, t, f)).astype(np.float32)
    k = np.ones(5, np.float32) / 5.0
    protos = np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), 1, protos)

    def make(n):
        y = rng.integers(0, c, size=n).astype(np.int32)
        x = protos[y] + 0.5 * rng.normal(size=(n, t, f)).astype(np.float32)
        return x.astype(np.float32), y

    x_tr, y_tr = make(n_train)
    x_te, y_te = make(n_test)
    return x_tr, y_tr, x_te, y_te
