"""HAR datasets (counterpart of `vmlmf_tpu.data.har`): the Opportunity
windows prepared as .npy files (`opp_preprocess.generate_npy`), UCI-HAR's
raw text files, and synthetic windows with the real datasets' shapes for
runs without either. Everything comes back as numpy arrays; the trainers
move batches to the device.
"""

from __future__ import annotations

import os

import numpy as np

UCI_SIGNALS = (
    "body_acc_x_", "body_acc_y_", "body_acc_z_",
    "body_gyro_x_", "body_gyro_y_", "body_gyro_z_",
    "total_acc_x_", "total_acc_y_", "total_acc_z_",
)

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


def load_opp(folder):
    """-> (x_train [N, 24, F] f32, y_train [N] i32, x_test, y_test) from
    ``X_{train,test}.npy`` and ``y_{train,test}.npy`` in ``folder``."""
    out = []
    for mode in ("train", "test"):
        x = np.load(os.path.join(folder, f"X_{mode}.npy")).astype(np.float32)
        y = np.load(os.path.join(folder, f"y_{mode}.npy")).astype(np.int32)
        out += [x, y]
    return tuple(out)


def _parse_signal_file(path):
    from vmlmf_tpu_torch.data import _native

    return np.atleast_2d(_native.loadtxt(path)).astype(np.float32)


def load_uci(folder):
    """-> (x_train [N, 128, 9] f32, y_train [N] i32, x_test, y_test) from
    UCI-HAR's folder: the nine inertial signals of each split, and its
    1-based labels made 0-based."""
    out = []
    for mode in ("train", "test"):
        sigs = [_parse_signal_file(os.path.join(folder, mode, "Inertial Signals",
                                                f"{s}{mode}.txt")) for s in UCI_SIGNALS]
        x = np.stack(sigs, axis=-1)
        with open(os.path.join(folder, mode, f"y_{mode}.txt"), encoding="utf-8") as f:
            y = np.array([int(line.strip()) for line in f], np.int32) - 1
        out += [x.astype(np.float32), y]
    return tuple(out)


def load_or_synthesize(kind, folder=None, **kw):
    """The dataset in ``folder`` when it holds one (``kind`` "opp" or "uci"),
    else `synthetic_har(kind, **kw)`."""
    if folder and os.path.isdir(folder):
        loader = load_opp if kind.lower() == "opp" else load_uci
        try:
            return loader(folder)
        except FileNotFoundError:
            pass
    return synthetic_har(kind, **kw)
