"""Opportunity dataset preparation: the zip's .dat files -> 77 or 113
channels -> windows -> .npy (counterpart of `vmlmf_tpu.data.opp_preprocess`).

Column selection, label remap, per-channel linear interpolation of NaNs,
min/max normalization with the published sensor thresholds, the fixed
train/test file split, then windows of 24 rows every 12. The 77-channel
challenge pipeline drops rows that hold a NaN before interpolating; the
legacy 113-channel one keeps every row and interpolates all of them.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np

from vmlmf_tpu_torch.data import _native
from vmlmf_tpu_torch.data.sliding_window import window_series

NB_SENSOR_CHANNELS = 77
SLIDING_WINDOW_LENGTH = 24
SLIDING_WINDOW_STEP = 12

# train/test file split used by the OPPORTUNITY challenge protocol
TRAIN_FILES = [
    "S1-Drill.dat", "S1-ADL1.dat", "S1-ADL2.dat", "S1-ADL3.dat", "S1-ADL4.dat",
    "S1-ADL5.dat", "S2-Drill.dat", "S2-ADL1.dat", "S2-ADL2.dat", "S2-ADL3.dat",
    "S3-Drill.dat", "S3-ADL1.dat", "S3-ADL2.dat", "S3-ADL3.dat",
]
TEST_FILES = ["S2-ADL4.dat", "S2-ADL5.dat", "S3-ADL4.dat", "S3-ADL5.dat"]

# 172 columns excluded (`preprocess_opp.py:88-97`); raw .dat rows have 250
# columns, the last (index 249) being the gesture label, which survives the
# deletion and lands at position 77 after it.
EXCLUDED_COLUMNS = (
    list(range(0, 37)) + list(range(46, 50)) + list(range(59, 63))
    + list(range(72, 76)) + list(range(85, 89)) + list(range(98, 102))
    + list(range(134, 249))
)

# hardcoded per-sensor normalization thresholds (`preprocess_opp.py:61-78`)
_ACC = [3000, 3000, 3000, 10000, 10000, 10000, 1500, 1500, 1500]
NORM_MAX = (
    _ACC * 5
    + [250, 25, 200] + [5000] * 6 + [10000] * 6
    + [250, 250, 25, 200] + [5000] * 6 + [10000] * 6 + [250]
)
_ACC_MIN = [-3000, -3000, -3000, -10000, -10000, -10000, -1000, -1000, -1000]
NORM_MIN = (
    _ACC_MIN * 5
    + [-250, -100, -200] + [-5000] * 6 + [-10000] * 6
    + [-250, -250, -100, -200] + [-5000] * 6 + [-10000] * 6 + [-250]
)

# gesture label id -> class index 1..17 (0 = null class), `preprocess_opp.py:178-196`
GESTURE_LABEL_MAP = {
    406516: 1, 406517: 2, 404516: 3, 404517: 4, 406520: 5, 404520: 6,
    406505: 7, 404505: 8, 406519: 9, 404519: 10, 406511: 11, 404511: 12,
    406508: 13, 404508: 14, 408512: 15, 407521: 16, 405506: 17,
}
LOCOMOTION_LABEL_MAP = {4: 3, 5: 4}

# ---- legacy 113-channel variant (`preprocess_Opportunity.py`) -------------
# Deletion list keeps 116 of 250 raw columns: timestamp (0), the 113
# challenge channels, the locomotion label (raw 243 -> position 114) and the
# gestures label (raw 249 -> position 115) (`preprocess_Opportunity.py:89-106`).
EXCLUDED_COLUMNS_113 = (
    list(range(46, 50)) + list(range(59, 63)) + list(range(72, 76))
    + list(range(85, 89)) + list(range(98, 102))
    + list(range(134, 243)) + list(range(244, 249))
)

# per-sensor thresholds for the 113 channels (`preprocess_Opportunity.py:59-85`)
_ACC113 = [3000] * 3 + [10000] * 3 + [1500] * 3
NORM_MAX_113 = (
    [3000] * 39 + [10000, 10000, 10000, 1500, 1500, 1500] + _ACC113 * 4
    + [250, 25, 200] + [5000] * 6 + [10000] * 6
    + [250, 250, 25, 200] + [5000] * 6 + [10000] * 6 + [250]
)
_ACC113_MIN = [-3000] * 3 + [-10000] * 3 + [-1000] * 3
NORM_MIN_113 = (
    [-3000] * 39 + [-10000, -10000, -10000, -1000, -1000, -1000] + _ACC113_MIN * 4
    + [-250, -100, -200] + [-5000] * 6 + [-10000] * 6
    + [-250, -250, -100, -200] + [-5000] * 6 + [-10000] * 6 + [-250]
)


def select_columns(data):
    """Keep the 77 OPPORTUNITY-challenge columns (+ the label column which
    survives the deletion at raw index 244 -> position 77)."""
    return np.delete(data, EXCLUDED_COLUMNS, axis=1)


def normalize(x):
    mx = np.asarray(NORM_MAX, np.float32)
    mn = np.asarray(NORM_MIN, np.float32)
    x = (x - mn) / (mx - mn)
    # reference boundary clamp: >1 -> 0.99, <0 -> 0.0 (`preprocess_opp.py:116-117`)
    x = np.where(x > 1.0, np.float32(0.99), x)
    x = np.where(x < 0.0, np.float32(0.0), x)
    return x


def interpolate_nan(x):
    """Per-channel linear interpolation of NaNs; leading/trailing NaNs -> 0."""
    out = x.copy()
    n = len(x)
    idx = np.arange(n)
    for c in range(x.shape[1]):
        col = out[:, c]
        bad = np.isnan(col)
        if bad.any():
            good = ~bad
            if good.any():
                # np.interp holds edge values constant; reference's pandas
                # interpolate leaves leading NaNs (then zeroed) — emulate:
                first = idx[good][0]
                col[bad] = np.interp(idx[bad], idx[good], col[good])
                col[:first][np.isnan(x[:first, c])] = 0.0
            else:
                col[:] = 0.0
            out[:, c] = col
    return np.nan_to_num(out, nan=0.0)


def _remap_labels(y, task):
    mapping = GESTURE_LABEL_MAP if task == "gestures" else LOCOMOTION_LABEL_MAP
    y_out = np.zeros_like(y) if task == "gestures" else y.copy()
    for raw_label, cls in mapping.items():
        y_out[y == raw_label] = cls
    return y_out.astype(np.int32)


def process_file(raw, task="gestures", channels=77):
    """One .dat matrix -> (x [N, channels] normalized f32, y [N] i32).

    channels=77: the 2021 challenge pipeline (`preprocess_opp.py`) — NaN rows
    dropped before interpolation, gesture label at position 77.
    channels=113: the legacy pipeline (`preprocess_Opportunity.py:220-248`) —
    no row dropping, timestamp column discarded, locomotion label at selected
    position 114 / gestures at 115.
    """
    if channels == 77:
        data = select_columns(raw)
        # the reference drops rows with NaN anywhere in the selected matrix
        # (`preprocess_opp.py:121-138`)
        data = data[~np.isnan(data).any(axis=1)]
        x = data[:, :77].astype(np.float32)
        y = data[:, 77].astype(np.int64)
        mn, mx = NORM_MIN, NORM_MAX
    elif channels == 113:
        data = np.delete(raw, EXCLUDED_COLUMNS_113, axis=1)
        x = data[:, 1:114].astype(np.float32)  # col 0 = timestamp
        y = data[:, 114 if task == "locomotion" else 115].astype(np.int64)
        mn, mx = NORM_MIN_113, NORM_MAX_113
    else:
        raise ValueError(f"channels must be 77 or 113, got {channels}")
    y_out = _remap_labels(y, task)
    x = _native.interp_nan_f32(x)
    x = _native.norm_clamp_f32(x, np.asarray(mn, np.float32),
                               np.asarray(mx, np.float32))
    return x, y_out


def generate_npy(zip_path, out_dir, task="gestures", channels=77):
    """Full ETL: OpportunityUCIDataset.zip -> X_/y_{train,test}.npy."""
    os.makedirs(out_dir, exist_ok=True)
    with zipfile.ZipFile(zip_path) as zf:
        split = {"train": TRAIN_FILES, "test": TEST_FILES}
        for mode, files in split.items():
            xs, ys = [], []
            for fn in files:
                member = f"OpportunityUCIDataset/dataset/{fn}"
                try:
                    raw = np.atleast_2d(_native.loadtxt(zf.read(member)))
                except KeyError:
                    continue
                x, y = process_file(raw, task, channels)
                xs.append(x)
                ys.append(y)
            x = np.concatenate(xs)
            y = np.concatenate(ys)
            xw, yw = window_series(x, y, SLIDING_WINDOW_LENGTH, SLIDING_WINDOW_STEP)
            np.save(os.path.join(out_dir, f"X_{mode}.npy"), xw)
            np.save(os.path.join(out_dir, f"y_{mode}.npy"), yw)
    return out_dir
