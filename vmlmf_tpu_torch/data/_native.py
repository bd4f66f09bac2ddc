"""ctypes binding of the repo's native host-data library
(``native/vmlmf_native.cpp``; counterpart of `vmlmf_tpu.data._native`).

The library is the parsing and windowing tier of the host: it never touches
the card. It is built on first use with ``make -C native`` (g++, no
dependencies) and loaded lazily; every entry has a NumPy version with the
same results, used where the library cannot be built or loaded, or under
``VMLMF_NO_NATIVE=1``.
"""

from __future__ import annotations

import ctypes
import functools
import io
import os
import subprocess
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native")
_SO = os.path.join(_NATIVE_DIR, "libvmlmf_native.so")
ABI_VERSION = 1

_i64 = ctypes.c_int64
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)

_SIGNATURES = {
    "count_matrix": (_i64, [ctypes.c_char_p, _i64, _i64p]),
    "parse_matrix_f64": (_i64, [ctypes.c_char_p, _i64, _f64p, _i64]),
    "sliding_window_f32": (None, [_f32p, _i64, _i64, _i64, _i64, _f32p]),
    "interp_nan_f32": (None, [_f32p, _i64, _i64]),
    "gather_rows_f32": (None, [_f32p, _i64p, _i64, _i64, _f32p]),
    "gather_rows_i32": (None, [_i32p, _i64p, _i64, _i64, _i32p]),
    "norm_clamp_f32": (None, [_f32p, _i64, _i64, _f32p, _f32p]),
    "vmlmf_native_abi_version": (ctypes.c_int, []),
}


def _build():
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True,
                       timeout=120)
        return True
    except (OSError, subprocess.SubprocessError) as e:  # no compiler here
        print(f"[vmlmf_tpu_torch] native build unavailable ({e}); using NumPy", file=sys.stderr)
        return False


@functools.lru_cache(maxsize=None)
def _load():
    """The library, built where it is missing and loaded once; None where it
    cannot be."""
    if not os.path.exists(_SO) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib if lib.vmlmf_native_abi_version() == ABI_VERSION else None


def get_lib():
    """The loaded native library, or None (the NumPy versions run): also
    under VMLMF_NO_NATIVE=1, read at each call."""
    if os.environ.get("VMLMF_NO_NATIVE") == "1":
        return None
    return _load()


def _ptr(a, ty):
    return a.ctypes.data_as(ty)


def loadtxt(source) -> np.ndarray:
    """`np.loadtxt` of a whitespace float matrix: ``source`` bytes, a path, or
    a file-like object with ``read``. One row comes back 1-D, as from
    `np.loadtxt`."""
    if isinstance(source, (bytes, bytearray)):
        buf = bytes(source)
    elif isinstance(source, str):
        with open(source, "rb") as f:
            buf = f.read()
    else:
        buf = source.read()
        if isinstance(buf, str):
            buf = buf.encode()
    lib = get_lib()
    if lib is None:
        return np.loadtxt(io.BytesIO(buf))
    rows = _i64(0)
    n = lib.count_matrix(buf, len(buf), ctypes.byref(rows))
    out = np.empty(n, np.float64)
    got = lib.parse_matrix_f64(buf, len(buf), _ptr(out, _f64p), n)
    if got != n:
        raise ValueError(f"parsed {got} of {n} values")
    r = rows.value
    if r > 1 and n % r == 0:
        return out.reshape(r, n // r)
    return out


def sliding_window_f32(x: np.ndarray, window: int, step: int) -> np.ndarray:
    """[n, feat] f32 -> [nw, window, feat], a window every ``step`` rows."""
    lib = get_lib()
    n, feat = x.shape
    if n < window:
        return np.empty((0, window, feat), np.float32)
    nw = (n - window) // step + 1
    if lib is None or not x.flags.c_contiguous or x.dtype != np.float32:
        view = np.lib.stride_tricks.sliding_window_view(x, window, axis=0)
        return np.ascontiguousarray(np.moveaxis(view, -1, 1)[::step])
    out = np.empty((nw, window, feat), np.float32)
    lib.sliding_window_f32(_ptr(x, _f32p), n, feat, window, step, _ptr(out, _f32p))
    return out


def interp_nan_f32(x: np.ndarray) -> np.ndarray:
    """Per-channel NaN interpolation (`opp_preprocess.interpolate_nan`)."""
    lib = get_lib()
    if lib is None or x.dtype != np.float32:
        from vmlmf_tpu_torch.data.opp_preprocess import interpolate_nan

        return interpolate_nan(x)
    out = np.ascontiguousarray(x, np.float32).copy()
    lib.interp_nan_f32(_ptr(out, _f32p), out.shape[0], out.shape[1])
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``src[idx]`` for C-contiguous f32 or i32 arrays (batch assembly)."""
    lib = get_lib()
    if (lib is None or not isinstance(src, np.ndarray) or not src.flags.c_contiguous
            or src.dtype not in (np.dtype(np.float32), np.dtype(np.int32))):
        return src[idx]
    idx = np.ascontiguousarray(idx, np.int64)
    if len(idx) and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(f"row index out of range for {len(src)} rows")
    out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    row_elems = int(np.prod(src.shape[1:], dtype=np.int64)) if src.ndim > 1 else 1
    if src.dtype == np.float32:
        lib.gather_rows_f32(_ptr(src, _f32p), _ptr(idx, _i64p), len(idx), row_elems,
                            _ptr(out, _f32p))
    else:
        lib.gather_rows_i32(_ptr(src, _i32p), _ptr(idx, _i64p), len(idx), row_elems,
                            _ptr(out, _i32p))
    return out


def norm_clamp_f32(x: np.ndarray, mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    """(x - mn) / (mx - mn) with the OPP clamp (> 1 -> 0.99, < 0 -> 0)."""
    lib = get_lib()
    if lib is None or x.dtype != np.float32:
        mn = np.asarray(mn, np.float32)
        mx = np.asarray(mx, np.float32)
        y = (np.asarray(x, np.float32) - mn) / (mx - mn)
        y = np.where(y > 1.0, np.float32(0.99), y)
        return np.where(y < 0.0, np.float32(0.0), y)
    out = np.ascontiguousarray(x).copy()
    mn = np.ascontiguousarray(mn, np.float32)
    mx = np.ascontiguousarray(mx, np.float32)
    if mn.shape != (out.shape[1],) or mx.shape != (out.shape[1],):
        raise ValueError(f"mn and mx must have {out.shape[1]} entries")
    lib.norm_clamp_f32(_ptr(out, _f32p), out.shape[0], out.shape[1], _ptr(mn, _f32p),
                       _ptr(mx, _f32p))
    return out
