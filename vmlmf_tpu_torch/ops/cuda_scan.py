"""Fused LSTM scan with the input projection inside: the port's counterpart
of `vmlmf_tpu.ops.pallas_scan.lstm_scan_fused_xin` (its no-grad primal).

`lstm_scan_fused_xin` launches the hand-written CUDA kernel
``csrc/lstm_scan_xin_fwd.cu`` for CUDA tensors and runs
`lstm_scan_fused_xin_plain`, the same arithmetic as a loop of torch ops,
for CPU tensors. There is no fallback between the two: a CUDA input that
the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from vmlmf_tpu_torch.cells.base import lstm_update, pad_features
from vmlmf_tpu_torch.ops import _build

KERNEL = "lstm_scan_xin_fwd"
REPLACES = "vmlmf_tpu/ops/pallas_scan.py:236"  # _fwd_kernel

_ARG_NAMES = ("xs", "ux", "vx", "xdvec", "bias", "u", "v", "dvec", "h0", "c0")


def lstm_scan_fused_xin_plain(xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0):
    """The kernel's function in torch ops: the batched input projection, then
    a Python loop over T. Same arguments and results as `lstm_scan_fused_xin`."""
    h = h0.shape[-1]
    gi = (xs @ ux) @ vx + pad_features(xs, h).repeat(1, 1, 4) * xdvec.reshape(-1) + bias
    dvec = dvec.reshape(-1)
    h_t, c_t = h0, c0
    ys = []
    for gi_t in gi:
        pre = gi_t + (h_t @ u) @ v + h_t.repeat(1, 4) * dvec
        h_t, c_t = lstm_update(pre, c_t)
        ys.append(h_t)
    return torch.stack(ys), c_t


def _check(args):
    """Validate the CUDA call's inputs; -> (T, B, F, rx, h, r)."""
    xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0 = args
    if xs.dim() != 3:
        raise ValueError(f"xs must be [T, B, F], got {tuple(xs.shape)}")
    t, b, f = xs.shape
    h = h0.shape[-1] if h0.dim() == 2 else -1
    rx, r = ux.shape[-1], u.shape[-1]
    want = {
        "xs": (t, b, f), "ux": (f, rx), "vx": (rx, 4 * h), "xdvec": (4, h),
        "bias": (4 * h,), "u": (h, r), "v": (r, 4 * h), "dvec": (4 * h,),
        "h0": (b, h), "c0": (b, h),
    }
    dev = xs.device
    for name, a in zip(_ARG_NAMES, args):
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} must have shape {want[name]}, got {tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, xs on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(t, b, f, rx, h, r) < 1:
        raise ValueError(f"empty scan: T={t}, B={b}, F={f}, rx={rx}, h={h}, r={r}")
    return t, b, f, rx, h, r


def _bind(lib):
    fn = lib.lstm_scan_xin_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.lstm_scan_xin_fwd_error.argtypes = [ctypes.c_int]
        lib.lstm_scan_xin_fwd_error.restype = ctypes.c_char_p
    return fn


def lstm_scan_fused_xin(xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0):
    """Fused LSTM scan, x mode, no gradient.

    xs [T, B, F]; ux [F, rx], vx [rx, 4h]; xdvec [4, h] (applied to x over its
    first min(F, h) features); bias [4h]; u [h, r], v [r, 4h]; dvec [4h];
    h0, c0 [B, h]. Gate order i, f, g, o. Returns (ys [T, B, h], c_last [B, h]).

    CPU tensors run `lstm_scan_fused_xin_plain`. CUDA tensors must be float32,
    contiguous and on one device; the kernel runs on the current stream and
    ``lstm_scan_fused_xin.launches`` counts its calls.
    """
    args = (xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0)
    if all(a.device.type == "cpu" for a in args):
        return lstm_scan_fused_xin_plain(*args)
    t, b, f, rx, h, r = _check(args)
    if xs.device.type != "cuda":
        raise ValueError(f"lstm_scan_fused_xin runs on CPU or CUDA tensors, got {xs.device}")
    fn = _bind(_build.load(KERNEL))
    with torch.cuda.device(xs.device):
        xu = torch.empty((t * b, rx), dtype=torch.float32, device=xs.device)
        gi = torch.empty((t * b, 4 * h), dtype=torch.float32, device=xs.device)
        ys = torch.empty((t, b, h), dtype=torch.float32, device=xs.device)
        c_last = torch.empty((b, h), dtype=torch.float32, device=xs.device)
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        ptrs = [a.data_ptr() for a in (*args, xu, gi, ys, c_last)]
        err = fn(*ptrs, t, b, f, rx, h, r, stream)
    if err != 0:
        msg = _build.load(KERNEL).lstm_scan_xin_fwd_error(err).decode()
        raise RuntimeError(f"{KERNEL} launch failed: {msg} (cudaError {err})")
    lstm_scan_fused_xin.launches += 1
    return ys, c_last


lstm_scan_fused_xin.launches = 0


def scan_cost(t, b, f, rx, h, r):
    """(operations, bytes) that the scan needs at least, for its roofline bound.

    Operations: two per multiply-add of the four products, 6 per gate element
    (the x term and bias, the h term and the sums) and 9 per hidden unit (the
    nonlinearities and the state update), each step and row. Bytes: each
    input read once and each output written once, f32.
    """
    macs = f * rx + rx * 4 * h + h * r + r * 4 * h
    ops = t * b * (2 * macs + 6 * 4 * h + 9 * h)
    floats = (t * b * f + f * rx + rx * 4 * h + 4 * h + 4 * h + h * r + r * 4 * h + 4 * h
              + 2 * b * h + t * b * h + b * h)
    return ops, 4 * floats
