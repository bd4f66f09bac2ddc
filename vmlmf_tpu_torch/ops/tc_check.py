"""The tensor-core tile of the LSTM scans (``csrc/gemm_tc.cuh``) on its own.

``tc_product`` computes c = A @ B through ``csrc/gemm_tc_check.cu`` at one
of the operand views the scan kernels hand the tile, so that a check can
hold the tile to a float64 product without a scan around it. It is on no
model's path. On CPU tensors it computes the plain product of the same
operands (bf16-rounded for ``bf16``).

Views of A (``a_kind``): 0 ``RowMajor`` (a0 [m, lda]), 1 ``Transposed``
(a0 [k, lda] read as its transpose), 2 ``PrevRows`` (the rows of a0
[nfirst, lda], then those of a1), 3 ``PrevRowsT`` (the transpose of that).
Views of B (``b_kind``): 0 ``RowMajor`` (b0 [k, ldb]), 1 ``Transposed``
(b0 [n, ldb]).
"""

from __future__ import annotations

import torch

from vmlmf_tpu_torch.ops import cuda_scan


def operands(a_kind, b_kind, a0, a1, b0):
    """The dense A [m, k] and B [k, n] that the views read."""
    if a_kind == 0:
        a = a0
    elif a_kind == 1:
        a = a0.T
    elif a_kind == 2:
        a = torch.cat([a0, a1])
    else:
        a = torch.cat([a0, a1]).T
    return a, b0 if b_kind == 0 else b0.T


def tc_product(a_kind, b_kind, a0, a1, nfirst, lda, b0, ldb, m, n, k, bf16, split=True,
               tile=0):
    """c [m, n] through the tile, with the split-k scratch the scans give it
    (``split``); ``tile`` 1 or 2 forces the 128x128 or the 64x64 tile,
    unsplit."""
    if a0.device.type != "cuda":
        a, b = operands(a_kind, b_kind, a0, a1, b0)
        if bf16:
            a, b = a.bfloat16().float(), b.bfloat16().float()
        return a @ b
    import ctypes

    from vmlmf_tpu_torch.ops import _build

    lib = _build.load("gemm_tc_check")
    fn = lib.gemm_tc_check
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.gemm_tc_check_error.restype = ctypes.c_char_p
    c = torch.full((m, n), float("nan"), device=a0.device)
    floats = cuda_scan._splitk_floats(m, n, k) if split else 0
    partial = torch.empty(max(1, floats), device=a0.device)
    code = fn(a_kind, b_kind, a0.data_ptr(), 0 if a1 is None else a1.data_ptr(), nfirst, lda,
              b0.data_ptr(), ldb, c.data_ptr(), m, n, k, partial.data_ptr() if floats else None,
              floats, int(bf16), tile, torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"gemm_tc_check: {lib.gemm_tc_check_error(code).decode()}")
    return c


def relative_error(got, a, b):
    """max |got - A @ B| / max |A @ B|, the product taken in float64."""
    want = a.double() @ b.double()
    return float((got.double() - want).abs().max() / want.abs().max())
