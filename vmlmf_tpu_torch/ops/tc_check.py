"""The tensor-core tiles of the LSTM scans (``csrc/gemm_tc.cuh``) on their own.

``tc_product`` computes c = A @ B through ``csrc/gemm_tc_check.cu`` at one
of the operand views the scan kernels hand the tiles, so that a check can
hold a tile to a float64 product without a scan around it; ``tc_cast``
runs the Hopper tile's bf16 cast pass alone. Neither is on a model's path.
On CPU tensors ``tc_product`` computes the plain product of the same
operands (bf16-rounded for ``bf16``) and ``tc_cast`` torch's rounding.

Views of A (``a_kind``): 0 ``RowMajor`` (a0 [m, lda]), 1 ``Transposed``
(a0 [k, lda] read as its transpose), 2 ``PrevRows`` (the rows of a0
[nfirst, lda], then those of a1), 3 ``PrevRowsT`` (the transpose of that).
Views of B (``b_kind``): 0 ``RowMajor`` (b0 [k, ldb]), 1 ``Transposed``
(b0 [n, ldb]).
"""

from __future__ import annotations

import ctypes

import torch

from vmlmf_tpu_torch.ops import cuda_scan

# tile: the plan's (0), the Ampere tile's 128x128 (1) or 64x64 (2), both
# unsplit, the Hopper tile (3, split by its own plan) or the Ampere tile
# split by its own plan (4)
PLAN, AMPERE_BIG, AMPERE_SMALL, HOPPER, AMPERE = range(5)


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


def scratch_floats(a_kind, b_kind, m, n, k, bf16, split=True, tile=PLAN):
    """(split-k floats, staged-copy floats) that ``tc_product`` gives the
    tile: the scans' rules (`tc_splitk_floats`, `staged_copies`), the
    Hopper tile's where ``tile`` forces it."""
    if tile in (AMPERE_BIG, AMPERE_SMALL):
        return 0, 0
    if tile == AMPERE:
        return (cuda_scan._splitk_floats(m, n, k) if split else 0), 0
    hopper = tile == HOPPER or cuda_scan.tc_route(m, n, k)
    floats = 0
    if split and tile == PLAN:
        floats = cuda_scan.tc_splitk_floats(m, n, k, bf16)
    elif split:
        splits = cuda_scan.wg_plan(m, n, k, cuda_scan.WG_MAX_SPLITS, bf16)[0]
        floats = splits * m * n if splits > 1 else 0
    product = (m, n, k, ("a", a_kind in (0, 2)), ("b", b_kind == 0), split, True)
    copies = cuda_scan.staged_copies([product], bf16, floats, route=lambda *_: hopper)
    return floats, sum(c[-1] for c in copies) // 4


def _lib():
    from vmlmf_tpu_torch.ops import _build

    lib = _build.load("gemm_tc_check")
    if lib.gemm_tc_check.argtypes is None:
        lib.gemm_tc_check.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.gemm_tc_cast_check.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.gemm_tc_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.gemm_tc_check_error.restype = ctypes.c_char_p
    return lib


def _raise(lib, name, code):
    if code:
        raise RuntimeError(f"{name}: {lib.gemm_tc_check_error(code).decode()}")


def tc_product(a_kind, b_kind, a0, a1, nfirst, lda, b0, ldb, m, n, k, bf16, split=True,
               tile=PLAN, flush=0):
    """c [m, n] through the tile, with the split-k and staging scratch the
    scans give it (``split``: the split-k scratch too); ``tile`` as
    `PLAN`, `AMPERE_BIG`, `AMPERE_SMALL`, `HOPPER` and `AMPERE` say;
    ``flush`` > 0: the Hopper tile's stages a chunk of its bf16 two-level
    sum (0: the header's, `cuda_scan.WG_FLUSH`)."""
    if a0.device.type != "cuda":
        a, b = operands(a_kind, b_kind, a0, a1, b0)
        if bf16:
            a, b = a.bfloat16().float(), b.bfloat16().float()
        return a @ b
    lib = _lib()
    c = torch.full((m, n), float("nan"), device=a0.device)
    floats, staged = scratch_floats(a_kind, b_kind, m, n, k, bf16, split, tile)
    partial = torch.empty(max(1, floats), device=a0.device)
    stage = torch.empty(max(1, staged), device=a0.device)
    code = lib.gemm_tc_check(a_kind, b_kind, a0.data_ptr(), 0 if a1 is None else a1.data_ptr(),
                             nfirst, lda, b0.data_ptr(), ldb, c.data_ptr(), m, n, k,
                             partial.data_ptr() if floats else None, stage.data_ptr(), floats,
                             staged, int(bf16), tile, flush,
                             torch.cuda.current_stream().cuda_stream)
    _raise(lib, "gemm_tc_check", code)
    return c


def tc_cast(a):
    """a [rows, cols] f32 rounded to bf16 by the Hopper tile's cast pass
    (CUDA) or by torch (CPU) -> [rows, cols] bf16."""
    if a.device.type != "cuda":
        return a.bfloat16()
    rows, cols = a.shape
    ld = -(-cols // 8) * 8
    out = torch.empty((rows, ld), dtype=torch.bfloat16, device=a.device)
    lib = _lib()
    _raise(lib, "gemm_tc_cast_check",
           lib.gemm_tc_cast_check(a.data_ptr(), a.stride(0), out.data_ptr(), rows, cols, ld,
                                  torch.cuda.current_stream().cuda_stream))
    return out[:, :cols]


def card_plan(m, n, k, room, bf16):
    """gemm_tc.cuh's own tc_plan(m, n, k, room, bf16), read through
    gemm_tc_check.cu -> (wg, big, splits, kslice); needs the built library
    (and so the CUDA toolkit), not a card."""
    lib = _lib()
    out = (ctypes.c_int * 4)()
    _raise(lib, "gemm_tc_plan", lib.gemm_tc_plan(m, n, k, room, int(bf16), out))
    return bool(out[0]), bool(out[1]), out[2], out[3]


def relative_error(got, a, b):
    """max |got - A @ B| / max |A @ B|, the product taken in float64."""
    want = a.double() @ b.double()
    return float((got.double() - want).abs().max() / want.abs().max())
