"""The tensor-core tiles of the LSTM scans (``csrc/gemm_tc.cuh``) on their own.

``tc_product`` computes c = A @ B through ``csrc/gemm_tc_check.cu`` at one
of the operand views the scan kernels hand the tiles, so that a check can
hold a tile to a float64 product without a scan around it; ``tc_cast``
runs the Hopper tile's bf16 cast pass alone. Neither is on a model's path.
On CPU tensors ``tc_product`` computes the plain product of the same
operands (bf16-rounded for ``bf16``) and ``tc_cast`` torch's rounding.

Views of A (``a_kind``): 0 ``RowMajor`` (a0 [m, lda]), 1 ``Transposed``
(a0 [k, lda] read as its transpose), 2 ``PrevRows`` (the rows of a0
[nfirst, lda], then those of a1), 3 ``PrevRowsT`` (the transpose of that),
4 `MASKED`: the transpose of X = a0 * a1 (the wavefront stack's layer input,
y times its mask, [k, lda] each), which the check writes into its staging
scratch first, as the stack's BPTT does (``Staging::masked``).
Views of B (``b_kind``): 0 ``RowMajor`` (b0 [k, ldb]), 1 ``Transposed``
(b0 [n, ldb]).

``gru_product`` does the same for the GRU BPTT's products
(``csrc/gru_scan_xin_bwd.cu::gru_tc_check``), whose operands are composites
that the Hopper tile stages through a gated source (``gemm_tc.cuh::
wg::Source``): R * Hprev, dN * R and [Hprev; R * Hprev]. ``gru_sources``
reads each operand as those sources lay it out, element by element from
the flat buffers, so the CPU tests hold the layout to the plain BPTT's
intermediates.
"""

from __future__ import annotations

import ctypes

import torch

from vmlmf_tpu_torch.ops import cuda_scan

# tile: the plan's (0), the Ampere tile's 128x128 (1) or 64x64 (2), both
# unsplit, the Hopper tile (3, split by its own plan) or the Ampere tile
# split by its own plan (4)
PLAN, AMPERE_BIG, AMPERE_SMALL, HOPPER, AMPERE = range(5)
MASKED = 4  # a_kind: X^T of X = y * mask, materialised first


def operands(a_kind, b_kind, a0, a1, b0):
    """The dense A [m, k] and B [k, n] that the views read."""
    if a_kind == 0:
        a = a0
    elif a_kind == 1:
        a = a0.T
    elif a_kind == 2:
        a = torch.cat([a0, a1])
    elif a_kind == 3:
        a = torch.cat([a0, a1]).T
    else:
        a = (a0 * a1).T
    return a, b0 if b_kind == 0 else b0.T


def scratch_floats(a_kind, b_kind, m, n, k, bf16, split=True, tile=PLAN):
    """(split-k floats, staged-copy floats) that ``tc_product`` gives the
    tile: the scans' rules (`tc_splitk_floats`, `staged_copies`), the
    Hopper tile's where ``tile`` forces it; `MASKED`'s X first."""
    x = cuda_scan._align(4 * k * m) // 4 if a_kind == MASKED else 0  # X [k, m]
    if tile in (AMPERE_BIG, AMPERE_SMALL):
        return 0, x
    if tile == AMPERE:
        return (cuda_scan._splitk_floats(m, n, k) if split else 0), x
    hopper = tile == HOPPER or cuda_scan.tc_route(m, n, k)
    floats = 0
    if split and tile == PLAN:
        floats = cuda_scan.tc_splitk_floats(m, n, k, bf16)
    elif split:
        splits = cuda_scan.wg_plan(m, n, k, cuda_scan.WG_MAX_SPLITS, bf16)[0]
        floats = splits * m * n if splits > 1 else 0
    product = (m, n, k, ("a", a_kind in (0, 2)), ("b", b_kind == 0), split, True)
    copies = cuda_scan.staged_copies([product], bf16, floats, route=lambda *_: hopper)
    return floats, x + sum(c[-1] for c in copies) // 4


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


# The GRU BPTT's products of gru_tc_check, by number: (name, (m, n, k) from
# (T*B, h, r, n), A and B as (source, runs along j), as `staged_copies`
# reads them).
GRU_PRODUCTS = (
    ("dPrz", lambda M, h, r, n: (h, 2 * h, M), ("hprev", False), ("dpre", True)),
    ("dPn pre", lambda M, h, r, n: (h, h, M), ("rh", False), ("dpre_n", True)),
    ("dPn post", lambda M, h, r, n: (h, h, M), ("hprev", False), ("dn_r", True)),
    ("dPrz lowrank", lambda M, h, r, n: (r, 2 * h, M), ("hu", False), ("dpre", True)),
    ("dPn lowrank", lambda M, h, r, n: (r, h, M), ("rhu", False), ("dpre_n", True)),
    ("dUf", lambda M, h, r, n: (h, r, 2 * M), ("hprev_rh", False), ("dhu_drhu", True)),
    ("RH @ w", lambda M, h, r, n: (M, n, h), ("rh", True), ("w", True)),
)
GRU_HOPPER, GRU_TILE = 0, 1  # gru_tc_check's tiles: the Hopper tile, gemm_tile.cuh


def source_rows(first, rest, nfirst, ld, rows, cols, gate=None, gate_ld=0, gated_from=0):
    """The rows [rows, cols] of a gemm_tc.cuh::wg::Source, element (i, j) as
    its `at` reads it from the flat buffers ``first``, ``rest`` and
    ``gate``: row i of first for i < nfirst, else row i - nfirst of rest,
    each ld floats apart; with a gate, rows i >= gated_from are row i' = i
    - gated_from times gate[i' * gate_ld + j]."""
    i = torch.arange(rows, device=first.device)[:, None]
    j = torch.arange(cols, device=first.device)[None, :]
    g = i - gated_from if gate is not None else i
    base = torch.where(g >= 0, g, i)

    def row_elem(r_):
        lo = first[(r_.clamp(max=nfirst - 1) * ld + j).clamp(max=first.numel() - 1)]
        if rest is None:
            return lo
        hi = rest[((r_ - nfirst).clamp(min=0) * ld + j).clamp(max=rest.numel() - 1)]
        return torch.where(r_ < nfirst, lo, hi)

    plain = row_elem(i)
    if gate is None:
        return plain
    gated = row_elem(base) * gate[(base * gate_ld + j).clamp(max=gate.numel() - 1)]
    return torch.where(i >= gated_from, gated, plain)


def gru_sources(product, h0, ys, gates, dpre, hu=None, rhu=None, dhu=None, drhu=None, w=None):
    """A [m, k] and B [k, n] of GRU product ``product`` as the Hopper tile
    stages them: each operand's source as gru_scan_xin_bwd.cu's source_of
    gives it (first, rest, nfirst, ld, gate, gate_ld, gated_from), read by
    `source_rows`, transposed where its view runs along i. ys [T, B, h],
    gates [T, B, 3h], dpre [T*B, 3h], hu, rhu, dhu, drhu [T*B, r], w [h, n]."""
    t, b, h = ys.shape
    M = t * b
    flat = lambda a: None if a is None else a.reshape(-1)  # noqa: E731
    h0f, ysf, gf, df = flat(h0), flat(ys), flat(gates), flat(dpre)
    hprev = source_rows(h0f, ysf, b, h, M, h)                                  # PrevRows(T)
    rh = source_rows(h0f, ysf, b, h, M, h, gf, 3 * h, 0)                       # GatedPrev(T)
    if product == 0:
        return hprev.T, source_rows(df, None, 1 << 30, 3 * h, M, 2 * h)
    if product == 1:
        return rh.T, source_rows(df[2 * h:], None, 1 << 30, 3 * h, M, h)
    if product == 2:
        return hprev.T, source_rows(df[2 * h:], None, 1 << 30, 3 * h, M, h, gf, 3 * h, 0)
    r = hu.shape[-1] if hu is not None else (dhu.shape[-1] if dhu is not None else 0)
    if product == 3:
        return (source_rows(flat(hu), None, 1 << 30, r, M, r).T,
                source_rows(df, None, 1 << 30, 3 * h, M, 2 * h))
    if product == 4:
        return (source_rows(flat(rhu), None, 1 << 30, r, M, r).T,
                source_rows(df[2 * h:], None, 1 << 30, 3 * h, M, h))
    if product == 5:
        return (source_rows(h0f, ysf, b, h, 2 * M, h, gf, 3 * h, M).T,
                source_rows(flat(dhu), flat(drhu), M, r, 2 * M, r))
    if product == 6:
        return rh, w
    raise ValueError(f"no GRU product {product}")


def gru_scratch_floats(product, tile, t, b, h, r, n):
    """(split-k floats, staged floats) that ``gru_product`` gives
    gru_tc_check: the Hopper tile's k slices by its own plan and its staged
    copies of the product's two sources, or gemm_tile.cuh's group of one."""
    from vmlmf_tpu_torch.ops import cuda_gru

    _, shape, a, b_ = GRU_PRODUCTS[product]
    m, n_, k = shape(t * b, h, r, n)
    if tile == GRU_TILE:
        return cuda_gru._group_floats([(m, n_, k)]), 0
    splits = cuda_scan.wg_plan(m, n_, k, cuda_scan.WG_MAX_SPLITS, False)[0]
    floats = splits * m * n_ if splits > 1 else 0
    copies = cuda_scan.staged_copies([(m, n_, k, a, b_, True, True)], False, floats,
                                     route=lambda *_: True)
    return floats, sum(c[-1] for c in copies) // 4


def gru_product(product, tile, h0, ys, gates, dpre, hu=None, rhu=None, dhu=None, drhu=None,
                w=None):
    """GRU product ``product`` (`GRU_PRODUCTS`) of the BPTT's residuals and
    dPre through gru_tc_check on ``tile`` (GRU_HOPPER: 3xTF32 on the Hopper
    tile; GRU_TILE: gemm_tile.cuh's CUDA-core split-k) -> c [m, n]; CPU
    tensors give the plain product of `gru_sources`."""
    if h0.device.type != "cuda":
        a, b = gru_sources(product, h0, ys, gates, dpre, hu, rhu, dhu, drhu, w)
        return a @ b
    t, bt, h = ys.shape
    r = next((x.shape[-1] for x in (hu, dhu) if x is not None), 0)
    n = 0 if w is None else w.shape[-1]
    m, n_, _ = GRU_PRODUCTS[product][1](t * bt, h, r, n)
    c = torch.full((m, n_), float("nan"), device=h0.device)
    floats, staged = gru_scratch_floats(product, tile, t, bt, h, r, n)
    partial = torch.empty(max(1, floats), device=h0.device) if floats else None
    stage = torch.empty(max(1, staged), device=h0.device) if staged else None
    cuda_scan._launch("gru_scan_xin_bwd", "gru_tc_check",
                      (h0, ys, gates, dpre, hu, rhu, dhu, drhu, w, c, partial, stage),
                      (product, tile, t, bt, h, r, n, floats, staged), h0.device)
    return c
