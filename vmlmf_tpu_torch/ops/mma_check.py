"""The bf16 tensor-core product of the LSTM scans' walk
(``csrc/scan_grid.cuh``: `mma_product` and ``Ring::mma_product``) on its
own.

``mma_walk_product`` computes out [cols, rpad] = W^T A for a weight slice W
[depth, cols] and an exchange A [depth, rpad], both rounded to bf16,
through ``csrc/mma_walk_check.cu`` on one CTA and its ring (the blocks past
``resident`` rows streamed, stages of ``piece`` floats), so that a check
can hold the product to a float64 one, and one resident depth or stage
size to another, without a scan around it. It is on no model's path. On
CPU tensors it returns `mma_emulate`, the kernel's order of sums in torch
ops.
"""

from __future__ import annotations

import torch

from vmlmf_tpu_torch.ops import cuda_scan


def mma_layout(depth, cols, rpad, resident):
    """(floats a ring stage, red floats) of one product on one CTA with
    ``resident`` rows in shared memory: stages of RING_PIECE_FLOATS, cut to
    what fits, as `cuda_scan.plan_layout` sizes them."""
    red = cuda_scan.mma_red_floats(depth, cols, rpad)
    held = cuda_scan.mma_resident(resident, depth) * cols
    free = cuda_scan.SMEM_LIMIT // 4 - (-(-held * 2 // 16) * 4) - red
    need = cuda_scan._ring_need(rpad, [(depth, cols)], 2, mma=True)
    return cuda_scan._ring_fit(free, need, cuda_scan.RING_PIECE_FLOATS) or need, red


def mma_emulate(w, a, rpad):
    """out [cols, rpad] in the kernel's order of sums (`cuda_scan.mma_split`):
    bf16-rounded operands; the blocks of each k-group in runs of MMA_FLUSH
    (each run's products summed exactly and rounded to f32: the tensor
    cores' sum, which truncates where this rounds), the runs added to the
    k-group's f32 sum in block order; the k-groups' sums added in k-group
    order."""
    depth, cols = w.shape
    blocks, kw = cuda_scan.mma_split(depth, cols, rpad)[0], cuda_scan.mma_split(depth, cols,
                                                                                rpad).kw
    d16 = blocks * cuda_scan.MMA_K
    wb = torch.zeros(d16, cols, dtype=torch.float64)
    ab = torch.zeros(d16, rpad, dtype=torch.float64)
    wb[:depth] = w.bfloat16().double().cpu()
    ab[:depth, :a.shape[1]] = a.bfloat16().double().cpu()
    k = cuda_scan.MMA_K
    parts = torch.einsum("bkc,bkr->bcr", wb.reshape(blocks, k, cols),
                         ab.reshape(blocks, k, rpad))
    total = None
    for j in range(kw):
        s, own = torch.zeros(cols, rpad), list(range(j, blocks, kw))
        for i in range(0, len(own), cuda_scan.MMA_FLUSH):
            s = s + parts[own[i:i + cuda_scan.MMA_FLUSH]].sum(0).float()
        total = s if total is None else total + s
    return total


def mma_walk_product(w, a, rpad, ncols=None, resident=None, piece=None, reps=1):
    """out [ncols, rpad] (ncols: all of W's columns where None) through the
    check kernel, the blocks past ``resident`` rows streamed (a multiple of
    16, or None: the whole depth, none streamed) through ring stages of
    ``piece`` floats (None: `mma_layout`'s); ``reps`` products in a row in
    one launch (for timings)."""
    depth, cols = w.shape
    ncols = cols if ncols is None else ncols
    if w.device.type != "cuda":
        return mma_emulate(w, a, rpad)[:ncols]
    import ctypes

    from vmlmf_tpu_torch.ops import _build

    lib = _build.load("mma_walk_check")
    fn = lib.mma_walk_check
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.mma_walk_check_error.restype = ctypes.c_char_p
    resident = depth if resident is None else resident
    fit, red = mma_layout(depth, cols, rpad, resident)
    piece = fit if piece is None else piece
    d16 = cuda_scan._round16(depth)
    xchg = torch.empty(d16 * cuda_scan.mma_xld(rpad), dtype=torch.bfloat16, device=w.device)
    streamed = (d16 - cuda_scan.mma_resident(resident, depth)) * cols
    wstream = torch.empty(max(1, streamed), dtype=torch.bfloat16, device=w.device)
    out = torch.full((cols, rpad), float("nan"), device=w.device)
    code = fn(w.contiguous().data_ptr(), a.contiguous().data_ptr(), out.data_ptr(),
              xchg.data_ptr(), wstream.data_ptr() if streamed else None, depth, cols, ncols, rpad,
              resident, piece, red, reps, torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"mma_walk_check: {lib.mma_walk_check_error(code).decode()}")
    return out[:ncols]


def relative_error(got, w, a):
    """max |got - W^T A| / max |W^T A|, W and A rounded to bf16 and the
    product taken in float64."""
    want = w.bfloat16().double().T @ a.bfloat16().double()
    return float((got.double() - want[:got.shape[0]]).abs().max() / want.abs().max())
