"""Where a step of the LSTM scan kernels goes, on one CUDA device.

    python -m vmlmf_tpu_torch.tools.scan_phases [--bf16] [SHAPE ...]
    python -m vmlmf_tpu_torch.tools.scan_phases --gemm [SHAPE ...]

Three readings for each shape (the PTB LM layer, T=35, F=h=650, low-rank
r=rx=300 at B in 1/20/128 and dense at B=20; the HAR layer, T=24, F=77,
h=180, low-rank r=6 and dense, B=81; the PTB "large" LM's dense layer,
T=35, F=h=1500, at B in 20 and 128), in f32 and, at the shapes of
`BF16_SHAPES`, in bf16 too (a line each; ``--bf16``: the bf16 lines
alone; SHAPE names: those shapes alone):

* ``device``: `torch.profiler`'s device time by kernel for each entry
  (no-grad forward, residual forward, BPTT from dys) at T and at 2T, so the
  difference over T is the time of a step and the rest the fixed part.
* ``stamps``: a copy of ``csrc/`` built apart (in a temporary directory
  under the git-ignored ``_build/``, never over the package's libraries)
  with a `%globaltimer` read by thread 0 of CTA 0 after a `__syncthreads`
  at each phase boundary of every step; the mean
  microseconds of each span over the steps. Forward spans: 0->1 phase A
  (hu), 1->2 its barrier, 2->3 phase B (the gates), 3->4 its barrier (dense:
  0->3, 3->4). BPTT: 0->1 phase A (dpre), 1->2 barrier, 2->3 phase B (dhu),
  3->4 barrier, 4->5 phase C (dh) (dense: 0->1, 1->2, 2->5). On a streamed
  plan's ring (scan_grid.cuh::Ring) also ``ring_wait``: the µs a step that
  the same thread, a consumer, waits on the ring's full barriers, in all
  the step's products (a walk at its FMA floor waits for none), and
  ``ring_refill``: the µs a step that CTA 0's producer waits for a stage to
  be released on its empty barrier. On a plan whose bf16 products run on
  the tensor cores (`ScanPlan.mma`), also the µs a step that the same
  thread spends in its warp's blocks of mmas (``mma_blocks``), in adding
  the k-groups' sums (``mma_gather``) and in the epilogue
  (``mma_epilogue``); the rest of a product is waiting for its data.
* ``mma_alone`` (on such a plan): each product of the walk by itself on one
  CTA (``csrc/mma_walk_check.cu``, with the plan's resident depth and ring
  stages), µs a product from CUDA events around one launch of 1 product and
  one of 33 in a row: the walk's products without the barriers, the other
  CTAs' reads of L2 and the epilogue's nonlinearities.
* ``gemm``: the GEMM phase of the no-grad forward and of the BPTT, product
  by product in launch order (the tensor-core tile of csrc/gemm_tc.cuh,
  its split-k sum added to its product), each beside the device time of
  ``torch.matmul`` of the same shape in the same profiler session (cuBLAS:
  f32 with TF32 off, and bf16),
  and ``split``: the device ms of the walk kernel, of the GEMM phase and of
  the rest of each entry. A product's ``ms`` is its tile kernel's and its
  split-k sum's (or its epilogue pass's: the Hopper tile's raw sums
  through a reading epilogue), ``sum_ms`` that of the second; ``cast_ms``
  that of the passes that write its operands' staged copies (bf16, or
  3xTF32's hi and lo) right before it, which serve the products after it
  too.

``--gemm``: the ``gemm`` reading alone, in f32 and in bf16, at the shapes
of `GEMM_SHAPES` and, for the wavefront stack's BPTT (`cuda_stack.
lstm_stack_bwd`, the LM stack: L=2, T=35, h=650, r=rx=300, dropout masks
as in training), of `STACK_SHAPES` (or the SHAPEs named): its weight
gradients product by product (`cuda_stack.stack_tc_products`), each beside
``torch.matmul`` of its shape, and its split into the walk
(``stack_bwd_kernel``), the GEMM phase (the masked input's pass counted
with the staging passes) and the rest (the column sums); no stamped build.

Prints one JSON line a shape, the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vmlmf_tpu_torch.ops import _build, cuda_scan, cuda_stack
from vmlmf_tpu_torch.tools.stack_case import (STACK_H, STACK_RANKS, STACK_T, STACK_XRANKS,
                                               stack_case)

SHAPES = {  # (T, B, F, h, rx, r); r = 0 and rx = 0: a dense side
    "lm_b1": (35, 1, 650, 650, 300, 300), "lm_b20": (35, 20, 650, 650, 300, 300),
    "lm_b128": (35, 128, 650, 650, 300, 300), "lm_dense_b20": (35, 20, 650, 650, 0, 0),
    "har_b81": (24, 81, 77, 180, 8, 6), "har_dense_b81": (24, 81, 77, 180, 0, 0),
    "dense1500_b20": (35, 20, 1500, 1500, 0, 0), "dense1500_b128": (35, 128, 1500, 1500, 0, 0),
}
# the shapes also read in bf16: the mixed-precision LM layer and the dense
# h=1500 layer at B = 20 and 128
BF16_SHAPES = ("lm_b20", "lm_b128", "dense1500_b20", "dense1500_b128")
# the shapes of the GEMM phase's reading (--gemm): the LM layer and the
# dense h=1500 layer at B = 20 and 128, the HAR layer at B=81
GEMM_SHAPES = ("lm_b20", "lm_b128", "har_b81", "dense1500_b20", "dense1500_b128")
# the wavefront LM stack's BPTT (--gemm): batch by name
STACK_SHAPES = {"stack_b1": 1, "stack_b20": 20, "stack_b128": 128}
# the kernels of the GEMM phase, by the part of a product each is: its tile,
# its split-k sum, and the passes that stage its operands (the stack's
# masked layer input among them)
TILE_KERNELS = ("tc_gemm_kernel", "wg_gemm_kernel")
SUM_KERNELS = ("tc_sum_kernel",)
CAST_KERNELS = ("cast_bf16_kernel", "split_tf32_kernel", "wg::mul_kernel")
WALK_KERNELS = ("grid_scan_kernel", "grid_bptt_kernel", "stack_bwd_kernel")
MAX_STEPS = 256
# the counters read at each stamp, after the stamp itself: the ring's waits
# and the mma walk's spans (scan_grid.cuh, patched below)
COUNTERS = (("read_waits", "g_ring_wait", "ring_wait"),
            ("read_refills", "g_ring_refill", "ring_refill"),
            ("read_blocks", "g_mma_blocks", "mma_blocks"),
            ("read_gathers", "g_mma_gather", "mma_gather"),
            ("read_epilogues", "g_mma_epilogue", "mma_epilogue"))
READERS = (("read_stamps", None, "step"), *COUNTERS)
STAMP = ("".join(f"__device__ unsigned long long g_{r[5:]}[8 * {MAX_STEPS}];\n"
                 for r, _, _ in READERS)
         + "#define STAMP(k) do { __syncthreads(); \\\n"
         + f"  if (blockIdx.x == 0 && threadIdx.x == 0 && t < {MAX_STEPS}) {{ \\\n"
         + "    g_stamps[t * 8 + (k)] = vmlmf::global_ns(); \\\n"
         + "".join(f"    g_{r[5:]}[t * 8 + (k)] = vmlmf::{c}; \\\n" for r, c, _ in COUNTERS)
         + "  } } while (0)\n"
         + "".join(f'extern "C" int {r}(unsigned long long* out) {{\n'
                   f"  return cudaMemcpyFromSymbol(out, g_{r[5:]}, sizeof(g_{r[5:]}));\n}}\n"
                   for r, _, _ in READERS))
# the ring's consumer wait on a full barrier, timed by thread 0 of CTA 0, and
# its producer's wait on an empty one, timed by CTA 0's producer
RING_WAIT = ("        mbar_wait(full + idx % kRingStages, (idx / kRingStages) & 1);\n",
             "        {\n          const unsigned long long w0 = global_ns();\n"
             "          mbar_wait(full + idx % kRingStages, (idx / kRingStages) & 1);\n"
             "          if (blockIdx.x == 0 && threadIdx.x == 0) g_ring_wait += global_ns() - w0;\n"
             "        }\n")
RING_REFILL = ("    mbar_wait(empty + st, ((idx / kRingStages) & 1) ^ 1);\n",
               "    const unsigned long long w0 = global_ns();\n"
               "    mbar_wait(empty + st, ((idx / kRingStages) & 1) ^ 1);\n"
               "    if (blockIdx.x == 0) g_ring_refill += global_ns() - w0;\n")
RING_COUNTER = ("// The bf16 tensor-core product of the LSTM scans' `mma` plans.\n",
                "__device__ unsigned long long g_ring_wait, g_ring_refill, g_mma_blocks, "
                "g_mma_gather, g_mma_epilogue;\n\n"
                "// The bf16 tensor-core product of the LSTM scans' `mma` plans.\n")


def timed(line, counter, indent):
    """``line`` of scan_grid.cuh run between two reads of the global timer by
    thread 0 of CTA 0, which adds the span to ``counter``."""
    pad = " " * indent
    return (f"{pad}{{\n{pad}  const unsigned long long s0 = global_ns();\n{line}"
            f"{pad}  if (blockIdx.x == 0 && threadIdx.x == 0) {counter} += global_ns() - s0;\n"
            f"{pad}}}\n")


# the mma walk's spans (Ring::mma_consume)
MMA_SPANS = [
    (line, timed(line, counter, indent)) for line, counter, indent in (
        ("          m.walk(div_up(e1 / kMmaK - kb, s.kw), w, s.kw * kMmaK * op.cols,\n"
         "                 sp + (size_t)(d - e0) * k.xld, s.kw * kMmaK * k.xld);\n",
         "g_mma_blocks", 10),
        ("      m.gather(s, op.cols, rpad, red, [] { consumers_sync(); });\n", "g_mma_gather", 6),
        ("    mma_epilogue(red, op.cols, op.ncols, rpad, epi);\n", "g_mma_epilogue", 4))]


# (anchor, its replacement): the phase boundaries of each kernel's step
MARKS = {
    "lstm_scan_xin_fwd": [
        ("  for (int t = 0; t < t_len; ++t) {\n",
         "  for (int t = 0; t < t_len; ++t) {\n    STAMP(0);\n"),
        ("      }\n      vmlmf::group_sync(count, plan.ctas, target);\n    }\n",
         "      }\n      STAMP(1);\n      vmlmf::group_sync(count, plan.ctas, target);\n"
         "      STAMP(2);\n    }\n"),
        ("    }\n    vmlmf::group_sync(count, plan.ctas, target);\n  }\n",
         "    }\n    STAMP(3);\n    vmlmf::group_sync(count, plan.ctas, target);\n"
         "    STAMP(4);\n  }\n")],
    "lstm_scan_xin_bwd": [
        ("    __syncthreads();  // pa, and the carry that phase C wrote\n",
         "    __syncthreads();  // pa, and the carry that phase C wrote\n    STAMP(0);\n"),
        ("      dhc[at] = dhp;\n    }\n    vmlmf::group_sync(count, plan.ctas, target);\n",
         "      dhc[at] = dhp;\n    }\n    STAMP(1);\n"
         "    vmlmf::group_sync(count, plan.ctas, target);\n    STAMP(2);\n"),
        ("      }\n      vmlmf::group_sync(count, plan.ctas, target);\n    }\n",
         "      }\n      STAMP(3);\n      vmlmf::group_sync(count, plan.ctas, target);\n"
         "      STAMP(4);\n    }\n"),
        ("epi_c);\n    }\n  }\n", "epi_c);\n    }\n    STAMP(5);\n  }\n")],
}


def stamped_libraries(work):
    """Build the stamped copies of the two scan sources -> {name: CDLL}."""
    src = os.path.join(work, "csrc")
    shutil.copytree(_build.CSRC, src)
    header = os.path.join(src, "scan_grid.cuh")
    text = open(header).read()
    for anchor, new in (RING_WAIT, RING_REFILL, RING_COUNTER, *MMA_SPANS):
        if text.count(anchor) < 1 or (anchor != RING_WAIT[0] and anchor != RING_REFILL[0]
                                      and text.count(anchor) != 1):
            raise RuntimeError(f"scan_grid.cuh: the ring's anchor moved: {anchor!r}")
        text = text.replace(anchor, new)  # every consumer's wait, every producer's
    open(header, "w").write(text)
    libs = {}
    for name, marks in MARKS.items():
        path = os.path.join(src, f"{name}.cu")
        text = open(path).read().replace('#include "scan_grid.cuh"\n',
                                         '#include "scan_grid.cuh"\n' + STAMP, 1)
        for anchor, new in marks:
            if text.count(anchor) != 1:
                raise RuntimeError(f"{name}.cu: the phase anchor moved: {anchor!r}")
            text = text.replace(anchor, new)
        open(path, "w").write(text)
        out = os.path.join(work, f"{name}.so")
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, path], check=True,
                       capture_output=True)
        libs[name] = ctypes.CDLL(out)
    return libs


def inputs(t, b, f, h, rx, r):
    g = torch.Generator().manual_seed(0)

    def n(*shape, scale):
        return (scale * torch.randn(shape, generator=g)).cuda()

    return (n(t, b, f, scale=1.0), n(f, rx or 4 * h, scale=f ** -0.5),
            n(rx, 4 * h, scale=rx ** -0.5) if rx else None, n(4, h, scale=0.1),
            n(4 * h, scale=0.1), n(h, r or 4 * h, scale=h ** -0.5),
            n(r, 4 * h, scale=r ** -0.5) if r else None, n(4 * h, scale=0.1),
            n(b, h, scale=0.5), n(b, h, scale=0.5))


def entries(shape, precision="f32"):
    """{entry: a call of it} on seeded inputs of ``shape``."""
    t, b, _, h = shape[:4]
    args = inputs(*shape)
    res = cuda_scan.lstm_scan_fused_xin_res(*args, precision)
    dys = 0.1 * torch.randn(t, b, h, generator=torch.Generator().manual_seed(5)).cuda()
    saved = (*args[:4], *args[5:], *res)
    return {"fwd": lambda: cuda_scan.lstm_scan_fused_xin(*args, precision),
            "res": lambda: cuda_scan.lstm_scan_fused_xin_res(*args, precision),
            "bwd": lambda: cuda_scan.lstm_scan_xin_bwd(*saved, dys, None, precision=precision)}


def products(shape, entry):
    """The GEMM phase of an x-mode entry with saved gates, in launch order
    (lstm_scan_xin_fwd.cu::project, lstm_scan_xin_bwd.cu::bwd):
    [(product, m, n, k)]."""
    t, b, f, h, rx, r = shape
    m, g4 = t * b, 4 * h
    if entry == "fwd":
        return ([("gi = x Ux", m, g4, f)] if not rx else
                [("xu = x Ux", m, rx, f), ("gi = xu Vx", m, g4, rx)])
    out = ([("dU = Hprev^T dPre", h, g4, m)] if not r else
           [("dV = HU^T dPre", r, g4, m), ("dU = Hprev^T dHU", h, r, m)])
    return out + ([("dx = dPre Ux^T", m, f, g4), ("dUx = X^T dPre", f, g4, m)] if not rx else
                  [("dXU = dPre Vx^T", m, rx, g4), ("dx = dXU Ux^T", m, f, rx),
                   ("dUx = X^T dXU", f, rx, m), ("dVx = XU^T dPre", rx, g4, m)])


def kernel_name(e):
    return e.name.replace("(anonymous namespace)::", "").split("(")[0]


def operands(m, n, k, dtype):
    g = torch.Generator(device="cuda").manual_seed(0)
    return (torch.randn(m, k, device="cuda", generator=g).to(dtype),
            torch.randn(k, n, device="cuda", generator=g).to(dtype))


def gemm_phase(shape, precision, reps=5):
    """{entry: {"products": [...], "split": {...}}} of the no-grad forward
    and the BPTT (`gemm_reading`)."""
    calls = entries(shape, precision)
    return {entry: gemm_reading(calls[entry], products(shape, entry), reps)
            for entry in ("fwd", "bwd")}


def stack_products(b):
    """The stack BPTT's weight gradients in launch order: [(product, m, n, k)]."""
    return [(f"layer {l} {name}", *p[:3]) for l, layer in enumerate(cuda_stack.stack_tc_products(
        STACK_T, b, STACK_H, STACK_RANKS, STACK_XRANKS)) for name, p in layer]


def gemm_reading(call, want, reps=5):
    """{"products": [...], "split": {...}} of one entry: each product of
    ``want`` [(product, m, n, k)], its device ms (its tile kernel and, split
    over k, its tc_sum_kernel) beside the device ms of ``torch.matmul`` of
    the same shape (f32 with TF32 off, and bf16), all of one profiler
    session, and the entry's device ms by part. A spin kernel between the
    groups of calls tells their kernels apart."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    mats = [operands(m, n, k, dtype) for _, m, n, k in want
            for dtype in (torch.float32, torch.bfloat16)]
    groups = [call] + [lambda a=a, b=b: torch.matmul(a, b) for a, b in mats]
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        for fn in groups:  # warm-up: cuBLAS picks its kernels on a shape's first call
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in groups:
                for _ in range(reps):
                    fn()
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    segments = [[]]
    for e in events:
        if "spin_kernel" in kernel_name(e):
            segments.append([])
        else:
            segments[-1].append((kernel_name(e), e.time_range.elapsed_us() / 1e3 / reps))
    split, runs, casts = {"walk": 0.0, "gemm": 0.0, "other": 0.0}, [], 0.0
    for name, ms in segments[0]:
        tile, tail, cast = (any(n in name for n in ks)
                            for ks in (TILE_KERNELS, SUM_KERNELS, CAST_KERNELS))
        part = ("walk" if any(n in name for n in WALK_KERNELS) else
                "gemm" if tile or tail or cast else "other")
        split[part] += ms
        if tile:
            runs.append([name, ms, casts, 0.0])
            casts = 0.0
        elif tail and runs:
            runs[-1][1] += ms
            runs[-1][3] += ms
        elif cast:
            casts += ms
    matmul = [round(sum(ms for _, ms in seg), 4) for seg in segments[1:1 + len(mats)]]
    per_call = len(runs) // reps
    rows = []
    for i, (name, _, _, _) in enumerate(runs[:per_call]):  # the products of one call
        row = {"kernel": name,
               "ms": round(sum(runs[c * per_call + i][1] for c in range(reps)), 4),
               "sum_ms": round(sum(runs[c * per_call + i][3] for c in range(reps)), 4),
               "cast_ms": round(sum(runs[c * per_call + i][2] for c in range(reps)), 4)}
        if per_call == len(want):
            label, m, n, k = want[i]
            row.update(product=label, m=m, n=n, k=k, matmul_f32_ms=matmul[2 * i],
                       matmul_bf16_ms=matmul[2 * i + 1])
        rows.append(row)
    return {"products": rows, "split": {k: round(v, 4) for k, v in split.items()}}


def device_ms(fn, reps=5):
    """Mean device ms of each kernel in one call of fn, by kernel name."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = kernel_name(e)
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return {k: round(v, 4) for k, v in sorted(by.items(), key=lambda kv: -kv[1])}


def spans(lib, steps, marks, ring=False, mma=False):
    """Mean µs between consecutive marks over the steps in walk order (the
    first left out), and of a whole step (mark to mark of the next step);
    with ``ring``, also the mean µs a step of the ring's full-barrier waits
    (``ring_wait``) and of its producer's waits for a free stage
    (``ring_refill``); with ``mma``, of the mma walk's spans."""
    out = {}
    for reader, _, key in READERS:
        if key.startswith("ring") and not ring or key.startswith("mma") and not mma:
            continue
        buf = (ctypes.c_ulonglong * (8 * MAX_STEPS))()
        getattr(lib, reader).argtypes = [ctypes.c_void_p]
        if getattr(lib, reader)(ctypes.addressof(buf)) != 0:
            raise RuntimeError(f"{reader} failed")
        rows = [[buf[s * 8 + k] for k in marks] for s in steps][1:]
        if key == "step":
            out.update({f"{a}->{b}": round(sum(r[i + 1] - r[i] for r in rows) / len(rows) / 1e3,
                                           3) for i, (a, b) in enumerate(zip(marks, marks[1:]))})
        out[key] = round((rows[-1][0] - rows[0][0]) / (len(rows) - 1) / 1e3, 3)
    return out


def mma_alone(plan, reps=33):
    """{kernel product: µs} of each product of an mma plan's walk alone."""
    from vmlmf_tpu_torch.ops.mma_check import mma_walk_product

    g = torch.Generator().manual_seed(3)
    out = {}
    for kernel in ("fwd", "bwd"):
        for (depth, cols), res in zip(plan.slices(kernel), plan.resident(kernel)):
            if not depth:
                continue
            w, a = (torch.randn(s, generator=g).cuda() for s in ((depth, cols),
                                                                  (depth, plan.rpad)))

            def launch(n):
                return mma_walk_product(w, a, plan.rpad, resident=res,
                                        piece=plan.piece(kernel), reps=n)

            ms = {}
            for n in (1, reps):
                launch(n)
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(5):
                    launch(n)
                end.record()
                end.synchronize()
                ms[n] = start.elapsed_time(end) / 5
            out[f"{kernel} {depth}x{cols}"] = round(1e3 * (ms[reps] - ms[1]) / (reps - 1), 3)
    return out


def reading(name, shape, precision, libs):
    """The three readings of one shape in one precision -> a JSON row."""
    t, r = shape[0], shape[5]
    plan = cuda_scan._chunks_for(shape[1], shape[3], r, torch.device("cuda"),
                                 precision == "bf16")[0][2]
    row = {"shape": name, "precision": precision, "card": torch.cuda.get_device_name(0),
           "plan": {k: plan.ints(k) for k in ("fwd", "bwd")}, "device": {}}
    for tt in (t, 2 * t):
        for entry, fn in entries((tt, *shape[1:]), precision).items():
            row["device"][f"{entry}_T{tt}"] = device_ms(fn)
    calls = entries(shape, precision)
    load, _build.load = _build.load, lambda n: libs[n]
    try:
        calls["fwd"]()
        torch.cuda.synchronize()
        row["stamps_fwd"] = spans(libs["lstm_scan_xin_fwd"], range(t),
                                  [0, 1, 2, 3, 4] if r else [0, 3, 4], plan.piece_fwd > 0,
                                  plan.mma)
        calls["bwd"]()
        torch.cuda.synchronize()
        row["stamps_bwd"] = spans(libs["lstm_scan_xin_bwd"], range(t - 1, -1, -1),
                                  [0, 1, 2, 3, 4, 5] if r else [0, 1, 2, 5], plan.piece_bwd > 0,
                                  plan.mma)
    finally:
        _build.load = load
    row["gemm"] = gemm_phase(shape, precision)
    if plan.mma:
        row["mma_alone"] = mma_alone(plan)
    return row


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    bf16_only, gemm_only = "--bf16" in argv, "--gemm" in argv
    names = ([a for a in argv if a not in ("--bf16", "--gemm")]
             or list((*GEMM_SHAPES, *STACK_SHAPES) if gemm_only else SHAPES))
    unknown = set(names) - set(SHAPES) - set(STACK_SHAPES if gemm_only else ())
    if unknown:
        raise SystemExit(f"unknown shapes {sorted(unknown)}; known: {list(SHAPES)}"
                         + (f" and {list(STACK_SHAPES)}" if gemm_only else ""))
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    _build.build_all()
    if gemm_only:
        for name in names:
            for precision in ("f32", "bf16"):
                if name in STACK_SHAPES:
                    b = STACK_SHAPES[name]
                    bwd_args = stack_case(b, precision)[2]
                    gemm = {"bwd": gemm_reading(lambda a=bwd_args: cuda_stack.lstm_stack_bwd(*a),
                                                stack_products(b))}
                else:
                    gemm = gemm_phase(SHAPES[name], precision)
                print(json.dumps({"shape": name, "precision": precision,
                                  "card": torch.cuda.get_device_name(0), "gemm": gemm}),
                      flush=True)
        return
    work = tempfile.mkdtemp(dir=_build.BUILD_DIR)  # git-ignored, beside the package's builds
    try:
        libs = stamped_libraries(work)
        for name in names:
            precisions = (() if bf16_only else ("f32",)) + (("bf16",) if name in BF16_SHAPES
                                                            else ())
            for precision in precisions:
                print(json.dumps(reading(name, SHAPES[name], precision, libs)), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
