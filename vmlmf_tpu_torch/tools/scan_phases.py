"""Where a step of the LSTM scan kernels goes, on one CUDA device.

    python -m vmlmf_tpu_torch.tools.scan_phases

Three readings for each shape (the PTB LM layer, T=35, F=h=650, low-rank
r=rx=300 at B in 1/20/128 and dense at B=20; the HAR layer, T=24, F=77,
h=180, low-rank r=6 and dense, B=81; the PTB "large" LM's dense layer,
T=35, F=h=1500, at B in 20 and 128):

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
  3->4 barrier, 4->5 phase C (dh) (dense: 0->1, 1->2, 2->5).
* ``gemm``: the GEMM phase of the no-grad forward and of the BPTT, product
  by product in launch order (the tensor-core tile of csrc/gemm_tc.cuh,
  its split-k sum added to its product), each beside the device time of
  ``torch.matmul`` of the same shape in the same profiler session (cuBLAS:
  f32 with TF32 off, and bf16),
  and ``split``: the device ms of the walk kernel, of the GEMM phase and of
  the rest of each entry. In f32 at every shape, and in bf16 at the LM
  layer and the dense h=1500 layer at B=20 (``gemm_bf16``).

Prints one JSON line a shape, the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import tempfile

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vmlmf_tpu_torch.ops import _build, cuda_scan

SHAPES = {  # (T, B, F, h, rx, r); r = 0 and rx = 0: a dense side
    "lm_b1": (35, 1, 650, 650, 300, 300), "lm_b20": (35, 20, 650, 650, 300, 300),
    "lm_b128": (35, 128, 650, 650, 300, 300), "lm_dense_b20": (35, 20, 650, 650, 0, 0),
    "har_b81": (24, 81, 77, 180, 8, 6), "har_dense_b81": (24, 81, 77, 180, 0, 0),
    "dense1500_b20": (35, 20, 1500, 1500, 0, 0), "dense1500_b128": (35, 128, 1500, 1500, 0, 0),
}
BF16_SHAPES = ("lm_b20", "dense1500_b20")  # whose GEMM phase is also read in bf16
MAX_STEPS = 256
STAMP = f"""
__device__ unsigned long long g_stamps[8 * {MAX_STEPS}];
#define STAMP(k) do {{ __syncthreads(); \\
  if (blockIdx.x == 0 && threadIdx.x == 0 && t < {MAX_STEPS}) \\
    g_stamps[t * 8 + (k)] = vmlmf::global_ns(); }} while (0)
extern "C" int read_stamps(unsigned long long* out) {{
  return cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}}
"""
# (anchor, its replacement): the phase boundaries of each kernel's step
MARKS = {
    "lstm_scan_xin_fwd": [
        ("  for (int t = 0; t < t_len; ++t) {\n",
         "  for (int t = 0; t < t_len; ++t) {\n    STAMP(0);\n"),
        ("      });\n      vmlmf::group_sync(count, plan.ctas, target);\n",
         "      });\n      STAMP(1);\n      vmlmf::group_sync(count, plan.ctas, target);\n"
         "      STAMP(2);\n"),
        ("    });\n    vmlmf::group_sync(count, plan.ctas, target);\n  }\n",
         "    });\n    STAMP(3);\n    vmlmf::group_sync(count, plan.ctas, target);\n"
         "    STAMP(4);\n  }\n")],
    "lstm_scan_xin_bwd": [
        ("    __syncthreads();  // pa, and the carry that phase C wrote\n",
         "    __syncthreads();  // pa, and the carry that phase C wrote\n    STAMP(0);\n"),
        ("      dhc[at] = dhp;\n    }\n    vmlmf::group_sync(count, plan.ctas, target);\n",
         "      dhc[at] = dhp;\n    }\n    STAMP(1);\n"
         "    vmlmf::group_sync(count, plan.ctas, target);\n    STAMP(2);\n"),
        ("      });\n      vmlmf::group_sync(count, plan.ctas, target);\n    }\n",
         "      });\n      STAMP(3);\n      vmlmf::group_sync(count, plan.ctas, target);\n"
         "      STAMP(4);\n    }\n"),
        ("dhc[jj * rpad + 4 * rb + i] += acc[c][i];\n      }\n    });\n",
         "dhc[jj * rpad + 4 * rb + i] += acc[c][i];\n      }\n    });\n    STAMP(5);\n")],
}


def stamped_libraries(work):
    """Build the stamped copies of the two scan sources -> {name: CDLL}."""
    src = os.path.join(work, "csrc")
    shutil.copytree(_build.CSRC, src)
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
    and the BPTT: each product's device ms (its tc_gemm_kernel and, split
    over k, its tc_sum_kernel) beside the device ms of ``torch.matmul`` of
    the same shape (f32 with TF32 off, and bf16), all of one profiler
    session, and the entry's device ms by part. A spin kernel between the
    groups of calls tells their kernels apart."""
    calls = entries(shape, precision)
    out, tf32 = {}, torch.backends.cuda.matmul.allow_tf32
    for entry in ("fwd", "bwd"):
        want = products(shape, entry)
        mats = [operands(m, n, k, dtype) for _, m, n, k in want
                for dtype in (torch.float32, torch.bfloat16)]
        groups = [calls[entry]] + [lambda a=a, b=b: torch.matmul(a, b) for a, b in mats]
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
        split, runs = {"walk": 0.0, "gemm": 0.0, "other": 0.0}, []
        for name, ms in segments[0]:
            part = ("walk" if "grid_scan_kernel" in name or "grid_bptt_kernel" in name else
                    "gemm" if "tc_gemm_kernel" in name or "tc_sum_kernel" in name else "other")
            split[part] += ms
            if "tc_gemm_kernel" in name:
                runs.append([name, ms])
            elif "tc_sum_kernel" in name and runs:
                runs[-1][1] += ms
        matmul = [round(sum(ms for _, ms in seg), 4) for seg in segments[1:1 + len(mats)]]
        per_call = len(runs) // reps
        rows = []
        for i, (name, ms) in enumerate(runs[:per_call]):  # the products of one call
            row = {"kernel": name, "ms": round(sum(runs[c * per_call + i][1]
                                                   for c in range(reps)), 4)}
            if per_call == len(want):
                label, m, n, k = want[i]
                row.update(product=label, m=m, n=n, k=k, matmul_f32_ms=matmul[2 * i],
                           matmul_bf16_ms=matmul[2 * i + 1])
            rows.append(row)
        out[entry] = {"products": rows, "split": {k: round(v, 4) for k, v in split.items()}}
    return out


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


def spans(lib, steps, marks):
    """Mean µs between consecutive marks over the steps in walk order (the
    first left out), and of a whole step (mark to mark of the next step)."""
    buf = (ctypes.c_ulonglong * (8 * MAX_STEPS))()
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    if lib.read_stamps(ctypes.addressof(buf)) != 0:
        raise RuntimeError("reading the stamps failed")
    rows = [[buf[s * 8 + k] for k in marks] for s in steps][1:]
    out = {f"{a}->{b}": round(sum(r[i + 1] - r[i] for r in rows) / len(rows) / 1e3, 3)
           for i, (a, b) in enumerate(zip(marks, marks[1:]))}
    out["step"] = round((rows[-1][0] - rows[0][0]) / (len(rows) - 1) / 1e3, 3)
    return out


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    _build.build_all()
    work = tempfile.mkdtemp(dir=_build.BUILD_DIR)  # git-ignored, beside the package's builds
    try:
        libs = stamped_libraries(work)
        for name, shape in SHAPES.items():
            t, r = shape[0], shape[5]
            row = {"shape": name, "card": torch.cuda.get_device_name(0),
                   "plan": cuda_scan.scan_plan(shape[1], shape[3], r).ints("fwd"), "device": {}}
            for tt in (t, 2 * t):
                for entry, fn in entries((tt, *shape[1:])).items():
                    row["device"][f"{entry}_T{tt}"] = device_ms(fn)
            calls = entries(shape)
            load, _build.load = _build.load, lambda n: libs[n]
            try:
                calls["fwd"]()
                torch.cuda.synchronize()
                row["stamps_fwd"] = spans(libs["lstm_scan_xin_fwd"], range(t),
                                          [0, 1, 2, 3, 4] if r else [0, 3, 4])
                calls["bwd"]()
                torch.cuda.synchronize()
                row["stamps_bwd"] = spans(libs["lstm_scan_xin_bwd"], range(t - 1, -1, -1),
                                          [0, 1, 2, 3, 4, 5] if r else [0, 1, 2, 5])
            finally:
                _build.load = load
            row["gemm"] = gemm_phase(shape, "f32")
            if name in BF16_SHAPES:
                row["gemm_bf16"] = gemm_phase(shape, "bf16")
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
