"""Where a step of the LSTM scan kernels goes, on one CUDA device.

    python -m vmlmf_tpu_torch.tools.scan_phases

Two readings for each shape (the PTB LM layer, T=35, F=h=650, low-rank
r=rx=300 at B in 1/20/128 and dense at B=20; the HAR layer, T=24, F=77,
h=180, low-rank r=6 and dense, B=81):

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
}
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


def entries(shape):
    """{entry: a call of it} on seeded inputs of ``shape``."""
    t, b, _, h = shape[:4]
    args = inputs(*shape)
    res = cuda_scan.lstm_scan_fused_xin_res(*args)
    dys = 0.1 * torch.randn(t, b, h, generator=torch.Generator().manual_seed(5)).cuda()
    saved = (*args[:4], *args[5:], *res)
    return {"fwd": lambda: cuda_scan.lstm_scan_fused_xin(*args),
            "res": lambda: cuda_scan.lstm_scan_fused_xin_res(*args),
            "bwd": lambda: cuda_scan.lstm_scan_xin_bwd(*saved, dys, None)}


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
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
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
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
