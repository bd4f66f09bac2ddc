"""Time the LSTM scan kernels of several checkouts of this repo in turns, in
one run, on one CUDA device.

    python -m vmlmf_tpu_torch.tools.ab_scan PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout (for example another commit,
unpacked from ``git archive``). Each runs in a subprocess of its own, which
imports that checkout's `vmlmf_tpu_torch`, builds its kernels there, and
prints one JSON line: the checkout, the card, and for each recurrent form,
entry and B in 1, 20 and 128 the mean ms of 20 calls at the PTB LM layer
(T=35, F=h=650), taken three times, on the same seeded inputs. The entries:
"fwd" (`lstm_scan_fused_xin`, no grad), "res" (`lstm_scan_fused_xin_res`,
the residual forward of training) and "bwd" (`lstm_scan_xin_bwd`, the BPTT,
from dys alone). The forms: "lowrank" (r=rx=300, the VMLMF LM) and "dense"
(U and Ux [650, 2600], no diagonals, the dense LM). A checkout that has
`ops/cuda_stack.py` also times the no-grad wavefront stack,
`lstm_stack_scan_fused`, on the two layers of the VMLMF LM ("stack").
Each line also gives, under "ptxas", the registers and spill bytes that
``nvcc -Xptxas -v`` reports for each form of the checkout's serial kernels
(`scan_kernel` and `bptt_kernel` or their grid forms, `stack_step_kernel`)
at the build's flags.
Giving the checkouts as parent, change, change, parent keeps drift on the
card from reading as a difference between them.
"""

from __future__ import annotations

import subprocess
import sys

CHILD = r"""
import json, os, re, subprocess, sys
sys.path.insert(0, sys.argv[1])
import importlib.util
import torch
from vmlmf_tpu_torch.ops import _build, cuda_scan

torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
t, f, h, rx, r = 35, 650, 650, 300, 300


def inputs(b, form):
    g = torch.Generator().manual_seed(0)
    n = lambda *s, scale: (scale * torch.randn(s, generator=g)).cuda()
    if form == "dense":
        return (n(t, b, f, scale=1.0), n(f, 4 * h, scale=f ** -0.5), None,
                torch.zeros(4, h).cuda(), n(4 * h, scale=0.1), n(h, 4 * h, scale=h ** -0.5), None,
                torch.zeros(4 * h).cuda(), n(b, h, scale=0.5), n(b, h, scale=0.5))
    return (n(t, b, f, scale=1.0), n(f, rx, scale=f ** -0.5), n(rx, 4 * h, scale=rx ** -0.5),
            n(4, h, scale=0.1), n(4 * h, scale=0.1), n(h, r, scale=h ** -0.5),
            n(r, 4 * h, scale=r ** -0.5), n(4 * h, scale=0.1), n(b, h, scale=0.5),
            n(b, h, scale=0.5))


def stack_inputs(b):
    g = torch.Generator().manual_seed(0)
    n = lambda *s, scale: (scale * torch.randn(s, generator=g)).cuda()
    layers = []
    for l in range(2):
        lay = dict(u=n(h, r, scale=h ** -0.5), v=n(r, 4 * h, scale=r ** -0.5),
                   dvec=n(4 * h, scale=0.1))
        if l:
            lay.update(ux=n(h, rx, scale=h ** -0.5), vx=n(rx, 4 * h, scale=rx ** -0.5),
                       dxvec=n(4 * h, scale=0.1), bias=n(4 * h, scale=0.1))
        layers.append(lay)
    return (n(t, b, 4 * h, scale=1.0), layers, [n(b, h, scale=0.5) for _ in range(2)],
            [n(b, h, scale=0.5) for _ in range(2)])


def mean_ms(fn, args, iters=20):
    fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ptxas(source):
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS[:4], "-Xptxas", "-v", "-c", "-o", os.devnull,
           str(_build.CSRC / source)]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
    stats, name, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(grid_scan_kernel|grid_bptt_kernel|scan_kernel|bptt_kernel|"
                          r"stack_step_kernel)I((?:Lb[01]E)+)E", line)
            name = m and f"{m.group(1)}<{','.join(re.findall(r'Lb([01])E', m.group(2)))}>"
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            stats[name] = dict(registers=regs, spill_bytes=spill)
    return stats


def entry_ms(b, form):
    args = inputs(b, form)
    res = cuda_scan.lstm_scan_fused_xin_res(*args)
    dys = torch.randn(t, b, h, generator=torch.Generator().manual_seed(5)).cuda()
    saved = (*args[:4], *args[5:], *res)
    return {"fwd": [mean_ms(cuda_scan.lstm_scan_fused_xin, args) for _ in range(3)],
            "res": [mean_ms(cuda_scan.lstm_scan_fused_xin_res, args) for _ in range(3)],
            "bwd": [mean_ms(cuda_scan.lstm_scan_xin_bwd, (*saved, dys, None)) for _ in range(3)]}


sources = [s for s in ("lstm_scan_xin_fwd.cu", "lstm_scan_xin_bwd.cu", "lstm_stack_fwd.cu")
           if (_build.CSRC / s).exists()]
regs = {s: ptxas(s) for s in sources}
ms = {form: {b: entry_ms(b, form) for b in (1, 20, 128)} for form in ("lowrank", "dense")}
if importlib.util.find_spec("vmlmf_tpu_torch.ops.cuda_stack") is not None:
    from vmlmf_tpu_torch.ops import cuda_stack
    ms["stack"] = {b: [mean_ms(cuda_stack.lstm_stack_scan_fused, stack_inputs(b))
                       for _ in range(3)] for b in (1, 20, 128)}
print(json.dumps({"checkout": sys.argv[1], "card": torch.cuda.get_device_name(0), "ms": ms,
                  "ptxas": regs}))
"""


def main(argv=None):
    dirs = sys.argv[1:] if argv is None else argv
    if not dirs:
        raise SystemExit(__doc__)
    for d in dirs:
        subprocess.run([sys.executable, "-c", CHILD, d], check=True, timeout=600)


if __name__ == "__main__":
    main()
