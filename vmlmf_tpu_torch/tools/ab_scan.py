"""Time the no-grad scan kernel of several checkouts of this repo in turns,
in one run, on one CUDA device.

    python -m vmlmf_tpu_torch.tools.ab_scan PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout (for example another commit,
unpacked from ``git archive``). Each runs in a subprocess of its own, which
imports that checkout's `vmlmf_tpu_torch`, builds its kernels there, and
prints one JSON line: the checkout, the card, and for B in 1, 20 and 128 the
mean ms of 20 calls of `lstm_scan_fused_xin` at the PTB LM layer (T=35,
F=h=650, r=rx=300), taken three times, on the same seeded inputs.
Giving the checkouts as parent, change, change, parent keeps drift on the
card from reading as a difference between them.
"""

from __future__ import annotations

import subprocess
import sys

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from vmlmf_tpu_torch.ops import _build, cuda_scan

torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
t, f, h, rx, r = 35, 650, 650, 300, 300


def inputs(b):
    g = torch.Generator().manual_seed(0)
    n = lambda *s, scale: (scale * torch.randn(s, generator=g)).cuda()
    return (n(t, b, f, scale=1.0), n(f, rx, scale=f ** -0.5), n(rx, 4 * h, scale=rx ** -0.5),
            n(4, h, scale=0.1), n(4 * h, scale=0.1), n(h, r, scale=h ** -0.5),
            n(r, 4 * h, scale=r ** -0.5), n(4 * h, scale=0.1), n(b, h, scale=0.5),
            n(b, h, scale=0.5))


def mean_ms(args, iters=20):
    cuda_scan.lstm_scan_fused_xin(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        cuda_scan.lstm_scan_fused_xin(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


ms = {b: [mean_ms(inputs(b)) for _ in range(3)] for b in (1, 20, 128)}
print(json.dumps({"checkout": sys.argv[1], "card": torch.cuda.get_device_name(0), "ms": ms}))
"""


def main(argv=None):
    dirs = sys.argv[1:] if argv is None else argv
    if not dirs:
        raise SystemExit(__doc__)
    for d in dirs:
        subprocess.run([sys.executable, "-c", CHILD, d], check=True, timeout=600)


if __name__ == "__main__":
    main()
