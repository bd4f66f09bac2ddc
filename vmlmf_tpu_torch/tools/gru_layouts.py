"""Time the GRU kernels on the row layout against the grid layout at the same
shapes, on one CUDA device.

    python -m vmlmf_tpu_torch.tools.gru_layouts [h ...]

For each width h (by default 135, 136, 137, 180, 256, 512 and 1000), each
recurrent form (dense "pre", dense "post", low-rank "pre" with r = h/4;
T=24, F=77, a dense x side) and B = 81 and 256, the three x-mode entries
run on `gru_plan`'s row layout and on the grid (`gru_grid_chunks`), each
forced through `cuda_gru._plan_for`: the mean ms of 5 calls after one
(CUDA events) of the no-grad forward, the residual forward and the BPTT
(from dys, no dx). Each line also gives where the row plan keeps each
kernel's recurrent weights and the layout `gru_layout` takes for each
kernel. This is how the rule of `gru_layout` was chosen.

Prints the card's name and power limit, then one JSON line a shape.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from vmlmf_tpu_torch.ops import _build, cuda_gru

T, F = 24, 77
WIDTHS = (135, 136, 137, 180, 256, 512, 1000)
FORMS = (("dense_pre", "pre", False), ("dense_post", "post", False),
         ("lowrank_pre", "pre", True))


def inputs(b, h, r):
    """Seeded (xs, ux, vx, bias, uf, prz, pn, h0) on the card, a dense x
    side, a dense recurrent side where r = 0; and dys."""
    g = torch.Generator().manual_seed(0)

    def n(*shape, scale):
        return (scale * torch.randn(shape, generator=g)).cuda()

    k = r or h
    args = (n(T, b, F, scale=1.0), n(F, 3 * h, scale=F ** -0.5), None, n(3 * h, scale=0.1),
            n(h, r, scale=h ** -0.5) if r else None, n(k, 2 * h, scale=k ** -0.5),
            n(k, h, scale=k ** -0.5), n(b, h, scale=0.5))
    return args, n(T, b, h, scale=0.1)


def mean_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def entry_ms(args, dys, mode):
    """ms of the no-grad forward, the residual forward and the BPTT."""
    res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode)
    saved = (*args[:3], *args[4:], *res, dys)
    return [mean_ms(lambda: cuda_gru.gru_scan_fused_xin(*args, mode=mode)),
            mean_ms(lambda: cuda_gru.gru_scan_fused_xin_res(*args, mode=mode)),
            mean_ms(lambda: cuda_gru.gru_scan_xin_bwd(*saved, mode=mode, dx=False))]


def main(argv=None):
    widths = [int(a) for a in (sys.argv[1:] if argv is None else argv)] or WIDTHS
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _build.build_all()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    forced = cuda_gru._plan_for
    try:
        for h in widths:
            for name, mode, lowrank in FORMS:
                r = max(1, h // 4) if lowrank else 0
                form = cuda_gru.form_of(object() if lowrank else None, mode)
                for b in (81, 256):
                    row = cuda_gru.gru_plan(T, b, F, 0, h, r, form, sms=sms)
                    layouts = {"rows": row,
                               "grid": cuda_gru.gru_grid_chunks(T, b, F, 0, h, r, form, sms=sms)}
                    args, dys = inputs(b, h, r)
                    out = {"h": h, "r": r, "b": b, "form": name,
                           "row_weights": [row.rec_weights, row.bwd_rec_weights],
                           "takes": ["rows" if isinstance(cuda_gru.gru_layout(
                               T, b, F, 0, h, r, form, kernel=k, sms=sms), cuda_gru.GRUPlan)
                                     else "grid" for k in ("fwd", "bwd")]}
                    for label, layout in layouts.items():
                        cuda_gru._plan_for = lambda *a, gi=False, chosen=layout: chosen
                        out[label] = entry_ms(args, dys, mode)
                    cuda_gru._plan_for = forced
                    print(json.dumps(out), flush=True)
    finally:
        cuda_gru._plan_for = forced


if __name__ == "__main__":
    main()
