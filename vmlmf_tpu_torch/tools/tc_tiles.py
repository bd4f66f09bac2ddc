"""The two tiles of csrc/gemm_tc.cuh side by side, on one CUDA device: the
numbers of the rule that sends a product to one of them (`cuda_scan.tc_route`).

    python -m vmlmf_tpu_torch.tools.tc_tiles [--error | --gru]

For each product of the GEMM phases (`cuda_scan.gemm_products`: the
projection, the recompute pre-pass and the BPTT) of the HAR layer (T=24,
F=77, h=180, low-rank rx=8, r=6, and dense) at B=81, the PTB medium LM
layer (T=35, F=h=650, r=rx=300, and dense) at B = 20 and 128 and the dense
h=1500 layer at B = 20 and 128, at the operand views the scans give it and
with a Store epilogue: the device ms of one call (`torch.profiler`'s
kernel times over 5 calls, after a warm one, the NaN fill of the output
left out) on the Hopper tile (`tc_check.HOPPER`: its staged copies, the
tile, its split-k sum) and on the Ampere tile (`tc_check.AMPERE`, split by
its own plan), in f32 and bf16, and the multiply-adds. Prints the card's
name and power limit, then one JSON line a product shape.

``--error``: the numbers of the chunk of the Hopper tile's two-level sum
instead: at the dense h=1500 layer's dx = dPre Ux^T (k = 6000) and dU =
Hprev^T dPre (k = 4480) at B=128, for bf16 chunks of 1 to 64 stages (and
one chunk over all of k), the max abs error over the max abs float64
output of the same (bf16-rounded) operands, and the device ms; f32 (its
chunk one k8 step whatever ``flush`` says) beside them.

Both ways, then the GRU BPTT's products that the rule sends to the Hopper
tile (`tc_check.GRU_PRODUCTS`: the recurrent weight gradients of the three
forms and the recompute pre-pass's (R * Hprev) @ W) at the HAR GRU nets'
h=3200 (T=24, B=81, r=800) and at h=1000 (B=256, a chunk of B=512), on
seeded residuals: the device ms and the error over float64 (as above) of
each on the Hopper tile in 3xTF32 (`tc_check.GRU_HOPPER`, staging passes
included), on gemm_tile.cuh's CUDA-core split-k (`GRU_TILE`, the tile
those products ran on before) and, where its operands are plain views
(dPrz dense: PrevRowsT, RowMajor), on the Ampere tile. ``--gru`` prints
these alone.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vmlmf_tpu_torch.ops import cuda_scan, tc_check

LAYERS = {"har": ((24, 77, 180, 8, 6), (81,)), "har_dense": ((24, 77, 180, 0, 0), (81,)),
          "lm": ((35, 650, 650, 300, 300), (20, 128)),
          "lm_dense": ((35, 650, 650, 0, 0), (20, 128)),
          "dense1500": ((35, 1500, 1500, 0, 0), (20, 128))}


def shapes():
    """{(m, n, k, a_kind, b_kind): [layer B=b, ...]} of every product."""
    out = {}
    for layer, ((t, f, h, rx, r), batches) in LAYERS.items():
        for b in batches:
            for entry, extra in (("fwd", {}), ("bwd", {"recompute": True})):
                for m, n, k, (_, a_along), (_, b_along), _, _ in cuda_scan.gemm_products(
                        t, b, f, rx, h, r, entry, **extra):
                    key = (m, n, k, 0 if a_along else 1, 0 if b_along else 1)
                    out.setdefault(key, [])
                    if f"{layer} B={b}" not in out[key]:
                        out[key].append(f"{layer} B={b}")
    return out


def time_ms(fn, reps=5):
    """Device ms of the port's kernels in one call of fn."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and "vmlmf" in e.name) / 1e3 / reps


def errors(g):
    """One JSON line a product and chunk: the error and ms of the Hopper
    tile's two-level sum by the stages a chunk."""
    m, h = 35 * 128, 1500
    for name, (a_kind, b_kind, m_, n_, k_) in {"dx": (0, 1, m, h, 4 * h),
                                               "dU": (1, 0, h, 4 * h, m)}.items():
        a0 = torch.randn((m_, k_) if a_kind == 0 else (k_, m_), generator=g).cuda()
        b0 = torch.randn((k_, n_) if b_kind == 0 else (n_, k_), generator=g).cuda()
        a, b = tc_check.operands(a_kind, b_kind, a0, None, b0)
        for flush in (1, 2, 4, 8, 16, 64, 1 << 20):
            row = {"product": name, "m": m_, "n": n_, "k": k_, "flush_stages": flush}
            for bf16 in (False, True):
                def call():
                    return tc_check.tc_product(a_kind, b_kind, a0, None, 0, a0.shape[1], b0,
                                               b0.shape[1], m_, n_, k_, bf16,
                                               tile=tc_check.HOPPER, flush=flush)
                want_a, want_b = (a.bfloat16().float(), b.bfloat16().float()) if bf16 else (a, b)
                key = "bf16" if bf16 else "f32"
                row[f"{key}_err"] = tc_check.relative_error(call(), want_a, want_b)
                row[f"{key}_ms"] = round(time_ms(call), 4)
            print(json.dumps(row), flush=True)


GRU_SHAPES = {"h3200": (24, 81, 3200, 800), "h1000": (24, 256, 1000, 250)}


def gru_products(g):
    """One JSON line a GRU product and shape: ms and error on each tile."""
    for name, (t, b, h, r) in GRU_SHAPES.items():
        m = t * b

        def n(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=g)).cuda()

        h0, ys = n(b, h, scale=0.5), torch.tanh(n(t, b, h))
        gates = torch.sigmoid(n(t, b, 3 * h))
        v = dict(hu=n(m, r), rhu=n(m, r), dhu=n(m, r, scale=0.1), drhu=n(m, r, scale=0.1),
                 w=n(h, r, scale=h ** -0.5))
        dpre = n(m, 3 * h, scale=0.1)
        for p, (label, shape, _, _) in enumerate(tc_check.GRU_PRODUCTS):
            mm, nn, kk = shape(m, h, r, r)
            a, bb = tc_check.gru_sources(p, h0, ys, gates, dpre, **v)
            row = {"shape": name, "product": label, "m": mm, "n": nn, "k": kk,
                   "macs": mm * nn * kk, "route": "hopper" if cuda_scan.tc_route(mm, nn, kk)
                   else "gemm_tile"}
            tiles = {"hopper": lambda: tc_check.gru_product(p, tc_check.GRU_HOPPER, h0, ys, gates,
                                                            dpre, **v),
                     "gemm_tile": lambda: tc_check.gru_product(p, tc_check.GRU_TILE, h0, ys, gates,
                                                               dpre, **v)}
            if p == 0:  # PrevRowsT x RowMajor: the Ampere tile takes it too
                tiles["ampere"] = lambda: tc_check.tc_product(
                    3, 0, h0, ys.reshape(m, h), b, h, dpre, 3 * h, h, 2 * h, m, False,
                    tile=tc_check.AMPERE)
            for tile, call in tiles.items():
                row[f"{tile}_err"] = tc_check.relative_error(call(), a, bb)
                row[f"{tile}_ms"] = round(time_ms(call), 4)
            print(json.dumps(row), flush=True)
            del a, bb


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    g = torch.Generator().manual_seed(0)
    if "--gru" in argv:
        gru_products(g)
        return
    if "--error" in argv:
        errors(g)
        gru_products(g)
        return
    for (m, n, k, a_kind, b_kind), where in shapes().items():
        a0 = torch.randn((m, k) if a_kind == 0 else (k, m), generator=g).cuda()
        b0 = torch.randn((k, n) if b_kind == 0 else (n, k), generator=g).cuda()
        lda, ldb = a0.shape[1], b0.shape[1]
        row = {"m": m, "n": n, "k": k, "views": [a_kind, b_kind], "where": where,
               "macs": m * n * k, "route": "hopper" if cuda_scan.tc_route(m, n, k) else "ampere"}
        for bf16 in (False, True):
            for name, tile in (("hopper", tc_check.HOPPER), ("ampere", tc_check.AMPERE)):
                row[f"{name}_{'bf16' if bf16 else 'f32'}_ms"] = round(time_ms(
                    lambda: tc_check.tc_product(a_kind, b_kind, a0, None, 0, lda, b0, ldb, m, n,
                                                k, bf16, tile=tile)), 4)
        print(json.dumps(row), flush=True)
    gru_products(g)


if __name__ == "__main__":
    main()
