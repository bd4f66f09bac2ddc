"""The ring of the LSTM scans' streamed plans, swept on one CUDA device.

    python -m vmlmf_tpu_torch.tools.ring_sweep [--bf16]

For the PTB "large" LM's layer (T=35, F=h=1500), dense and low-rank
(r=rx=750), at B = 1, 20 and 128 in f32: the device ms of the three x-mode
entries (no-grad forward, residual forward, BPTT from dys) on the
streamed plan (`cuda_scan.streamed_plan`) with stages of each size in
`PIECES` (the ring's two stages; a stage larger than fits beside the
slabs is cut to the most that fits). Each reading is the mean of 10 calls
between CUDA events, taken in two rounds, the second in the reverse order
of the first; each plan's floats a stage, resident depths and streamed MB
a step beside it. Then, at each shape of `BF16_SHAPES` (widths whose f32
weights stream and whose bf16 ones are resident, at batches that a
resident bf16 plan takes in chunks of rows, and the large layer at B=20,
where its resident plan is one launch), the bf16 layer's resident plans
(`resident_chunks`; one launch where a resident plan takes the batch)
against one streamed launch, each entry: the two sides of
`cuda_scan.scan_chunks`' bf16 rule (one streamed launch where no resident
plan takes the batch, or where it is an mma plan of `MMA_STREAM_ROWS` rows
or more). Then, at the batches whose groups pad to 4 rows (`SMALL_SHAPES`),
the bf16 resident plan on the FMA product against the same grouping on the
tensor-core walk (`ScanPlan.mma` forced, rows padded to 8), and at
batches whose groups pad to 16 rows or more the FMA layout against the
tensor-core one (each the first grouping that fits): the sides of
`MMA_MIN_ROWS`. ``--bf16``: the bf16 readings alone.

Prints one JSON line a shape, the card's name and power limit first.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from vmlmf_tpu_torch.ops import _build, cuda_scan

SHAPES = {"dense_b1": (1, 0), "dense_b20": (20, 0), "dense_b128": (128, 0),
          "lowrank_b1": (1, 750), "lowrank_b20": (20, 750), "lowrank_b128": (128, 750)}
T, H = 35, 1500
ITERS = 10
# floats a stage of the rings swept: 8, 16, 24, 48, 64, 80, 96 and 104 KB
PIECES = (2048, 4096, 6144, 12288, 16384, 20480, 24576, 26624)
# (B, h, r) of the bf16 rule's check: the large layer at B=128 and at the
# least batch that needs two resident chunks, a dense h=1100 and the
# low-rank r=750 layer at theirs
BF16_SHAPES = ((128, 1500, 0), (53, 1500, 0), (201, 1100, 0), (125, 1500, 750), (20, 1500, 0))
# (B, h, r) of the walk's rule: groups that pad to 4 rows (the large layer
# at B = 1 and 4, the PTB LM layer at B = 1 and 20) and to 16 or more (the
# PTB LM layer at B = 64, 128 and 256, the dense one at 128)
SMALL_SHAPES = ((1, 1500, 0), (4, 1500, 0), (1, 650, 300), (20, 650, 300), (64, 650, 300),
                (128, 650, 300), (256, 650, 300), (128, 650, 0))


def inputs(b, r, h=H, seed=0):
    g = torch.Generator().manual_seed(seed)

    def n(*shape, scale):
        return (scale * torch.randn(shape, generator=g)).cuda()

    k = r or 4 * h
    return (n(T, b, h, scale=1.0), n(h, r or 4 * h, scale=h ** -0.5),
            n(r, 4 * h, scale=r ** -0.5) if r else None, n(4, h, scale=0.1),
            n(4 * h, scale=0.1), n(h, k, scale=h ** -0.5),
            n(r, 4 * h, scale=r ** -0.5) if r else None, n(4 * h, scale=0.1),
            n(b, h, scale=0.5), n(b, h, scale=0.5))


def calls(b, r, precision="f32", h=H):
    """{entry: a call of it} on seeded inputs."""
    args = inputs(b, r, h)
    res = cuda_scan.lstm_scan_fused_xin_res(*args, precision)
    dys = 0.1 * torch.randn(T, b, h, generator=torch.Generator().manual_seed(5)).cuda()
    saved = (*args[:4], *args[5:], *res, dys, None)
    return {"fwd": lambda: cuda_scan.lstm_scan_fused_xin(*args, precision),
            "res": lambda: cuda_scan.lstm_scan_fused_xin_res(*args, precision),
            "bwd": lambda: cuda_scan.lstm_scan_xin_bwd(*saved, precision=precision)}


def event_ms(fn):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def on_chunks(chunks, fn):
    """fn run with the wrappers taking ``chunks`` for every batch."""
    keep = cuda_scan._chunks_for
    cuda_scan._chunks_for = lambda *a, **k: chunks
    try:
        return fn()
    finally:
        cuda_scan._chunks_for = keep


def describe(plan):
    return dict(ctas=plan.n_ctas, piece=(plan.piece_fwd, plan.piece_bwd),
                resident=(plan.resident_fwd, plan.resident_bwd),
                streamed_mb=[round(4 * cuda_scan.stream_floats(plan, k) / 1e6, 3)
                             for k in ("fwd", "bwd")])


def timed(sides, fns):
    """{side: {"ms": {entry: [round 1, round 2]}}} of each side's chunks."""
    out = {name: {"ms": {}} for name in sides}
    order = list(sides)
    for rnd in (order, order[::-1]):
        for name in rnd:
            for entry, fn in fns.items():
                out[name]["ms"].setdefault(entry, []).append(
                    round(on_chunks(sides[name], lambda: event_ms(fn)), 4))
    return out


def sweep(b, r, sms):
    """{"p<floats>": {"plan": ..., "ms": {entry: [round 1, round 2]}}}."""
    plans = {f"p{piece}": cuda_scan.streamed_plan(b, H, r, sms, piece=piece) for piece in PIECES}
    out = timed({name: ((0, b, p),) for name, p in plans.items()}, calls(b, r))
    for name, p in plans.items():
        out[name]["plan"] = describe(p)
    return out


def resident_chunks(b, h, r, sms):
    """The bf16 layer's batch in as few chunks as each have a resident
    plan: `scan_chunks` without its bf16 rule."""
    for n in range(1, b + 1):
        bounds = [cuda_scan._split_at(i, b, n) for i in range(n + 1)]
        try:
            return tuple((b0, b1 - b0, cuda_scan.scan_plan(b1 - b0, h, r, sms, 2))
                         for b0, b1 in zip(bounds, bounds[1:]))
        except ValueError:
            continue
    raise ValueError(f"no bf16 plan for B=1, h={h}, r={r}")


def bf16_sides(b, h, r, sms):
    """The bf16 layer: resident chunks against a streamed plan in one
    launch, and which `scan_chunks` takes -> {"chunks" | "streamed": ...}."""
    sides = {"chunks": resident_chunks(b, h, r, sms),
             "streamed": ((0, b, cuda_scan.streamed_plan(b, h, r, sms, 2)),)}
    out = timed(sides, calls(b, r, "bf16", h))
    for name, chunks in sides.items():
        out[name].update(launches=len(chunks), plan=describe(chunks[0][2]))
    taken = cuda_scan.scan_chunks(b, h, r, sms, 2)
    out["scan_chunks_takes"] = "streamed" if taken[0][2].streamed else "chunks"
    out["mma"] = [chunks[0][2].mma for chunks in sides.values()]
    return out


def mma_sides(b, h, r, sms):
    """The bf16 layer's resident plan on the FMA product against its
    resident plan on the tensor-core walk, each the first grouping of
    `scan_plan`'s search that fits in its layout."""
    sides = {name: ((0, b, cuda_scan._fits_resident(b, h, r, sms, 2, mma=mma)),)
             for name, mma in (("fma", False), ("mma", True))}
    out = timed(sides, calls(b, r, "bf16", h))
    for name, chunks in sides.items():
        p = chunks[0][2]
        out[name].update(plan=describe(p), groups=p.groups, rpad=p.rpad)
    out["rule"] = "mma" if cuda_scan.scan_plan(b, h, r, sms, 2).mma else "fma"
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    _build.build_all()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = torch.cuda.get_device_name(0)
    for name, (b, r) in SHAPES.items() if "--bf16" not in argv else ():
        print(json.dumps({"shape": name, "card": card, "sweep": sweep(b, r, sms)}), flush=True)
    for b, h, r in BF16_SHAPES:
        print(json.dumps({"shape": f"bf16_h{h}_r{r}_b{b}", "card": card,
                          "sides": bf16_sides(b, h, r, sms)}), flush=True)
    for b, h, r in SMALL_SHAPES:
        print(json.dumps({"shape": f"bf16_small_h{h}_r{r}_b{b}", "card": card,
                          "sides": mma_sides(b, h, r, sms)}), flush=True)


if __name__ == "__main__":
    main()
