"""Where a step of the GRU scan kernels goes, on one CUDA device.

    python -m vmlmf_tpu_torch.tools.gru_phases

Two readings for the HAR GRU layer (T=24, F=77, h=64, rx=9) in each
recurrent form ("lowrank_pre" r=9, "dense_post", "dense_pre") at the train
batch B=81, and of the no-grad forward at `evaluate`'s B=256:

* ``device``: `torch.profiler`'s device µs by kernel for each entry
  (no-grad forward, residual forward, BPTT from dys) at T and at 4T, and
  ``per_step``: for each kernel, (µs at 4T - µs at T) / 3T, the time a step
  costs, and ``fixed``, the rest of its µs at T (staging and the
  projection; the BPTT's GEMMs grow with T through their k = T*B).
* ``stamps``: a copy of ``csrc/`` built apart (in a temporary directory
  under the git-ignored ``_build/``, never over the package's libraries)
  with a `%globaltimer` read by thread 0 of CTA 0 after a `__syncthreads`
  at each phase boundary of every step; the mean µs of each span over the
  steps. Forward, "post": 0->1 the products, 1->2 their shuffles, 2->3 the
  gates and the update, 3->4 the barrier; "pre": 0->5 h @ Uf (low-rank),
  ->6 the gates, ->7 (r*h) @ Uf (low-rank), ->8 the candidate and the
  update. Walk: 0->1 issuing the next step's copies, 1->2 the elementwise
  part and its barrier, then "post" 2->3 the product, "pre" 2->5 dRHU
  (low-rank), ->6 drh, ->7 dHU (low-rank), ->3 the last product; 3->4 the
  wait for the copies.

Then, for the shapes whose kernels take the grid layout (`gru_layout`:
the HAR GRU at its default width h=180, dense x side, "pre" and "post" at
B=81 and 256; the dense "pre" h=1000 at B=512; the three forms at h=3200,
B=81, low-rank x side), the layout and ``device`` µs by kernel of each
entry at T and 2T, ``per_step`` as above, and ``split``: the scan kernel
(`grid_fwd_kernel`, `grid_walk_kernel`) against the GEMMs of the same call
(the forward's projection; the BPTT's dXU, its grouped split-k or the
Hopper tile's products and their staging passes and, under recompute, its
pre-pass), in ms a call; and, where a kernel runs on the TMA ring
(`GRUGridPlan.piece`), ``ring``: from a copy of ``csrc/`` built apart with
``scan_grid.cuh`` patched as `scan_phases` patches it, the µs a step that
CTA 0's first consumer thread waits on the ring's full barriers
(``ring_wait``), that its producer waits for a free stage
(``ring_refill``) and that its thread 0 waits at the group barrier
(``barrier_wait``), beside the kernel's µs a step (``step``); and
``other_ring``: each entry's device µs on another ring, the chosen plan's
against (h=3200) the ring of RING_OTHER-float stages, more pieces a step,
or (h=1000, whose rows are all resident) a ring forced into the staging
buffer's room (`ring_in_stage`), which no plan takes; and ``tiles``: at
h=3200, h=1000 and h=180 B=256, the scan kernel's µs a step (`per_step`)
of each entry on the chosen plan's groups and CTAs with product items of
each height R the kernels are built for (`TILES`: GRUGridPlan.tile_fwd and
tile_bwd, rows
padded to a multiple of R; `with_tile`), and on a ring the waits at each
R; at h=3200 "post" also the forward with 12-row items in one slice and a
larger ring (`one_slice`: no partials, the stage size against the
slices).
``--grid`` runs these alone.

``--sass [CSRC ...]`` builds nothing into the package: it compiles every
source of each csrc directory given (default: the package's; another
checkout's to compare) to a cubin and prints, per source, a digest of its
SASS (addresses, encodings, parameter offsets and the anonymous
namespace's hash left out) and, per kernel by template arguments, ptxas's
registers and spill
bytes, a digest of its own SASS, and the `FFMA` and `LDS.128` of its loop
with the most FFMA (the consumers' product loop; `loop_counts`).

Prints one JSON line a shape, the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vmlmf_tpu_torch.ops import _build, cuda_gru

T, F, H, RX = 24, 77, 64, 9
FORMS = {"lowrank_pre": (9, "pre"), "dense_post": (0, "post"), "dense_pre": (0, "pre")}
MAX_STEPS = 256
STAMP = f"""
__device__ unsigned long long g_stamps[16 * {MAX_STEPS}];
#define STAMP(k) do {{ __syncthreads(); \\
  if (blockIdx.x == 0 && threadIdx.x == 0 && t < {MAX_STEPS}) \\
    g_stamps[t * 16 + (k)] = vmlmf::global_ns(); }} while (0)
extern "C" int read_stamps(unsigned long long* out) {{
  return cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}}
"""
# (anchor, its replacement): the phase boundaries of each kernel's step
MARKS = {
    "gru_scan_xin_fwd": [
        ("    for (int tt = 0; tt < nb; ++tt) {\n",
         "    for (int tt = 0; tt < nb; ++tt) {\n      const int t = t0 + tt;\n      STAMP(0);\n"),
        ("          slice_reduce<3>(acc, live);\n",
         "          STAMP(1);\n          slice_reduce<3>(acc, live);\n          STAMP(2);\n"),
        ("              a.recn[(m0 + row) * h + j] = rec;\n            }\n          }\n        }\n"
         "        __syncthreads();\n",
         "              a.recn[(m0 + row) * h + j] = rec;\n            }\n          }\n        }\n"
         "        STAMP(3);\n        __syncthreads();\n        STAMP(4);\n"),
        ("          __syncthreads();\n          src = hus;",
         "          STAMP(5);\n          __syncthreads();\n          src = hus;"),
        ("        __syncthreads();\n        const float* nsrc = rh;",
         "        STAMP(6);\n        __syncthreads();\n        const float* nsrc = rh;"),
        ("          __syncthreads();\n          nsrc = rhus;",
         "          STAMP(7);\n          __syncthreads();\n          nsrc = rhus;"),
        ("            if (Residuals) a.gates[(m0 + row) * g3 + 2 * h + j] = n;\n          }\n"
         "        }\n        __syncthreads();\n",
         "            if (Residuals) a.gates[(m0 + row) * g3 + 2 * h + j] = n;\n          }\n"
         "        }\n        STAMP(8);\n        __syncthreads();\n")],
    "gru_scan_xin_bwd": [
        ("  int cur = 0;\n  for (int t = a.t_len - 1; t >= 0; --t) {\n",
         "  int cur = 0;\n  for (int t = a.t_len - 1; t >= 0; --t) {\n    STAMP(0);\n"),
        ("    // elementwise: dz_pre, dn_pre",
         "    STAMP(1);\n    // elementwise: dz_pre, dn_pre"),
        ("    __syncthreads();\n\n    if constexpr (kPost) {",
         "    __syncthreads();\n    STAMP(2);\n\n    if constexpr (kPost) {"),
        ("        __syncthreads();\n        drh_src = drhus;",
         "        STAMP(5);\n        __syncthreads();\n        drh_src = drhus;"),
        ("      __syncthreads();\n      const float* last_src = drz;",
         "      STAMP(6);\n      __syncthreads();\n      const float* last_src = drz;"),
        ("        __syncthreads();\n        last_src = dhus;",
         "        STAMP(7);\n        __syncthreads();\n        last_src = dhus;"),
        ("    // No barrier closes the step",
         "    STAMP(3);\n    // No barrier closes the step"),
        ("    vmlmf::cp_async_wait_all();  // this lane's inputs of step t - 1\n",
         "    vmlmf::cp_async_wait_all();  // this lane's inputs of step t - 1\n    STAMP(4);\n")],
}
# the marks each form passes, in the order a step passes them
FWD_MARKS = {"lowrank_pre": [0, 5, 6, 7, 8], "dense_post": [0, 1, 2, 3, 4],
             "dense_pre": [0, 6, 8]}
BWD_MARKS = {"lowrank_pre": [0, 1, 2, 5, 6, 7, 3, 4], "dense_post": [0, 1, 2, 3, 4],
             "dense_pre": [0, 1, 2, 6, 3, 4]}


def stamped_libraries(work):
    """Build the stamped copies of the two GRU sources -> {name: CDLL}."""
    src = os.path.join(work, "csrc")
    shutil.copytree(_build.CSRC, src)
    libs = {}
    for name, marks in MARKS.items():
        path = os.path.join(src, f"{name}.cu")
        text = open(path).read().replace('#include "gru_tile.cuh"\n',
                                         '#include "gru_tile.cuh"\n' + STAMP, 1)
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


# the counters of the ring's build: scan_phases' ring waits, and thread 0
# of CTA 0's wait at a group barrier (group_sync's wait_count)
GROUP_WAIT = [("// Barrier of the `n` CTAs of one group:",
               "__device__ unsigned long long g_group_wait;\n\n"
               "// Barrier of the `n` CTAs of one group:"),
              ("  wait_count(count, target);\n",
               "  {\n    const unsigned long long g0 = global_ns();\n"
               "    wait_count(count, target);\n"
               "    if (blockIdx.x == 0 && threadIdx.x == 0) g_group_wait += global_ns() - g0;\n"
               "  }\n")]
RING_READER = """
extern "C" int ring_counters(unsigned long long* out, int reset) {
  unsigned long long zero = 0;
  cudaError_t e = cudaSuccess;
  if (reset) {
    e = cudaMemcpyToSymbol(vmlmf::g_ring_wait, &zero, 8);
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(vmlmf::g_ring_refill, &zero, 8);
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(vmlmf::g_group_wait, &zero, 8);
    return e;
  }
  e = cudaMemcpyFromSymbol(out, vmlmf::g_ring_wait, 8);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out + 1, vmlmf::g_ring_refill, 8);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out + 2, vmlmf::g_group_wait, 8);
  return e;
}
"""


def ring_libraries(work):
    """Build the GRU sources with scan_grid.cuh's ring waits and group barrier
    timed (`scan_phases.RING_WAIT`, `RING_REFILL`, `GROUP_WAIT`), one nvcc
    each, started together -> {name: CDLL}, each with ring_counters()."""
    from vmlmf_tpu_torch.tools.scan_phases import RING_COUNTER, RING_REFILL, RING_WAIT

    src = os.path.join(work, "csrc")
    shutil.copytree(_build.CSRC, src)
    header = os.path.join(src, "scan_grid.cuh")
    text = open(header).read()
    for anchor, new in (RING_WAIT, RING_REFILL, RING_COUNTER, *GROUP_WAIT):
        if text.count(anchor) < 1:
            raise RuntimeError(f"scan_grid.cuh: the ring's anchor moved: {anchor!r}")
        text = text.replace(anchor, new)
    open(header, "w").write(text)
    procs = {}
    for name in MARKS:
        path = os.path.join(src, f"{name}.cu")
        with open(path, "a") as out:
            out.write(RING_READER)
        lib = os.path.join(work, f"{name}.so")
        procs[name] = (lib, subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
                                              path], stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the ring build of {name}.cu:\n{err}")
        libs[name] = ctypes.CDLL(lib)
        libs[name].ring_counters.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return libs


def ring_waits(libs, calls, plans, t):
    """{kernel: µs a step of the ring's waits and of the kernel} of the
    forward (the no-grad entry) and the walk (the BPTT), each run once on
    the ring's build."""
    out = {}
    load, _build.load = _build.load, lambda n: libs[n]
    try:
        for kernel, entry, lib in (("fwd", "fwd", "gru_scan_xin_fwd"),
                                   ("bwd", "bwd", "gru_scan_xin_bwd")):
            if not any(p.piece(kernel) for p in plans):
                continue
            buf = (ctypes.c_ulonglong * 3)()
            libs[lib].ring_counters(ctypes.addressof(buf), 1)
            calls[entry]()
            torch.cuda.synchronize()
            libs[lib].ring_counters(ctypes.addressof(buf), 0)
            us = device_us(calls[entry], reps=1)
            scan = sum(v for k, v in us.items() if k.startswith("grid_"))
            out[kernel] = dict(ring_wait=round(buf[0] / 1e3 / t, 3),
                               ring_refill=round(buf[1] / 1e3 / t, 3),
                               barrier_wait=round(buf[2] / 1e3 / t, 3),
                               step=round(scan / t, 3))
    finally:
        _build.load = load
    return out


def inputs(t, b, r, f=F, rx=RX, h=H):
    """Seeded (xs, ux, vx, bias, uf, prz, pn, h0) on the card; rx = 0 is a
    dense x side, r = 0 a dense recurrent side."""
    g = torch.Generator().manual_seed(0)

    def n(*shape, scale):
        return (scale * torch.randn(shape, generator=g)).cuda()

    k = r or h
    return (n(t, b, f, scale=1.0), n(f, rx or 3 * h, scale=f ** -0.5),
            n(rx, 3 * h, scale=rx ** -0.5) if rx else None, n(3 * h, scale=0.1),
            n(h, r, scale=h ** -0.5) if r else None, n(k, 2 * h, scale=k ** -0.5),
            n(k, h, scale=k ** -0.5), n(b, h, scale=0.5))


def entries(t, b, form):
    """{entry: a call of it} on seeded inputs; the BPTT from dys alone."""
    r, mode = FORMS[form]
    args = inputs(t, b, r)
    res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode)
    dys = 0.1 * torch.randn(t, b, H, generator=torch.Generator().manual_seed(5)).cuda()
    saved = (*args[:3], *args[4:], *res, dys)
    return {"fwd": lambda: cuda_gru.gru_scan_fused_xin(*args, mode=mode),
            "res": lambda: cuda_gru.gru_scan_fused_xin_res(*args, mode=mode),
            "bwd": lambda: cuda_gru.gru_scan_xin_bwd(*saved, mode=mode)}


def device_us(fn, reps=10):
    """Mean device µs of each kernel in one call of fn, by kernel name."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
            name = name.replace("void ", "").replace("vmlmf::", "")
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / reps
    return {k: round(v, 2) for k, v in sorted(by.items(), key=lambda kv: -kv[1])}


def spans(lib, steps, marks):
    """Mean µs between consecutive marks over the steps in walk order (the
    first left out), and of a whole step (mark to mark of the next step)."""
    buf = (ctypes.c_ulonglong * (16 * MAX_STEPS))()
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    if lib.read_stamps(ctypes.addressof(buf)) != 0:
        raise RuntimeError("reading the stamps failed")
    rows = [[buf[s * 16 + k] for k in marks] for s in steps][1:]
    out = {f"{a}->{b}": round(sum(r[i + 1] - r[i] for r in rows) / len(rows) / 1e3, 3)
           for i, (a, b) in enumerate(zip(marks, marks[1:]))}
    out["step"] = round(abs(rows[-1][0] - rows[0][0]) / (len(rows) - 1) / 1e3, 3)
    return out


# (name, T, B, F, rx, h, r, mode) of the grid shapes
GRID_SHAPES = [("har180_pre", T, 81, F, 0, 180, 0, "pre"), ("har180_post", T, 81, F, 0, 180, 0,
                                                              "post"),
               ("har180_pre", T, 256, F, 0, 180, 0, "pre"), ("har180_post", T, 256, F, 0, 180,
                                                               0, "post"),
               ("h1000_pre", T, 512, F, 0, 1000, 0, "pre"),
               ("h3200_post", T, 81, F, RX, 3200, 0, "post"),
               ("h3200_pre", T, 81, F, RX, 3200, 0, "pre"),
               ("h3200_lowrank_pre", T, 81, F, RX, 3200, 800, "pre")]


RING_OTHER = 8192  # floats a stage of the other ring at h=3200


def ring_in_stage(plan):
    """``plan`` with each kernel on a ring of two stages in its staging
    buffer's room (0 where a stage would not hold a row of the exchange),
    the same order of sums: a plan that no planner picks (every row
    resident), which the checks hold to the staging buffer."""
    fields = {}
    for kernel in ("fwd", "bwd"):
        stage, _, smem = plan.ints(kernel)[3:6]
        piece = plan.piece(kernel) or (stage // cuda_gru.RING_STAGES - 4) // 4 * 4
        piece = piece if piece >= plan.rpad else 0
        if piece and not plan.piece(kernel):
            smem -= 4 * (stage - cuda_gru.RING_STAGES * (piece + 4))
        fields.update({f"piece_{kernel}": piece, f"smem_{kernel}": smem})
    return dataclasses.replace(plan, **fields)


def other_ring(t, b, f, rx, h, r, mode, form, sms, dx):
    """{entry: [device µs on the chosen layout, on the other ring]}."""
    chosen = cuda_gru.gru_grid_chunks(t, b, f, rx, h, r, form, sms=sms)
    if any(p.streamed for _, _, p in chosen):
        other = ((0, b, cuda_gru.grid_streamed_plan(b, h, r, form, sms, RING_OTHER)),)
    else:
        other = tuple((b0, n, ring_in_stage(p)) for b0, n, p in chosen)
    out, keep = {}, cuda_gru._plan_for
    try:
        for layout in (chosen, other):
            cuda_gru._plan_for = lambda *a, gi=False, lay=layout: lay
            for entry, fn in grid_entries(t, b, f, rx, h, r, mode, dx).items():
                out.setdefault(entry, []).append(round(sum(device_us(fn, reps=3).values()), 2))
    finally:
        cuda_gru._plan_for = keep
    return out


TILES = (4, 8, 12)  # the item heights the grid kernels are built for (gru_grid.cuh)


def with_tile(plan, tile, sms):
    """``plan`` with product items of ``tile`` rows: its groups and CTAs, and
    its ring where it streams (`cuda_gru.grid_streamed_plan`); None where
    that does not fit in shared memory."""
    if plan.streamed:
        other = cuda_gru.grid_streamed_plan(plan.b, plan.h, plan.r, plan.form, sms, tile=tile)
    else:
        other = cuda_gru.grid_plan_layout(plan.b, plan.h, plan.r, plan.form, plan.groups,
                                          plan.ctas, tile=tile)
    return other if other.smem_bytes <= cuda_gru.SMEM_LIMIT else None


def one_slice(plan):
    """``plan``'s forward with each product in one depth slice (no partials:
    `red` 0) and its ring's stages grown into red's room, up to
    `cuda_scan.ring_piece`: a plan that no planner picks, the stage size
    weighed against the slices."""
    piece = min(cuda_gru.ring_piece(plan.rpad),
                plan.piece_fwd + plan.red_fwd // cuda_gru.RING_STAGES // 4 * 4)
    smem = plan.smem_fwd - 4 * plan.red_fwd + 4 * cuda_gru.RING_STAGES * (piece - plan.piece_fwd)
    return dataclasses.replace(plan, red_fwd=0, piece_fwd=piece, smem_fwd=smem)


def tile_sweep(name, t, b, f, rx, h, r, mode, form, sms, libs):
    """{R: the scan kernel's µs a step of each entry, the plans' rpad and,
    on a ring, `ring_waits`} on the chosen layout's groups and CTAs with
    items of each height of TILES (`with_tile`), and at h=3200 "post" R=12
    in one slice (`one_slice`)."""
    chosen = cuda_gru.gru_grid_chunks(t, b, f, rx, h, r, form, sms=sms)
    variants = {}
    for tile in TILES:
        layout = tuple((b0, n, with_tile(p, tile, sms)) for b0, n, p in chosen)
        if all(p is not None for _, _, p in layout):
            variants[str(tile)] = layout
    if name == "h3200_post" and "12" in variants:
        variants["12_one_slice"] = tuple((b0, n, one_slice(p)) for b0, n, p in variants["12"])
    names = ("fwd",) if b == 256 else ("fwd", "res", "bwd")
    dx = not name.startswith("har")
    out, keep = {}, cuda_gru._plan_for
    try:
        for label, layout in variants.items():
            cuda_gru._plan_for = lambda *a, gi=False, lay=layout: lay
            plans = [p for _, _, p in layout]
            row = {"rpad": plans[0].rpad, "chosen": layout == chosen,
                   "tiles": (plans[0].tile_fwd, plans[0].tile_bwd),
                   "pieces": [(p.piece_fwd, p.piece_bwd) for p in plans[:1]]}
            scan = {}
            for tt in (t, 2 * t):
                calls = grid_entries(tt, b, f, rx, h, r, mode, dx)
                for entry in names:
                    us = device_us(calls[entry], reps=3)
                    scan[entry, tt] = sum(v for k, v in us.items() if k.startswith("grid_"))
            row["per_step"] = {e: round((scan[e, 2 * t] - scan[e, t]) / t, 3) for e in names}
            if b != 256 and any(p.piece_fwd or p.piece_bwd for p in plans):
                row["ring"] = ring_waits(libs, grid_entries(t, b, f, rx, h, r, mode, dx), plans, t)
            out[label] = row
    finally:
        cuda_gru._plan_for = keep
    return out


KERNEL_NAME = re.compile(r"(grid_fwd_kernel|grid_walk_kernel|scan_kernel|bptt_kernel|fwd_kernel|"
                         r"walk_kernel|stack_fwd_kernel|stack_bwd_kernel)I((?:L[bi]\d+E)+)E")


def _kernel(mangled):
    m = KERNEL_NAME.search(mangled)
    return m and f"{m.group(1)}<{','.join(re.findall(r'L[bi](\d+)E', m.group(2)))}>"


def source_sass(csrc, name, work):
    """One source of a csrc directory compiled to a cubin at the package's
    flags -> {"sass_sha": a digest of its whole SASS (`_sass_sha`: what
    moves when the code does not left out, such as the parameters'
    offsets after a field added to a parameter struct), "kernels":
    {kernel<template arguments>: registers,
    spill bytes, its own SASS digest and, in its loop with the most FFMA
    (`loop_counts`), the FFMA and LDS.128}}."""
    cubin = os.path.join(work, f"{os.path.basename(csrc.rstrip('/'))}-{name}.cubin")
    log = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS[:4], "-cubin", "-Xptxas", "-v",
                          "-o", cubin, os.path.join(csrc, f"{name}.cu")], capture_output=True,
                         text=True, check=True).stderr
    kernels, kernel, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = _kernel(line)
        elif kernel and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif kernel and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            kernels[kernel] = dict(registers=regs, spill_bytes=spill)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    for kernel, (ffma, lds) in loop_counts(sass).items():
        kernels.setdefault(kernel, {}).update(loop_ffma=ffma, loop_lds128=lds)
    for func in re.split(r"\n(?=\s*Function :)", sass):
        kernel = _kernel(func.split("\n", 1)[0]) if "Function :" in func else None
        if kernel:
            kernels.setdefault(kernel, {})["sass_sha"] = _sass_sha(func)
    return {"sass_sha": _sass_sha(sass), "kernels": kernels}


def _sass_sha(sass):
    """A digest of SASS text without what moves when nothing else does: the
    instructions' addresses and encodings, the kernel parameters'
    constant-bank offsets and the anonymous namespace's hash of the source
    file's path."""
    code = re.sub(r"/\*.*?\*/", "", sass)
    code = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]", code)
    code = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "_GLOBAL__N_", code)
    code = re.sub(r"[ \t]+", " ", code)
    return hashlib.sha256(code.encode()).hexdigest()[:16]


def loop_counts(sass):
    """{kernel<template arguments>: (FFMA, LDS.128)} of the loop with the
    most FFMA in each function of ``sass`` (cuobjdump's listing): a loop is
    a basic block (cut at branch targets, labelled or by address, and after
    branches) whose last instruction branches back to its own first."""
    best = {}
    for func in re.split(r"\n(?=\s*Function :)", sass):
        kernel = _kernel(func.split("\n", 1)[0]) if "Function :" in func else None
        if not kernel:
            continue
        lines = func.splitlines()
        targets = {f"0x{int(t, 16):x}" for t in re.findall(r"\bBRA\s+(0x[0-9a-f]+)", func)}
        blocks, block = [], None
        for line in lines:
            label = re.match(r"\s*(\.L_x_\d+):", line)
            ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if label:
                block = ({label.group(1)}, [])
                blocks.append(block)
            if not ins:
                continue
            addr = f"0x{int(ins.group(1), 16):x}"
            if block is None or addr in targets or (block[1] and re.search(
                    r"\b(BRA|EXIT|RET|BRX|JMP)\b", block[1][-1])):
                if block is None or block[1]:
                    block = (set(), [])
                    blocks.append(block)
            if not block[1]:
                block[0].add(addr)
            block[1].append(re.sub(r"^@!?P\w+\s+", "", ins.group(2)))
        for names, body in blocks:
            target = body and re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", body[-1])
            if target and target.group(1) in names:
                ffma = sum(t.startswith("FFMA ") for t in body)
                lds = sum(t.startswith("LDS.128 ") for t in body)
                if ffma > best.get(kernel, (0, 0))[0]:
                    best[kernel] = (ffma, lds)
    return best


def sass_main(dirs):
    """`source_sass` of every source of each csrc directory in ``dirs``, one
    nvcc a source, in parallel: one JSON line a directory."""
    from concurrent.futures import ThreadPoolExecutor

    _build.BUILD_DIR.mkdir(exist_ok=True)
    work = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    try:
        for csrc in dirs:
            names = sorted(n[:-3] for n in os.listdir(csrc) if n.endswith(".cu"))
            with ThreadPoolExecutor(len(names)) as pool:
                got = dict(zip(names, pool.map(lambda n: source_sass(csrc, n, work), names)))
            print(json.dumps({"csrc": csrc, "sources": got}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def grid_entries(t, b, f, rx, h, r, mode, dx):
    """{entry: a call of it} at a grid shape; the BPTT from dys alone, dx
    when ``dx`` (not for a first layer's raw input)."""
    args = inputs(t, b, r, f, rx, h)
    res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode)
    dys = 0.1 * torch.randn(t, b, h, generator=torch.Generator().manual_seed(5)).cuda()
    saved = (*args[:3], *args[4:], *res, dys)
    return {"fwd": lambda: cuda_gru.gru_scan_fused_xin(*args, mode=mode),
            "res": lambda: cuda_gru.gru_scan_fused_xin_res(*args, mode=mode),
            "bwd": lambda: cuda_gru.gru_scan_xin_bwd(*saved, mode=mode, dx=dx)}


def grid_main(libs):
    """One JSON line for each of GRID_SHAPES; ``libs``: `ring_libraries`."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, t, b, f, rx, h, r, mode in GRID_SHAPES:
        form = cuda_gru.form_of(object() if r else None, mode)
        row = {"shape": name, "b": b, "card": torch.cuda.get_device_name(0), "layout": {},
               "device": {}, "per_step": {}, "split": {}}
        for kernel in ("fwd", "bwd"):
            layout = cuda_gru.gru_layout(t, b, f, rx, h, r, form, kernel=kernel, sms=sms)
            row["layout"][kernel] = "rows" if isinstance(layout, cuda_gru.GRUPlan) else [
                dict(rows=n, groups=p.groups, ctas=p.ctas, resident=p.resident(kernel),
                     streamed_mb=round(4e-6 * p.n_ctas * p.streamed_elems(kernel), 1),
                     piece=p.piece(kernel))
                for _, n, p in layout]
        names = ("fwd",) if b == 256 else ("fwd", "res", "bwd")
        for tt in (t, 2 * t):
            calls = grid_entries(tt, b, f, rx, h, r, mode, not name.startswith("har"))
            for entry in names:
                row["device"][f"{entry}_T{tt}"] = device_us(calls[entry], reps=3)
        for entry in names:
            at_t, at_2t = row["device"][f"{entry}_T{t}"], row["device"][f"{entry}_T{2 * t}"]
            for k in at_t:
                row["per_step"][f"{entry}:{k}"] = round((at_2t.get(k, 0.0) - at_t[k]) / t, 3)
            scan = sum(v for k, v in at_t.items() if k.startswith("grid_"))
            row["split"][entry] = dict(scan_ms=round(scan / 1e3, 4),
                                       gemm_ms=round((sum(at_t.values()) - scan) / 1e3, 4))
        plans = []
        for kernel in ("fwd", "bwd"):
            layout = cuda_gru.gru_layout(t, b, f, rx, h, r, form, kernel=kernel, sms=sms)
            if not isinstance(layout, cuda_gru.GRUPlan):
                plans += [p for _, _, p in layout]
        if b != 256 and any(p.piece_fwd or p.piece_bwd for p in plans):
            row["ring"] = ring_waits(libs, grid_entries(t, b, f, rx, h, r, mode,
                                                        not name.startswith("har")), plans, t)
        if h >= 1000:
            row["other_ring"] = other_ring(t, b, f, rx, h, r, mode, form, sms, True)
        if h >= 1000 or b == 256:
            row["tiles"] = tile_sweep(name, t, b, f, rx, h, r, mode, form, sms, libs)
        print(json.dumps(row), flush=True)


def main():
    if "--sass" in sys.argv[1:]:  # the csrc directories after it (default: the package's)
        sass_main(sys.argv[sys.argv.index("--sass") + 1:] or [str(_build.CSRC)])
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    _build.build_all()
    work = tempfile.mkdtemp(dir=_build.BUILD_DIR)  # git-ignored, beside the package's builds
    try:
        ring = ring_libraries(os.path.join(work, "ring"))
        if "--grid" in sys.argv[1:]:
            grid_main(ring)
            return
        libs = stamped_libraries(work)
        for form, b in [(f, 81) for f in FORMS] + [(f, 256) for f in FORMS]:
            r, mode = FORMS[form]
            plan = cuda_gru.gru_plan(T, b, F, RX, H, r, cuda_gru.form_of(
                object() if r else None, mode))
            row = {"form": form, "b": b, "card": torch.cuda.get_device_name(0),
                   "plan": dict(rows=plan.rows, threads=plan.threads, ctas=plan.ctas,
                                rec=plan.rec_weights), "device": {}, "per_step": {},
                   "fixed": {}}
            names = ("fwd",) if b != 81 else ("fwd", "res", "bwd")
            for tt in (T, 4 * T):
                calls = entries(tt, b, form)
                for entry in names:
                    row["device"][f"{entry}_T{tt}"] = device_us(calls[entry])
            for entry in names:
                at_t, at_4t = row["device"][f"{entry}_T{T}"], row["device"][f"{entry}_T{4 * T}"]
                for k in at_t:
                    step = (at_4t.get(k, 0.0) - at_t[k]) / (3 * T)
                    row["per_step"][f"{entry}:{k}"] = round(step, 3)
                    row["fixed"][f"{entry}:{k}"] = round(at_t[k] - T * step, 2)
            if b == 81:
                calls = entries(T, b, form)
                load, _build.load = _build.load, lambda n: libs[n]
                try:
                    calls["fwd"]()
                    torch.cuda.synchronize()
                    row["stamps_fwd"] = spans(libs["gru_scan_xin_fwd"], range(T),
                                              FWD_MARKS[form])
                    calls["bwd"]()
                    torch.cuda.synchronize()
                    row["stamps_bwd"] = spans(libs["gru_scan_xin_bwd"], range(T - 1, -1, -1),
                                              BWD_MARKS[form])
                finally:
                    _build.load = load
            print(json.dumps(row), flush=True)
        grid_main(ring)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
