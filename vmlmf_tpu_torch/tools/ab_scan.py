"""Time the scan kernels of several checkouts of this repo in turns, in one
run, on one CUDA device: the LSTM scans, the GRU scans and the wavefront
stack.

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
A checkout whose `cuda_scan` has the JAX package's kernel variants (a
`variant` function) also times, under "variants", the bf16 products
("bf16"), the bf16 residuals ("bf16_res") and the recompute policy
("recompute") beside f32 at the LM layer (low-rank at B in 20 and 128,
dense at B=20) and at the HAR layer (T=24, F=77, h=180, rx=8, r=6, B=81).
Under "gru", the GRU entries at the HAR GRU layer (T=24, F=77, h=64,
rx=9; "lowrank_pre" r=9, "dense_post", "dense_pre"; B=81, and B=256 for the
no-grad entry): "fwd", "res", "bwd" of x mode with saved gates and, where
the checkout's `cuda_gru` has gi mode (`gru_scan_fused`), "gi_fwd",
"gi_res", "gi_bwd" and the recompute policy's "rc_res" and "rc_bwd".
Under "stack", the stack's three entries at the LM stack (L=2, T=35,
h=650, r=rx=300) at B = 1, 20 and 128 (the residual forward and the BPTT
with a dropout mask), and, where the checkout's stack takes
``precision``, the same in bf16 ("stack_bf16"); then, under "plans",
"stack_peak_mib": the peak device MiB of one BPTT call at B=128 in f32
and in bf16. ``--stack`` (anywhere among the checkouts) runs this part
alone, in f32 and bf16, with the "stack" and "stack_bf16" digests.
Each line also gives, under "ptxas", the registers and spill bytes that
``nvcc -Xptxas -v`` reports for each form of the checkout's serial kernels
(`scan_kernel` and `bptt_kernel` or their grid forms, the GRU's
`fwd_kernel` and `walk_kernel`, `stack_fwd_kernel`, `stack_bwd_kernel`)
at the build's flags, by template arguments.
A checkout that runs layers wider than the SMs' shared memory also times,
under "dense1500", the three LSTM entries at the PTB "large" LM's dense
layer (T=35, F=h=1500) at B = 1, 20 and 128 in f32 and B=20 in bf16, and
at a low-rank layer of that width (r=rx=750) at B = 1, 20 and 128 in f32;
prints each of those six f32 plans under "plans" (CTAs, resident depths
and, on a ring, the floats a stage of each kernel's); and adds their
outputs' digests to the "lstm" family.
Under "digest", a sha256 of all the outputs of the f32 entries that every
checkout since the stack has: the LSTM scan's three at B=20 in both
forms, the GRU's three x-mode entries at B=81 in each recurrent form, and
the stack's three at B=20: equal digests show that two checkouts' kernels
give the same bits. A checkout that runs the wide layers also digests the
bf16 LSTM entries (no-grad, residual, BPTT) at the LM layer, B=20, and at
the dense h=1500 layer, B = 1, 20 and 128, and the bf16 stack's three at
B=20, and times the bf16 entries at the dense layer's B = 1 and 128
(beside B=20) and the LM layer's B = 20 and 128 ("bf16_lstm").
"digest_family" gives one per family of kernels ("lstm", "gru", "stack",
"lstm_bf16", "stack_bf16", "gru_grid") and one over them all ("all"), so
that one run can show one family's bits changed and the others' not.
Giving the checkouts as parent, change, change, parent keeps drift on the
card from reading as a difference between them.

Under "gru_grid", the GRU's grid layout (`cuda_gru.gru_layout`): the ms of
the three x-mode entries (three readings, CUDA events) at the HAR GRU's
h=180 ("pre", "post"; B=81), the HAR GRU nets' h=3200 (B=81, F=77, rx=9:
"post", "pre", low-rank "pre" r=800) and the dense "pre" h=1000 at B=512
(two chunks); each shape's plans (groups, CTAs, resident depths and, where
the checkout has a ring, its floats a stage); the peak device MiB of the
h=3200 "post" BPTT call and of one HAR train step of the h=3200 "post"
net, and at each h=3200 form those of the BPTT call and of the residual
forward and BPTT together under each residual policy ("saved",
"recompute"); and the "gru_grid" digests: every output of the three
x-mode entries at h=180, and at GRU_GRID_ODD's low-rank shape (T=6, B=37,
F=20, h=197, rx=5, r=23) on a plan with a third of each slice streamed
(the resident plan's groups and CTAs), and the h=3200 forwards' outputs
and residuals; no product of these passes the Hopper tile's rule.
``--gru-grid`` (anywhere among the checkouts) runs this part alone.
``--bits`` times nothing: each line then holds the ptxas registers, the
plans and the digests alone (a few minutes a checkout), the quick check
that a change kept the bits of the kernel families it did not mean to
move. Each plan of the grid shows its items' rows (``tile``: 4 where the
checkout has no such field).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CHILD = r"""
import hashlib, inspect, json, os, re, subprocess, sys
from concurrent.futures import ThreadPoolExecutor
sys.path.insert(0, sys.argv[1])
import torch
from vmlmf_tpu_torch.ops import _build, cuda_gru, cuda_scan, cuda_stack

torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
BITS = "--bits" in sys.argv[2:]  # no timings: ptxas, plans and digests
t, f, h, rx, r = 35, 650, 650, 300, 300
# the stack's seeded inputs: main puts tools/stack_case.py's source here
# {stack_case}


def inputs(b, form):
    g = torch.Generator().manual_seed(0)
    n = lambda *s, scale: (scale * torch.randn(s, generator=g)).cuda()
    if form == "har":
        return (n(24, b, 77, scale=1.0), n(77, 8, scale=77 ** -0.5), n(8, 720, scale=8 ** -0.5),
                n(4, 180, scale=0.1), n(720, scale=0.1), n(180, 6, scale=180 ** -0.5),
                n(6, 720, scale=6 ** -0.5), n(720, scale=0.1), n(b, 180, scale=0.5),
                n(b, 180, scale=0.5))
    if form == "dense1500":  # the PTB "large" LM's dense layer
        w = 1500
        return (n(t, b, w, scale=1.0), n(w, 4 * w, scale=w ** -0.5), None,
                torch.zeros(4, w).cuda(), n(4 * w, scale=0.1), n(w, 4 * w, scale=w ** -0.5), None,
                torch.zeros(4 * w).cuda(), n(b, w, scale=0.5), n(b, w, scale=0.5))
    if form == "lowrank1500":  # a low-rank layer of that width, r = rx = 750
        w, k = 1500, 750
        return (n(t, b, w, scale=1.0), n(w, k, scale=w ** -0.5), n(k, 4 * w, scale=k ** -0.5),
                n(4, w, scale=0.1), n(4 * w, scale=0.1), n(w, k, scale=w ** -0.5),
                n(k, 4 * w, scale=k ** -0.5), n(4 * w, scale=0.1), n(b, w, scale=0.5),
                n(b, w, scale=0.5))
    if form == "dense":
        return (n(t, b, f, scale=1.0), n(f, 4 * h, scale=f ** -0.5), None,
                torch.zeros(4, h).cuda(), n(4 * h, scale=0.1), n(h, 4 * h, scale=h ** -0.5), None,
                torch.zeros(4 * h).cuda(), n(b, h, scale=0.5), n(b, h, scale=0.5))
    return (n(t, b, f, scale=1.0), n(f, rx, scale=f ** -0.5), n(rx, 4 * h, scale=rx ** -0.5),
            n(4, h, scale=0.1), n(4 * h, scale=0.1), n(h, r, scale=h ** -0.5),
            n(r, 4 * h, scale=r ** -0.5), n(4 * h, scale=0.1), n(b, h, scale=0.5),
            n(b, h, scale=0.5))


def gru_inputs(b, form):
    g = torch.Generator().manual_seed(0)
    n = lambda *s, scale: (scale * torch.randn(s, generator=g)).cuda()
    gh, k = 64, (9 if form == "lowrank_pre" else 64)
    return (n(24, b, 77, scale=1.0), n(77, 9, scale=77 ** -0.5), n(9, 3 * gh, scale=9 ** -0.5),
            n(3 * gh, scale=0.1), n(gh, 9, scale=gh ** -0.5) if form == "lowrank_pre" else None,
            n(k, 2 * gh, scale=k ** -0.5), n(k, gh, scale=k ** -0.5), n(b, gh, scale=0.5))


GRU_FORMS = {"lowrank_pre": "pre", "dense_post": "post", "dense_pre": "pre"}


# every output of the three f32 x-mode GRU entries at B=81, and the inputs
# and residuals the BPTT took
def gru_outputs(form):
    mode, args = GRU_FORMS[form], gru_inputs(81, form)
    res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode)
    dys = torch.randn(*res[0].shape, generator=torch.Generator().manual_seed(5)).cuda()
    saved = (*args[:3], *args[4:], *res, dys)
    return ((cuda_gru.gru_scan_fused_xin(*args, mode=mode), *res,
             *cuda_gru.gru_scan_xin_bwd(*saved, mode=mode)), args, saved)


def gru_ms(form):
    mode = GRU_FORMS[form]
    _, args, saved = gru_outputs(form)
    wide = gru_inputs(256, form)
    out = {"fwd": [mean_ms(lambda: cuda_gru.gru_scan_fused_xin(*wide, mode=mode))
                   for _ in range(3)],
           "res": [mean_ms(lambda: cuda_gru.gru_scan_fused_xin_res(*args, mode=mode))
                   for _ in range(3)],
           "bwd": [mean_ms(lambda: cuda_gru.gru_scan_xin_bwd(*saved, mode=mode))
                   for _ in range(3)]}
    if hasattr(cuda_gru, "gru_scan_fused"):
        gi = cuda_gru._x_side(*args[:4])[1].contiguous()
        gi_wide = cuda_gru._x_side(*wide[:4])[1].contiguous()
        res = cuda_gru.gru_scan_fused_res(gi, *args[4:], mode=mode)
        rc = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode, save_gates=False)
        rc_saved = (*args[:3], *args[4:], *rc, saved[-1])
        out.update(
            gi_fwd=[mean_ms(lambda: cuda_gru.gru_scan_fused(gi_wide, *wide[4:], mode=mode))
                    for _ in range(3)],
            gi_res=[mean_ms(lambda: cuda_gru.gru_scan_fused_res(gi, *args[4:], mode=mode))
                    for _ in range(3)],
            gi_bwd=[mean_ms(lambda: cuda_gru.gru_scan_bwd(*args[4:], *res, saved[-1],
                                                          mode=mode)) for _ in range(3)],
            rc_res=[mean_ms(lambda: cuda_gru.gru_scan_fused_xin_res(*args, mode=mode,
                                                                    save_gates=False))
                    for _ in range(3)],
            rc_bwd=[mean_ms(lambda: cuda_gru.gru_scan_xin_bwd(*rc_saved, mode=mode,
                                                              bias=args[3]))
                    for _ in range(3)])
    return out


def mean_ms(fn, args=(), iters=20):
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
            m = re.search(r"(grid_scan_kernel|grid_bptt_kernel|grid_fwd_kernel|grid_walk_kernel|"
                          r"scan_kernel|bptt_kernel|fwd_kernel|walk_kernel|stack_fwd_kernel|"
                          r"stack_bwd_kernel)"
                          r"I((?:L[bi]\d+E)+)E", line)
            name = m and f"{m.group(1)}<{','.join(re.findall(r'L[bi](\d+)E', m.group(2)))}>"
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            stats[name] = dict(registers=regs, spill_bytes=spill)
    return stats


# three readings of each entry; variant: (precision, residuals, save_gates)
# where the checkout has the variants
def entry_ms(b, form, *variant):
    args = inputs(b, form)
    prec = variant[:1]
    res = cuda_scan.lstm_scan_fused_xin_res(*args, *variant)
    dys = torch.randn(*res[0].shape, generator=torch.Generator().manual_seed(5)).cuda()
    saved = (*args[:4], *args[5:], *res, dys, None)
    if variant:
        saved += (None if variant[2] else args[4], variant[0])
    return {"fwd": [mean_ms(cuda_scan.lstm_scan_fused_xin, (*args, *prec)) for _ in range(3)],
            "res": [mean_ms(cuda_scan.lstm_scan_fused_xin_res, (*args, *variant))
                    for _ in range(3)],
            "bwd": [mean_ms(cuda_scan.lstm_scan_xin_bwd, saved) for _ in range(3)]}


VARIANTS = {"f32": ("f32", "f32", True), "bf16": ("bf16", "f32", True),
            "bf16_res": ("f32", "bf16", True), "recompute": ("f32", "f32", False)}


# every output of the stack's three entries (f32 where precision is None,
# as every checkout takes it), and the BPTT's arguments
def stack_outputs(b, precision=None):
    (gi0, layers, h0s, c0s, mk, prec), res, bwd_args = stack_case(b, precision)
    fwd = cuda_stack.lstm_stack_scan_fused(gi0, layers, h0s, c0s, None, *prec)
    grads = cuda_stack.lstm_stack_bwd(*bwd_args)
    outs = [fwd[0], *fwd[1], *fwd[2], *(a for group in res for a in group), grads[0],
            *(a for d in grads[1] for _, a in sorted(d.items())), *grads[2], *grads[3]]
    return outs, (gi0, layers, h0s, c0s, mk, prec), bwd_args


def stack_ms(b, precision=None):
    _, (gi0, layers, h0s, c0s, mk, prec), bwd_args = stack_outputs(b, precision)
    return {"fwd": [mean_ms(cuda_stack.lstm_stack_scan_fused, (gi0, layers, h0s, c0s, None, *prec))
                    for _ in range(3)],
            "res": [mean_ms(cuda_stack.lstm_stack_scan_fused_res,
                            (gi0, layers, h0s, c0s, mk, *prec)) for _ in range(3)],
            "bwd": [mean_ms(cuda_stack.lstm_stack_bwd, bwd_args) for _ in range(3)]}


# sha256 of every output of the three f32 entries at B=20 (both forms; the
# wide layers at B = 1, 20 and 128), or of ``precision``'s, so that two
# checkouts' kernels can be shown to give the same bits
def digest(form, b=20, precision=None):
    prec = () if precision is None else (precision,)
    if form in GRU_FORMS:
        outs = gru_outputs(form)[0]
    elif form == "stack":
        outs = stack_outputs(20, precision)[0]
    else:
        args = inputs(b, form)
        res = cuda_scan.lstm_scan_fused_xin_res(*args, *prec)
        dys = torch.randn(*res[0].shape, generator=torch.Generator().manual_seed(5)).cuda()
        if prec:  # bf16 cotangents at the scale of the bf16 checks
            dys = 0.1 * dys
        outs = [*cuda_scan.lstm_scan_fused_xin(*args, *prec), *res,
                *cuda_scan.lstm_scan_xin_bwd(*args[:4], *args[5:], *res, dys, None,
                                             **({"precision": precision} if prec else {}))]
    h = hashlib.sha256()
    for a in outs:
        if a is not None:
            h.update(a.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


GRU_GRID = {"h180_pre": (24, 81, 77, 0, 180, 0, "pre"), "h180_post": (24, 81, 77, 0, 180, 0, "post"),
            "h3200_post": (24, 81, 77, 9, 3200, 0, "post"),
            "h3200_pre": (24, 81, 77, 9, 3200, 0, "pre"),
            "h3200_lowrank_pre": (24, 81, 77, 9, 3200, 800, "pre"),
            "h1000_pre_b512": (24, 512, 77, 0, 1000, 0, "pre")}
GRU_ODD = (6, 37, 20, 5, 197, 23, "pre")


def grid_inputs(t, b, f, rx, h, r, mode):
    g = torch.Generator().manual_seed(0)
    n = lambda *s, scale: (scale * torch.randn(s, generator=g)).cuda()
    k = r or h
    return (n(t, b, f, scale=1.0), n(f, rx or 3 * h, scale=f ** -0.5),
            n(rx, 3 * h, scale=rx ** -0.5) if rx else None, n(3 * h, scale=0.1),
            n(h, r, scale=h ** -0.5) if r else None, n(k, 2 * h, scale=k ** -0.5),
            n(k, h, scale=k ** -0.5), n(b, h, scale=0.5))


def grid_calls(shape):
    t, b, f, rx, h, r, mode = shape
    args = grid_inputs(*shape)
    res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode)
    dys = 0.1 * torch.randn(t, b, h, generator=torch.Generator().manual_seed(5)).cuda()
    saved = (*args[:3], *args[4:], *res, dys)
    return {"fwd": lambda: cuda_gru.gru_scan_fused_xin(*args, mode=mode),
            "res": lambda: cuda_gru.gru_scan_fused_xin_res(*args, mode=mode),
            "bwd": lambda: cuda_gru.gru_scan_xin_bwd(*saved, mode=mode)}


def grid_plans(shape):
    t, b, f, rx, h, r, mode = shape
    form = cuda_gru.form_of(object() if r else None, mode)
    out = {}
    for kernel in ("fwd", "bwd"):
        layout = cuda_gru.gru_layout(t, b, f, rx, h, r, form, kernel=kernel)
        out[kernel] = "rows" if isinstance(layout, cuda_gru.GRUPlan) else [
            dict(rows=n, groups=p.groups, ctas=p.ctas, rpad=p.rpad,
                 tile=p.tile(kernel) if hasattr(p, "tile_fwd") else 4,
                 resident=p.resident(kernel),
                 piece=p.piece(kernel) if hasattr(p, "piece") else 0) for _, n, p in layout]
    return out


def grid_digest(outs):
    h = hashlib.sha256()
    for a in outs:
        if a is not None:
            h.update(a.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# -> (ms, plans, peak MiB, digests) of the grid part
def gru_grid():
    ms, plans, digests = {}, {}, {}
    for name, shape in GRU_GRID.items():
        calls = grid_calls(shape)
        plans[name] = grid_plans(shape)
        iters = 5 if shape[4] >= 1000 else 20
        if not BITS:
            ms[name] = {e: [mean_ms(fn, iters=iters) for _ in range(3)]
                        for e, fn in calls.items()}
        if shape[4] == 180:
            outs = [calls["fwd"](), *calls["res"](), *calls["bwd"]()]
        elif shape[4] == 3200:
            outs = [calls["fwd"](), *calls["res"]()]
        else:
            continue
        digests[f"grid_{name}"] = grid_digest(outs)
    # the odd shape on a forced plan, a third of each slice streamed
    t, b, f, rx, h, r, mode = GRU_ODD
    form = cuda_gru.form_of(object(), mode)
    resident = cuda_gru.gru_grid_plan(t, b, f, rx, h, r, form)
    part = tuple(tuple(d // 3 for d, _ in resident.slices(k)) for k in ("fwd", "bwd"))
    forced = cuda_gru.grid_plan_layout(b, h, r, form, resident.groups, resident.ctas,
                                       resident=part)
    keep = cuda_gru._plan_for
    cuda_gru._plan_for = lambda *a, gi=False, p=forced: ((0, b, p),)
    try:
        calls = grid_calls(GRU_ODD)
        digests["grid_odd_streamed"] = grid_digest([calls["fwd"](), *calls["res"](),
                                                    *calls["bwd"]()])
    finally:
        cuda_gru._plan_for = keep
    plans["odd_streamed"] = dict(groups=forced.groups, ctas=forced.ctas,
                                 tile=(getattr(forced, "tile_fwd", 4),
                                       getattr(forced, "tile_bwd", 4)),
                                 resident=(forced.resident_fwd, forced.resident_bwd),
                                 piece=(getattr(forced, "piece_fwd", 0),
                                        getattr(forced, "piece_bwd", 0)))
    return ms, plans, {} if BITS else grid_peaks(), digests


def peak_mib(step):
    step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return round((torch.cuda.max_memory_allocated() - base) / 2 ** 20, 1)


# the peak MiB of one layer's BPTT call and of its residual forward and BPTT
# together, under each residual policy: the recompute policy is there to
# save memory
def policy_peaks(name):
    t, b, f, rx, h, r, mode = GRU_GRID[name]
    args = grid_inputs(t, b, f, rx, h, r, mode)
    dys = 0.1 * torch.randn(t, b, h, generator=torch.Generator().manual_seed(5)).cuda()
    out = {}
    for policy, save in (("saved", True), ("recompute", False)):
        extra = {} if save else {"bias": args[3]}
        bwd = lambda res: cuda_gru.gru_scan_xin_bwd(*args[:3], *args[4:], *res, dys, mode=mode,
                                                    **extra)
        fwd = lambda: cuda_gru.gru_scan_fused_xin_res(*args, mode=mode, save_gates=save)
        res = fwd()
        out[f"bwd_{name}_{policy}"] = peak_mib(lambda: bwd(res))
        del res
        out[f"res_bwd_{name}_{policy}"] = peak_mib(lambda: bwd(fwd()))
    return out


def grid_peaks():
    from vmlmf_tpu_torch.config import HARConfig
    from vmlmf_tpu_torch.data.har import synthetic_har
    from vmlmf_tpu_torch.train.har import HARTrainer

    out = {"bwd_h3200_post": peak_mib(grid_calls(GRU_GRID["h3200_post"])["bwd"])}
    for name in ("h3200_post", "h3200_pre", "h3200_lowrank_pre"):
        out.update(policy_peaks(name))
    model = HARConfig(model="mygru_group", layer_sizes=(3200,), w_rank=9,
                      u_ranks=(12, 6)).build_model()
    trainer = HARTrainer(model, batch_size=81)
    params, opt = trainer.init()
    x, y, _, _ = synthetic_har("opp", n_train=81, n_test=1, seed=2)
    out["har_step_h3200_post"] = peak_mib(lambda: trainer.train_step(params, opt, x, y))
    return out


# the peak MiB of one stack BPTT call at B=128 (with masks, as in
# training), f32 and bf16
def stack_peaks():
    return {f"bwd_b128_{p}": peak_mib(lambda a=stack_outputs(128, p)[2]:
                                       cuda_stack.lstm_stack_bwd(*a)) for p in ("f32", "bf16")}


if "--stack" in sys.argv[2:]:
    print(json.dumps({"checkout": sys.argv[1], "card": torch.cuda.get_device_name(0),
                      "stack": {p: {b: stack_ms(b, p) for b in (1, 20, 128)}
                                for p in ("f32", "bf16")},
                      "stack_peak_mib": stack_peaks(),
                      "digest": {"stack": digest("stack"),
                                 "stack_bf16": digest("stack", precision="bf16")}}))
    sys.exit(0)

if "--gru-grid" in sys.argv[2:]:
    gms, gplans, gpeaks, gdig = gru_grid()
    print(json.dumps({"checkout": sys.argv[1], "card": torch.cuda.get_device_name(0),
                      "gru_grid": {"ms": gms, "plans": gplans, "peak_mib": gpeaks},
                      "digest": gdig,
                      "digest_family": {"gru_grid": hashlib.sha256(" ".join(
                          gdig[k] for k in sorted(gdig)).encode()).hexdigest()[:16]}}))
    sys.exit(0)

sources = [s for s in ("lstm_scan_xin_fwd.cu", "lstm_scan_xin_bwd.cu", "gru_scan_xin_fwd.cu",
                      "gru_scan_xin_bwd.cu", "lstm_stack_fwd.cu", "lstm_stack_bwd.cu")
           if (_build.CSRC / s).exists()]
with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc a source, together
    regs = dict(zip(sources, pool.map(ptxas, sources)))
ms = {} if BITS else {form: {b: entry_ms(b, form) for b in (1, 20, 128)}
                      for form in ("lowrank", "dense")}
if hasattr(cuda_scan, "variant") and not BITS:
    ms["variants"] = {name: {f"{form}_b{b}": entry_ms(b, form, *v)
                             for form, b in (("lowrank", 20), ("lowrank", 128), ("dense", 20),
                                             ("har", 81))}
                      for name, v in VARIANTS.items()}
if not BITS:
    ms["gru"] = {form: gru_ms(form) for form in GRU_FORMS}
    ms["stack"] = {b: stack_ms(b) for b in (1, 20, 128)}
if "precision" in inspect.signature(cuda_stack.lstm_stack_scan_fused).parameters and not BITS:
    ms["stack_bf16"] = {b: stack_ms(b, "bf16") for b in (1, 20, 128)}
WIDE = {}  # the wide layers' digests, by form and batch
plans = {}  # their plans: CTAs, resident depths and, with a ring, its floats a stage
if hasattr(cuda_scan, "stream_floats") and not BITS:
    ms["dense1500"] = {"f32_b1": entry_ms(1, "dense1500", *VARIANTS["f32"]),
                       "f32_b20": entry_ms(20, "dense1500", *VARIANTS["f32"]),
                       "f32_b128": entry_ms(128, "dense1500", *VARIANTS["f32"]),
                       "bf16_b1": entry_ms(1, "dense1500", *VARIANTS["bf16"]),
                       "bf16_b20": entry_ms(20, "dense1500", *VARIANTS["bf16"]),
                       "bf16_b128": entry_ms(128, "dense1500", *VARIANTS["bf16"]),
                       "lowrank_f32_b1": entry_ms(1, "lowrank1500", *VARIANTS["f32"]),
                       "lowrank_f32_b20": entry_ms(20, "lowrank1500", *VARIANTS["f32"]),
                       "lowrank_f32_b128": entry_ms(128, "lowrank1500", *VARIANTS["f32"])}
if hasattr(cuda_scan, "stream_floats"):  # layers wider than the SMs' shared memory
    for form, rank in (("dense1500", 0), ("lowrank1500", 750)):
        for wb in (1, 20, 128):
            WIDE[f"{form}_b{wb}"] = (form, wb)
            wp = cuda_scan._chunks_for(wb, 1500, rank, torch.device("cuda"))[0][2]
            plans[f"{form}_b{wb}"] = dict(
                ctas=wp.n_ctas, resident=(wp.resident_fwd, wp.resident_bwd),
                **({"piece": (wp.piece_fwd, wp.piece_bwd)} if hasattr(wp, "piece") else {}))
digests = {f: digest(f) for f in ("lowrank", "dense", *GRU_FORMS, "stack")}
digests.update({k: digest(*v) for k, v in WIDE.items()})
families = {"lstm": ("lowrank", "dense", *WIDE), "gru": tuple(GRU_FORMS), "stack": ("stack",)}
if WIDE:  # the bf16 entries of the LSTM scans and the stack
    BF16 = {"bf16_lm_b20": ("lowrank", 20), **{f"bf16_dense1500_b{wb}": ("dense1500", wb)
                                              for wb in (1, 20, 128)}}
    digests.update({k: digest(*v, "bf16") for k, v in BF16.items()})
    digests["stack_bf16"] = digest("stack", precision="bf16")
    families.update(lstm_bf16=tuple(BF16), stack_bf16=("stack_bf16",))
gms, gplans, gpeaks, gdig = gru_grid()
ms["gru_grid"] = gms
plans["gru_grid"] = gplans
plans["gru_grid_peak_mib"] = gpeaks
if "precision" in inspect.signature(cuda_stack.lstm_stack_scan_fused).parameters:
    plans["stack_peak_mib"] = stack_peaks()
digests.update(gdig)
families["gru_grid"] = tuple(sorted(gdig))
families["all"] = tuple(digests)
print(json.dumps({"checkout": sys.argv[1], "card": torch.cuda.get_device_name(0), "ms": ms,
                  "plans": plans, "ptxas": regs, "digest": digests,
                  "digest_family": {fam: hashlib.sha256(" ".join(digests[f] for f in forms)
                                                        .encode()).hexdigest()[:16]
                                    for fam, forms in families.items()}}))
"""


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    flags = ("--gru-grid", "--bits", "--stack")
    dirs = [a for a in args if a not in flags]
    if not dirs:
        raise SystemExit(__doc__)
    only = [a for a in flags if a in args]
    child = CHILD.replace("# {stack_case}\n", (Path(__file__).parent / "stack_case.py").read_text())
    for d in dirs:
        subprocess.run([sys.executable, "-c", child, d, *only], check=True, timeout=900)


if __name__ == "__main__":
    main()
