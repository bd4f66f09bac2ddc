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
h=650, r=rx=300) at B = 1 (no-grad), 20 and 128, and, where the
checkout's stack takes ``precision``, the same in bf16 ("bf16_fwd", ...).
Each line also gives, under "ptxas", the registers and spill bytes that
``nvcc -Xptxas -v`` reports for each form of the checkout's serial kernels
(`scan_kernel` and `bptt_kernel` or their grid forms, the GRU's
`fwd_kernel` and `walk_kernel`, `stack_fwd_kernel`, `stack_bwd_kernel`)
at the build's flags, by template arguments.
A checkout that runs layers wider than the SMs' shared memory also times,
under "dense1500", the three LSTM entries at the PTB "large" LM's dense
layer (T=35, F=h=1500) at B=20 and 128 in f32 and B=20 in bf16.
Under "digest", a sha256 of all the outputs of the f32 entries that every
checkout since the stack has: the LSTM scan's three at B=20 in both
forms, the GRU's three x-mode entries at B=81 in each recurrent form, and
the stack's three at B=20: equal digests show that two checkouts' kernels
give the same bits. "digest_family" gives one per family of kernels
("lstm", "gru", "stack") and one over them all ("all"), so that one run
can show one family's bits changed and the others' not. Giving the
checkouts as parent, change, change, parent keeps drift on the card from
reading as a difference between them.
"""

from __future__ import annotations

import subprocess
import sys

CHILD = r"""
import hashlib, inspect, json, os, re, subprocess, sys
sys.path.insert(0, sys.argv[1])
import torch
from vmlmf_tpu_torch.ops import _build, cuda_gru, cuda_scan, cuda_stack

torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
t, f, h, rx, r = 35, 650, 650, 300, 300


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
            m = re.search(r"(grid_scan_kernel|grid_bptt_kernel|scan_kernel|bptt_kernel|"
                          r"fwd_kernel|walk_kernel|stack_fwd_kernel|stack_bwd_kernel)"
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
    gi0, layers, h0s, c0s = stack_inputs(b)
    prec = () if precision is None else (precision,)
    g = torch.Generator().manual_seed(7)
    mk = [(torch.rand(gi0.shape[:2] + (h,), generator=g) < 0.5).float().cuda() / 0.5]
    res = cuda_stack.lstm_stack_scan_fused_res(gi0, layers, h0s, c0s, mk, *prec)
    dys = torch.randn(*res[0][0].shape, generator=torch.Generator().manual_seed(5)).cuda()
    bwd_args = (layers, h0s, c0s, mk, *res, dys, [None] * 2, [None] * 2, *prec)
    fwd = cuda_stack.lstm_stack_scan_fused(gi0, layers, h0s, c0s, None, *prec)
    grads = cuda_stack.lstm_stack_bwd(*bwd_args)
    outs = [fwd[0], *fwd[1], *fwd[2], *(a for group in res for a in group), grads[0],
            *(a for d in grads[1] for _, a in sorted(d.items())), *grads[2], *grads[3]]
    return outs, (gi0, layers, h0s, c0s, mk, prec), bwd_args


def stack_ms(b, precision=None):
    _, (gi0, layers, h0s, c0s, mk, prec), bwd_args = stack_outputs(b, precision)
    out = {"fwd": [mean_ms(cuda_stack.lstm_stack_scan_fused, (gi0, layers, h0s, c0s, None, *prec))
                   for _ in range(3)]}
    if b > 1:
        out["res"] = [mean_ms(cuda_stack.lstm_stack_scan_fused_res,
                              (gi0, layers, h0s, c0s, mk, *prec)) for _ in range(3)]
        out["bwd"] = [mean_ms(cuda_stack.lstm_stack_bwd, bwd_args) for _ in range(3)]
    return out


# sha256 of every output of the three f32 entries at B=20 (both forms), so
# that two checkouts' kernels can be shown to give the same bits
def digest(form):
    if form in GRU_FORMS:
        outs = gru_outputs(form)[0]
    elif form == "stack":
        outs = stack_outputs(20)[0]
    else:
        args = inputs(20, form)
        res = cuda_scan.lstm_scan_fused_xin_res(*args)
        dys = torch.randn(*res[0].shape, generator=torch.Generator().manual_seed(5)).cuda()
        outs = [*cuda_scan.lstm_scan_fused_xin(*args), *res,
                *cuda_scan.lstm_scan_xin_bwd(*args[:4], *args[5:], *res, dys, None)]
    h = hashlib.sha256()
    for a in outs:
        if a is not None:
            h.update(a.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


sources = [s for s in ("lstm_scan_xin_fwd.cu", "lstm_scan_xin_bwd.cu", "gru_scan_xin_fwd.cu",
                      "gru_scan_xin_bwd.cu", "lstm_stack_fwd.cu", "lstm_stack_bwd.cu")
           if (_build.CSRC / s).exists()]
regs = {s: ptxas(s) for s in sources}
ms = {form: {b: entry_ms(b, form) for b in (1, 20, 128)} for form in ("lowrank", "dense")}
if hasattr(cuda_scan, "variant"):
    ms["variants"] = {name: {f"{form}_b{b}": entry_ms(b, form, *v)
                             for form, b in (("lowrank", 20), ("lowrank", 128), ("dense", 20),
                                             ("har", 81))}
                      for name, v in VARIANTS.items()}
ms["gru"] = {form: gru_ms(form) for form in GRU_FORMS}
ms["stack"] = {b: stack_ms(b) for b in (1, 20, 128)}
if "precision" in inspect.signature(cuda_stack.lstm_stack_scan_fused).parameters:
    ms["stack_bf16"] = {b: stack_ms(b, "bf16") for b in (1, 20, 128)}
if hasattr(cuda_scan, "stream_floats"):  # layers wider than the SMs' shared memory
    ms["dense1500"] = {"f32_b20": entry_ms(20, "dense1500", *VARIANTS["f32"]),
                       "f32_b128": entry_ms(128, "dense1500", *VARIANTS["f32"]),
                       "bf16_b20": entry_ms(20, "dense1500", *VARIANTS["bf16"])}
digests = {f: digest(f) for f in ("lowrank", "dense", *GRU_FORMS, "stack")}
families = {"lstm": ("lowrank", "dense"), "gru": tuple(GRU_FORMS), "stack": ("stack",),
            "all": tuple(digests)}
print(json.dumps({"checkout": sys.argv[1], "card": torch.cuda.get_device_name(0), "ms": ms,
                  "ptxas": regs, "digest": digests,
                  "digest_family": {fam: hashlib.sha256(" ".join(digests[f] for f in forms)
                                                        .encode()).hexdigest()[:16]
                                    for fam, forms in families.items()}}))
"""


def main(argv=None):
    dirs = sys.argv[1:] if argv is None else argv
    if not dirs:
        raise SystemExit(__doc__)
    for d in dirs:
        subprocess.run([sys.executable, "-c", CHILD, d], check=True, timeout=900)


if __name__ == "__main__":
    main()
