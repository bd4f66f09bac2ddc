#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`vmlmf_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:
  1. device  — the card's name and power limit (nvidia-smi); TF32 off.
  2. build   — nvcc builds every kernel under vmlmf_tpu_torch/csrc at once.
  3. kernels — each LSTM kernel entry against its plain PyTorch version on
               the card, at the shapes of the main paths (the PTB LM layer:
               T=35, F=h=650, r=rx=300; the HAR layer: T=24, F=77, h=180,
               rx=8, r=6): the no-grad forward at B in 1/20/128 (LM) and
               81/256 (HAR; 256 is `evaluate`'s batch), the residual forward
               and the BPTT at B in 20/128 (LM) and 81 (HAR). Each with its
               time, the plain version's, its roofline bound, and cuDNN's
               LSTM on the same scan's dense weights (the library yardstick).
  4. gru kernels — each GRU kernel entry (no-grad forward, residual forward,
               BPTT) against its plain version at T=24, h=64, rx=9: the
               layers of both HAR GRUs (main: low-rank "pre", r=9; group:
               dense "post"; F=77 then 64) at B=81, the train batch, where
               all three entries run, and at B=256, `evaluate`'s batch,
               where the no-grad entry runs; a dense "pre" layer; and a
               dense "post" and a low-rank "pre" layer at h=256 whose
               weights do not fit in shared memory. Library: cuDNN's GRU on
               the dense weights for "post"; for "pre" the script shows that
               cuDNN's GRU computes another function, and there is none.
  5. serve   — the PTB "medium" LM (vocab 10000, 2x650, VMLMF w300/u300;
               seeded random weights) served by `Decoder`: prefill of a T=35
               prompt at B=20 then 64 greedy tokens, top-k sampling, and beam
               search; each prefill must launch the no-grad kernel once per
               layer. The fused prefill is held to the loop backend's; then
               prefill ms and decode tokens/s at B in 1/20/128.
  6. train   — the same LM trained by `LMTrainer` (T=35, B=20, dropout 0.5,
               lr 1.0, clip 5.0) for 30 chunks of a synthetic corpus: the
               loss must fall, each step must launch the residual forward and
               the BPTT once per layer, and `perplexity` only the no-grad
               kernel. At dropout 0 the fused gradients are held to the loop
               backend's. Then train step ms and words/s at B in 20/128.
  7. har     — `HARTrainer` on HARNet (77 -> 180, VMLMF w8/u6, 18 classes),
               B=81, two epochs of synthetic OPP windows: the loss must fall;
               accuracy, macro-F1 and step ms.
  8. har_gru — the same for the two GRU HARNets (77 -> 64 -> 64, 18
               classes): GRUCell w9/u9 and GRUGroupCell w9, u(12, 6), g=2.
               Each train step must launch the GRU residual forward and BPTT
               twice and no LSTM kernel, `evaluate` only the GRU no-grad
               kernel, twice per batch; the fused logits of an `evaluate`
               batch (B=256) and one step's fused gradients are held to the
               loop backend's; accuracy, macro-F1 and step ms.
  9. bdnet   — a bidirectional BDNet (GRU w9/u9, 77 -> 64 -> 64, concat)
               trained for a few steps: its reverse tower runs the GRU
               kernels with reverse=True, four launches of each training
               entry per step. Then the fused logits of a GRU and an LSTM
               BDNet against the loop backend's.
 10. trace   — one `torch.profiler` trace each of an LM train step at B=20
               and of a main HAR GRU train step at B=81: the device time of
               each kernel, the port's against cuBLAS's. A profiler error or
               an empty trace fails the run.
 11. report  — one JSON line listing every kernel entry, then the last line
               {"ok": true, "device": {...}}.

In phases 5-9 every launch count is set to 0 just before the path runs and
read just after. Needs one CUDA device and nvcc; imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM, dense, at its 700 W limit: f32 outside the tensor cores, and HBM3
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

TOL = 1e-4  # outputs: f32 sums over K=650 and K=300 in another order, 35 steps
GRAD_TOL = 1e-3  # gradients: weight gradients sum over all T*B rows in another order
LM = dict(vocab=10000, hidden=650, layers=2, rank=300, prompt=35)
LM_BATCHES = (1, 20, 128)
TRAIN_BATCHES = (20, 128)
MAIN_BATCH = 20
HAR = dict(t=24, b=81, f=77, h=180, rx=8, r=6)
TRAIN_CHUNKS = 30
# the HAR GRU configurations: layers of 64, x side rank 9, T=24, B=81
GRU = dict(t=24, b=81, f=77, h=64, rx=9, r=9)
GRU_CONFIGS = {"main": dict(u_rank=9), "group": dict(u_ranks=(12, 6), groups=2)}
EVAL_BATCH = 256  # `evaluate`'s batch, into which it pads the test windows


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, iters):
    """Mean device time of fn() over `iters` calls, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def close(torch, got, want, tol=TOL):
    """-> (ok, max abs error) under atol = rtol = tol."""
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol + tol * want.abs()).all())
    return ok, float(err.max())


def all_close(torch, gots, wants, tol):
    """close() over pairs of tensors -> (all ok, largest max abs error)."""
    checks = [close(torch, g, w, tol) for g, w in zip(gots, wants)]
    return all(ok for ok, _ in checks), max(e for _, e in checks)


def bound(ops, nbytes):
    """(bound ms, what bounds it) at the card's f32 and memory peaks."""
    op_ms, byte_ms = 1e3 * ops / PEAK_F32_OPS, 1e3 * nbytes / PEAK_BYTES
    return max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes"


def entries():
    """{entry name: (its wrapper, its kernel module)} for every kernel entry."""
    from vmlmf_tpu_torch.ops import cuda_gru, cuda_scan

    return {"lstm_scan_xin_fwd": (cuda_scan.lstm_scan_fused_xin, cuda_scan),
            "lstm_scan_xin_fwd_res": (cuda_scan.lstm_scan_fused_xin_res, cuda_scan),
            "lstm_scan_xin_bwd": (cuda_scan.lstm_scan_xin_bwd, cuda_scan),
            "gru_scan_xin_fwd": (cuda_gru.gru_scan_fused_xin, cuda_gru),
            "gru_scan_xin_fwd_res": (cuda_gru.gru_scan_fused_xin_res, cuda_gru),
            "gru_scan_xin_bwd": (cuda_gru.gru_scan_xin_bwd, cuda_gru)}


def launch_counts():
    """The launch count of each kernel entry, by name."""
    return {name: fn.launches for name, (fn, _) in entries().items()}


def reset_launch_counts():
    for fn, _ in entries().values():
        fn.launches = 0


def count_delta(before):
    return {k: v - before[k] for k, v in launch_counts().items()}


def only(**counts):
    """A launch-count dict of every entry: the given counts, 0 for the rest."""
    want = dict.fromkeys(entries(), 0)
    want.update(counts)
    return want


def dense_lstm_weights(ux, vx, xdvec, bias, u, v, dvec):
    """The fused scan's weights as one dense LSTM layer's, in PyTorch's layout
    and gate order (i, f, g, o): [w_ih [4h, F], w_hh [4h, h], b_ih, b_hh].

    The VMLMF pre-activation is linear in x and in h, so w_ih = (ux@vx)^T
    plus xdvec[g, j] at [g*h + j, j] for j < min(F, h), w_hh = (u@v)^T plus
    dvec on each gate's diagonal, b_ih = bias and b_hh = 0. cuDNN's LSTM on
    these weights computes the same scan: the library yardstick.
    """
    import torch

    f, h = ux.shape[0], xdvec.shape[1]
    w_ih = (ux @ vx).T.contiguous()
    w_hh = (u @ v).T.contiguous()
    jx = torch.arange(min(f, h), device=ux.device)
    jh = torch.arange(h, device=ux.device)
    for g in range(4):
        w_ih[g * h + jx, jx] += xdvec[g, : len(jx)]
        w_hh[g * h + jh, jh] += dvec[g * h : (g + 1) * h]
    return [w_ih, w_hh, bias.clone(), torch.zeros_like(bias)]


def dense_gru_weights(ux, vx, bias, uf, prz, pn):
    """The fused GRU scan's weights as one dense GRU layer's, in PyTorch's
    layout and gate order (r, z, n): [w_ih [3h, F], w_hh [3h, h], b_ih, b_hh]
    with w_ih = (ux@vx)^T, w_hh = [prz | pn]^T (low-rank: (uf@[prz | pn])^T),
    b_ih = bias and b_hh = 0.

    PyTorch's GRU applies the reset gate after the recurrent product, n =
    tanh(W_in x + b_in + r * (W_hn h + b_hn)), so cuDNN's GRU on these
    weights computes the scan's mode "post", and not mode "pre".
    """
    import torch

    w = torch.cat([prz, pn], dim=1)
    w_hh = w if uf is None else uf @ w
    return [(ux @ vx).T.contiguous(), w_hh.T.contiguous(), bias.clone(), torch.zeros_like(bias)]


def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"cudnn {torch.backends.cudnn.version()}")
    return card


def phase_build():
    from vmlmf_tpu_torch.ops import _build

    t0 = time.perf_counter()
    try:
        built = _build.build_all()
    except _build.BuildError as e:
        fail(str(e))
    print(f"build: {built} in {time.perf_counter() - t0:.2f} s")


def scan_inputs(torch, t, b, f, h, rx, r, seed=0):
    """Seeded scan inputs on the card, scaled so that the gates are O(1)."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, scale):
        return (scale * torch.randn(shape, generator=g)).cuda()

    return (n(t, b, f, scale=1.0), n(f, rx, scale=f ** -0.5), n(rx, 4 * h, scale=rx ** -0.5),
            n(4, h, scale=0.1), n(4 * h, scale=0.1), n(h, r, scale=h ** -0.5),
            n(r, 4 * h, scale=r ** -0.5), n(4 * h, scale=0.1), n(b, h, scale=0.5),
            n(b, h, scale=0.5))


def cudnn_lstm(torch, args):
    """A one-layer `nn.LSTM` (cuDNN) holding the scan's dense weights, flattened
    once, outside any timed window. Fails unless it computes the same scan."""
    from vmlmf_tpu_torch.ops import cuda_scan

    xs, h0, c0 = args[0], args[8], args[9]
    lstm = torch.nn.LSTM(xs.shape[-1], h0.shape[-1]).cuda()
    with torch.no_grad():
        for p, w in zip((lstm.weight_ih_l0, lstm.weight_hh_l0, lstm.bias_ih_l0,
                         lstm.bias_hh_l0), dense_lstm_weights(*args[1:8])):
            p.copy_(w)
    lstm.flatten_parameters()
    with torch.no_grad():
        out, (_, c_n) = lstm(xs, (h0[None], c0[None]))
        ys, c_last = cuda_scan.lstm_scan_fused_xin_plain(*args)
    ok, err = all_close(torch, (out, c_n[0]), (ys, c_last), GRAD_TOL)
    if not ok:
        fail(f"cuDNN's LSTM on the dense weights is not the same scan: max abs err {err}")
    return lstm, err


def library_train_ms(torch, train_fwd, dys, iters):
    """(training forward ms, backward ms) of one library layer: train_fwd()
    runs it on inputs that need a gradient and returns its output sequence
    first. The backward is (forward + backward) - forward, each the best of
    three interleaved windows: the difference of two means is noisy."""
    def fwd_bwd():
        torch.autograd.backward(train_fwd()[0], dys)

    fwd_ms, both_ms = [], []
    for _ in range(3):
        fwd_ms.append(cuda_ms(torch, train_fwd, iters))
        both_ms.append(cuda_ms(torch, fwd_bwd, iters))
    return min(fwd_ms), min(both_ms) - min(fwd_ms)


def kernel_row(name, shape, err, tol, ms, plain_ms, cost, library_ms):
    bms, by = bound(*cost)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"kernel {name} {shape}: max_abs_err {err:.3g} (tol {tol}), {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), library (cuDNN) {lib}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms)


def phase_kernels(torch):
    """-> {(entry, shape name, B): row} for the kernels line and PERF.md."""
    from vmlmf_tpu_torch.ops import cuda_scan

    shapes = [("lm", dict(t=LM["prompt"], b=b, f=LM["hidden"], h=LM["hidden"],
                          rx=LM["rank"], r=LM["rank"])) for b in LM_BATCHES]
    shapes += [("har", HAR), ("har", dict(HAR, b=EVAL_BATCH))]  # train step, `evaluate`
    rows = {}
    print(f"tolerances: outputs and residuals atol = rtol = {TOL} (f32 sums in another "
          f"order); gradients {GRAD_TOL} (weight gradients sum over T*B rows in another order)")
    for name, s in shapes:
        size = (s["t"], s["b"], s["f"], s["rx"], s["h"], s["r"])
        label = (f"{name} T={s['t']} B={s['b']} F={s['f']} h={s['h']} rx={s['rx']} "
                 f"r={s['r']}")
        args = scan_inputs(torch, **s)
        lstm, lib_err = cudnn_lstm(torch, args)
        xs, h0, c0 = args[0], args[8], args[9]
        print(f"library: cuDNN LSTM on the dense weights, {label}: max abs err {lib_err:.3g} "
              f"against the plain scan")

        # -- the no-grad forward
        ys, c_last = cuda_scan.lstm_scan_fused_xin(*args)
        torch.cuda.synchronize()
        ok, err = all_close(torch, (ys, c_last), cuda_scan.lstm_scan_fused_xin_plain(*args), TOL)
        if not ok:
            fail(f"lstm_scan_xin_fwd disagrees with its plain version at {label}: {err}")

        def lib_fwd():
            with torch.no_grad():
                lstm(xs, (h0[None], c0[None]))

        rows[("lstm_scan_xin_fwd", name, s["b"])] = kernel_row(
            "lstm_scan_xin_fwd", label, err, TOL,
            cuda_ms(torch, lambda: cuda_scan.lstm_scan_fused_xin(*args), 10),
            cuda_ms(torch, lambda: cuda_scan.lstm_scan_fused_xin_plain(*args), 5),
            cuda_scan.scan_cost(*size), cuda_ms(torch, lib_fwd, 10))
        if s["b"] not in (TRAIN_BATCHES if name == "lm" else (HAR["b"],)):
            continue

        # -- the residual forward and the BPTT, with dys given and dc_last
        # absent, as on the LM's training path
        res = cuda_scan.lstm_scan_fused_xin_res(*args)
        torch.cuda.synchronize()
        res_p = cuda_scan.lstm_scan_xin_fwd_res_plain(*args)
        ok, err = all_close(torch, res, res_p, TOL)
        if not ok:
            fail(f"lstm_scan_xin_fwd_res disagrees with its plain version at {label}: {err}")
        dys = 0.1 * torch.randn(ys.shape, generator=torch.Generator().manual_seed(5)).cuda()
        saved = (*args[:4], *args[5:], *res)
        grads = cuda_scan.lstm_scan_xin_bwd(*saved, dys, None)
        torch.cuda.synchronize()
        ok_g, err_g = all_close(torch, grads,
                                cuda_scan.lstm_scan_xin_bwd_plain(*saved, dys, None), GRAD_TOL)
        if not ok_g:
            fail(f"lstm_scan_xin_bwd disagrees with its plain version at {label}: {err_g}")

        x, h, c = (t.detach().requires_grad_() for t in (xs, h0, c0))
        lib_fwd_ms, lib_bwd_ms = library_train_ms(
            torch, lambda: lstm(x, (h[None], c[None])), dys, 10)
        rows[("lstm_scan_xin_fwd_res", name, s["b"])] = kernel_row(
            "lstm_scan_xin_fwd_res", label, err, TOL,
            cuda_ms(torch, lambda: cuda_scan.lstm_scan_fused_xin_res(*args), 10),
            cuda_ms(torch, lambda: cuda_scan.lstm_scan_xin_fwd_res_plain(*args), 5),
            cuda_scan.scan_res_cost(*size), lib_fwd_ms)
        rows[("lstm_scan_xin_bwd", name, s["b"])] = kernel_row(
            "lstm_scan_xin_bwd", label, err_g, GRAD_TOL,
            cuda_ms(torch, lambda: cuda_scan.lstm_scan_xin_bwd(*saved, dys, None), 10),
            cuda_ms(torch, lambda: cuda_scan.lstm_scan_xin_bwd_plain(*saved, dys, None), 3),
            cuda_scan.scan_bwd_cost(*size), lib_bwd_ms)
    return rows


def gru_scan_inputs(torch, t, b, f, h, rx, r, lowrank, seed=0):
    """Seeded GRU scan inputs on the card (xs, ux, vx, bias, uf, prz, pn, h0),
    scaled so that the gates are O(1); uf is None when the recurrent side is
    dense."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, scale):
        return (scale * torch.randn(shape, generator=g)).cuda()

    k = r if lowrank else h
    return (n(t, b, f, scale=1.0), n(f, rx, scale=f ** -0.5), n(rx, 3 * h, scale=rx ** -0.5),
            n(3 * h, scale=0.1), n(h, r, scale=h ** -0.5) if lowrank else None,
            n(k, 2 * h, scale=k ** -0.5), n(k, h, scale=k ** -0.5), n(b, h, scale=0.5))


def cudnn_gru(torch, args, mode):
    """A one-layer `nn.GRU` (cuDNN) holding the scan's dense weights, flattened
    once, outside any timed window, and its max abs error against the plain
    scan. For mode "post" it must compute the same scan, else the script
    fails. For mode "pre" it must not: cuDNN's GRU applies the reset gate
    after the recurrent product, so it is no yardstick there and None comes
    back in its place."""
    from vmlmf_tpu_torch.ops import cuda_gru

    xs, h0 = args[0], args[7]
    gru = torch.nn.GRU(xs.shape[-1], h0.shape[-1]).cuda()
    with torch.no_grad():
        for p, w in zip((gru.weight_ih_l0, gru.weight_hh_l0, gru.bias_ih_l0, gru.bias_hh_l0),
                        dense_gru_weights(*args[1:7])):
            p.copy_(w)
        gru.flatten_parameters()
        out, _ = gru(xs, h0[None])
        ok, err = close(torch, out, cuda_gru.gru_scan_fused_xin_plain(*args, mode=mode),
                        GRAD_TOL)
    if mode == "post" and not ok:
        fail(f"cuDNN's GRU on the dense weights is not the mode 'post' scan: max abs err {err}")
    if mode == "pre" and ok:
        fail(f"cuDNN's GRU computed the mode 'pre' scan (max abs err {err}): the library "
             f"column of the 'pre' rows must name it")
    return (gru if mode == "post" else None), err


def gru_kernel_shapes():
    """(name, (T, B, F, h, rx, r), mode, low-rank recurrent side, dx, train)
    of each GRU kernel check: the layers of both HAR GRUs at the train batch,
    where all three entries run (a first layer needs no dx), and at
    evaluate's batch, where only the no-grad entry runs; a dense "pre" layer;
    and a dense and a low-rank layer at h=256 whose weights do not fit in
    shared memory."""
    t, f, h, rx, r = GRU["t"], GRU["f"], GRU["h"], GRU["rx"], GRU["r"]
    layers = [("main_l1", f, h, r, "pre", True, False), ("main_l2", h, h, r, "pre", True, True),
              ("group_l1", f, h, 0, "post", False, False),
              ("group_l2", h, h, 0, "post", False, True)]
    shapes = [(name, (t, b, fi, hi, rx, ri), mode, lowrank, dx, b == GRU["b"])
              for b in (GRU["b"], EVAL_BATCH)
              for name, fi, hi, ri, mode, lowrank, dx in layers]
    return shapes + [("dense_pre", (t, GRU["b"], f, h, rx, 0), "pre", False, True, True),
                     ("wide_post_l2", (t, GRU["b"], f, 256, rx, 0), "post", False, True, True),
                     ("wide_pre_l2", (t, GRU["b"], f, 256, rx, 64), "pre", True, True, True)]


def phase_gru_kernels(torch):
    """-> {(entry, shape name, B): row} for the kernels line and PERF.md."""
    from vmlmf_tpu_torch.ops import cuda_gru

    rows = {}
    for name, (t, b, f, h, rx, r), mode, lowrank, dx, train in gru_kernel_shapes():
        args = gru_scan_inputs(torch, t, b, f, h, rx, r, lowrank)
        size = (t, b, f, rx, h, r, cuda_gru.form_of(args[4], mode))
        label = (f"{name} T={t} B={b} F={f} h={h} rx={rx} r={r} mode={mode} "
                 f"{'low-rank' if lowrank else 'dense'}{', no dx' if train and not dx else ''}")
        gru, lib_err = cudnn_gru(torch, args, mode)
        print(f"library: cuDNN GRU on the dense weights, {label}: max abs err {lib_err:.3g} "
              f"against the plain scan ({'the same scan' if gru else 'another function'})")
        xs, h0 = args[0], args[7]

        ys = cuda_gru.gru_scan_fused_xin(*args, mode=mode)
        torch.cuda.synchronize()
        ok, err = close(torch, ys, cuda_gru.gru_scan_fused_xin_plain(*args, mode=mode))
        if not ok:
            fail(f"gru_scan_xin_fwd disagrees with its plain version at {label}: {err}")

        def lib_fwd():
            with torch.no_grad():
                gru(xs, h0[None])

        checks = [("gru_scan_xin_fwd", err, TOL,
                   cuda_ms(torch, lambda: cuda_gru.gru_scan_fused_xin(*args, mode=mode), 20),
                   cuda_ms(torch, lambda: cuda_gru.gru_scan_fused_xin_plain(*args, mode=mode), 5),
                   cuda_gru.gru_scan_cost(*size), cuda_ms(torch, lib_fwd, 20) if gru else None)]
        if train:
            checks += gru_train_checks(torch, cuda_gru, args, ys, size, label, mode, dx, gru)
        for entry, e_err, tol, ms, plain_ms, cost, lib_ms in checks:
            rows[(entry, name, b)] = kernel_row(entry, label, e_err, tol, ms, plain_ms, cost,
                                                lib_ms)
            print(f"kernel {entry} {name} B={b}: {1e3 * ms / t:.3f} us per step (whole call / T)")
    return rows


def gru_train_checks(torch, cuda_gru, args, ys, size, label, mode, dx, gru):
    """The residual forward and the BPTT at one shape, against their plain
    versions -> their (entry, err, tol, ms, plain ms, cost, library ms)."""
    xs, h0 = args[0], args[7]
    res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode)
    torch.cuda.synchronize()
    res_p = cuda_gru.gru_scan_xin_fwd_res_plain(*args, mode=mode)
    ok_r, err_r = all_close(torch, [a for a in res if a is not None],
                            [a for a in res_p if a is not None], TOL)
    if not ok_r:
        fail(f"gru_scan_xin_fwd_res disagrees with its plain version at {label}: {err_r}")
    dys = 0.1 * torch.randn(ys.shape, generator=torch.Generator().manual_seed(5)).cuda()
    saved = (*args[:3], *args[4:], *res, dys)
    grads = cuda_gru.gru_scan_xin_bwd(*saved, mode=mode, dx=dx)
    torch.cuda.synchronize()
    grads_p = cuda_gru.gru_scan_xin_bwd_plain(*saved, mode=mode, dx=dx)
    ok_g, err_g = all_close(torch, [a for a in grads if a is not None],
                            [a for a in grads_p if a is not None], GRAD_TOL)
    if not ok_g:
        fail(f"gru_scan_xin_bwd disagrees with its plain version at {label}: {err_g}")

    lib_fwd_ms = lib_bwd_ms = None
    if gru is not None:
        x_leaf, h_leaf = xs.detach().requires_grad_(dx), h0.detach().requires_grad_()
        lib_fwd_ms, lib_bwd_ms = library_train_ms(torch, lambda: gru(x_leaf, h_leaf[None]), dys,
                                                  20)
    return [("gru_scan_xin_fwd_res", err_r, TOL,
             cuda_ms(torch, lambda: cuda_gru.gru_scan_fused_xin_res(*args, mode=mode), 20),
             cuda_ms(torch, lambda: cuda_gru.gru_scan_xin_fwd_res_plain(*args, mode=mode), 5),
             cuda_gru.gru_scan_res_cost(*size), lib_fwd_ms),
            ("gru_scan_xin_bwd", err_g, GRAD_TOL,
             cuda_ms(torch, lambda: cuda_gru.gru_scan_xin_bwd(*saved, mode=mode, dx=dx), 20),
             cuda_ms(torch, lambda: cuda_gru.gru_scan_xin_bwd_plain(*saved, mode=mode, dx=dx), 5),
             cuda_gru.gru_scan_bwd_cost(*size, dx=dx), lib_bwd_ms)]


def lm_model(backend, dropout_rate=0.0):
    from vmlmf_tpu_torch.cells import VMLMFCell
    from vmlmf_tpu_torch.nn.models import LMModel

    return LMModel(vocab_size=LM["vocab"], hidden_size=LM["hidden"], num_layers=LM["layers"],
                   cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=LM["rank"],
                                                       u_rank=LM["rank"]),
                   dropout_rate=dropout_rate, winit=0.05, backend=backend)


def prompt_ids(torch, b, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, LM["vocab"], (LM["prompt"], b), generator=g).cuda()


def phase_serve(torch):
    """-> the launch counts of the serving path."""
    from vmlmf_tpu_torch.ops import cuda_scan
    from vmlmf_tpu_torch.serve import Decoder

    fused, loop = lm_model("fused"), lm_model("loop")
    params = fused.init(torch.Generator().manual_seed(0), device="cuda")
    dec = Decoder(fused)
    vocab, layers = LM["vocab"], LM["layers"]
    prompt = prompt_ids(torch, MAIN_BATCH)
    prefill_deltas = []

    def prefill(ids):
        before = cuda_scan.lstm_scan_fused_xin.launches
        out = dec.prefill(params, ids, fused.state0(ids.shape[1]))
        prefill_deltas.append(cuda_scan.lstm_scan_fused_xin.launches - before)
        return out

    # -- the main path, with the launch counts read around it
    reset_launch_counts()
    logits, states = prefill(prompt)
    greedy, _ = dec.decode(params, logits, states, steps=64)
    logits, states = prefill(prompt)
    sampled, _ = dec.decode(params, logits, states, steps=64, temperature=0.8, top_k=50,
                            generator=torch.Generator(device="cuda").manual_seed(2))
    beam_prompt = prompt[:, :4]
    before = cuda_scan.lstm_scan_fused_xin.launches
    beams, scores = dec.beam_search(params, beam_prompt, steps=16, beams=4)
    prefill_deltas.append(cuda_scan.lstm_scan_fused_xin.launches - before)
    torch.cuda.synchronize()
    launches = launch_counts()

    print(f"serve: launches {launches}, no-grad forward per prefill {prefill_deltas}")
    if prefill_deltas != [layers] * 3 or launches != only(lstm_scan_xin_fwd=3 * layers):
        fail(f"each prefill must launch the no-grad kernel {layers} times and nothing else, "
             f"got {prefill_deltas}, {launches}")
    for name, toks, shape in (("greedy", greedy, (64, MAIN_BATCH)),
                              ("sampled", sampled, (64, MAIN_BATCH)),
                              ("beam", beams, (16, 4, 4))):
        if tuple(toks.shape) != shape or int(toks.min()) < 0 or int(toks.max()) >= vocab:
            fail(f"{name} tokens: shape {tuple(toks.shape)}, range "
                 f"[{int(toks.min())}, {int(toks.max())}]")
    if not bool(torch.isfinite(scores).all()) or bool((scores.diff(dim=1) > 1e-6).any()):
        fail(f"beam scores not finite and sorted: {scores.tolist()}")
    print(f"serve: greedy[:8, 0] {greedy[:8, 0].tolist()}, sampled[:8, 0] "
          f"{sampled[:8, 0].tolist()}, beam scores[0] {[round(x, 4) for x in scores[0].tolist()]}")

    # -- the fused prefill against the loop backend's, on the card
    lf, sf = dec.prefill(params, prompt, fused.state0(MAIN_BATCH))
    ll, sl = Decoder(loop).prefill(params, prompt, loop.state0(MAIN_BATCH))
    ok, err = all_close(torch, [lf] + [a for s in sf for a in s], [ll] + [a for s in sl for a in s],
                        TOL)
    print(f"serve: fused vs loop prefill, max abs err {err:.3g} (tol {TOL})")
    if not ok:
        fail("fused prefill disagrees with the loop backend")

    # -- speed
    perf = {}
    for b in LM_BATCHES:
        ids = prompt_ids(torch, b)
        s0 = fused.state0(b)
        prefill_ms = cuda_ms(torch, lambda: dec.prefill(params, ids, s0), 5)
        loop_prefill_ms = cuda_ms(torch, lambda: Decoder(loop).prefill(params, ids, s0), 5)
        logits, states = dec.prefill(params, ids, s0)
        dec.decode(params, logits, states, steps=4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.decode(params, logits, states, steps=64)
        torch.cuda.synchronize()
        tps = 64 * b / (time.perf_counter() - t0)
        perf[b] = dict(prefill_ms=prefill_ms, loop_prefill_ms=loop_prefill_ms,
                       decode_tokens_per_s=tps)
        print(f"serve B={b}: prefill {prefill_ms:.3f} ms (loop backend {loop_prefill_ms:.3f} ms),"
              f" greedy decode {tps:.1f} tokens/s")
    print(json.dumps({"serving": {str(b): p for b, p in perf.items()}}))
    return launches


def lm_chunks(b):
    """(train, valid) chunks of the synthetic corpus at vocab 10000, T=35."""
    from vmlmf_tpu_torch.data.ptb import load_or_synthesize, minibatch

    trn, vld, _, _ = load_or_synthesize(None, vocab_size=LM["vocab"], seed=0)
    return minibatch(trn, b, LM["prompt"]), minibatch(vld, b, LM["prompt"])


def train_step_ms(torch, trainer, params, chunks, steps, generator):
    """Host time of one train step that ends in a synchronize, over `steps`
    steps after two warm ones."""
    states = trainer.state0()
    for x, y in chunks[:2]:
        params, states, _, _ = trainer.train_step(params, states, x, y, 1.0, generator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x, y in chunks[2 : 2 + steps]:
        params, states, _, _ = trainer.train_step(params, states, x, y, 1.0, generator)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def phase_train(torch):
    """-> the launch counts of the training path."""
    from vmlmf_tpu_torch.train.lm import LMTrainer, lm_loss
    from vmlmf_tpu_torch.utils.tree import tree_leaves

    layers = LM["layers"]
    trn, vld = lm_chunks(MAIN_BATCH)
    trainer = LMTrainer(lm_model("fused", dropout_rate=0.5), batch_size=MAIN_BATCH,
                        seq_length=LM["prompt"], learning_rate=1.0, max_grad_norm=5.0)
    params = trainer.init()
    generator = torch.Generator(device="cuda").manual_seed(1)
    states = trainer.state0()

    # -- the main path, with the launch counts read around it
    reset_launch_counts()
    losses, deltas = [], []
    for x, y in trn[:TRAIN_CHUNKS]:
        before = launch_counts()
        params, states, loss, gnorm = trainer.train_step(params, states, x, y, 1.0, generator)
        deltas.append({k: v - before[k] for k, v in launch_counts().items()})
        losses.append(loss)
    before = launch_counts()
    ppl = trainer.perplexity(params, vld[:10])
    ppl_delta = {k: v - before[k] for k, v in launch_counts().items()}
    torch.cuda.synchronize()
    launches = launch_counts()

    losses = [float(v) / MAIN_BATCH for v in losses]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"train: {TRAIN_CHUNKS} chunks at B={MAIN_BATCH}, loss per word {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (mean of first 5 {first:.4f}, last 5 {last:.4f}), last gnorm "
          f"{float(gnorm):.4f}, valid perplexity on 10 chunks {ppl:.2f}")
    print(f"train: launches {launches}, per step {deltas[0]}, in perplexity {ppl_delta}")
    want_step = only(lstm_scan_xin_fwd_res=layers, lstm_scan_xin_bwd=layers)
    if any(d != want_step for d in deltas):
        fail(f"each train step must launch {want_step}, got {deltas}")
    if ppl_delta != only(lstm_scan_xin_fwd=10 * layers):
        fail(f"perplexity must launch only the no-grad kernel, {layers} per chunk: {ppl_delta}")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)) or not last < first:
        fail(f"the training loss did not fall: {losses}")

    # -- one step's gradients, fused against loop, at dropout 0
    grads = []
    x, y = (torch.as_tensor(a, device="cuda").long() for a in trn[0])
    for backend in ("fused", "loop"):
        model = lm_model(backend)
        p = model.init(torch.Generator().manual_seed(0), device="cuda")
        leaves = [q.requires_grad_() for q in tree_leaves(p)]
        logits, _ = model.apply(p, x, model.state0(MAIN_BATCH), train=True)
        grads.append(torch.autograd.grad(lm_loss(logits, y), leaves))
    # each tensor against its own scale: at winit 0.05 the gradients are far
    # below 1e-3, where an absolute tolerance would pass even all-zero ones
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(*grads)]
    dead = [i for i, a in enumerate(grads[0]) if not float(a.abs().max()) > 0]
    print(f"train: fused vs loop gradients of one step at dropout 0, largest max|diff| / "
          f"max|loop grad| over {len(rel)} tensors {max(rel):.3g} (tol {GRAD_TOL})")
    if dead or not max(rel) <= GRAD_TOL:
        fail(f"the fused backend's gradients disagree with the loop backend's: relative "
             f"errors {rel}, all-zero tensors {dead}")

    # -- speed
    perf = {}
    for b in TRAIN_BATCHES:
        chunks, _ = lm_chunks(b)
        for backend in ("fused", "loop"):
            t = LMTrainer(lm_model(backend, dropout_rate=0.5), batch_size=b,
                          seq_length=LM["prompt"])
            ms = train_step_ms(torch, t, t.init(), chunks, 5, generator)
            perf[f"{backend}_b{b}"] = dict(step_ms=ms, words_per_s=b * LM["prompt"] / ms * 1e3)
            print(f"train B={b} {backend}: step {ms:.3f} ms, "
                  f"{perf[f'{backend}_b{b}']['words_per_s']:.1f} words/s")
    print(json.dumps({"training": perf}))
    return launches


def phase_har(torch):
    """-> the launch counts of the HAR training path."""
    from vmlmf_tpu_torch.cells import VMLMFCell
    from vmlmf_tpu_torch.data.har import synthetic_har
    from vmlmf_tpu_torch.nn.models import HARNet
    from vmlmf_tpu_torch.train.har import HARTrainer, evaluate

    model = HARNet(HAR["f"], (HAR["h"],), num_classes=18,
                   cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=HAR["rx"], u_rank=HAR["r"]))
    trainer = HARTrainer(model, batch_size=HAR["b"])
    x_tr, y_tr, x_te, y_te = synthetic_har("opp", n_train=30 * HAR["b"], n_test=500, seed=0)
    params, opt = trainer.init()

    reset_launch_counts()
    params, opt, hist = trainer.fit(params, opt, x_tr, y_tr, epochs=2, log_fn=print)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"har: launches {launches}")
    if launches != only(lstm_scan_xin_fwd_res=60, lstm_scan_xin_bwd=60):
        fail(f"HAR training must launch the residual forward and the BPTT once per batch: "
             f"{launches}")
    if not hist[1]["loss"] < hist[0]["loss"]:
        fail(f"the HAR loss did not fall: {hist}")
    metrics = evaluate(model, params, x_te, y_te)
    xb, yb = x_tr[: HAR["b"]], y_tr[: HAR["b"]]
    ms = cuda_ms(torch, lambda: trainer.train_step(params, opt, xb, yb), 20)
    print(f"har: accuracy {metrics['accuracy']:.4f}, macro-F1 {metrics['macro_f1']:.4f} on "
          f"{len(y_te)} test windows; train step {ms:.4f} ms at B={HAR['b']}")
    print(json.dumps({"har": dict(metrics, step_ms=ms, losses=[h["loss"] for h in hist])}))
    return launches


def gru_factory(config):
    from vmlmf_tpu_torch.cells import GRUCell, GRUGroupCell

    kw = GRU_CONFIGS[config]
    if config == "group":
        return lambda n, h: GRUGroupCell(n, h, w_rank=GRU["rx"], **kw)
    return lambda n, h: GRUCell(n, h, w_rank=GRU["rx"], **kw)


def gru_harnet(config, backend="fused"):
    from vmlmf_tpu_torch.nn.models import HARNet

    return HARNet(GRU["f"], (GRU["h"], GRU["h"]), num_classes=18, backend=backend,
                  cell_factory=gru_factory(config))


def grads_fused_vs_loop(torch, make_model, x, y):
    """One step's gradients of every parameter, fused against loop backend,
    each tensor against its own scale -> (largest relative error, all-zero
    or missing tensors)."""
    from vmlmf_tpu_torch.train.har import cross_entropy
    from vmlmf_tpu_torch.utils.tree import trainable_leaves

    grads = []
    for backend in ("fused", "loop"):
        model = make_model(backend)
        params = model.init(torch.Generator().manual_seed(0), device="cuda")
        leaves = trainable_leaves(params)
        cross_entropy(model.apply(params, x), y).backward()
        grads.append([p.grad for p in leaves])
    dead = [i for i, a in enumerate(grads[0]) if a is None or not float(a.abs().max()) > 0]
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(*grads)
           if a is not None]
    return max(rel), dead


def phase_har_gru(torch):
    """-> the launch counts of the two HAR GRU paths (training and evaluation)."""
    from vmlmf_tpu_torch.data.har import synthetic_har
    from vmlmf_tpu_torch.train.har import HARTrainer, evaluate

    b = GRU["b"]
    x_tr, y_tr, x_te, y_te = synthetic_har("opp", n_train=30 * b, n_test=500, seed=0)
    total, out = {}, {}
    for config in GRU_CONFIGS:
        model = gru_harnet(config)
        trainer = HARTrainer(model, batch_size=b)
        params, opt = trainer.init()

        # -- the main path, with the launch counts read around it
        reset_launch_counts()
        params, opt, hist = trainer.fit(params, opt, x_tr, y_tr, epochs=2, log_fn=print)
        torch.cuda.synchronize()
        fit_counts = launch_counts()
        metrics = evaluate(model, params, x_te, y_te)
        eval_counts = count_delta(fit_counts)
        launches = launch_counts()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

        steps = 2 * (len(x_tr) // b)
        batches = -(-len(x_te) // 256)
        print(f"har_gru {config}: launches in fit {fit_counts}, in evaluate {eval_counts}")
        if fit_counts != only(gru_scan_xin_fwd_res=2 * steps, gru_scan_xin_bwd=2 * steps):
            fail(f"each {config} GRU train step must launch the GRU residual forward and BPTT "
                 f"twice and nothing else: {fit_counts} over {steps} steps")
        if eval_counts != only(gru_scan_xin_fwd=2 * batches):
            fail(f"evaluate must launch only the GRU no-grad kernel, twice per batch: "
                 f"{eval_counts} over {batches} batches")
        if not hist[1]["loss"] < hist[0]["loss"]:
            fail(f"the {config} HAR GRU loss did not fall: {hist}")

        # -- evaluate's batch through the fused no-grad path against the loop backend
        xe = torch.as_tensor(x_te[:EVAL_BATCH], device="cuda")
        with torch.no_grad():
            ok, err = close(torch, model.apply(params, xe),
                            gru_harnet(config, "loop").apply(params, xe))
        print(f"har_gru {config}: fused vs loop logits at B={EVAL_BATCH}, max abs err {err:.3g} "
              f"(tol {TOL})")
        if not ok:
            fail(f"the {config} GRU HARNet's fused logits disagree with the loop backend's at "
                 f"B={EVAL_BATCH}: {err}")

        # -- one step's gradients, fused against loop (HARNet has no dropout)
        xb = torch.as_tensor(x_tr[:b], device="cuda")
        yb = torch.as_tensor(y_tr[:b], device="cuda")
        rel, dead = grads_fused_vs_loop(torch, lambda be, c=config: gru_harnet(c, be), xb, yb)
        print(f"har_gru {config}: fused vs loop gradients of one step, largest max|diff| / "
              f"max|loop grad| {rel:.3g} (tol {GRAD_TOL})")
        if dead or not rel <= GRAD_TOL:
            fail(f"the {config} GRU fused gradients disagree with the loop backend's: "
                 f"{rel}, all-zero or missing tensors {dead}")

        ms = cuda_ms(torch, lambda: trainer.train_step(params, opt, x_tr[:b], y_tr[:b]), 20)
        out[config] = dict(metrics, step_ms=ms, losses=[h["loss"] for h in hist])
        print(f"har_gru {config}: accuracy {metrics['accuracy']:.4f}, macro-F1 "
              f"{metrics['macro_f1']:.4f} on {len(y_te)} test windows; train step {ms:.4f} ms "
              f"at B={b}")
    print(json.dumps({"har_gru": out}))
    return total


def phase_bdnet(torch):
    """-> the launch counts of a short BDNet training run."""
    from vmlmf_tpu_torch.cells import VMLMFCell
    from vmlmf_tpu_torch.data.har import synthetic_har
    from vmlmf_tpu_torch.nn.models import BDNet
    from vmlmf_tpu_torch.train.har import HARTrainer

    b, steps = GRU["b"], 5
    x_tr, y_tr, _, _ = synthetic_har("opp", n_train=steps * b, n_test=b, seed=1)

    def bdnet(backend, factory=gru_factory("main"), sizes=(GRU["h"], GRU["h"])):
        return BDNet(GRU["f"], sizes, num_classes=18, merge="concat", backend=backend,
                     cell_factory=factory)

    trainer = HARTrainer(bdnet("fused"), batch_size=b)
    params, opt = trainer.init()
    reset_launch_counts()
    params, opt, hist = trainer.fit(params, opt, x_tr, y_tr, epochs=1, log_fn=None)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"bdnet: {steps} steps, loss {hist[0]['loss']:.4f}, launches {launches}")
    if launches != only(gru_scan_xin_fwd_res=4 * steps, gru_scan_xin_bwd=4 * steps) or \
            not hist[0]["loss"] == hist[0]["loss"]:
        fail(f"each BDNet step must launch the GRU residual forward and BPTT four times "
             f"(two layers, two towers): {launches}, loss {hist}")

    # the reverse tower's fused scans against the loop backend, GRU and LSTM
    x = torch.as_tensor(x_tr[:b], device="cuda")
    lstm = (lambda n, h: VMLMFCell(n, h, w_rank=HAR["rx"], u_rank=HAR["r"]), (HAR["h"],))
    for name, (factory, sizes) in (("gru", (gru_factory("main"), (GRU["h"], GRU["h"]))),
                                   ("lstm", lstm)):
        p = bdnet("fused", factory, sizes).init(torch.Generator().manual_seed(0), device="cuda")
        with torch.no_grad():
            got = bdnet("fused", factory, sizes).apply(p, x)
            want_l = bdnet("loop", factory, sizes).apply(p, x)
        ok, err = close(torch, got, want_l)
        print(f"bdnet {name}: fused vs loop logits, max abs err {err:.3g} (tol {TOL})")
        if not ok:
            fail(f"the {name} BDNet's fused logits disagree with the loop backend's: {err}")
    return launches


def trace_step(torch, label, step):
    """One profiled call of step(), after a warm one: device time by kernel,
    the port's against cuBLAS's -> dict(wall_ms, busy_ms, groups)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    if not kernels:
        fail(f"trace: the profiler recorded no device time in one {label}")

    def group(name):
        if any(s in name for s in ("scan_kernel", "bptt_kernel", "colsum_kernel", "vmlmf::")):
            return "port"
        if any(s in name for s in ("gemm", "xmma", "cutlass", "cublas", "splitK")):
            return "cublas"
        return "other"

    groups = {}
    for name, (n, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1]):
        groups[group(name)] = groups.get(group(name), 0.0) + ms
        print(f"trace: {ms:9.4f} ms  x{n:<3d} [{group(name)}] {name[:110]}")
    busy = sum(groups.values())
    print(f"trace: one {label}, wall {wall_ms:.3f} ms, device busy {busy:.3f} ms (idle share "
          f"{1 - busy / wall_ms:.3f}), by group "
          + ", ".join(f"{g} {ms:.3f} ms" for g, ms in sorted(groups.items())))
    return dict(wall_ms=wall_ms, busy_ms=busy, groups=groups)


def phase_trace(torch):
    """One profiled train step each of the LM at B=20 and the main HAR GRU at B=81."""
    from vmlmf_tpu_torch.data.har import synthetic_har
    from vmlmf_tpu_torch.train.har import HARTrainer
    from vmlmf_tpu_torch.train.lm import LMTrainer

    trn, _ = lm_chunks(MAIN_BATCH)
    trainer = LMTrainer(lm_model("fused", dropout_rate=0.5), batch_size=MAIN_BATCH,
                        seq_length=LM["prompt"])
    params, states = trainer.init(), trainer.state0()
    generator = torch.Generator(device="cuda").manual_seed(1)
    lm = trace_step(torch, f"LM train step at B={MAIN_BATCH}",
                    lambda: trainer.train_step(params, states, *trn[1], 1.0, generator))

    har = HARTrainer(gru_harnet("main"), batch_size=GRU["b"])
    har_params, opt = har.init()
    x, y, _, _ = synthetic_har("opp", n_train=GRU["b"], n_test=1, seed=2)
    gru = trace_step(torch, f"main HAR GRU train step at B={GRU['b']}",
                     lambda: har.train_step(har_params, opt, x, y))
    print(json.dumps({"trace": dict(lm=lm, har_gru=gru)}))


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    sys.path.insert(0, ROOT)
    try:
        import vmlmf_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")

    t0 = time.perf_counter()
    card = phase_device(torch)
    phase_build()
    rows = phase_kernels(torch)
    rows.update(phase_gru_kernels(torch))
    paths = [phase_serve(torch), phase_train(torch), phase_har(torch), phase_har_gru(torch),
             phase_bdnet(torch)]
    phase_trace(torch)

    kernels = []
    for name, (_, module) in entries().items():
        launches = sum(p[name] for p in paths)
        if launches == 0:
            fail(f"{name} was never launched on the main paths")
        bwd = name.endswith("_bwd")
        src = module.BWD_KERNEL if bwd else module.KERNEL
        # each entry's row at its main path's shape: the LM layer at B=20, or
        # the main HAR GRU's first layer at the batch its launches ran at
        # (`evaluate`'s for the no-grad entry, the train step's for the others)
        if name.startswith("lstm"):
            row = rows[(name, "lm", MAIN_BATCH)]
        else:
            row = rows[(name, "main_l1", EVAL_BATCH if name == "gru_scan_xin_fwd" else GRU["b"])]
        kernels.append(dict(name=name, route="cuda", source=f"vmlmf_tpu_torch/csrc/{src}.cu",
                            replaces=module.BWD_REPLACES if bwd else module.REPLACES,
                            launches=launches, **row))
    print(f"done in {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
