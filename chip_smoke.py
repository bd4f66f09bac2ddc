#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`vmlmf_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:
  1. device  — the card's name and power limit (nvidia-smi); TF32 off.
  2. build   — nvcc builds every kernel under vmlmf_tpu_torch/csrc at once.
  3. kernels — each kernel against its plain PyTorch version on the card, at
               the shapes of the main path (the PTB LM layer: T=35, F=h=650,
               r=rx=300, B in 1/20/128) and at the HAR layer (F < h), with
               its time, the plain version's time and its roofline bound.
  4. serve   — the main path: the PTB "medium" LM (vocab 10000, 2x650, VMLMF
               w300/u300; seeded random weights) served by `Decoder`:
               prefill of a T=35 prompt at B=20 then 64 greedy tokens,
               top-k sampling, and beam search. The kernels' launch counts
               are set to 0 just before and read just after; each prefill
               must launch the scan kernel once per layer. The fused prefill
               is held to the loop backend's on the card; then prefill ms
               and decode tokens/s at B in 1/20/128.
  5. report  — one JSON line listing every kernel, then the last line
               {"ok": true, "device": {...}}.

Needs one CUDA device and nvcc; imports neither JAX nor the JAX package.
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

TOL = 1e-4  # atol = rtol; f32 sums over K=650 and K=300 in another order, 35 steps
LM = dict(vocab=10000, hidden=650, layers=2, rank=300, prompt=35)
LM_BATCHES = (1, 20, 128)
MAIN_BATCH = 20
HAR = dict(t=24, b=81, f=77, h=180, rx=8, r=6)


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


def close(torch, got, want):
    """-> (ok, max abs error) under atol = rtol = TOL."""
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= TOL + TOL * want.abs()).all())
    return ok, float(err.max())


def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")


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


def phase_kernels(torch):
    from vmlmf_tpu_torch.ops import cuda_scan

    shapes = [("lm", dict(t=LM["prompt"], b=b, f=LM["hidden"], h=LM["hidden"],
                          rx=LM["rank"], r=LM["rank"])) for b in LM_BATCHES]
    shapes.append(("har", HAR))
    rows = {}
    for name, s in shapes:
        args = scan_inputs(torch, **s)
        ys, c_last = cuda_scan.lstm_scan_fused_xin(*args)
        torch.cuda.synchronize()
        ys_p, c_p = cuda_scan.lstm_scan_fused_xin_plain(*args)
        ok_y, err_y = close(torch, ys, ys_p)
        ok_c, err_c = close(torch, c_last, c_p)
        err = max(err_y, err_c)
        ms = cuda_ms(torch, lambda: cuda_scan.lstm_scan_fused_xin(*args), 10)
        plain_ms = cuda_ms(torch, lambda: cuda_scan.lstm_scan_fused_xin_plain(*args), 5)
        ops, nbytes = cuda_scan.scan_cost(s["t"], s["b"], s["f"], s["rx"], s["h"], s["r"])
        op_ms, byte_ms = 1e3 * ops / PEAK_F32_OPS, 1e3 * nbytes / PEAK_BYTES
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(op_ms, byte_ms),
                   bound_by="operations" if op_ms >= byte_ms else "bytes")
        print(f"kernel lstm_scan_xin_fwd {name} T={s['t']} B={s['b']} F={s['f']} h={s['h']} "
              f"rx={s['rx']} r={s['r']}: max_abs_err {err:.3g} (tol {TOL}), {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        if not (ok_y and ok_c):
            fail(f"lstm_scan_xin_fwd disagrees with its plain version at {name} B={s['b']}: "
                 f"max abs err {err}")
        rows[(name, s["b"])] = row
    return rows


def lm_models(torch):
    from vmlmf_tpu_torch.cells import VMLMFCell
    from vmlmf_tpu_torch.nn.models import LMModel

    kw = dict(vocab_size=LM["vocab"], hidden_size=LM["hidden"], num_layers=LM["layers"],
              cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=LM["rank"], u_rank=LM["rank"]),
              dropout_rate=0.0, winit=0.05)
    fused, loop = LMModel(backend="fused", **kw), LMModel(backend="loop", **kw)
    params = fused.init(torch.Generator().manual_seed(0), device="cuda")
    return fused, loop, params


def prompt_ids(torch, b, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, LM["vocab"], (LM["prompt"], b), generator=g).cuda()


def phase_serve(torch):
    from vmlmf_tpu_torch.ops import cuda_scan
    from vmlmf_tpu_torch.serve import Decoder

    fused, loop, params = lm_models(torch)
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
    cuda_scan.lstm_scan_fused_xin.launches = 0
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
    launches = cuda_scan.lstm_scan_fused_xin.launches

    print(f"serve: launches of lstm_scan_xin_fwd {launches}, per prefill {prefill_deltas}")
    if prefill_deltas != [layers] * 3:
        fail(f"each prefill must launch the scan kernel {layers} times, got {prefill_deltas}")
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
    errs = [close(torch, lf, ll)] + [close(torch, a, b) for pair_f, pair_l in zip(sf, sl)
                                     for a, b in zip(pair_f, pair_l)]
    print(f"serve: fused vs loop prefill, max abs err {max(e for _, e in errs):.3g} (tol {TOL})")
    if not all(ok for ok, _ in errs) or not bool(torch.isfinite(lf).all()):
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

    phase_device(torch)
    phase_build()
    rows = phase_kernels(torch)
    launches = phase_serve(torch)
    from vmlmf_tpu_torch.ops import cuda_scan

    main_row = rows[("lm", MAIN_BATCH)]
    kernels = [dict(name=cuda_scan.KERNEL, route="cuda",
                    source=f"vmlmf_tpu_torch/csrc/{cuda_scan.KERNEL}.cu",
                    replaces=cuda_scan.REPLACES, launches=launches,
                    **main_row, library_ms=None)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
