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
               and the BPTT at B in 20/128 (LM) and 81 (HAR). Then the dense
               forms: a dense recurrent side (the group VMLMF HAR layer, rx=8,
               U [180, 720]), dense on both sides (the dense HAR layer, and
               the dense PTB LM layer at B=20 and 128, U and Ux [650, 2600]),
               and a dense x side (h=180, r=6). Each shape's layout from
               `scan_plan` is printed first (batch groups, CTAs, shared
               memory). Each with its time, the plain
               version's, its roofline bound, and cuDNN's LSTM on the same
               scan's dense weights (the library yardstick); where the scan
               is dense on both sides with no diagonal, cuDNN's output is
               also held to the kernel's. Then the JAX package's variants:
               bf16 products at the LM layer (low-rank at B in 1/20/128,
               dense at B=20), bf16 residuals and the recompute policy at
               the HAR layer (B=81), with cuDNN's LSTM in bf16 (other
               rounding) or f32 as the library. A bf16 kernel's first two
               steps (ys and cs of the forwards, dxs at T-2 and T-1 of the
               BPTT from its own residuals) must also lie 4x nearer its
               plain bf16 version than that lies to the f32 one, and two
               calls of a bf16 entry must give equal bits. The bf16 plans
               whose batch groups pad to 24 rows or more run the walk's
               products on the tensor cores (`ScanPlan.mma`); the kernels
               line names those entries by the forms "wide_dense_bf16_mma"
               (the large LM's layer at B=20, resident) and
               "wide_dense_bf16_mma_ring" (B=128, one streamed launch).
  4. gru kernels — each GRU kernel entry (no-grad forward, residual forward,
               BPTT) against its plain version at T=24, h=64, rx=9: the
               layers of both HAR GRUs (main: low-rank "pre", r=9; group:
               dense "post"; F=77 then 64) at B=81, the train batch, where
               all three entries run, and at B=256, `evaluate`'s batch,
               where the no-grad entry runs; a dense "pre" layer; and a
               dense "post" and a low-rank "pre" layer at h=256 whose
               weights do not fit in shared memory; then each recurrent form
               with a dense x side (ux [F, 3h]): the layers of the two dense-x
               HAR GRUs at B=81 and 256, and a dense "pre" layer; then the
               first layer of `har_main --model mygru` at its default width
               (dense "pre", dense x side, h=180) and its "post" form at
               B=81 and 256. Each shape's layout is printed first: `gru_plan`
               (rows a CTA), or, where that reads the recurrent weights
               through L2 (h=180, h=256), the grid (`gru_grid_plan`: groups
               x CTAs, each CTA holding its units' weight slices in shared
               memory, one cooperative launch a chunk of rows). Library:
               cuDNN's GRU on
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
 10. har_dense — the HAR paths through the dense forms, built by
               `HARConfig(...).build_model()` at full width and run as in 7
               and 8: the group VMLMF HARNet (77 -> 180, w8, u(2, 4), g=2:
               a dense [180, 720] recurrent matrix), the dense LSTM HARNet
               (the CLI default, `HARConfig()`), and the two GRU HARNets with
               a dense x side (`mygru` u9, `mygru_group` u(12, 6)).
 11. lm_dense — the dense PTB LM, `LMConfig(lstm_type="custom")` (vocab
               10000, 2x650, dropout 0.5): prefill and 64 greedy tokens at
               B=20 (one no-grad launch per layer per prefill; fused against
               loop), then 30 `LMTrainer` chunks (launches per step, falling
               loss, perplexity's launches, fused against loop gradients at
               dropout 0), prefill ms and train step ms.
 12. reduced — short runs of the other cells at reduced depth (3 steps):
               dualdiag, mylstm_group, vmgroup_novm, LMF mylstm, mylstm with
               a dense x side, the dense and the w9 mygru, DeepConvNet (64
               channels, 77 sensors: a 4928-wide cell input), and the two
               cells without a fused form, diag and the shuffled
               LSTMGroupCell, which must launch nothing.
 13. wavefront — the PTB medium LM on backend "fused_pipelined" (the
               VMLMF_EXPERIMENTAL_WAVEFRONT=1 knob is set by the script), the
               wavefront stack: each stack kernel entry against its plain
               version at L=2, T=35, h=650, r=rx=300, each at B in 1/20/128
               (the no-grad forward without masks, the residual forward and
               the BPTT with masks; each shape's `stack_plan` printed
               first: one cooperative launch over the SMs, a set of CTAs per
               layer), with cuDNN's two-layer LSTM on the dense weights from
               x as the library yardstick and beside it the port's path from
               x, the "fused" backend's two per-layer scans from x, and µs a
               step of the stack (no-grad, and BPTT with its GEMMs); the
               BPTT twice to equal bits, its weight gradients' tile and k
               slices by product (csrc/gemm_tc.cuh's rule), a trace of the
               walk against them (the Hopper tile there wherever the rule
               routes a product, gemm_tile.cuh nowhere), the peak MiB of a
               BPTT call and its staging scratch; prefill at B=20 and 64 greedy tokens through `LMConfig`
               and `Decoder` (one no-grad stack launch per prefill and no
               per-layer one, held to the "fused" prefill); 30 `LMTrainer`
               chunks at B=20, dropout 0.5 (one residual forward and one
               BPTT of the stack per step, `perplexity` only the no-grad
               stack, a falling loss, one step's gradients held to "fused"'s
               under equal generator seeds; the same 30 chunks on "fused"
               and "loop", whose losses must agree with the wavefront's over
               the first 10 steps, and the step where each pair parts); a
               4x650 stack with `stack_fits`
               forced to a 2+2 grouping for 3 steps, held to "fused"; a
               VMLMF BDNet at the HAR width (one stack for its forward tower,
               the per-layer fused scans for its reverse tower, held to
               "fused"); then prefill ms at B in 1/20/128 and train step ms
               at B in 20/128 beside the "fused" backend's, and fit's block
               of 8 chunks graphed at B=128 on both backends (each held bit
               for bit to its eager steps), ms a step.
 14. mixed   — the JAX package's kernel variants of the LSTM scan: the gi-mode
               entries against their plain versions at the LM layer, B=20,
               with cuDNN's f32 LSTM from x as the library; then three
               paths at full width, each with exact launch counts of each
               variant: the PTB LM in the JAX package's mixed precision
               (VMLMF_PALLAS_PRECISION=bf16 and head_bf16, as
               scripts/bench_lm_b128_precision.py builds "bf16+head")
               served by `Decoder` and trained by `LMTrainer` for 30 chunks
               at B=20 and 128, its first step's gradients held to the f32
               "fused" step's; the HAR flagship trained under
               VMLMF_PALLAS_SAVED_GATES=0 and under
               VMLMF_PALLAS_RESIDUALS=bf16; the LM trained in gi mode
               (VMLMF_PALLAS_XIN=0), held to x mode. Prefill ms, greedy
               tokens/s, train step ms and words/s beside f32 "fused"; the
               peak memory of a HAR (B=81) and an LM (B=128) train step
               under each residual policy; and a `torch.profiler` trace of
               a mixed-precision LM train step.
 15. variants — the last variants of the Pallas kernels. The GRU's gi-mode
               entries (`gru_scan_fused`, `gru_scan_fused_res`,
               `gru_scan_bwd`, from the layer's own gi) and its recompute
               policy (the residual forward writes ys alone; the BPTT's
               pre-pass rebuilds the residuals) against their plain
               versions in the three recurrent forms at T=24, h=64, B=81
               (no-grad gi also at 256), beside cuDNN's GRU from x for
               "post". Both HAR GRUs trained and evaluated under
               VMLMF_PALLAS_XIN=0 and under VMLMF_PALLAS_SAVED_GATES=0 with
               exact launch counts of those entries only, beside saved-gates
               x mode in the same phase (fused against loop gradients,
               accuracy, macro-F1, step ms); the dense "pre" GRU (mygru_w9)
               for a few steps under each; a GRU BDNet in gi mode; the peak
               memory of a GRU step under each policy. Then the stack with
               bf16 products: each entry against its plain version at the
               LM stack (B = 1/20/128, the bf16 plan) to the bf16 tolerances,
               beside "fused"'s per-layer scans, the first two
               steps of each walk 4x nearer the plain bf16 version than the
               f32 one, cuDNN's two-layer LSTM in bf16 beside it; and the
               mixed-precision LM (VMLMF_PALLAS_PRECISION=bf16, head_bf16)
               on "fused_pipelined" served at B = 1/20/128 and trained at
               B = 20/128, every launch of the "bf16" variant, its first
               step's gradients held to the f32 wavefront's, prefill and
               step ms beside the mixed-precision "fused" LM.
 16. plans   — faults 9 and 10: the PTB LM layer at B=1024, past the largest
               batch one launch's plan takes, in f32 and in bf16 (its
               `scan_chunks` printed; each entry one launch a chunk of rows,
               counted), and a dense "pre" GRU layer at T=24, B=512, F=77,
               h=1000 on the grid layout, two chunks of 256 rows (its
               `gru_grid_plan` printed, one launch a chunk): every entry
               against its plain version (each BPTT on the kernel's own
               residuals, the comparison on the plain forward's printed
               beside it), ms, bound, cuDNN's LSTM (and the GRU's, another
               function, for scale).
 17. cli     — the port's entry points through each CLI module's main(argv)
               with a temporary --ckpt_dir: `har_main --total --synthetic`
               on the VMLMF flagship (180, w8/u6, 2 epochs), then without
               --total, which loads the checkpoint and must report the same
               accuracy and macro-F1 with the no-grad kernel alone; the HAR
               GRU (64 64, w9/u9); `--model mygru` at its default width
               (a dense GRU of 180 units on the grid layout), trained and
               then tested from its checkpoint, and `--model mygru_group
               --uRanks 12 6` (dense "post", 180); the UCI-HAR shape (T=128,
               F=9); `lm_main
               --synthetic --vocab_size 10000 --total_epochs 1` at the PTB
               "medium" width on "fused", "fused_pipelined", then "fused"
               again (the first run also pays the warm-up), whose
               validation perplexity must be finite and below a uniform
               guess's, the vocabulary size (the epoch is one block of
               `fuse_chunks`, logged once at its end). Launches (only the path's
               family), seconds an epoch and the LM's words/s.
 18. ranker  — the session ranker at the JAX package's bench config
               (bench.py:533-543, :590-594: 100,000 items, H=650, one VMLMF
               layer w300/u300, T=35, B=128, k=100; seeded random weights):
               `rank_next` on "fused" (exactly one no-grad launch a call)
               held to the "loop" backend on the card (equal ids, scores to
               1e-4); serving sessions/s, the median of CUDA-event times of
               24 chained calls (each call's next batch from its ids, as
               bench.py chains them), at 100,000 items and at 1,000,000 (the
               table drawn on the card); the full-row `torch.topk` against
               `blocked_topk` at both sizes; the sparse trainer (8 chunks of
               sampled softmax, 8192 negatives, in-batch negatives; one
               residual forward and one BPTT a chunk) in training sessions/s;
               its 3 steps held to the dense sampled trainer on the same
               negatives (loss and gnorm to 1e-5 relative, every tensor to
               1e-4), two equal steps to equal bits; a step's peak memory
               and device-busy share (`torch.profiler`).
 19. graphs  — the paths that run many steps in one dispatch, as CUDA graphs
               (`utils.graphs.StepGraph`), each held bit for bit to the same
               step run eagerly from equal seeds and generators: the PTB LM
               (2x650, w300/u300, T=35, dropout 0.5) in `LMTrainer.
               _fused_chunks` (fit's block) over 8 chunks at B=20 and 128 on
               "fused" and at B=20 on "fused_pipelined"; `perplexity` over
               16 chunks; greedy decode of 64 tokens at B = 1/20/128, top-k
               sampling at B=20 and beam search (16 steps, 4 beams) at
               B=20; the HAR flagship VMLMF and the main HAR GRU, a block of
               `fuse_batches` (64) Adam steps at B=81; the ranker's
               `fused_chunks` at its bench config (8 chunks, 8192 negatives
               drawn in the graph). For each, eager and graphed: the launch
               counts of a run (equal), the port's kernels in a trace of a
               run of up to 16 steps (equal, one main kernel a counted launch,
               the profiler's window padded with spin kernels; a trace that
               lost a main kernel is taken again with one more spin kernel
               at each edge, a pair that disagrees again), wall ms a step
               (CUDA events, median of 3), busy ms and idle share from the
               trace, the memory a run holds beyond what was live, the
               capture's seconds and its pool; decode tokens/s. Then
               `Decoder.prefill` of a T=35 prompt graphed (its results read
               from a replay) against eager, bit for bit, at B = 1/20/128 on
               "fused" and "fused_pipelined" and at B=20 for the
               mixed-precision LM (every launch of the "bf16" variant), 16
               calls a run; the other phases time a prefill once its
               graph is captured (`replay_ms`); beam
               search above starts with the graphed prefill. Then the
               capturable Adam against the default one over 20 HAR steps
               (1e-6 relative).
 20. parallel — `vmlmf_tpu_torch.parallel` on NCCL at world size 1 (a free
               port on 127.0.0.1): `dryrun_multichip(1)` (phases 1 and 3;
               phase 2 needs two ranks on "model"), one `LMTrainer` and one
               `HARTrainer` step with a mesh, each bit-equal to the same step
               without one, and `topk_sharded` at S=1 bit-equal to `topk`.
               Then the graphed paths on the 1x1 mesh, their NCCL
               collectives captured (`MESH_PATHS`: the LM block at B=20 and
               128 on "fused", perplexity over 16 chunks, the two 64-step
               HAR blocks, the ranker's 8 chunks): each bit-equal to its
               eager steps on the mesh (equal launch counts and traces, the
               numbers of phase 19) and to the same path graphed without a
               mesh in phase 19.
 21. trace   — one `torch.profiler` trace each of an LM train step at B=20,
               of a main HAR GRU train step at B=81, of a dense LM train
               step at B=20 and of a wavefront LM train step at B=20: the
               device time of each kernel, the port's against cuBLAS's, the
               LSTM products of the LM, dense LM and wavefront steps on
               csrc/gemm_tc.cuh's tiles alone, some on wgmma (every
               trace counts kernels, copies and sets, not the ranges that
               `record_function` draws on the device's timeline, such as
               `Optimizer.step`'s, in a window opened and closed by spin
               kernels). A profiler error or an empty trace fails.
 22. wide    — fault 11, layers too wide for the shared memory of all SMs.
               Kernel checks, each shape's plan printed first (the resident
               depth of each weight slice and the MB streamed a step): the
               LSTM entries at h=1500, dense and r=rx=750, T=35, B=20 and
               128 in f32 (streamed plans) and B=20 in bf16 (B=128 dense in
               chunks of rows), the gi-mode entries at the dense layer, with
               cuDNN's LSTM; a streamed plan forced at the PTB LM layer (B=20)
               with the resident plan's layout, all six entries bit-equal to
               it; the GRU's three forms at h=3200 (T=24, B=81) on the grid
               layout, each weight slice streamed through the TMA ring (the
               plan printed with its MB a step and its ring), every entry
               against plain and a ring of other stages bit-equal, the
               BPTT's products routed to the `wgmma` tile (printed) against
               float64 beside `gemm_tile.cuh`, the peak MiB of a BPTT call
               and a HAR train step, cuDNN's GRU for "post". Then the
               dense PTB "large" LM (Zaremba et al.
               2014, section 4.1: 2x1500, dropout 0.65, init 0.04, clip 10;
               vocab 10000, seeded random weights): the graphed prefill at
               B = 1/20/128 and greedy decode, each bit-equal to eager; 60
               eager train steps at B=20 (a falling loss; the first 10 held
               to the loop backend's) and a graphed block of 8 chunks;
               "fused_pipelined" (each dense layer a singleton group through
               the per-layer scans, no stack launch) bit-equal to "fused";
               the mixed precision (bf16 products and head) at B=20 and 128;
               a VMLMF LM of that width (r=750) served and trained; one
               `lm_main` epoch at the large LM's flags; the HAR GRU nets at
               h=3200, two steps and `evaluate` each.
 23. report  — one JSON line listing every kernel entry in every form that
               the main paths ran, then the last line {"ok": true, ...}.

In phases 5-22 every launch count is set to 0 just before the path runs and
read just after. Needs one CUDA device and nvcc; imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM, dense, at its 700 W limit: f32 outside the tensor cores, bf16 on
# the tensor cores, f32 products as 3xTF32 on the tensor cores (three TF32
# passes at 494 TFLOP/s), and HBM3
PEAK_F32_OPS = 67e12
PEAK_BF16_OPS = 989e12
PEAK_3XTF32_OPS = 494e12 / 3
PEAK_BYTES = 3.35e12

TOL = 1e-4  # outputs: f32 sums over K=650 and K=300 in another order, 35 steps
GRAD_TOL = 1e-3  # gradients: weight gradients sum over all T*B rows in another order
# bf16 products: the kernel and its plain version round the same operands,
# but sums in another order can move a value across a bf16 rounding
# boundary (tests/test_pallas.py:97, :114); bf16 residuals (:209-213)
BF16_TOL, BF16_GRAD_TOL, RES_GRAD_TOL = 5e-3, 5e-2, 2e-2
LM = dict(vocab=10000, hidden=650, layers=2, rank=300, prompt=35)
LM_BATCHES = (1, 20, 128)
TRAIN_BATCHES = (20, 128)
MAIN_BATCH = 20
HAR = dict(t=24, b=81, f=77, h=180, rx=8, r=6)
TRAIN_CHUNKS = 30
PARTING_STEPS = 10  # train steps over which the LM's backends must give the same losses
TC_TOL = 1e-5  # the tensor-core tile's f32 products against float64, relative to the output
CHAOS_RATIO = 10  # the most a chaotic run's backends may part, in partings of a one-ulp witness
# the HAR GRU layers: 64 wide, x side rank 9, T=24, B=81
GRU = dict(t=24, b=81, f=77, h=64, rx=9, r=9)
# HARConfig's default layer width (vmlmf_tpu/config.py), which `har_main
# --model mygru` trains as a dense "pre" GRU with a dense x side: the GRU
# kernels take the grid layout there
GRU_DEFAULT_H = 180
EVAL_BATCH = 256  # `evaluate`'s batch, into which it pads the test windows
REDUCED_STEPS = 3
# fault 9: the LM layer's batch past the largest one launch's plan takes
# (656 with f32 weights, 832 with bf16); fault 10: a dense "pre" GRU layer
# (T, B, F, h, rx, r) whose four rows a CTA do not fit in shared memory
PLAN_BATCH = 1024
GRU_WIDE = (24, 512, 77, 1000, 0, 0)
# the session ranker's bench config (bench.py:533-543, :590-594) and the
# larger catalog scripts/bench_ranker.py:70 serves
RANKER = dict(items=100_000, items_big=1_000_000, hidden=650, rank=300, t=35, b=128, k=100,
              negatives=8192, chunks=8, serve_calls=24)

# The HAR paths at full width: their `HARConfig` fields and the kernel form
# they run ("family:form"): first the low-rank ones, then the dense forms.
HAR_PATHS = {
    "vmlmf": (dict(model="vmmodel", w_rank=8, u_ranks=(6,)), "lstm:lowrank"),
    "gru_main": (dict(model="mygru", layer_sizes=(64, 64), w_rank=9, u_ranks=(9,)),
                 "gru:lowrank_pre"),
    "gru_group": (dict(model="mygru_group", layer_sizes=(64, 64), w_rank=9, u_ranks=(12, 6)),
                  "gru:dense_post"),
    "group_vmlmf": (dict(model="vmgroup", w_rank=8, u_ranks=(2, 4)), "lstm:dense_rec"),
    "dense_lstm": (dict(), "lstm:dense"),
    "gru_dense_x": (dict(model="mygru", layer_sizes=(64, 64), u_ranks=(9,)),
                    "gru:dx_lowrank_pre"),
    "gru_group_dense_x": (dict(model="mygru_group", layer_sizes=(64, 64), u_ranks=(12, 6)),
                          "gru:dx_dense_post"),
}
# The short runs at reduced depth: `HARConfig` fields (None: the shuffled
# LSTMGroupCell, which no config field selects) and the form (None: no
# fused form, so no launch).
REDUCED = {
    "dualdiag": (dict(model="dualdiag"), "lstm:dense"),
    "mylstm_group": (dict(model="mylstm_group", u_ranks=(2, 4)), "lstm:dense"),
    "vmgroup_novm": (dict(model="vmgroup_novm", w_rank=8, u_ranks=(2, 4)), "lstm:dense_rec"),
    "mylstm_lmf": (dict(model="mylstm", w_rank=8, u_ranks=(6,)), "lstm:lowrank"),
    "mylstm_dense_x": (dict(model="mylstm", u_ranks=(6,)), "lstm:dense_x"),
    "mygru_dense": (dict(model="mygru", layer_sizes=(64, 64)), "gru:dx_dense_pre"),
    "mygru_w9": (dict(model="mygru", layer_sizes=(64, 64), w_rank=9), "gru:dense_pre"),
    "deepconv": (dict(model="mylstm", deepconv=True, layer_sizes=(128, 128)), "lstm:dense"),
    "diag": (dict(model="diag"), None),
    "lstm_group_shuffle": (None, None),
}
# Each form of each kernel family, with the kernel check whose numbers its
# row in the kernels line carries: (shape name, B of the no-grad entry, B of
# the training entries). The low-rank forms keep their entries' plain names.
# A form whose no-grad entry has no such variant (the residual policies)
# has None in its place.
FORMS = {
    "lstm": {"lowrank": ("lm", 20, 20), "dense_rec": ("har_group", EVAL_BATCH, 81),
             "dense": ("lm_dense", 20, 20), "dense_x": ("har_dense_x", 81, 81),
             "bf16": ("lm_bf16", 20, 20), "bf16_res": ("har_bf16_res", None, 81),
             "recompute": ("har_recompute", None, 81),
             "wide_dense": ("wide_dense", 20, 20), "wide_lowrank": ("wide_lowrank", 20, 20),
             "wide_dense_bf16_mma": ("wide_dense_bf16", 20, 20),
             "wide_dense_bf16_mma_ring": ("wide_dense_bf16", 128, 128)},
    "lstm_gi": {"lowrank": ("lm_gi", 20, 20)},
    "gru": {"lowrank_pre": ("main_l1", EVAL_BATCH, 81),
            "dense_post": ("group_l1", EVAL_BATCH, 81),
            "dense_pre": ("dense_pre", 81, 81),
            "dx_lowrank_pre": ("dx_main_l1", EVAL_BATCH, 81),
            "dx_dense_post": ("dx_group_l1", EVAL_BATCH, 81),
            "dx_dense_pre": ("dx_dense_pre", 81, 81),
            "recompute": ("main_l1_recompute", None, 81),
            "recompute_dense_post": ("group_l1_recompute", None, 81),
            "recompute_dense_pre": ("dense_pre_recompute", None, 81),
            "wide_post": ("wide_post", 81, 81), "wide_pre": ("wide_pre", 81, 81),
            "wide_lowrank_pre": ("wide_lowrank_pre", 81, 81),
            "har180_dense_pre": ("har180_pre", EVAL_BATCH, 81),
            "har180_dense_post": ("har180_post", EVAL_BATCH, 81)},
    "gru_gi": {"lowrank_pre": ("main_l1", EVAL_BATCH, 81),
               "dense_post": ("group_l1", EVAL_BATCH, 81),
               "dense_pre": ("dense_pre", 81, 81)},
    "lstm_stack": {"lowrank": ("stack", MAIN_BATCH, MAIN_BATCH),
                   "bf16": ("stack_bf16", MAIN_BATCH, MAIN_BATCH)},
}
# Forms whose rows keep their entries' plain names; the GRU's gi-mode rows
# name every form
FIRST_FORMS = ("lowrank", "lowrank_pre")
NAMED_FORMS = ("gru_gi",)
# The entries of each kernel family: (no-grad forward, residual forward, BPTT)
FAMILIES = {
    "lstm": ("lstm_scan_xin_fwd", "lstm_scan_xin_fwd_res", "lstm_scan_xin_bwd"),
    "lstm_gi": ("lstm_scan_fwd", "lstm_scan_fwd_res", "lstm_scan_bwd"),
    "gru": ("gru_scan_xin_fwd", "gru_scan_xin_fwd_res", "gru_scan_xin_bwd"),
    "gru_gi": ("gru_scan_fwd", "gru_scan_fwd_res", "gru_scan_bwd"),
    "lstm_stack": ("lstm_stack_fwd", "lstm_stack_fwd_res", "lstm_stack_bwd"),
}


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


def replay_ms(torch, fn, iters):
    """`cuda_ms` of a graphed call (`Decoder.prefill`) once its graph is
    captured: after `utils.graphs.WARMUP` eager calls, `cuda_ms`'s warm call
    captures it, and the timed calls replay it."""
    from vmlmf_tpu_torch.utils.graphs import WARMUP

    for _ in range(WARMUP):
        fn()
    return cuda_ms(torch, fn, iters)


def close(torch, got, want, tol=TOL):
    """-> (ok, max abs error) under atol = rtol = tol."""
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol + tol * want.abs()).all())
    return ok, float(err.max())


def all_close(torch, gots, wants, tol):
    """close() over pairs of tensors -> (all ok, largest max abs error)."""
    checks = [close(torch, g, w, tol) for g, w in zip(gots, wants)]
    return all(ok for ok, _ in checks), max(e for _, e in checks)


def bound(ops, nbytes, bf16_ops=0, tf32_ops=0):
    """(bound ms, what bounds it) at the card's memory peak and its peaks for
    the operations' types: ``bf16_ops`` of the ``ops`` (the products of a
    bf16 variant) at the bf16 tensor-core rate, ``tf32_ops`` (an f32
    variant's GEMM phase, 3xTF32) at a third of the TF32 rate, the rest at
    the f32 rate."""
    op_ms = 1e3 * ((ops - bf16_ops - tf32_ops) / PEAK_F32_OPS + bf16_ops / PEAK_BF16_OPS
                   + tf32_ops / PEAK_3XTF32_OPS)
    byte_ms = 1e3 * nbytes / PEAK_BYTES
    return max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes"


def entries():
    """{entry name: (its wrapper, its kernel module)} for every kernel entry."""
    from vmlmf_tpu_torch.ops import cuda_gru, cuda_scan, cuda_stack

    return {"lstm_scan_xin_fwd": (cuda_scan.lstm_scan_fused_xin, cuda_scan),
            "lstm_scan_xin_fwd_res": (cuda_scan.lstm_scan_fused_xin_res, cuda_scan),
            "lstm_scan_xin_bwd": (cuda_scan.lstm_scan_xin_bwd, cuda_scan),
            "lstm_scan_fwd": (cuda_scan.lstm_scan_fused, cuda_scan),
            "lstm_scan_fwd_res": (cuda_scan.lstm_scan_fused_res, cuda_scan),
            "lstm_scan_bwd": (cuda_scan.lstm_scan_bwd, cuda_scan),
            "gru_scan_xin_fwd": (cuda_gru.gru_scan_fused_xin, cuda_gru),
            "gru_scan_xin_fwd_res": (cuda_gru.gru_scan_fused_xin_res, cuda_gru),
            "gru_scan_xin_bwd": (cuda_gru.gru_scan_xin_bwd, cuda_gru),
            "gru_scan_fwd": (cuda_gru.gru_scan_fused, cuda_gru),
            "gru_scan_fwd_res": (cuda_gru.gru_scan_fused_res, cuda_gru),
            "gru_scan_bwd": (cuda_gru.gru_scan_bwd, cuda_gru),
            "lstm_stack_fwd": (cuda_stack.lstm_stack_scan_fused, cuda_stack),
            "lstm_stack_fwd_res": (cuda_stack.lstm_stack_scan_fused_res, cuda_stack),
            "lstm_stack_bwd": (cuda_stack.lstm_stack_bwd, cuda_stack)}


def launch_counts():
    """The launch count of each kernel entry, by name."""
    return {name: fn.launches for name, (fn, _) in entries().items()}


def reset_launch_counts():
    for fn, _ in entries().values():
        fn.launches = 0
        if hasattr(fn, "variants"):
            fn.variants.clear()


def count_delta(before):
    return {k: v - before[k] for k, v in launch_counts().items()}


def only(**counts):
    """A launch-count dict of every entry: the given counts, 0 for the rest."""
    want = dict.fromkeys(entries(), 0)
    want.update(counts)
    return want


def nonzero(counts):
    """The entries of a launch-count dict that launched, for printing."""
    return {k: v for k, v in counts.items() if v}


def train_counts(form, n):
    """The launch counts of n training scans of a form ("family:form")."""
    _, res, bwd = FAMILIES[form.split(":")[0]]
    return only(**{res: n, bwd: n})


def eval_counts(form, n):
    """The launch counts of n no-grad scans of a form ("family:form")."""
    return only(**{FAMILIES[form.split(":")[0]][0]: n})


def dense_lstm_weights(ux, vx, xdvec, bias, u, v, dvec):
    """The fused scan's weights as one dense LSTM layer's, in PyTorch's layout
    and gate order (i, f, g, o): [w_ih [4h, F], w_hh [4h, h], b_ih, b_hh].

    The VMLMF pre-activation is linear in x and in h, so w_ih = (ux@vx)^T
    (ux^T for a dense x side, vx None) plus xdvec[g, j] at [g*h + j, j] for
    j < min(F, h), w_hh = (u@v)^T (u^T dense) plus dvec on each gate's
    diagonal, b_ih = bias and b_hh = 0. cuDNN's LSTM on these weights
    computes the same scan: the library yardstick.
    """
    import torch

    f, h = ux.shape[0], xdvec.shape[1]
    w_ih = (ux if vx is None else ux @ vx).T.contiguous()
    w_hh = (u if v is None else u @ v).T.contiguous()
    jx = torch.arange(min(f, h), device=ux.device)
    jh = torch.arange(h, device=ux.device)
    for g in range(4):
        w_ih[g * h + jx, jx] += xdvec[g, : len(jx)]
        w_hh[g * h + jh, jh] += dvec[g * h : (g + 1) * h]
    return [w_ih, w_hh, bias.clone(), torch.zeros_like(bias)]


def dense_gru_weights(ux, vx, bias, uf, prz, pn):
    """The fused GRU scan's weights as one dense GRU layer's, in PyTorch's
    layout and gate order (r, z, n): [w_ih [3h, F], w_hh [3h, h], b_ih, b_hh]
    with w_ih = (ux@vx)^T (ux^T for a dense x side, vx None), w_hh =
    [prz | pn]^T (low-rank: (uf@[prz | pn])^T), b_ih = bias and b_hh = 0.

    PyTorch's GRU applies the reset gate after the recurrent product, n =
    tanh(W_in x + b_in + r * (W_hn h + b_hn)), so cuDNN's GRU on these
    weights computes the scan's mode "post", and not mode "pre".
    """
    import torch

    w = torch.cat([prz, pn], dim=1)
    w_hh = w if uf is None else uf @ w
    w_ih = ux if vx is None else ux @ vx
    return [w_ih.T.contiguous(), w_hh.T.contiguous(), bias.clone(), torch.zeros_like(bias)]


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


def scan_inputs(torch, t, b, f, h, rx, r, seed=0, diagonals=True):
    """Seeded scan inputs on the card, scaled so that the gates are O(1). rx =
    0 is a dense x side (ux [F, 4h], vx None), r = 0 a dense recurrent side
    (u [h, 4h], v None); without ``diagonals`` xdvec and dvec are zeros, as
    `LSTMCell` gives them."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, scale):
        return (scale * torch.randn(shape, generator=g)).cuda()

    xs, ux = n(t, b, f, scale=1.0), n(f, rx or 4 * h, scale=f ** -0.5)
    vx = n(rx, 4 * h, scale=rx ** -0.5) if rx else None
    xdvec, bias = n(4, h, scale=0.1), n(4 * h, scale=0.1)
    u = n(h, r or 4 * h, scale=h ** -0.5)
    v = n(r, 4 * h, scale=r ** -0.5) if r else None
    dvec, h0, c0 = n(4 * h, scale=0.1), n(b, h, scale=0.5), n(b, h, scale=0.5)
    if not diagonals:
        xdvec, dvec = torch.zeros_like(xdvec), torch.zeros_like(dvec)
    return xs, ux, vx, xdvec, bias, u, v, dvec, h0, c0


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


def kernel_row(name, shape, err, tol, ms, plain_ms, cost, library_ms, library="cuDNN"):
    """A kernel check's numbers; ``cost`` is (ops, bytes), (ops, bytes,
    bf16 ops) or (ops, bytes, bf16 ops, 3xTF32 ops), as `bound` takes it."""
    bms, by = bound(*cost)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"kernel {name} {shape}: max_abs_err {err:.3g} (tol {tol}), {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), library ({library}) {lib}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms)


F32 = ("f32", "f32", True)  # (precision, residuals, save_gates) of the default kernels


def lstm_kernel_shapes():
    """(name, shape, train, diagonals, variant) of each LSTM kernel check: the
    PTB LM layer at B in 1/20/128 and the VMLMF HAR layer at B=81 and 256
    (both low-rank); the dense PTB LM layer at B=20 and 128; the group VMLMF
    HAR layer (dense recurrence) and the dense HAR layer at B=81 and 256; a
    dense x side at B=81. Then the JAX package's variants: bf16 products at
    the LM layer (low-rank at B in 1/20/128, dense at B=20), bf16 residuals
    and the recompute policy at the HAR layer, B=81. ``train``: the residual
    forward and the BPTT run there too; ``variant``: (precision, residuals,
    save_gates)."""
    lm = dict(t=LM["prompt"], f=LM["hidden"], h=LM["hidden"], rx=LM["rank"], r=LM["rank"])
    out = [("lm", dict(lm, b=b), b in TRAIN_BATCHES, True, F32) for b in LM_BATCHES]
    out += [("har", HAR, True, True, F32), ("har", dict(HAR, b=EVAL_BATCH), False, True, F32)]
    out += [("lm_dense", dict(lm, b=b, rx=0, r=0), True, False, F32) for b in TRAIN_BATCHES]
    for name, over, diagonals in (("har_group", dict(r=0), True),
                                  ("har_dense", dict(rx=0, r=0), False)):
        out += [(name, dict(HAR, **over), True, diagonals, F32),
                (name, dict(HAR, b=EVAL_BATCH, **over), False, diagonals, F32)]
    out.append(("har_dense_x", dict(HAR, rx=0), True, False, F32))
    bf16 = ("bf16", "f32", True)
    out += [("lm_bf16", dict(lm, b=b), b in TRAIN_BATCHES, True, bf16) for b in LM_BATCHES]
    out.append(("lm_dense_bf16", dict(lm, b=MAIN_BATCH, rx=0, r=0), True, False, bf16))
    return out + [("har_bf16_res", HAR, True, True, ("f32", "bf16", True)),
                  ("har_recompute", HAR, True, True, ("f32", "f32", False))]


def cudnn_lstm_bf16(torch, lstm):
    """cuDNN's LSTM with the same weights in bf16: the same work with bf16
    storage and other rounding points, the library yardstick of the bf16 rows."""
    lib = torch.nn.LSTM(lstm.input_size, lstm.hidden_size,
                        num_layers=lstm.num_layers).cuda().bfloat16()
    with torch.no_grad():
        for name, p in lstm.named_parameters():
            getattr(lib, name).copy_(p)
    lib.flatten_parameters()
    return lib


def rms_diff(pairs):
    """The root mean square of a - b over all elements of the pairs."""
    pairs = list(pairs)
    sq = sum(float(((a.float() - b.float()) ** 2).sum()) for a, b in pairs)
    return (sq / sum(a.numel() for a, _ in pairs)) ** 0.5


def bf16_control(what, label, gots, bf16_plain, f32_plain):
    """Fails unless a bf16 kernel's results lie 4 times nearer (in root mean
    square) its plain bf16 version than that version lies to the plain f32
    one: a kernel that ignored the bf16 flag would sit at the gap, inside
    the bf16 tolerances. Sums in another order move a value across a bf16
    rounding boundary now and then, and a crossing spreads along the scan,
    so the callers pass the first two steps of a walk, where every path of
    the kernel has run and no crossing has spread yet. -> (rms to the bf16
    plain version, rms gap of bf16 to f32)."""
    err, gap = rms_diff(zip(gots, bf16_plain)), rms_diff(zip(bf16_plain, f32_plain))
    print(f"control {what} {label}: rms to the bf16 plain version {err:.3g}, bf16 plain to f32 "
          f"plain {gap:.3g} (must exceed 4x the first)")
    if not err * 4 < gap:
        fail(f"{what} at {label} is not nearer its bf16 plain version than the f32 one: "
             f"rms {err:.3g} against a bf16-f32 gap of {gap:.3g}")
    return err, gap


def phase_kernels(torch):
    """-> {(entry, shape name, B): row} for the kernels line and PERF.md."""
    rows = {}
    print(f"tolerances: outputs and residuals atol = rtol = {TOL} (f32 sums in another "
          f"order); gradients {GRAD_TOL} (weight gradients sum over T*B rows in another order); "
          f"bf16 outputs and residuals {BF16_TOL}, gradients {BF16_GRAD_TOL}; bf16-residual "
          f"gradients {RES_GRAD_TOL}")
    for name, s, train, diagonals, policy in lstm_kernel_shapes():
        lstm_check(torch, rows, name, s, train, diagonals, policy)
    return rows


def print_scan_chunks(torch, label, b, h, r, bf16):
    """Print the chunks of rows `scan_chunks` cuts a batch into (one for a
    batch that one launch's plan takes) and each chunk's layout -> the
    chunks."""
    from vmlmf_tpu_torch.ops import cuda_scan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunks = cuda_scan._chunks_for(b, h, r, torch.device("cuda", 0), bf16)
    for b0, n, plan in chunks:
        streamed = ""
        if plan.streamed:
            streamed = "; " + ", ".join(
                f"{kernel} resident depths {plan.resident(kernel)} of "
                f"{tuple(d for d, _ in plan.slices(kernel))}, streamed "
                f"{plan.n_ctas * plan.streamed_elems(kernel) * plan.elsize / 1e6:.3f} MB a step, "
                f"a ring of {cuda_scan.RING_STAGES} stages of {4 * plan.piece(kernel)} B"
                for kernel in ("fwd", "bwd"))
        print(f"plan {label}{f' rows {b0}-{b0 + n - 1}' if len(chunks) > 1 else ''}: "
              f"{plan.groups} batch groups x {plan.ctas} CTAs = {plan.n_ctas} CTAs of {sms} SMs, "
              f"{plan.rpad} padded rows a group, shared memory {plan.smem_fwd} B forward, "
              f"{plan.smem_bwd} B BPTT ({plan.elsize}-byte weights){streamed}")
    return chunks


def same_bits(torch, what, label, first, second):
    """Fails unless two calls' outputs are bit-equal (None where None)."""
    if len(first) != len(second) or any(
            (a is None) != (b is None) or (a is not None and not torch.equal(a, b))
            for a, b in zip(first, second)):
        fail(f"{what} gives other bits in a second call at {label}")


def lstm_check(torch, rows, name, s, train, diagonals, policy, own_residuals=False):
    """One LSTM kernel check: each entry that runs at this shape against its
    plain version, then its ms, the plain version's, its bound and cuDNN's,
    into ``rows`` by (entry, name, B). The BPTT's plain version runs on the
    plain forward's residuals, or with ``own_residuals`` on the kernel's
    (the same inputs as the kernel; the residuals are held to the plain
    forward's before), and then the other comparison is printed too."""
    from vmlmf_tpu_torch.ops import cuda_scan

    plain = cuda_scan.lstm_scan_fused_xin_plain
    res_plain, bwd_plain = cuda_scan.lstm_scan_xin_fwd_res_plain, cuda_scan.lstm_scan_xin_bwd_plain
    precision, residuals, save = policy
    bf16 = precision == "bf16"
    variant = cuda_scan.variant(*policy)
    size = (s["t"], s["b"], s["f"], s["rx"], s["h"], s["r"])
    label = (f"{name} T={s['t']} B={s['b']} F={s['f']} h={s['h']} rx={s['rx'] or 'dense'} "
             f"r={s['r'] or 'dense'}{'' if diagonals else ', no diagonals'}"
             f"{'' if variant == 'f32' else f', variant {variant}'}")
    print_scan_chunks(torch, label, s["b"], s["h"], s["r"], bf16)
    args = scan_inputs(torch, **s, diagonals=diagonals)
    lstm, lib_err = cudnn_lstm(torch, args)
    print(f"library: cuDNN LSTM on the dense weights, {label}: max abs err {lib_err:.3g} "
          f"against the plain scan")
    lib, lib_name = ((cudnn_lstm_bf16(torch, lstm), "cuDNN, bf16, other rounding") if bf16
                     else (lstm, "cuDNN"))
    xs, h0, c0 = (a.to(torch.bfloat16 if bf16 else torch.float32)
                  for a in (args[0], args[8], args[9]))
    mm = cuda_scan.scan_mm_ops(*size) if bf16 else 0

    def tf32(entry):  # the f32 variants' GEMM phase runs as 3xTF32
        return 0 if bf16 else cuda_scan.scan_gemm_ops(*size, entry, save_gates=save)
    fwd_tol = BF16_TOL if bf16 else TOL
    res_tol = BF16_TOL if bf16 or residuals == "bf16" else TOL
    grad_tol = BF16_GRAD_TOL if bf16 else RES_GRAD_TOL if residuals == "bf16" else GRAD_TOL

    # -- the no-grad forward, whose variants are its precisions
    if residuals == "f32" and save:
        ys, c_last = cuda_scan.lstm_scan_fused_xin(*args, precision)
        torch.cuda.synchronize()
        want = plain(*args, precision)
        ok, err = all_close(torch, (ys, c_last), want, fwd_tol)
        if not ok:
            fail(f"lstm_scan_xin_fwd disagrees with its plain version at {label}: {err}")
        if bf16:
            bf16_control("lstm_scan_xin_fwd ys[:2]", label, [ys[:2]], [want[0][:2]],
                         [plain(*args, "f32")[0][:2]])
            same_bits(torch, "lstm_scan_xin_fwd", label, (ys, c_last),
                      cuda_scan.lstm_scan_fused_xin(*args, precision))
        elif not diagonals and not s["rx"] and not s["r"]:
            # dense on both sides with no diagonal: exactly cuDNN's LSTM
            with torch.no_grad():
                out, (_, c_n) = lstm(xs, (h0[None], c0[None]))
            ok_l, err_l = all_close(torch, (out, c_n[0]), (ys, c_last), GRAD_TOL)
            print(f"library: cuDNN LSTM against the kernel, {label}: max abs err {err_l:.3g}")
            if not ok_l:
                fail(f"cuDNN's LSTM disagrees with the dense kernel at {label}: {err_l}")

        def lib_fwd():
            with torch.no_grad():
                lib(xs, (h0[None], c0[None]))

        rows[("lstm_scan_xin_fwd", name, s["b"])] = kernel_row(
            "lstm_scan_xin_fwd", label, err, fwd_tol,
            cuda_ms(torch, lambda: cuda_scan.lstm_scan_fused_xin(*args, precision), 10),
            cuda_ms(torch, lambda: plain(*args, precision), 5),
            (*cuda_scan.scan_cost(*size), mm, tf32("fwd")), cuda_ms(torch, lib_fwd, 10),
            lib_name)
    if not train:
        return

    # -- the residual forward and the BPTT, with dys given and dc_last
    # absent, as on the LM's training path
    res = cuda_scan.lstm_scan_fused_xin_res(*args, *policy)
    torch.cuda.synchronize()
    res_p = res_plain(*args, *policy)
    if any((a is None) != (p is None) or (a is not None and a.dtype != p.dtype)
           for a, p in zip(res, res_p)):
        fail(f"lstm_scan_xin_fwd_res stores other residuals than its plain version at {label}")
    ok, err = all_close(torch, [a.float() for a in res if a is not None],
                        [a.float() for a in res_p if a is not None], res_tol)
    if not ok:
        fail(f"lstm_scan_xin_fwd_res disagrees with its plain version at {label}: {err}")
    dys = 0.1 * torch.randn(res[0].shape, generator=torch.Generator().manual_seed(5)).cuda()
    bias = None if save else args[4]
    saved, saved_p = (*args[:4], *args[5:], *res), (*args[:4], *args[5:], *res_p)
    grads = cuda_scan.lstm_scan_xin_bwd(*saved, dys, None, bias=bias, precision=precision)
    torch.cuda.synchronize()
    refs = [bwd_plain(*own, dys, None, bias=bias, precision=precision)
            for own in ((saved, saved_p) if own_residuals else (saved_p,))]
    ok_g, err_g = all_close(torch, [a for a in grads if a is not None],
                            [a for a in refs[0] if a is not None], grad_tol)
    if not ok_g:
        fail(f"lstm_scan_xin_bwd disagrees with its plain version at {label}: {err_g}")
    if own_residuals:
        other = all_close(torch, [a for a in grads if a is not None],
                          [a for a in refs[1] if a is not None], grad_tol)[1]
        spread = all_close(torch, [a for a in refs[0] if a is not None],
                           [a for a in refs[1] if a is not None], grad_tol)[1]
        print(f"lstm_scan_xin_bwd {label}: max abs err {err_g:.3g} against the plain BPTT on "
              f"the kernel's residuals, {other:.3g} on the plain forward's, which move the "
              f"plain BPTT itself by {spread:.3g}")
    if bf16:
        same_bits(torch, "lstm_scan_xin_fwd_res", label, res,
                  cuda_scan.lstm_scan_fused_xin_res(*args, *policy))
        same_bits(torch, "lstm_scan_xin_bwd", label, grads,
                  cuda_scan.lstm_scan_xin_bwd(*saved, dys, None, bias=bias, precision=precision))
        res_f = res_plain(*args, "f32", residuals, save)
        bf16_control("lstm_scan_xin_fwd_res ys, cs [:2]", label, [a[:2] for a in res[:2]],
                     [a[:2] for a in res_p[:2]], [a[:2] for a in res_f[:2]])
        # both plain BPTTs from the kernel's residuals: the backward's rounding alone
        dxs = [bwd_plain(*saved, dys, None, bias=bias, precision=p)[0][-2:]
               for p in ("bf16", "f32")]
        bf16_control("lstm_scan_xin_bwd dxs[-2:]", label, [grads[0][-2:]], [dxs[0]], [dxs[1]])

    x, hh, cc = (a.detach().requires_grad_() for a in (xs, h0, c0))
    lib_fwd_ms, lib_bwd_ms = library_train_ms(
        torch, lambda: lib(x, (hh[None], cc[None])), dys.to(xs.dtype), 10)
    rows[("lstm_scan_xin_fwd_res", name, s["b"])] = kernel_row(
        "lstm_scan_xin_fwd_res", label, err, res_tol,
        cuda_ms(torch, lambda: cuda_scan.lstm_scan_fused_xin_res(*args, *policy), 10),
        cuda_ms(torch, lambda: res_plain(*args, *policy), 5),
        (*cuda_scan.scan_res_cost(*size, residuals=residuals, save_gates=save), mm,
         tf32("fwd")),
        lib_fwd_ms, lib_name)
    rows[("lstm_scan_xin_bwd", name, s["b"])] = kernel_row(
        "lstm_scan_xin_bwd", label, err_g, grad_tol,
        cuda_ms(torch, lambda: cuda_scan.lstm_scan_xin_bwd(*saved, dys, None, bias=bias,
                                                           precision=precision), 10),
        cuda_ms(torch, lambda: bwd_plain(*saved_p, dys, None, bias=bias,
                                         precision=precision), 3),
        (*cuda_scan.scan_bwd_cost(*size, residuals=residuals, save_gates=save),
         (2 if save else 3) * mm, tf32("bwd")), lib_bwd_ms, lib_name)


def gru_scan_inputs(torch, t, b, f, h, rx, r, lowrank, seed=0):
    """Seeded GRU scan inputs on the card (xs, ux, vx, bias, uf, prz, pn, h0),
    scaled so that the gates are O(1); uf is None when the recurrent side is
    dense, and vx when rx = 0 (a dense x side, ux [F, 3h])."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, scale):
        return (scale * torch.randn(shape, generator=g)).cuda()

    k = r if lowrank else h
    return (n(t, b, f, scale=1.0), n(f, rx or 3 * h, scale=f ** -0.5),
            n(rx, 3 * h, scale=rx ** -0.5) if rx else None,
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
    shared memory; then the same HAR layers with a dense x side (rx = 0, the
    two dense-x HAR GRUs) at both batches, and a dense "pre" layer; last the
    first layer of `har_main --model mygru` at its default width (dense
    "pre", dense x side, h=180) and its "post" form, at both batches, whose
    kernels take the grid layout."""
    t, f, h, rx, r = GRU["t"], GRU["f"], GRU["h"], GRU["rx"], GRU["r"]
    layers = [("main_l1", f, h, r, "pre", True, False), ("main_l2", h, h, r, "pre", True, True),
              ("group_l1", f, h, 0, "post", False, False),
              ("group_l2", h, h, 0, "post", False, True)]
    shapes = [(prefix + name, (t, b, fi, hi, x_rank, ri), mode, lowrank, dx, b == GRU["b"])
              for prefix, x_rank in (("", rx), ("dx_", 0))
              for b in (GRU["b"], EVAL_BATCH)
              for name, fi, hi, ri, mode, lowrank, dx in layers]
    har180 = [(name, (t, b, f, GRU_DEFAULT_H, 0, 0), mode, False, False, b == GRU["b"])
              for b in (GRU["b"], EVAL_BATCH)
              for name, mode in (("har180_pre", "pre"), ("har180_post", "post"))]
    return shapes + [("dense_pre", (t, GRU["b"], f, h, rx, 0), "pre", False, True, True),
                     ("wide_post_l2", (t, GRU["b"], f, 256, rx, 0), "post", False, True, True),
                     ("wide_pre_l2", (t, GRU["b"], f, 256, rx, 64), "pre", True, True, True),
                     ("dx_dense_pre", (t, GRU["b"], f, h, 0, 0), "pre", False, True, True),
                     *har180]


def phase_gru_kernels(torch):
    """-> {(entry, shape name, B): row} for the kernels line and PERF.md."""
    rows = {}
    for name, shape, mode, lowrank, dx, train in gru_kernel_shapes():
        gru_check(torch, rows, name, shape, mode, lowrank, dx, train)
    # the "post" no-grad body and its residual body at one batch
    for layer in ("group_l1", "dx_group_l1"):
        nograd, res = (rows[(e, layer, GRU["b"])]["ms"]
                       for e in ("gru_scan_xin_fwd", "gru_scan_xin_fwd_res"))
        print(f"gru post bodies {layer} B={GRU['b']}: no-grad {nograd:.4f} ms, residual "
              f"{res:.4f} ms")
    return rows


def gru_check(torch, rows, name, shape, mode, lowrank, dx, train, iters=20):
    """One GRU kernel check at ``shape`` (T, B, F, h, rx, r): each entry that
    runs there against its plain version, then its ms (a mean over
    ``iters`` calls), the plain version's, its bound and cuDNN's (mode
    "post"), into ``rows`` by (entry, name, B)."""
    from vmlmf_tpu_torch.ops import cuda_gru

    t, b, f, h, rx, r = shape
    args = gru_scan_inputs(torch, t, b, f, h, rx, r, lowrank)
    size = (t, b, f, rx, h, r, cuda_gru.form_of(args[4], mode))
    label = (f"{name} T={t} B={b} F={f} h={h} rx={rx or 'dense'} r={r} mode={mode} "
             f"{'low-rank' if lowrank else 'dense'}{', no dx' if train and not dx else ''}")
    print_gru_plan(torch, cuda_gru, name, size)
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
               cuda_ms(torch, lambda: cuda_gru.gru_scan_fused_xin(*args, mode=mode), iters),
               cuda_ms(torch, lambda: cuda_gru.gru_scan_fused_xin_plain(*args, mode=mode), 5),
               cuda_gru.gru_scan_cost(*size), cuda_ms(torch, lib_fwd, iters) if gru else None)]
    if train:
        checks += gru_train_checks(torch, cuda_gru, args, ys, size, label, mode, dx, gru, iters)
    for entry, e_err, tol, ms, plain_ms, cost, lib_ms in checks:
        rows[(entry, name, b)] = kernel_row(entry, label, e_err, tol, ms, plain_ms, cost,
                                            lib_ms)
        print(f"kernel {entry} {name} B={b}: {1e3 * ms / t:.3f} us per step (whole call / T)")


def print_gru_plan(torch, cuda_gru, name, size, gi=False):
    """Print the layout the GRU wrappers take at one shape (`gru_layout`),
    the forward's and, where it differs, the walk's: `gru_plan`'s rows a
    CTA, or the grid's chunks of rows, each with its groups x CTAs, rows a
    group, the rows R of a product item, resident depths, MB streamed a
    step and its TMA ring's stages."""
    t, b = size[:2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    layouts = {k: cuda_gru.gru_layout(*size, kernel=k, gi=gi, sms=sms) for k in ("fwd", "bwd")}
    same = layouts["fwd"] == layouts["bwd"]
    for kernel, layout in layouts.items():
        if kernel == "bwd" and same:
            break
        which = "" if same else (" forward" if kernel == "fwd" else " walk")
        if isinstance(layout, cuda_gru.GRUPlan):
            x_side = "-" if gi else "shared" if layout.x_resident else "L2"
            print(f"gru_plan {name}{which} B={b}{' gi' if gi else ''}: {layout.ctas} CTAs x "
                  f"{layout.threads} threads, {layout.rows} rows a CTA, time block "
                  f"{layout.tblock} of {t}, recurrent weights {layout.rec_weights} (walk "
                  f"{layout.bwd_rec_weights}), x side {x_side}, {layout.smem_fwd} / "
                  f"{layout.smem_bwd} bytes a CTA (forward / walk)")
            continue
        for b0, n, plan in layout:
            held = ", ".join(
                f"{k} resident {plan.resident(k)} of {tuple(d for d, _ in plan.slices(k))} "
                f"rows, {4e-6 * plan.n_ctas * plan.streamed_elems(k):.1f} MB streamed a step, "
                + (f"ring of 2 x {plan.piece(k)} floats" if plan.piece(k) else "no ring")
                for k in ("fwd", "bwd"))
            print(f"gru_grid_plan {name}{which} B={b}{' gi' if gi else ''} rows {b0}..{b0 + n}: "
                  f"{plan.groups} groups x {plan.ctas} CTAs, {plan.rpad} rows a group (padded), "
                  f"items of 4 columns x R={plan.tile_fwd} / {plan.tile_bwd} rows (forward / "
                  f"walk), {held}, {plan.smem_fwd} / "
                  f"{plan.smem_bwd} bytes a CTA (forward / walk)")


def gru_bwd_split(torch, label, bwd, t, calls=5, hopper=False):
    """Device time of `calls` BPTT calls by kernel (torch.profiler): the walk
    (`walk_kernel`) against the GEMMs (the grouped split-k's two kernels,
    the x side's and the recompute pre-pass's; of them, the Hopper tile's
    `wg_gemm_kernel` and its staging passes, which must run where
    ``hopper``: a product that gemm_tc.cuh's rule routes there) -> (walk us
    per step, GEMM share of the device time, device ms a call)."""
    def run():
        for _ in range(calls):
            bwd()

    walk = other = tile = 0.0
    for name, ms in device_events(torch, run, f"GRU BPTT at {label}", cpu=False)[0]:
        if "walk_kernel" in name:
            walk += ms
        else:
            other += ms
            if "wg_gemm_kernel" in name or "split_tf32_kernel" in name:
                tile += ms
    if walk == 0.0:
        fail(f"the profiler saw no walk_kernel in the GRU BPTT at {label}")
    if hopper != (tile > 0.0):
        fail(f"the GRU BPTT at {label}: the Hopper tile's kernels ran {tile:.4f} ms; gemm_tc.cuh's "
             f"rule routes {'some' if hopper else 'no'} product there")
    print(f"gru bwd split {label}: walk {1e3 * walk / calls / t:.3f} us per step, GEMMs "
          f"{other / calls:.4f} ms a call (Hopper tile and its staging {tile / calls:.4f}), GEMM "
          f"share {other / (walk + other):.3f}, device {(walk + other) / calls:.4f} ms a call")
    return 1e3 * walk / calls / t, other / (walk + other), (walk + other) / calls


def gru_routes(cuda_gru, size, dx, gi=False, recompute=False):
    """The BPTT's products at ``size`` (T, B, F, rx, h, r, form), each with
    the tile it runs on (gemm_tc.cuh's rule, `cuda_scan.tc_route`) ->
    (printable list, whether any takes the Hopper tile)."""
    from vmlmf_tpu_torch.ops.cuda_scan import tc_route

    t, b, f, rx, h, r, form = size
    lowrank = form == cuda_gru.LOWRANK_PRE
    names = ["dPrz", "dPn"] + (["dUf"] if lowrank else [])
    products = cuda_gru.gru_bwd_products(t, b, f, rx, h, r, form, gi=gi, dx=dx)
    names += ([] if gi else ["dUx"] + (["dVx"] if rx else []) + ["dbias"] + (["dx"] if dx else []))
    out = list(zip(names, cuda_gru._routed(products, 2 + lowrank)))
    if recompute:  # the pre-pass's recurrent products, in launch order
        rebuild = cuda_gru.gru_tc_products(t, b, f, rx, h, r, form, recompute=True)
        pre = (["HU", "RZ", "RHU", "N"] if lowrank else
               ["R", "Z"] * (len(rebuild) == 5) + ["RZ"] * (len(rebuild) == 4)
               + ["RECN" if form == cuda_gru.DENSE_POST else "N"])
        out = [(f"recompute {name}", tc_route(m, n, k)) for name, (m, n, k, *_) in zip(
            pre, rebuild)] + out
    return [f"{name} {'hopper' if go else 'gemm_tile'}" for name, go in out], any(
        go for _, go in out)


def gru_train_checks(torch, cuda_gru, args, ys, size, label, mode, dx, gru, iters=20):
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
    again = cuda_gru.gru_scan_xin_bwd(*saved, mode=mode, dx=dx)
    torch.cuda.synchronize()
    grads_p = cuda_gru.gru_scan_xin_bwd_plain(*saved, mode=mode, dx=dx)
    ok_g, err_g = all_close(torch, [a for a in grads if a is not None],
                            [a for a in grads_p if a is not None], GRAD_TOL)
    if not ok_g:
        fail(f"gru_scan_xin_bwd disagrees with its plain version at {label}: {err_g}")
    if not all(torch.equal(a, b) for a, b in zip(grads, again) if a is not None):
        fail(f"two calls of gru_scan_xin_bwd gave different bits at {label}")
    routes, hopper = gru_routes(cuda_gru, size, dx)
    print(f"gru bwd routes {label}: {', '.join(routes)}")
    gru_bwd_split(torch, label, lambda: cuda_gru.gru_scan_xin_bwd(*saved, mode=mode, dx=dx),
                  xs.shape[0], hopper=hopper)

    lib_fwd_ms = lib_bwd_ms = None
    if gru is not None:
        x_leaf, h_leaf = xs.detach().requires_grad_(dx), h0.detach().requires_grad_()
        lib_fwd_ms, lib_bwd_ms = library_train_ms(torch, lambda: gru(x_leaf, h_leaf[None]), dys,
                                                  iters)
    return [("gru_scan_xin_fwd_res", err_r, TOL,
             cuda_ms(torch, lambda: cuda_gru.gru_scan_fused_xin_res(*args, mode=mode), iters),
             cuda_ms(torch, lambda: cuda_gru.gru_scan_xin_fwd_res_plain(*args, mode=mode), 5),
             cuda_gru.gru_scan_res_cost(*size), lib_fwd_ms),
            ("gru_scan_xin_bwd", err_g, GRAD_TOL,
             cuda_ms(torch, lambda: cuda_gru.gru_scan_xin_bwd(*saved, mode=mode, dx=dx), iters),
             cuda_ms(torch, lambda: cuda_gru.gru_scan_xin_bwd_plain(*saved, mode=mode, dx=dx), 5),
             (*cuda_gru.gru_scan_bwd_cost(*size, dx=dx), 0, cuda_gru.gru_gemm_ops(*size)),
             lib_bwd_ms)]


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
        prefill_ms = replay_ms(torch, lambda: dec.prefill(params, ids, s0), 5)
        loop_prefill_ms = replay_ms(torch, lambda d=Decoder(loop): d.prefill(params, ids, s0), 5)
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
    return [("lstm:lowrank", launches)]


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


def lm_grads_fused_vs_loop(torch, label, make_model, chunk):
    """One step's gradients of every parameter at dropout 0, fused against
    loop backend, on one chunk; fails unless each tensor agrees."""
    from vmlmf_tpu_torch.train.lm import lm_loss
    from vmlmf_tpu_torch.utils.tree import tree_leaves

    grads = []
    x, y = (torch.as_tensor(a, device="cuda").long() for a in chunk)
    for backend in ("fused", "loop"):
        model = make_model(backend)
        p = model.init(torch.Generator().manual_seed(0), device="cuda")
        leaves = [q.requires_grad_() for q in tree_leaves(p)]
        logits, _ = model.apply(p, x, model.state0(x.shape[1]), train=True)
        grads.append(torch.autograd.grad(lm_loss(logits, y), leaves))
    # each tensor against its own scale: at winit 0.05 the gradients are far
    # below 1e-3, where an absolute tolerance would pass even all-zero ones
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(*grads)]
    dead = [i for i, a in enumerate(grads[0]) if not float(a.abs().max()) > 0]
    print(f"{label}: fused vs loop gradients of one step at dropout 0, largest max|diff| / "
          f"max|loop grad| over {len(rel)} tensors {max(rel):.3g} (tol {GRAD_TOL})")
    if dead or not max(rel) <= GRAD_TOL:
        fail(f"{label}: the fused backend's gradients disagree with the loop backend's: "
             f"relative errors {rel}, all-zero tensors {dead}")


def phase_train(torch):
    """-> the launch counts of the training path."""
    from vmlmf_tpu_torch.train.lm import LMTrainer

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

    lm_grads_fused_vs_loop(torch, "train", lm_model, trn[0])

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
    return [("lstm:lowrank", launches)]


def har_config(name, backend="fused"):
    """The `HARConfig` of a HAR path or a reduced run, by name."""
    from vmlmf_tpu_torch.config import HARConfig

    fields = {**HAR_PATHS, **REDUCED}[name][0]
    return HARConfig(**fields, backend=backend)


def har_model(name, backend="fused"):
    """The model of a HAR path or a reduced run: its config's build, or, for
    the shuffled LSTMGroupCell, a HARNet of it (77 -> 180, u(2, 4))."""
    if name == "lstm_group_shuffle":
        from vmlmf_tpu_torch.cells import LSTMGroupCell
        from vmlmf_tpu_torch.nn.models import HARNet

        return HARNet(HAR["f"], (HAR["h"],), num_classes=18, backend=backend,
                      cell_factory=lambda n, h: LSTMGroupCell(n, h, u_ranks=(2, 4), shuffle=True))
    return har_config(name, backend).build_model()


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


def har_data():
    """Synthetic OPP windows: 30 train batches of 81 and 500 test windows."""
    from vmlmf_tpu_torch.data.har import synthetic_har

    return synthetic_har("opp", n_train=30 * HAR["b"], n_test=500, seed=0)


def har_path(torch, name, data, form=None, grad_tol=GRAD_TOL):
    """One HAR path at full width: `HARTrainer.fit` for two epochs, one more
    step and `evaluate`, each with its exact launch counts; a falling loss; the fused
    logits of an `evaluate` batch and one step's gradients of every
    parameter against the loop backend's (within ``grad_tol``); accuracy,
    macro-F1, step ms. ``form`` names the kernel form in the report (by
    default the path's). -> (the form, its launch counts, its results)."""
    from vmlmf_tpu_torch.train.har import HARTrainer, evaluate

    x_tr, y_tr, x_te, y_te = data
    form = form or HAR_PATHS[name][1]
    b = HAR["b"]
    model = har_model(name)
    layers = len(model.rnn.cells)
    trainer = HARTrainer(model, batch_size=b)
    params, opt = trainer.init()

    # -- the main path, with the launch counts read around it
    reset_launch_counts()
    params, opt, hist = trainer.fit(params, opt, x_tr, y_tr, epochs=2, log_fn=None)
    torch.cuda.synchronize()
    fit_counts = launch_counts()
    metrics = evaluate(model, params, x_te, y_te)
    eval_delta = count_delta(fit_counts)
    launches = launch_counts()

    steps = 2 * (len(x_tr) // b)
    batches = -(-len(x_te) // EVAL_BATCH)
    print(f"{name}: launches in fit {nonzero(fit_counts)}, in evaluate {nonzero(eval_delta)}")
    if fit_counts != train_counts(form, layers * steps):
        fail(f"each {name} train step must launch the residual forward and the BPTT once per "
             f"layer and nothing else: {fit_counts} over {steps} steps")
    if eval_delta != eval_counts(form, layers * batches):
        fail(f"{name}: evaluate must launch only the no-grad kernel, once per layer and batch: "
             f"{eval_delta} over {batches} batches")
    if not hist[1]["loss"] < hist[0]["loss"]:
        fail(f"the {name} HAR loss did not fall: {hist}")
    before = launch_counts()
    trainer.train_step(params, opt, x_tr[:b], y_tr[:b])
    step_delta = count_delta(before)
    if step_delta != train_counts(form, layers):
        fail(f"one {name} train step must launch the residual forward and the BPTT once per "
             f"layer: {step_delta}")

    # -- evaluate's batch through the fused no-grad path against the loop backend
    xe = torch.as_tensor(x_te[:EVAL_BATCH], device="cuda")
    with torch.no_grad():
        ok, err = close(torch, model.apply(params, xe), har_model(name, "loop").apply(params, xe))
    print(f"{name}: fused vs loop logits at B={EVAL_BATCH}, max abs err {err:.3g} (tol {TOL})")
    if not ok:
        fail(f"the {name} HARNet's fused logits disagree with the loop backend's at "
             f"B={EVAL_BATCH}: {err}")

    # -- one step's gradients, fused against loop (HARNet has no dropout)
    xb = torch.as_tensor(x_tr[:b], device="cuda")
    yb = torch.as_tensor(y_tr[:b], device="cuda")
    rel, dead = grads_fused_vs_loop(torch, lambda be: har_model(name, be), xb, yb)
    print(f"{name}: fused vs loop gradients of one step, largest max|diff| / max|loop grad| "
          f"{rel:.3g} (tol {grad_tol})")
    if dead or not rel <= grad_tol:
        fail(f"the {name} fused gradients disagree with the loop backend's: {rel}, all-zero or "
             f"missing tensors {dead}")

    ms = cuda_ms(torch, lambda: trainer.train_step(params, opt, x_tr[:b], y_tr[:b]), 20)
    print(f"{name}: losses {[round(h['loss'], 4) for h in hist]}, accuracy "
          f"{metrics['accuracy']:.4f}, macro-F1 {metrics['macro_f1']:.4f} on {len(y_te)} test "
          f"windows; train step {ms:.4f} ms at B={b}")
    return form, launches, dict(metrics, step_ms=ms, losses=[h["loss"] for h in hist])


def har_phase(torch, label, names):
    """har_path for each name -> [(form, launch counts)]; prints one JSON line."""
    data = har_data()
    runs, out = [], {}
    for name in names:
        form, launches, out[name] = har_path(torch, name, data)
        runs.append((form, launches))
    print(json.dumps({label: out}))
    return runs


def phase_har(torch):
    """The VMLMF HAR flagship (77 -> 180, w8/u6)."""
    return har_phase(torch, "har", ("vmlmf",))


def phase_har_gru(torch):
    """The two GRU HARNets (77 -> 64 -> 64): GRUCell w9/u9 and GRUGroupCell
    w9, u(12, 6), g=2."""
    return har_phase(torch, "har_gru", ("gru_main", "gru_group"))


def phase_har_dense(torch):
    """The HAR paths through the dense forms: group VMLMF, the dense LSTM
    (the CLI default), and the two GRUs with a dense x side."""
    return har_phase(torch, "har_dense",
                     ("group_vmlmf", "dense_lstm", "gru_dense_x", "gru_group_dense_x"))


def bdnet(backend, factory=None, sizes=(GRU["h"], GRU["h"])):
    """A bidirectional BDNet (77 -> 64 -> 64, concat), GRU w9/u9 by default."""
    from vmlmf_tpu_torch.nn.models import BDNet

    return BDNet(GRU["f"], sizes, num_classes=18, merge="concat", backend=backend,
                 cell_factory=factory or har_config("gru_main").cell_factory())


def bdnet_train(torch, form, label="bdnet"):
    """A short GRU BDNet training run whose steps must each launch the
    residual forward and BPTT of ``form`` ("family:form") four times (two
    layers, two towers) -> (its launch counts, the data)."""
    from vmlmf_tpu_torch.data.har import synthetic_har
    from vmlmf_tpu_torch.train.har import HARTrainer

    b, steps = GRU["b"], 5
    x_tr, y_tr, _, _ = synthetic_har("opp", n_train=steps * b, n_test=b, seed=1)
    trainer = HARTrainer(bdnet("fused"), batch_size=b)
    params, opt = trainer.init()
    reset_launch_counts()
    params, opt, hist = trainer.fit(params, opt, x_tr, y_tr, epochs=1, log_fn=None)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"{label}: {steps} steps, loss {hist[0]['loss']:.4f}, launches {nonzero(launches)}")
    if launches != train_counts(form, 4 * steps) or not hist[0]["loss"] == hist[0]["loss"]:
        fail(f"each {label} step must launch the GRU residual forward and BPTT four times "
             f"(two layers, two towers): {launches}, loss {hist}")
    return launches, (x_tr, y_tr)


def phase_bdnet(torch):
    """-> the launch counts of a short BDNet training run."""
    from vmlmf_tpu_torch.cells import VMLMFCell

    b = GRU["b"]
    launches, (x_tr, _) = bdnet_train(torch, "gru:lowrank_pre")

    # the reverse tower's fused scans against the loop backend, GRU and LSTM
    x = torch.as_tensor(x_tr[:b], device="cuda")
    lstm = (lambda n, h: VMLMFCell(n, h, w_rank=HAR["rx"], u_rank=HAR["r"]), (HAR["h"],))
    for name, (factory, sizes) in (("gru", (har_config("gru_main").cell_factory(),
                                             (GRU["h"], GRU["h"]))),
                                   ("lstm", lstm)):
        p = bdnet("fused", factory, sizes).init(torch.Generator().manual_seed(0), device="cuda")
        with torch.no_grad():
            got = bdnet("fused", factory, sizes).apply(p, x)
            want_l = bdnet("loop", factory, sizes).apply(p, x)
        ok, err = close(torch, got, want_l)
        print(f"bdnet {name}: fused vs loop logits, max abs err {err:.3g} (tol {TOL})")
        if not ok:
            fail(f"the {name} BDNet's fused logits disagree with the loop backend's: {err}")
    return [("gru:lowrank_pre", launches)]


def phase_lm_dense(torch):
    """The dense PTB LM (`LMConfig(lstm_type="custom")`): serving and training.
    -> [(its form, launch counts)]."""
    from vmlmf_tpu_torch.config import LMConfig
    from vmlmf_tpu_torch.serve import Decoder
    from vmlmf_tpu_torch.train.lm import LMTrainer

    def model(backend, dropout=0.5):
        return LMConfig(lstm_type="custom", hidden_size=LM["hidden"], layer_num=LM["layers"],
                        dropout=dropout, backend=backend).build_model(LM["vocab"])

    layers, b = LM["layers"], MAIN_BATCH
    fused = model("fused")
    params = fused.init(torch.Generator().manual_seed(0), device="cuda")
    dec = Decoder(fused)
    prompt = prompt_ids(torch, b)

    # -- serving, with the launch counts read around it
    reset_launch_counts()
    logits, states = dec.prefill(params, prompt, fused.state0(b))
    prefill_counts = launch_counts()
    greedy, _ = dec.decode(params, logits, states, steps=64)
    torch.cuda.synchronize()
    decode_delta = count_delta(prefill_counts)
    serve_launches = launch_counts()
    print(f"lm_dense: launches in prefill {nonzero(prefill_counts)}, in decode "
          f"{nonzero(decode_delta)}")
    if prefill_counts != eval_counts("lstm:dense", layers) or decode_delta != only():
        fail(f"a dense prefill must launch the no-grad kernel once per layer, decode nothing: "
             f"{prefill_counts}, {decode_delta}")
    lo, hi = int(greedy.min()), int(greedy.max())
    if tuple(greedy.shape) != (64, b) or not 0 <= lo <= hi < LM["vocab"]:
        fail(f"dense greedy tokens: shape {tuple(greedy.shape)}")
    lf, sf = dec.prefill(params, prompt, fused.state0(b))
    loop = model("loop")
    ll, sl = Decoder(loop).prefill(params, prompt, loop.state0(b))
    ok, err = all_close(torch, [lf] + [a for s in sf for a in s], [ll] + [a for s in sl for a in s],
                        TOL)
    print(f"lm_dense: fused vs loop prefill, max abs err {err:.3g} (tol {TOL})")
    if not ok:
        fail("the dense LM's fused prefill disagrees with the loop backend")
    prefill_ms = replay_ms(torch, lambda: dec.prefill(params, prompt, fused.state0(b)), 5)

    # -- training, with the launch counts read around each step
    trn, vld = lm_chunks(b)
    trainer = LMTrainer(fused, batch_size=b, seq_length=LM["prompt"], learning_rate=1.0,
                        max_grad_norm=5.0)
    params = trainer.init()
    generator = torch.Generator(device="cuda").manual_seed(1)
    states = trainer.state0()
    reset_launch_counts()
    losses, deltas = [], []
    for x, y in trn[:TRAIN_CHUNKS]:
        before = launch_counts()
        params, states, loss, _ = trainer.train_step(params, states, x, y, 1.0, generator)
        deltas.append(count_delta(before))
        losses.append(loss)
    before = launch_counts()
    ppl = trainer.perplexity(params, vld[:10])
    ppl_delta = count_delta(before)
    torch.cuda.synchronize()
    train_launches = launch_counts()
    losses = [float(v) / b for v in losses]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"lm_dense: {TRAIN_CHUNKS} chunks at B={b}, loss per word {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (mean of first 5 {first:.4f}, last 5 {last:.4f}), valid perplexity "
          f"on 10 chunks {ppl:.2f}; launches per step {nonzero(deltas[0])}, in perplexity "
          f"{nonzero(ppl_delta)}")
    if any(d != train_counts("lstm:dense", layers) for d in deltas):
        fail(f"each dense LM train step must launch the residual forward and the BPTT once per "
             f"layer: {deltas}")
    if ppl_delta != eval_counts("lstm:dense", 10 * layers):
        fail(f"perplexity must launch only the no-grad kernel, {layers} per chunk: {ppl_delta}")
    if not all(v == v and abs(v) != float("inf") for v in losses) or not last < first:
        fail(f"the dense LM's training loss did not fall: {losses}")

    lm_grads_fused_vs_loop(torch, "lm_dense", lambda be: model(be, dropout=0.0), trn[0])
    step = {be: train_step_ms(torch, LMTrainer(model(be), batch_size=b, seq_length=LM["prompt"]),
                              trainer.init(), trn, 5, generator) for be in ("fused", "loop")}
    print(f"lm_dense B={b}: prefill {prefill_ms:.3f} ms, train step fused {step['fused']:.3f} ms "
          f"({b * LM['prompt'] / step['fused'] * 1e3:.1f} words/s), loop {step['loop']:.3f} ms")
    print(json.dumps({"lm_dense": dict(prefill_ms=prefill_ms, step_ms=step, losses=losses[::5],
                                       perplexity=ppl)}))
    return [("lstm:dense", serve_launches), ("lstm:dense", train_launches)]


def phase_reduced(torch):
    """Short runs of the other cells -> [(form, launch counts)] of those with
    a fused form. Each: REDUCED_STEPS train steps at B=81 (exact launches,
    finite losses), then fused against loop logits and gradients."""
    from vmlmf_tpu_torch.data.har import synthetic_har

    x_tr, y_tr, _, _ = synthetic_har("opp", n_train=REDUCED_STEPS * HAR["b"], n_test=1, seed=3)
    runs = []
    for name, (_, form) in REDUCED.items():
        launches = reduced_run(torch, name, form, x_tr, y_tr)
        if form is not None:
            runs.append((form, launches))
    return runs


def reduced_run(torch, name, form, x_tr, y_tr):
    """One short run of phase_reduced -> its launch counts; ``form`` names
    the kernel form whose exact launches it must make (None: none)."""
    from vmlmf_tpu_torch.train.har import HARTrainer

    b = HAR["b"]
    x, y = torch.as_tensor(x_tr[:b], device="cuda"), torch.as_tensor(y_tr[:b], device="cuda")
    model = har_model(name)
    layers = len(model.rnn.cells)
    trainer = HARTrainer(model, batch_size=b)
    params, opt = trainer.init()
    reset_launch_counts()
    losses = [float(trainer.train_step(params, opt, x_tr[i * b:(i + 1) * b],
                                       y_tr[i * b:(i + 1) * b])[2])
              for i in range(REDUCED_STEPS)]
    with torch.no_grad():
        before = launch_counts()
        ok, err = close(torch, model.apply(params, x), har_model(name, "loop").apply(params, x))
        eval_delta = count_delta(before)
    torch.cuda.synchronize()
    launches = launch_counts()
    train_delta = {k: before[k] for k in launches}
    want_train = only() if form is None else train_counts(form, layers * REDUCED_STEPS)
    want_eval = only() if form is None else eval_counts(form, layers)
    print(f"reduced {name}: losses {[round(v, 4) for v in losses]}, launches in "
          f"{REDUCED_STEPS} steps {nonzero(train_delta)}, in one no-grad apply "
          f"{nonzero(eval_delta)}; fused vs loop logits max abs err {err:.3g}")
    if train_delta != want_train or eval_delta != want_eval:
        fail(f"reduced {name} must launch {want_train} in training and {want_eval} in one "
             f"no-grad apply: {train_delta}, {eval_delta}")
    if not all(v == v and abs(v) != float("inf") for v in losses) or not ok:
        fail(f"reduced {name}: losses {losses}, fused vs loop logits {err}")
    rel, dead = grads_fused_vs_loop(torch, lambda be, n=name: har_model(n, be), x, y)
    print(f"reduced {name}: fused vs loop gradients, largest relative error {rel:.3g}")
    if dead or not rel <= GRAD_TOL or (form is None and launch_counts() != launches):
        fail(f"reduced {name}: fused gradients {rel}, all-zero or missing tensors {dead}, "
             f"launches {launch_counts()} after {launches}")
    return launches


def stack_check_inputs(torch, b, masks, seed=0):
    """Seeded inputs of the LM stack at batch b: x [T, B, h], layer 0's x side
    (ux, vx, xdvec [4, h], bias), the stack's layer dicts, h0s, c0s and, for
    the training entries, L - 1 dropout masks at rate 0.5. Scaled so that the
    gates are O(1)."""
    t, h, r, n = LM["prompt"], LM["hidden"], LM["rank"], LM["layers"]
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale):
        return (scale * torch.randn(shape, generator=g)).cuda()

    x = rnd(t, b, h, scale=1.0)
    x_side = (rnd(h, r, scale=h ** -0.5), rnd(r, 4 * h, scale=r ** -0.5), rnd(4, h, scale=0.1),
              rnd(4 * h, scale=0.1))
    layers = []
    for l in range(n):
        d = {"u": rnd(h, r, scale=h ** -0.5), "v": rnd(r, 4 * h, scale=r ** -0.5),
             "dvec": rnd(4 * h, scale=0.1)}
        if l:
            d.update(ux=rnd(h, r, scale=h ** -0.5), vx=rnd(r, 4 * h, scale=r ** -0.5),
                     dxvec=rnd(4 * h, scale=0.1), bias=rnd(4 * h, scale=0.1))
        layers.append(d)
    mk = None
    if masks:
        mk = [(torch.rand((t, b, h), generator=g) < 0.5).float().cuda() / 0.5 for _ in range(n - 1)]
    return x, x_side, layers, [rnd(b, h, scale=0.5) for _ in range(n)], \
        [rnd(b, h, scale=0.5) for _ in range(n)], mk


def layer0_inp(x, ux, vx, xdvec, bias):
    """Layer 0's input contribution gi0 from x, as the fused scan computes it."""
    return (x @ ux) @ vx + x.repeat(1, 1, 4) * xdvec.reshape(-1) + bias


def cudnn_stack(torch, x, x_side, layers, h0s, c0s):
    """A two-layer `nn.LSTM` (cuDNN) holding the stack's dense weights, layer 0
    with its x side, flattened once, outside any timed window. Fails unless
    it computes the same stack from x (no masks)."""
    from vmlmf_tpu_torch.ops import cuda_stack

    n, h = len(layers), x.shape[-1]
    lstm = torch.nn.LSTM(h, h, num_layers=n).cuda()
    with torch.no_grad():
        for l, lay in enumerate(layers):
            xs = x_side if l == 0 else (lay["ux"], lay["vx"], lay["dxvec"].reshape(4, h),
                                        lay["bias"])
            for name, w in zip(("weight_ih", "weight_hh", "bias_ih", "bias_hh"),
                               dense_lstm_weights(*xs, lay["u"], lay["v"], lay["dvec"])):
                getattr(lstm, f"{name}_l{l}").copy_(w)
        lstm.flatten_parameters()
        out, (h_n, c_n) = lstm(x, (torch.stack(h0s), torch.stack(c0s)))
        ys, hl, cl = cuda_stack.lstm_stack_scan_fused_plain(layer0_inp(x, *x_side),
                                                            layers, h0s, c0s)
    ok, err = all_close(torch, (out, h_n, c_n), (ys, torch.stack(hl), torch.stack(cl)), GRAD_TOL)
    if not ok:
        fail(f"cuDNN's {n}-layer LSTM on the dense weights is not the same stack: {err}")
    return lstm, err


def fused_pair(torch, x, x_side, layers, h0s, c0s, mk, dys, precision):
    """The "fused" backend's route through the same two layers: a per-layer
    scan from x each (x mode), the mask between them -> closures (no-grad
    forward, residual forward, BPTT from the residuals of one residual
    forward), to time beside the stack."""
    from vmlmf_tpu_torch.ops import cuda_scan

    h = x.shape[-1]
    l1 = layers[1]
    side1 = (l1["ux"], l1["vx"], l1["dxvec"].reshape(4, h), l1["bias"])
    rec = [(lay["u"], lay["v"], lay["dvec"]) for lay in layers]

    def fwd():
        y0, _ = cuda_scan.lstm_scan_fused_xin(x, *x_side, *rec[0], h0s[0], c0s[0], precision)
        return cuda_scan.lstm_scan_fused_xin(y0, *side1, *rec[1], h0s[1], c0s[1], precision)

    def res():
        r0 = cuda_scan.lstm_scan_fused_xin_res(x, *x_side, *rec[0], h0s[0], c0s[0], precision)
        x1 = r0[0] if mk is None else r0[0] * mk[0]
        return r0, x1, cuda_scan.lstm_scan_fused_xin_res(x1, *side1, *rec[1], h0s[1], c0s[1],
                                                         precision)

    r0, x1, r1 = res()

    def bwd():
        g1 = cuda_scan.lstm_scan_xin_bwd(x1, *side1[:3], *rec[1], h0s[1], c0s[1], *r1, dys, None,
                                         precision=precision)
        dx1 = g1[0] if mk is None else g1[0] * mk[0]
        return cuda_scan.lstm_scan_xin_bwd(x, *x_side[:3], *rec[0], h0s[0], c0s[0], *r0, dx1,
                                           None, precision=precision)

    return fwd, res, bwd


def stack_step_us(torch, gi0, layers, h0s, c0s, mk, dys, precision):
    """µs a step of the no-grad stack and of the BPTT (its weight GEMMs
    included): the time at 2T less the time at T, over T. The walk's own
    device time is in the trace phase's wavefront train step
    (stack_bwd_kernel)."""
    from vmlmf_tpu_torch.ops import cuda_stack

    t = gi0.shape[0]
    long = [torch.cat([a, a]) for a in (gi0, dys)]
    mk2 = None if mk is None else [torch.cat([m, m]) for m in mk]
    out = {}
    ms = [cuda_ms(torch, lambda g=g: cuda_stack.lstm_stack_scan_fused(g, layers, h0s, c0s, None,
                                                                      precision), 10)
          for g in (gi0, long[0])]
    out["fwd_us_per_step"] = 1e3 * (ms[1] - ms[0]) / t
    none = [None] * len(layers)
    ms = []
    for g, d, m in ((gi0, dys, mk), (long[0], long[1], mk2)):
        res = cuda_stack.lstm_stack_scan_fused_res(g, layers, h0s, c0s, m, precision)
        args = (layers, h0s, c0s, m, *res, d, none, none, precision)
        ms.append(cuda_ms(torch, lambda a=args: cuda_stack.lstm_stack_bwd(*a), 10))
    out["bwd_us_per_step"] = 1e3 * (ms[1] - ms[0]) / t
    return out


def stack_bwd_routes(b, bf16):
    """Each weight-gradient product of the LM stack's BPTT at batch b with
    the tile and the k slices that gemm_tc.cuh's rule gives it
    (`cuda_scan.tc_plan`, with the split-k room the wrapper gives the call)
    -> (printable list, whether any takes the Hopper tile)."""
    from vmlmf_tpu_torch.ops import cuda_scan, cuda_stack

    t, h, r, n = LM["prompt"], LM["hidden"], LM["rank"], LM["layers"]
    ranks, xranks = (r,) * n, (r,) * (n - 1)
    floats = cuda_stack.stack_partial_floats(t, b, h, ranks, xranks, bf16)
    out, hopper = [], False
    for l, layer in enumerate(cuda_stack.stack_tc_products(t, b, h, ranks, xranks)):
        for name, (m, nn, k, *_) in layer:
            wg, big, splits, _ = cuda_scan.tc_plan(m, nn, k, floats // (m * nn), bf16)
            hopper |= wg
            tile = "hopper" if wg else f"mma.sync {'128x128' if big else '64x64'}"
            out.append(f"layer {l} {name} [{m}, {nn}] over k={k}: {tile}, {splits} slice(s)")
    return out, hopper


def stack_bwd_split(torch, label, bwd, t, hopper, calls=5):
    """Device time of `calls` BPTT calls by kernel (torch.profiler): the walk
    (`stack_bwd_kernel`) against the weight gradients (gemm_tc.cuh's tiles,
    their staging passes and split-k sums, the masked input's pass, the
    column sums). The Hopper tile's `wg_gemm_kernel` must run where
    ``hopper`` (a product that the rule routes there), and no kernel of
    gemm_tile.cuh at all -> (walk ms, weight-gradient ms) a call."""
    def run():
        for _ in range(calls):
            bwd()

    walk = grads = tile = 0.0
    for name, ms in device_events(torch, run, f"stack BPTT at {label}", cpu=False)[0]:
        if "stack_bwd_kernel" in name:
            walk += ms
            continue
        grads += ms
        if "wg_gemm_kernel" in name:
            tile += ms
        if "vmlmf::gemm_kernel" in name or "group_partial_kernel" in name:
            fail(f"the stack BPTT at {label} ran gemm_tile.cuh's {name}")
    if walk == 0.0:
        fail(f"the profiler saw no stack_bwd_kernel in the stack BPTT at {label}")
    if hopper != (tile > 0.0):
        fail(f"the stack BPTT at {label}: the Hopper tile ran {tile:.4f} ms; gemm_tc.cuh's rule "
             f"routes {'some' if hopper else 'no'} product there")
    print(f"stack bwd split {label}: walk {walk / calls:.4f} ms a call "
          f"({1e3 * walk / calls / t:.3f} us a step), weight gradients {grads / calls:.4f} ms a "
          f"call (Hopper tile {tile / calls:.4f}), their share {grads / (walk + grads):.3f}")
    return walk / calls, grads / calls


def phase_stack_kernels(torch, precision="f32"):
    """Each stack entry against its plain version at the LM stack (L=2, T=35,
    h=650, r=rx=300), each at B in 1/20/128: the no-grad forward without
    masks, the residual forward and the BPTT with masks; each shape's
    `stack_plan` printed first. Library: cuDNN's two-layer LSTM on the dense
    weights, from x (in bf16 for the bf16 stack: other rounding points);
    beside it the port's path from x (layer 0's projection in torch ops,
    then the stack), the "fused" backend's two per-layer scans from x in
    the same phase, and µs a step of the stack (its time at 2T less its
    time at T). Under ``precision`` "bf16" the bf16 tolerances hold, and the
    first two steps of each walk must lie 4x nearer the plain bf16 version
    than the plain f32 one. The BPTT's weight gradients: each product's tile
    and k slices, the walk against them in a trace (the Hopper tile there
    wherever the rule routes a product), the peak MiB of a call; its bound
    prices them at the tensor cores' rate (3xTF32 in f32, bf16) and the
    walk at the f32 rate. -> {(entry, "stack" or "stack_bf16", B): row}."""
    from vmlmf_tpu_torch.ops import cuda_scan, cuda_stack

    rows, extra = {}, {}
    t, h, r, n = LM["prompt"], LM["hidden"], LM["rank"], LM["layers"]
    ranks, xranks = [r] * n, [r] * (n - 1)
    bf16 = precision == "bf16"
    shape = "stack_bf16" if bf16 else "stack"
    tol, grad_tol = (BF16_TOL, BF16_GRAD_TOL) if bf16 else (TOL, GRAD_TOL)
    fwd_plain, res_plain = cuda_stack.lstm_stack_scan_fused_plain, cuda_stack.lstm_stack_fwd_res_plain
    bwd_plain = cuda_stack.lstm_stack_bwd_plain
    for b in LM_BATCHES:
        x, x_side, layers, h0s, c0s, mk = stack_check_inputs(torch, b, masks=True)
        label = f"{shape} L={n} T={t} B={b} h={h} r=rx={r}"
        plan = cuda_stack.stack_plan(b, h, tuple(ranks), tuple(xranks),
                                     cuda_scan._sm_count(0), 2 if bf16 else 4)
        print(f"stack plan {label}: {plan.describe()}")
        gi0 = layer0_inp(x, *x_side)
        lstm, lib_err = cudnn_stack(torch, x, x_side, layers, h0s, c0s)
        print(f"library: cuDNN {n}-layer LSTM on the dense weights, {label}: max abs err "
              f"{lib_err:.3g} against the plain f32 stack")
        state0 = (torch.stack(h0s), torch.stack(c0s))
        lib, lib_name, lx = lstm, "cuDNN", x
        if bf16:
            lib, lib_name = cudnn_lstm_bf16(torch, lstm), "cuDNN, bf16, other rounding"
            lx, state0 = x.bfloat16(), tuple(a.bfloat16() for a in state0)
        mm = cuda_stack.stack_mm_ops(t, b, h, ranks, xranks) if bf16 else 0
        gemm = cuda_stack.stack_gemm_ops(t, b, h, ranks, xranks)  # the weight gradients'
        # the bound's (bf16 ops, 3xTF32 ops) of the BPTT: in bf16 the walk's
        # products and the weight gradients at the bf16 rate, in f32 the walk's
        # at the f32 rate and the weight gradients' at 3xTF32's
        bwd_ops = (mm + gemm, 0) if bf16 else (0, gemm)

        # -- the no-grad forward, without masks (serving)
        out = cuda_stack.lstm_stack_scan_fused(gi0, layers, h0s, c0s, None, precision)
        torch.cuda.synchronize()
        want = fwd_plain(gi0, layers, h0s, c0s, None, precision)
        ok, err = all_close(torch, [out[0], *out[1], *out[2]], [want[0], *want[1], *want[2]], tol)
        if not ok:
            fail(f"lstm_stack_fwd disagrees with its plain version at {label}: {err}")
        if bf16:
            bf16_control("lstm_stack_fwd ys[:2]", label, [out[0][:2]], [want[0][:2]],
                         [fwd_plain(gi0, layers, h0s, c0s)[0][:2]])

        def lib_fwd():
            with torch.no_grad():
                lib(lx, state0)

        def port_from_x():
            cuda_stack.lstm_stack_scan_fused(layer0_inp(x, *x_side), layers, h0s, c0s, None,
                                             precision)

        with torch.no_grad():
            rows[("lstm_stack_fwd", shape, b)] = kernel_row(
                "lstm_stack_fwd", label, err, tol,
                cuda_ms(torch, lambda: cuda_stack.lstm_stack_scan_fused(gi0, layers, h0s, c0s,
                                                                        None, precision), 10),
                cuda_ms(torch, lambda: fwd_plain(gi0, layers, h0s, c0s, None, precision), 3),
                (*cuda_stack.stack_cost(t, b, h, ranks, xranks), mm), cuda_ms(torch, lib_fwd, 10),
                lib_name)
            extra[f"fwd_b{b}"] = dict(port_from_x_ms=cuda_ms(torch, port_from_x, 10))
        # -- the residual forward and the BPTT, with masks, dys given and the
        # final states' cotangents absent, as on the LM's training path
        dys = 0.1 * torch.randn((t, b, h), generator=torch.Generator().manual_seed(5)).cuda()
        res = cuda_stack.lstm_stack_scan_fused_res(gi0, layers, h0s, c0s, mk, precision)
        torch.cuda.synchronize()
        res_p = res_plain(gi0, layers, h0s, c0s, mk, precision)
        ok, err = all_close(torch, [a for group in res for a in group],
                            [a for group in res_p for a in group], tol)
        if not ok:
            fail(f"lstm_stack_fwd_res disagrees with its plain version at {label}: {err}")
        none = [None] * n
        bwd_args = (layers, h0s, c0s, mk, *res, dys, none, none, precision)
        grads = cuda_stack.lstm_stack_bwd(*bwd_args)
        torch.cuda.synchronize()
        grads_p = bwd_plain(*bwd_args)

        def flat(g):
            return [g[0], *(a for d in g[1] for a in d.values()), *g[2], *g[3]]

        ok_g, err_g = all_close(torch, flat(grads), flat(grads_p), grad_tol)
        if not ok_g:
            fail(f"lstm_stack_bwd disagrees with its plain version at {label}: {err_g}")
        again = cuda_stack.lstm_stack_bwd(*bwd_args)
        torch.cuda.synchronize()
        if not all(torch.equal(u, w) for u, w in zip(flat(grads), flat(again))):
            fail(f"two calls of lstm_stack_bwd gave different bits at {label}")
        routes, hopper = stack_bwd_routes(b, bf16)
        print(f"stack bwd routes {label}: {'; '.join(routes)}")
        walk_ms, grads_ms = stack_bwd_split(torch, label, lambda: cuda_stack.lstm_stack_bwd(
            *bwd_args), t, hopper)
        peak = peak_step_mib(torch, lambda: cuda_stack.lstm_stack_bwd(*bwd_args))
        stage = 4 * cuda_stack.stack_tc_stage_floats(t, b, h, tuple(ranks), tuple(xranks), bf16,
                                                     True) / 2 ** 20
        print(f"stack bwd memory {label}: peak {peak:.1f} MiB a call beyond its inputs, of "
              f"which the weight gradients' staging scratch {stage:.1f} MiB")
        if bf16:
            res_f = res_plain(gi0, layers, h0s, c0s, mk)
            bf16_control("lstm_stack_fwd_res ys, cs [:2] of layer 0", label,
                         [res[0][0][:2], res[1][0][:2]], [res_p[0][0][:2], res_p[1][0][:2]],
                         [res_f[0][0][:2], res_f[1][0][:2]])
            # both plain BPTTs from the kernel's residuals: the backward's rounding alone
            dgi = [bwd_plain(*bwd_args[:-1], p)[0][-2:] for p in ("bf16", "f32")]
            bf16_control("lstm_stack_bwd dgi0[-2:]", label, [grads[0][-2:]], [dgi[0]], [dgi[1]])

        fused_fwd, fused_res, fused_bwd = fused_pair(torch, x, x_side, layers, h0s, c0s, mk, dys,
                                                     precision)
        with torch.no_grad():
            extra[f"fwd_b{b}"].update(fused_ms=cuda_ms(torch, fused_fwd, 10),
                                      fused_res_ms=cuda_ms(torch, fused_res, 10),
                                      fused_bwd_ms=cuda_ms(torch, fused_bwd, 10))
        extra[f"fwd_b{b}"].update(stack_step_us(torch, gi0, layers, h0s, c0s, mk, dys, precision))
        e = extra[f"fwd_b{b}"]
        e.update(bwd_walk_ms=walk_ms, bwd_weight_grads_ms=grads_ms, bwd_peak_mib=peak,
                 bwd_stage_mib=stage)
        print(f"kernel lstm_stack_fwd {label}: the port from x (projection + stack) "
              f"{e['port_from_x_ms']:.4f} ms against {lib_name}'s from x "
              f"{rows[('lstm_stack_fwd', shape, b)]['library_ms']:.4f} ms and \"fused\"'s two "
              f"per-layer scans from x {e['fused_ms']:.4f} ms; stack {e['fwd_us_per_step']:.2f} "
              f"us a step no-grad, {e['bwd_us_per_step']:.2f} us a step BPTT (GEMMs included)")
        xl, hl, cl = (a.detach().requires_grad_() for a in (lx, *state0))
        lib_fwd_ms, lib_bwd_ms = library_train_ms(torch, lambda: lib(xl, (hl, cl)),
                                                  dys.to(lx.dtype), 10)
        cost = dict(masks=True)
        rows[("lstm_stack_fwd_res", shape, b)] = kernel_row(
            "lstm_stack_fwd_res", label + ", masks", err, tol,
            cuda_ms(torch, lambda: cuda_stack.lstm_stack_scan_fused_res(gi0, layers, h0s, c0s,
                                                                        mk, precision), 10),
            cuda_ms(torch, lambda: res_plain(gi0, layers, h0s, c0s, mk, precision), 3),
            (*cuda_stack.stack_res_cost(t, b, h, ranks, xranks, **cost), mm), lib_fwd_ms,
            lib_name)
        rows[("lstm_stack_bwd", shape, b)] = kernel_row(
            "lstm_stack_bwd", label + ", masks", err_g, grad_tol,
            cuda_ms(torch, lambda: cuda_stack.lstm_stack_bwd(*bwd_args), 10),
            cuda_ms(torch, lambda: bwd_plain(*bwd_args), 3),
            (*cuda_stack.stack_bwd_cost(t, b, h, ranks, xranks, **cost),
             *bwd_ops), lib_bwd_ms, lib_name)
        print(f"kernel lstm_stack_fwd_res {label}: "
              f"{rows[('lstm_stack_fwd_res', shape, b)]['ms']:.4f} ms against \"fused\"'s two "
              f"residual scans from x {e['fused_res_ms']:.4f} ms; lstm_stack_bwd "
              f"{rows[('lstm_stack_bwd', shape, b)]['ms']:.4f} ms against their two BPTTs "
              f"{e['fused_bwd_ms']:.4f} ms")
    print(json.dumps({"wavefront_kernels" + ("_bf16" if bf16 else ""): extra}))
    return rows


def wavefront_lm(backend, dropout=0.5, layers=LM["layers"], head_bf16=False):
    """The PTB medium LM through `LMConfig` on a backend."""
    from vmlmf_tpu_torch.config import LMConfig

    return LMConfig(hidden_size=LM["hidden"], layer_num=layers, dropout=dropout,
                    w_rank=LM["rank"], u_ranks=(LM["rank"],), backend=backend,
                    head_bf16=head_bf16).build_model(LM["vocab"])


def step_grads(torch, model, params, chunk, seed):
    """One train-mode step's gradients of every parameter, dropout masks from
    a generator seeded with `seed`."""
    from vmlmf_tpu_torch.train.lm import lm_loss
    from vmlmf_tpu_torch.utils.tree import tree_leaves

    x, y = (torch.as_tensor(a, device="cuda").long() for a in chunk)
    leaves = [q.detach().requires_grad_() for q in tree_leaves(params)]
    p = params_like(params, iter(leaves))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits, _ = model.apply(p, x, model.state0(x.shape[1]), train=True, generator=gen)
    return torch.autograd.grad(lm_loss(logits, y), leaves)


def first_parting(losses, other):
    """The first step whose losses differ by more than GRAD_TOL relative, or None."""
    return next((i for i, (u, v) in enumerate(zip(losses, other))
                 if abs(u - v) > GRAD_TOL * abs(v)), None)


def params_like(tree, leaves):
    """`tree` with its tensors replaced, in order, by those of `leaves`."""
    if isinstance(tree, dict):
        return {k: params_like(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_like(v, leaves) for v in tree)
    return next(leaves)


def phase_wavefront(torch):
    """The PTB medium LM on backend "fused_pipelined" (the knob set): the
    stack kernels' checks, serving, training, a 2+2 grouping of a 4x650
    stack, and prefill and train step ms beside the per-layer "fused"
    backend's. -> (rows, [(form, launch counts)])."""
    from vmlmf_tpu_torch.ops import cuda_stack
    from vmlmf_tpu_torch.serve import Decoder
    from vmlmf_tpu_torch.train.lm import LMTrainer

    rows = phase_stack_kernels(torch)
    b, form = MAIN_BATCH, "lstm_stack:lowrank"
    wave, fused = wavefront_lm("fused_pipelined"), wavefront_lm("fused")
    params = wave.init(torch.Generator().manual_seed(0), device="cuda")
    dec = Decoder(wave)
    prompt = prompt_ids(torch, b)

    # -- serving, with the launch counts read around it
    reset_launch_counts()
    logits, states = dec.prefill(params, prompt, wave.state0(b))
    prefill_counts = launch_counts()
    greedy, _ = dec.decode(params, logits, states, steps=64)
    torch.cuda.synchronize()
    decode_delta = count_delta(prefill_counts)
    serve_launches = launch_counts()
    print(f"wavefront: launches in prefill {nonzero(prefill_counts)}, in decode "
          f"{nonzero(decode_delta)}")
    if prefill_counts != eval_counts(form, 1) or decode_delta != only():
        fail(f"a wavefront prefill must launch the no-grad stack entry once and nothing else, "
             f"decode nothing: {prefill_counts}, {decode_delta}")
    lo, hi = int(greedy.min()), int(greedy.max())
    if tuple(greedy.shape) != (64, b) or not 0 <= lo <= hi < LM["vocab"]:
        fail(f"wavefront greedy tokens: shape {tuple(greedy.shape)}, range [{lo}, {hi}]")
    lf, sf = Decoder(fused).prefill(params, prompt, fused.state0(b))
    ok, err = all_close(torch, [logits] + [a for s in states for a in s],
                        [lf] + [a for s in sf for a in s], TOL)
    print(f"wavefront: prefill vs the per-layer fused backend's, max abs err {err:.3g} (tol {TOL})")
    if not ok:
        fail("the wavefront prefill disagrees with the per-layer fused backend's")

    # -- training, with the launch counts read around each step
    trn, vld = lm_chunks(b)
    trainer = LMTrainer(wave, batch_size=b, seq_length=LM["prompt"], learning_rate=1.0,
                        max_grad_norm=5.0)
    tparams, tstates = trainer.init(), trainer.state0()
    generator = torch.Generator(device="cuda").manual_seed(1)
    reset_launch_counts()
    losses, deltas = [], []
    for x, y in trn[:TRAIN_CHUNKS]:
        before = launch_counts()
        tparams, tstates, loss, _ = trainer.train_step(tparams, tstates, x, y, 1.0, generator)
        deltas.append(count_delta(before))
        losses.append(loss)
    before = launch_counts()
    ppl = trainer.perplexity(tparams, vld[:10])
    ppl_delta = count_delta(before)
    torch.cuda.synchronize()
    train_launches = launch_counts()
    losses = [float(v) / b for v in losses]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"wavefront: {TRAIN_CHUNKS} chunks at B={b}, loss per word {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (mean of first 5 {first:.4f}, last 5 {last:.4f}), valid perplexity "
          f"on 10 chunks {ppl:.2f}; launches per step {nonzero(deltas[0])}, in perplexity "
          f"{nonzero(ppl_delta)}")
    if any(d != train_counts(form, 1) for d in deltas):
        fail(f"each wavefront train step must launch one residual forward and one BPTT of the "
             f"stack and nothing else: {deltas}")
    if ppl_delta != eval_counts(form, 10):
        fail(f"perplexity must launch only the no-grad stack entry, once per chunk: {ppl_delta}")
    if not all(v == v and abs(v) != float("inf") for v in losses) or not last < first:
        fail(f"the wavefront LM's training loss did not fall: {losses}")

    # -- the same chunks on the per-layer backends, from the same init and
    # seed: at lr 1.0 training is chaotic, so f32 sums in another order part
    # the losses after some steps, "fused" and "loop" alike; they must agree
    # for the first PARTING_STEPS
    parting = {}
    for be in ("fused", "loop"):
        tr = LMTrainer(wavefront_lm(be), batch_size=b, seq_length=LM["prompt"],
                       learning_rate=1.0, max_grad_norm=5.0)
        p, s = tr.init(), tr.state0()
        gen, other = torch.Generator(device="cuda").manual_seed(1), []
        for x, y in trn[:TRAIN_CHUNKS]:
            p, s, loss, _ = tr.train_step(p, s, x, y, 1.0, gen)
            other.append(float(loss) / b)
        if be == "fused":
            fused_losses = other
        else:
            parting["fused vs loop"] = first_parting(fused_losses, other)
        parting[f"fused_pipelined vs {be}"] = first_parting(losses, other)
    print(f"wavefront: first of {TRAIN_CHUNKS} train steps whose losses part by more than "
          f"{GRAD_TOL} relative (None: none) {parting}")
    if any(v is not None and v < PARTING_STEPS for v in parting.values()):
        fail(f"the wavefront's training losses part from the per-layer backends' within "
             f"{PARTING_STEPS} steps: {parting}")

    # -- one step's gradients at dropout 0.5 under equal generator seeds: the
    # same masks, so the per-layer fused backend's gradients
    g_wave = step_grads(torch, wave, params, trn[0], seed=3)
    g_fused = step_grads(torch, fused, params, trn[0], seed=3)
    rel = [float((a - c).abs().max() / c.abs().max()) for a, c in zip(g_wave, g_fused)]
    print(f"wavefront: gradients of one step at dropout 0.5 vs the fused backend's, largest "
          f"max|diff| / max|fused grad| over {len(rel)} tensors {max(rel):.3g} (tol {GRAD_TOL})")
    if not max(rel) <= GRAD_TOL:
        fail(f"the wavefront gradients disagree with the fused backend's: {rel}")

    group_launches = wavefront_grouping(torch, trn, generator)
    wavefront_reverse(torch)

    # -- speed, beside the per-layer fused backend, same params
    perf, block_runs = {}, []
    for bb in LM_BATCHES:
        ids = prompt_ids(torch, bb)
        s0 = wave.state0(bb)
        perf[f"prefill_b{bb}"] = {
            be: replay_ms(torch, lambda d=Decoder(m): d.prefill(params, ids, s0), 5)
            for be, m in (("fused_pipelined", wave), ("fused", fused))}
    for bb in TRAIN_BATCHES:
        chunks, _ = lm_chunks(bb)
        for be in ("fused_pipelined", "fused"):
            t = LMTrainer(wavefront_lm(be), batch_size=bb, seq_length=LM["prompt"])
            ms = train_step_ms(torch, t, t.init(), chunks, 5, generator)
            perf[f"train_b{bb}_{be}"] = dict(step_ms=ms, words_per_s=bb * LM["prompt"] / ms * 1e3)
    perf["depth3"] = wavefront_depth3(torch)
    # fit's block graphed at B=128 on both backends, the same LM config
    graphed = {}
    for be in ("fused_pipelined", "fused"):
        report, counts, _ = graph_lm(torch, be, TRAIN_BATCHES[-1], model=wavefront_lm(be),
                                     label="wavefront LM")
        graphed[be] = report["graphed"]["wall_ms"]
        block_runs.append(("lstm_stack:lowrank" if be == "fused_pipelined" else "lstm:lowrank",
                           counts))
    perf[f"graphed_train_block_b{TRAIN_BATCHES[-1]}_ms_a_step"] = graphed
    for k, v in perf.items():
        print(f"wavefront {k}: {v}")
    print(json.dumps({"wavefront": dict(perf, losses=losses[::5], perplexity=ppl,
                                        parting=parting)}))
    return rows, [(form, serve_launches), (form, train_launches), (form, group_launches),
                  *block_runs]


def wavefront_depth3(torch):
    """A 3x650 LM on "fused_pipelined": `stack_fits` takes the three layers
    as one group, run at B=128 in chunks of rows (`stack_chunks`). Prefill
    and train step ms at B = 20 and 128 of that group, of the same stack
    with `stack_fits` forced to a 2+1 grouping, and of "fused"; the
    one-group prefill is held to the "fused" one. -> {batch: {way: ms}}."""
    from vmlmf_tpu_torch.ops import cuda_stack
    from vmlmf_tpu_torch.serve import Decoder
    from vmlmf_tpu_torch.train.lm import LMTrainer

    wave, fused = wavefront_lm("fused_pipelined", layers=3), wavefront_lm("fused", layers=3)
    params = wave.init(torch.Generator().manual_seed(0), device="cuda")
    preps = [c.prepare(p) for c, p in zip(wave.rnn.cells, params["rnn"])]
    fits, out = cuda_stack.stack_fits, {}
    for bb in TRAIN_BATCHES:
        ids, chunks = prompt_ids(torch, bb), lm_chunks(bb)[0]
        s0, res = wave.state0(bb), {}
        for way, rule in (("one group", fits), ("2+1", lambda layers: len(layers) <= 2)):
            cuda_stack.stack_fits = rule
            try:
                groups = cuda_stack.stack_groups(cuda_stack.stack_units(wave.rnn.cells, preps))
                if groups != {"one group": [(0, 3)], "2+1": [(0, 2), (2, 3)]}[way]:
                    fail(f"3x650 grouped {groups} under the {way} rule")
                dec = Decoder(wave)  # a graph of this grouping's prefill
                reset_launch_counts()
                logits, _ = dec.prefill(params, ids, s0)
                torch.cuda.synchronize()
                launches = launch_counts()
                res[f"prefill {way}"] = replay_ms(torch, lambda: dec.prefill(params, ids, s0), 5)
                t = LMTrainer(wavefront_lm("fused_pipelined", layers=3), batch_size=bb,
                              seq_length=LM["prompt"])
                res[f"train {way}"] = train_step_ms(torch, t, t.init(), chunks, 5,
                                                    torch.Generator(device="cuda").manual_seed(1))
            finally:
                cuda_stack.stack_fits = fits
            r = LM["rank"]
            chunks3 = cuda_stack.stack_chunks(bb, LM["hidden"], (r,) * 3, (r,) * 2)
            want = (only(lstm_stack_fwd=len(chunks3)) if way == "one group"
                    else only(lstm_stack_fwd=1, lstm_scan_xin_fwd=1))
            if launches != want:
                fail(f"a 3x650 prefill at B={bb} under the {way} rule launched "
                     f"{nonzero(launches)}, not {nonzero(want)}")
            if way == "one group":
                ok, err = close(torch, logits, Decoder(fused).prefill(params, ids, s0)[0])
                print(f"wavefront 3x650 at B={bb}: one group of {nonzero(launches)}, prefill "
                      f"vs the fused backend's max abs err {err:.3g} (tol {TOL})")
                if not ok:
                    fail(f"the 3x650 one-group prefill disagrees with the fused backend's: {err}")
        res["prefill fused"] = replay_ms(torch, lambda d=Decoder(fused): d.prefill(params, ids, s0),
                                       5)
        t = LMTrainer(wavefront_lm("fused", layers=3), batch_size=bb, seq_length=LM["prompt"])
        res["train fused"] = train_step_ms(torch, t, t.init(), chunks, 5,
                                           torch.Generator(device="cuda").manual_seed(1))
        out[f"b{bb}"] = res
    return out


def wavefront_grouping(torch, trn, generator):
    """A 4x650 stack with `stack_fits` forced to a 2+2 grouping: REDUCED_STEPS
    train steps and one no-grad apply, held to the per-layer fused backend
    from the same parameters and generator seeds. -> its launch counts."""
    from vmlmf_tpu_torch.ops import cuda_stack
    from vmlmf_tpu_torch.train.lm import LMTrainer
    from vmlmf_tpu_torch.utils.tree import tree_leaves

    fits = cuda_stack.stack_fits
    cuda_stack.stack_fits = lambda layers: len(layers) <= 2
    try:
        models = {be: wavefront_lm(be, layers=4) for be in ("fused_pipelined", "fused")}
        wave = models["fused_pipelined"]
        params = wave.init(torch.Generator().manual_seed(0), device="cuda")
        preps = [c.prepare(p) for c, p in zip(wave.rnn.cells, params["rnn"])]
        groups = cuda_stack.stack_groups(cuda_stack.stack_units(wave.rnn.cells, preps))
        if groups != [(0, 2), (2, 4)]:
            fail(f"the forced grouping of the 4x650 stack is {groups}")
        trained, losses = {}, {}
        for be, model in models.items():
            tr = LMTrainer(model, batch_size=MAIN_BATCH, seq_length=LM["prompt"])
            p = params_like(params, (a.clone() for a in tree_leaves(params)))
            states, gen = tr.state0(), torch.Generator(device="cuda").manual_seed(4)
            reset_launch_counts()
            losses[be] = []
            for x, y in trn[:REDUCED_STEPS]:
                p, states, loss, _ = tr.train_step(p, states, x, y, 1.0, gen)
                losses[be].append(float(loss) / MAIN_BATCH)
            with torch.no_grad():
                ids = torch.as_tensor(trn[0][0], device="cuda").long()
                logits, _ = model.apply(p, ids, model.state0(MAIN_BATCH))
            torch.cuda.synchronize()
            trained[be] = (logits, [a.detach() for a in tree_leaves(p)], launch_counts())
    finally:
        cuda_stack.stack_fits = fits
    (lw, pw, launches), (lf, pf, _) = trained["fused_pipelined"], trained["fused"]
    rel = [float((a - c).abs().max() / max(float(c.abs().max()), 1e-12)) for a, c in zip(pw, pf)]
    ok, err = close(torch, lw, lf, GRAD_TOL)
    print(f"wavefront grouping 2+2 of 4x650: losses {losses}, logits after {REDUCED_STEPS} steps "
          f"max abs err {err:.3g}, parameters largest relative diff {max(rel):.3g}; launches "
          f"{nonzero(launches)}")
    want = only(lstm_stack_fwd_res=2 * REDUCED_STEPS, lstm_stack_bwd=2 * REDUCED_STEPS,
                lstm_stack_fwd=2)
    if launches != want:
        fail(f"the 2+2 grouping must launch two stacks per step and per apply: {launches}")
    if not ok or not max(rel) <= GRAD_TOL:
        fail(f"the 2+2 grouped stack disagrees with the per-layer fused backend: {err}, {rel}")
    return launches


def wavefront_reverse(torch):
    """A VMLMF BDNet at the HAR width (77 -> 180 -> 180) on "fused_pipelined":
    its forward tower runs one no-grad stack, its reverse tower the per-layer
    fused scans; the logits are held to the "fused" BDNet's."""
    from vmlmf_tpu_torch.cells import VMLMFCell
    from vmlmf_tpu_torch.nn.models import BDNet

    def bdnet(backend):
        return BDNet(HAR["f"], (HAR["h"], HAR["h"]), num_classes=18, merge="concat",
                     backend=backend,
                     cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=HAR["rx"], u_rank=HAR["r"]))

    wave = bdnet("fused_pipelined")
    params = wave.init(torch.Generator().manual_seed(0), device="cuda")
    x = torch.randn(HAR["b"], HAR["t"], HAR["f"], generator=torch.Generator().manual_seed(1))
    x = x.to("cuda")
    with torch.no_grad():
        reset_launch_counts()
        got = wave.apply(params, x)
        torch.cuda.synchronize()
        launches = launch_counts()
        want = bdnet("fused").apply(params, x)
    ok, err = close(torch, got, want)
    print(f"wavefront BDNet: launches {nonzero(launches)}, logits vs the fused backend's max abs "
          f"err {err:.3g} (tol {TOL})")
    if launches != only(lstm_stack_fwd=1, lstm_scan_xin_fwd=2):
        fail(f"a wavefront BDNet must run its forward tower as one stack and its reverse tower "
             f"through the per-layer fused scans: {launches}")
    if not ok:
        fail(f"the wavefront BDNet's logits disagree with the fused backend's: {err}")


# -- phase 14: the JAX package's kernel variants of the LSTM scan ------------

VARIANT_ENV = ("VMLMF_PALLAS_PRECISION", "VMLMF_PALLAS_RESIDUALS", "VMLMF_PALLAS_SAVED_GATES",
               "VMLMF_PALLAS_XIN")


class switches:
    """Sets the JAX package's kernel switches in the environment for a block
    and restores them after it."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in VARIANT_ENV}
        for k in VARIANT_ENV:
            os.environ.pop(k, None)
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def gi_check(torch, rows, sms, name="lm_gi", h=LM["hidden"], r=LM["rank"]):
    """The gi-mode entries against their plain versions at the LM layer (or a
    layer of width ``h`` and rank ``r``, 0 dense), B=20, from the layer's
    own input contribution; cuDNN's f32 LSTM from x as the library (it
    computes the same layer)."""
    from vmlmf_tpu_torch.ops import cuda_scan

    t, b = LM["prompt"], MAIN_BATCH
    s = dict(t=t, b=b, f=h, h=h, rx=r, r=r)
    args = scan_inputs(torch, **s)
    lstm, _ = cudnn_lstm(torch, args)
    gi = cuda_scan._gi_plain(*args[:5], h, False)[1].contiguous()
    gargs = (gi, *args[5:])
    label = f"{name} T={t} B={b} h={h} r={r or 'dense'}, gi mode"
    print_scan_chunks(torch, label, b, h, r, False)
    ys, c_last = cuda_scan.lstm_scan_fused(*gargs)
    res = cuda_scan.lstm_scan_fused_res(*gargs)
    dys = 0.1 * torch.randn((t, b, h), generator=torch.Generator().manual_seed(5)).cuda()
    grads = cuda_scan.lstm_scan_bwd(*args[5:], *res, dys, None)
    torch.cuda.synchronize()
    res_p = cuda_scan.lstm_recurrence_plain(*gargs)
    checks = [("lstm_scan_fwd", (ys, c_last), cuda_scan.lstm_scan_fused_plain(*gargs), TOL),
              ("lstm_scan_fwd_res", res, res_p, TOL),
              ("lstm_scan_bwd", grads, cuda_scan.lstm_scan_bwd_plain(*args[5:], *res_p, dys, None),
               GRAD_TOL)]
    errs = {}
    for entry, got, want, tol in checks:
        ok, errs[entry] = all_close(torch, [a for a in got if a is not None],
                                    [a for a in want if a is not None], tol)
        if not ok:
            fail(f"{entry} disagrees with its plain version at {label}: {errs[entry]}")
    xs, h0, c0 = args[0], args[8], args[9]
    x, hh, cc = (a.detach().requires_grad_() for a in (xs, h0, c0))
    lib_fwd_ms, lib_bwd_ms = library_train_ms(torch, lambda: lstm(x, (hh[None], cc[None])), dys,
                                              10)

    def lib_fwd():
        with torch.no_grad():
            lstm(xs, (h0[None], c0[None]))

    size = (t, b, h, 0, h, r)
    for entry, fn, plain, cost, tol, lib_ms in (
            ("lstm_scan_fwd", lambda: cuda_scan.lstm_scan_fused(*gargs),
             lambda: cuda_scan.lstm_scan_fused_plain(*gargs),
             cuda_scan.scan_cost(*size, gi=True), TOL, cuda_ms(torch, lib_fwd, 10)),
            ("lstm_scan_fwd_res", lambda: cuda_scan.lstm_scan_fused_res(*gargs),
             lambda: cuda_scan.lstm_recurrence_plain(*gargs),
             cuda_scan.scan_res_cost(*size, gi=True), TOL, lib_fwd_ms),
            ("lstm_scan_bwd", lambda: cuda_scan.lstm_scan_bwd(*args[5:], *res, dys, None),
             lambda: cuda_scan.lstm_scan_bwd_plain(*args[5:], *res, dys, None),
             (*cuda_scan.scan_bwd_cost(*size, gi=True), 0,
              cuda_scan.scan_gemm_ops(*size, "bwd", gi=True)), GRAD_TOL, lib_bwd_ms)):
        rows[(entry, name, b)] = kernel_row(entry, label, errs[entry], tol,
                                               cuda_ms(torch, fn, 10), cuda_ms(torch, plain, 3),
                                               cost, lib_ms)


def mixed_lm(backend="fused", dropout=0.5, head_bf16=True):
    """The PTB LM of scripts/bench_lm_b128_precision.py's "bf16+head" (its
    products in bf16 come from VMLMF_PALLAS_PRECISION, set by the caller)."""
    from vmlmf_tpu_torch.cells import VMLMFCell
    from vmlmf_tpu_torch.nn.models import LMModel

    return LMModel(vocab_size=LM["vocab"], hidden_size=LM["hidden"], num_layers=LM["layers"],
                   cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=LM["rank"],
                                                       u_rank=LM["rank"]),
                   dropout_rate=dropout, winit=0.05, backend=backend, head_bf16=head_bf16)


def only_variant(variant):
    """Fails unless every kernel launch since the last reset was of
    ``variant`` -> the launch counts."""
    counts = launch_counts()
    bad = {name: dict(fn.variants) for name, (fn, _) in entries().items()
           if hasattr(fn, "variants") and set(fn.variants) - {variant}}
    if bad:
        fail(f"launches of another variant than {variant}: {bad}")
    return counts


def lm_train_run(torch, trainer, chunks, steps, want_step, label, falling=True, start=None):
    """`steps` train steps over ``chunks`` (cycled) with the launch counts of
    each step held to ``want_step`` -> (losses per word, params); the
    losses finite and, with ``falling``, the mean of the last 5 below the
    first 5's. ``start`` maps the initial parameters."""
    params, states = trainer.init(), trainer.state0()
    if start is not None:
        params = start(params)
    generator = torch.Generator(device="cuda").manual_seed(1)
    losses = []
    for i in range(steps):
        x, y = chunks[i % len(chunks)]
        before = launch_counts()
        params, states, loss, _ = trainer.train_step(params, states, x, y, 1.0, generator)
        delta = count_delta(before)
        if delta != want_step:
            fail(f"{label}: train step {i} must launch {nonzero(want_step)}, got {nonzero(delta)}")
        losses.append(float(loss) / trainer.batch_size)
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"{label}: {steps} steps, loss per word {losses[0]:.4f} -> {losses[-1]:.4f} (mean of "
          f"first 5 {first:.4f}, last 5 {last:.4f})")
    if not all(v == v and abs(v) != float("inf") for v in losses) or \
            (falling and not last < first):
        fail(f"{label}: the training loss did not fall: {losses}")
    return losses, params


def phase_mixed_lm(torch):
    """The PTB LM in the JAX package's mixed precision, served and trained
    -> [(form, launch counts)] and its numbers beside f32 "fused"."""
    from vmlmf_tpu_torch.serve import Decoder
    from vmlmf_tpu_torch.train.lm import LMTrainer

    layers, b = LM["layers"], MAIN_BATCH
    form = "lstm:bf16"
    with switches(VMLMF_PALLAS_PRECISION="bf16"):
        model = mixed_lm()
        params = model.init(torch.Generator().manual_seed(0), device="cuda")
        dec = Decoder(model)
        prompt = prompt_ids(torch, b)
        reset_launch_counts()
        logits, states = dec.prefill(params, prompt, model.state0(b))
        prefill_counts = launch_counts()
        greedy, _ = dec.decode(params, logits, states, steps=64)
        torch.cuda.synchronize()
        serve_launches = only_variant("bf16")
        if prefill_counts != eval_counts(form, layers) or serve_launches != prefill_counts:
            fail(f"a mixed-precision prefill must launch the bf16 no-grad kernel once per layer "
                 f"and decode nothing: {prefill_counts}, {serve_launches}")
        lo, hi = int(greedy.min()), int(greedy.max())
        if tuple(greedy.shape) != (64, b) or not 0 <= lo <= hi < LM["vocab"] or \
                not bool(torch.isfinite(logits).all()):
            fail(f"mixed-precision greedy tokens: shape {tuple(greedy.shape)}, [{lo}, {hi}]")
        print(f"mixed lm: prefill launches {nonzero(prefill_counts)}, greedy[:8, 0] "
              f"{greedy[:8, 0].tolist()}")

        runs = [(form, serve_launches)]
        for bb in TRAIN_BATCHES:
            trn, vld = lm_chunks(bb)
            trainer = LMTrainer(mixed_lm(), batch_size=bb, seq_length=LM["prompt"],
                                learning_rate=1.0, max_grad_norm=5.0)
            reset_launch_counts()
            _, tparams = lm_train_run(torch, trainer, trn, TRAIN_CHUNKS,
                                      train_counts(form, layers), f"mixed lm train B={bb}")
            before = launch_counts()
            ppl = trainer.perplexity(tparams, vld[:4])
            if count_delta(before) != eval_counts(form, len(vld[:4]) * layers):
                fail(f"mixed lm perplexity must launch only the bf16 no-grad kernel: "
                     f"{count_delta(before)}")
            runs.append((form, only_variant("bf16")))
            print(f"mixed lm B={bb}: valid perplexity on {len(vld[:4])} chunks {ppl:.2f}")

        # the first step's gradients against the f32 "fused" step's (dropout 0)
        trn, _ = lm_chunks(b)
        g_mixed = step_grads(torch, mixed_lm(dropout=0.0), params, trn[0], seed=3)
    with switches():
        g_f32 = step_grads(torch, mixed_lm(dropout=0.0, head_bf16=False), params, trn[0], seed=3)
    rel = [float((a - c).abs().max() / c.abs().max()) for a, c in zip(g_mixed, g_f32)]
    print(f"mixed lm: first-step gradients against the f32 fused step's, largest max|diff| / "
          f"max|f32 grad| over {len(rel)} tensors {max(rel):.3g} (tol {BF16_GRAD_TOL})")
    if not max(rel) <= BF16_GRAD_TOL:
        fail(f"the mixed-precision gradients part from the f32 ones: {rel}")

    # -- speed, beside f32 "fused" in the same run
    perf = {}
    for label, env, head in (("mixed", dict(VMLMF_PALLAS_PRECISION="bf16"), True),
                             ("f32", {}, False)):
        with switches(**env):
            m = mixed_lm(head_bf16=head)
            d = Decoder(m)
            for bb in LM_BATCHES:
                ids, s0 = prompt_ids(torch, bb), m.state0(bb)
                pre_ms = replay_ms(torch, lambda: d.prefill(params, ids, s0), 5)
                lg, st = d.prefill(params, ids, s0)
                d.decode(params, lg, st, steps=4)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                d.decode(params, lg, st, steps=64)
                torch.cuda.synchronize()
                perf[f"{label}_b{bb}"] = dict(prefill_ms=pre_ms,
                                              decode_tokens_per_s=64 * bb / (time.perf_counter()
                                                                             - t0))
            for bb in TRAIN_BATCHES:
                chunks, _ = lm_chunks(bb)
                tr = LMTrainer(mixed_lm(head_bf16=head), batch_size=bb, seq_length=LM["prompt"])
                ms = train_step_ms(torch, tr, tr.init(), chunks, 5,
                                   torch.Generator(device="cuda").manual_seed(1))
                perf[f"{label}_train_b{bb}"] = dict(step_ms=ms,
                                                    words_per_s=bb * LM["prompt"] / ms * 1e3)
    for k, v in perf.items():
        print(f"mixed lm {k}: {v}")
    return runs, perf


def phase_mixed_har(torch):
    """The HAR flagship under the recompute policy and under bf16 residuals,
    beside f32 in the same run -> [(form, launch counts)] and step ms."""
    data = har_data()
    runs, out = [], {}
    for label, env, variant, tol in (
            ("recompute", dict(VMLMF_PALLAS_SAVED_GATES="0"), "recompute", GRAD_TOL),
            ("bf16_res", dict(VMLMF_PALLAS_RESIDUALS="bf16"), "bf16_res", RES_GRAD_TOL),
            ("f32", {}, "f32", GRAD_TOL)):
        with switches(**env):
            form, launches, out[label] = har_path(torch, "vmlmf", data, f"lstm:{label}", tol)
            res, bwd = entries()["lstm_scan_xin_fwd_res"][0], entries()["lstm_scan_xin_bwd"][0]
            if set(res.variants) != {variant} or set(bwd.variants) != {variant}:
                fail(f"har {label}: training launched other variants: {dict(res.variants)}, "
                     f"{dict(bwd.variants)}")
        if label != "f32":
            runs.append((form, launches))
    print(json.dumps({"har_variants": {k: dict(step_ms=v["step_ms"], accuracy=v["accuracy"])
                                       for k, v in out.items()}}))
    return runs


def phase_mixed_gi(torch):
    """The LM trained in gi mode (VMLMF_PALLAS_XIN=0) for a few steps: the gi
    entries' exact launch counts, its gradients held to x mode's."""
    from vmlmf_tpu_torch.train.lm import LMTrainer

    layers, b, form, steps = LM["layers"], MAIN_BATCH, "lstm_gi:lowrank", 10
    trn, vld = lm_chunks(b)
    with switches(VMLMF_PALLAS_XIN="0"):
        trainer = LMTrainer(lm_model("fused", dropout_rate=0.5), batch_size=b,
                            seq_length=LM["prompt"], learning_rate=1.0, max_grad_norm=5.0)
        reset_launch_counts()
        _, params = lm_train_run(torch, trainer, trn, steps, train_counts(form, layers),
                                 "gi lm train")
        before = launch_counts()
        trainer.perplexity(params, vld[:4])
        if count_delta(before) != eval_counts(form, len(vld[:4]) * layers):
            fail(f"gi lm perplexity must launch only the gi no-grad kernel: {count_delta(before)}")
        launches = launch_counts()
        g_gi = step_grads(torch, lm_model("fused"), params, trn[0], seed=3)
    with switches():
        g_x = step_grads(torch, lm_model("fused"), params, trn[0], seed=3)
    rel = [float((a - c).abs().max() / c.abs().max()) for a, c in zip(g_gi, g_x)]
    print(f"gi lm: gradients against x mode's, largest max|diff| / max|grad| {max(rel):.3g} "
          f"(tol {GRAD_TOL})")
    if not max(rel) <= GRAD_TOL:
        fail(f"gi-mode gradients disagree with x mode's: {rel}")
    return [(form, launches)]


def peak_step_mib(torch, step):
    """The device memory one step() holds at its peak beyond what was
    allocated before it, in MiB, after a warm step."""
    step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def residual_memory(torch):
    """The peak memory of a HAR flagship train step (B=81) and of an LM train
    step (B=128) under each residual policy: what bf16 residuals and
    recompute are for."""
    from vmlmf_tpu_torch.data.har import synthetic_har
    from vmlmf_tpu_torch.train.har import HARTrainer
    from vmlmf_tpu_torch.train.lm import LMTrainer

    x, y, _, _ = synthetic_har("opp", n_train=HAR["b"], n_test=1, seed=2)
    trn, _ = lm_chunks(TRAIN_BATCHES[-1])
    out = {}
    for label, env in (("f32", {}), ("bf16_res", dict(VMLMF_PALLAS_RESIDUALS="bf16")),
                       ("recompute", dict(VMLMF_PALLAS_SAVED_GATES="0"))):
        with switches(**env):
            har = HARTrainer(har_model("vmlmf"), batch_size=HAR["b"])
            har_params, opt = har.init()
            lm = LMTrainer(lm_model("fused", dropout_rate=0.5), batch_size=TRAIN_BATCHES[-1],
                           seq_length=LM["prompt"])
            params, states = lm.init(), lm.state0()
            gen = torch.Generator(device="cuda").manual_seed(1)
            out[label] = {
                f"har_b{HAR['b']}": peak_step_mib(torch, lambda: har.train_step(har_params, opt,
                                                                                x, y)),
                f"lm_b{TRAIN_BATCHES[-1]}": peak_step_mib(
                    torch, lambda: lm.train_step(params, states, *trn[1], 1.0, gen))}
    print(json.dumps({"peak_step_mib": out}))


def phase_mixed(torch):
    """The kernel variants: checks of each new entry and form, then the
    mixed-precision LM, the HAR variants and gi mode at full width, and a
    trace of a mixed-precision LM train step. -> (rows, runs)."""
    from vmlmf_tpu_torch.train.lm import LMTrainer

    rows = {}
    gi_check(torch, rows, torch.cuda.get_device_properties(0).multi_processor_count)
    runs, perf = phase_mixed_lm(torch)
    runs += phase_mixed_har(torch)
    runs += phase_mixed_gi(torch)
    residual_memory(torch)
    trn, _ = lm_chunks(MAIN_BATCH)
    with switches(VMLMF_PALLAS_PRECISION="bf16"):
        trainer = LMTrainer(mixed_lm(), batch_size=MAIN_BATCH, seq_length=LM["prompt"])
        params, states = trainer.init(), trainer.state0()
        gen = torch.Generator(device="cuda").manual_seed(1)
        trace = trace_step(torch, f"mixed-precision LM train step at B={MAIN_BATCH}",
                           lambda: trainer.train_step(params, states, *trn[1], 1.0, gen))
    print(json.dumps({"mixed": dict(perf, trace=trace)}))
    return rows, runs


# -- phase 15: the last variants: the GRU scan's gi mode and recompute
# policy, and the bf16 stack ----------------------------------------------------

def gru_variant_shapes():
    """(name, (T, B, F, h, rx, r), mode, low-rank, dx) of the gi-mode and
    recompute checks, one layer of each recurrent form: the first layers of
    the two HAR GRUs (low-rank "pre", dense "post") and a dense "pre" layer,
    at the train batch B=81 and, for the no-grad gi entry, at evaluate's
    B=256."""
    t, f, h, rx, r = GRU["t"], GRU["f"], GRU["h"], GRU["rx"], GRU["r"]
    layers = [("main_l1", r, "pre", True, False), ("group_l1", 0, "post", False, False),
              ("dense_pre", 0, "pre", False, True)]
    return [(name, (t, b, f, h, rx, ri), mode, lowrank, dx)
            for b in (GRU["b"], EVAL_BATCH) for name, ri, mode, lowrank, dx in layers]


def phase_gru_variant_kernels(torch):
    """The gi-mode entries (from the layer's own gi) and the recompute
    policy's residual forward and BPTT against their plain versions, in the
    three recurrent forms; cuDNN's GRU from x beside mode "post".
    -> {(entry, shape name, B): row}; the recompute rows' shape names end
    in "_recompute"."""
    from vmlmf_tpu_torch.ops import cuda_gru

    rows = {}
    for name, (t, b, f, h, rx, r), mode, lowrank, dx in gru_variant_shapes():
        args = gru_scan_inputs(torch, t, b, f, h, rx, r, lowrank)
        form = cuda_gru.form_of(args[4], mode)
        size = (t, b, f, rx, h, r, form)
        label = f"{name} T={t} B={b} F={f} h={h} rx={rx} r={r} mode={mode}"
        gru, _ = cudnn_gru(torch, args, mode)
        lib_name = "cuDNN, from x" if gru else "cuDNN"
        print_gru_plan(torch, cuda_gru, name, (t, b, 0, 0, h, r, form), gi=True)
        xs, h0 = args[0], args[7]
        gi = cuda_gru._x_side(*args[:4])[1].contiguous()
        rec = (gi, *args[4:])

        ys = cuda_gru.gru_scan_fused(*rec, mode=mode)
        torch.cuda.synchronize()
        ok, err = close(torch, ys, cuda_gru.gru_scan_fused_plain(*rec, mode=mode))
        if not ok:
            fail(f"gru_scan_fwd disagrees with its plain version at {label}, gi mode: {err}")

        def lib_fwd():
            with torch.no_grad():
                gru(xs, h0[None])

        checks = [("gru_scan_fwd", name, err, TOL,
                   cuda_ms(torch, lambda: cuda_gru.gru_scan_fused(*rec, mode=mode), 20),
                   cuda_ms(torch, lambda: cuda_gru.gru_scan_fused_plain(*rec, mode=mode), 5),
                   cuda_gru.gru_scan_cost(*size, gi=True),
                   cuda_ms(torch, lib_fwd, 20) if gru else None)]
        if b == GRU["b"]:
            dys = 0.1 * torch.randn(ys.shape, generator=torch.Generator().manual_seed(5)).cuda()
            lib_fwd_ms = lib_bwd_ms = None
            if gru is not None:
                x_leaf, h_leaf = xs.detach().requires_grad_(dx), h0.detach().requires_grad_()
                lib_fwd_ms, lib_bwd_ms = library_train_ms(
                    torch, lambda: gru(x_leaf, h_leaf[None]), dys, 20)
            # -- gi mode: the residual forward and the BPTT, whose dpre is dgi
            res = cuda_gru.gru_scan_fused_res(*rec, mode=mode)
            torch.cuda.synchronize()
            ok_r, err_r = all_close(torch, [a for a in res if a is not None],
                                    [a for a in cuda_gru.gru_recurrence_plain(*rec, mode=mode)
                                     if a is not None], TOL)
            saved = (*args[4:], *res, dys)
            grads = cuda_gru.gru_scan_bwd(*saved, mode=mode)
            torch.cuda.synchronize()
            ok_g, err_g = all_close(torch, [a for a in grads if a is not None],
                                    [a for a in cuda_gru.gru_scan_bwd_plain(*saved, mode=mode)
                                     if a is not None], GRAD_TOL)
            if not ok_r or not ok_g:
                fail(f"gru_scan_fwd_res / gru_scan_bwd disagree with their plain versions at "
                     f"{label}, gi mode: {err_r}, {err_g}")
            checks += [
                ("gru_scan_fwd_res", name, err_r, TOL,
                 cuda_ms(torch, lambda: cuda_gru.gru_scan_fused_res(*rec, mode=mode), 20),
                 cuda_ms(torch, lambda: cuda_gru.gru_recurrence_plain(*rec, mode=mode), 5),
                 cuda_gru.gru_scan_res_cost(*size, gi=True), lib_fwd_ms),
                ("gru_scan_bwd", name, err_g, GRAD_TOL,
                 cuda_ms(torch, lambda: cuda_gru.gru_scan_bwd(*saved, mode=mode), 20),
                 cuda_ms(torch, lambda: cuda_gru.gru_scan_bwd_plain(*saved, mode=mode), 5),
                 (*cuda_gru.gru_scan_bwd_cost(*size, gi=True), 0,
                  cuda_gru.gru_gemm_ops(*size, gi=True)), lib_bwd_ms)]
            # -- the recompute policy: ys alone forward, the pre-pass in the BPTT
            fwd_rc = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode, save_gates=False)
            torch.cuda.synchronize()
            if any(a is not None for a in fwd_rc[1:]):
                fail(f"the recompute forward stored residuals at {label}")
            ok_r, err_r = close(torch, fwd_rc[0], cuda_gru.gru_scan_fused_xin_plain(*args,
                                                                                  mode=mode))
            saved_rc = (*args[:3], *args[4:], *fwd_rc, dys)
            grads = cuda_gru.gru_scan_xin_bwd(*saved_rc, mode=mode, dx=dx, bias=args[3])
            torch.cuda.synchronize()
            want = cuda_gru.gru_scan_xin_bwd_plain(*saved_rc, mode=mode, dx=dx, bias=args[3])
            ok_g, err_g = all_close(torch, [a for a in grads if a is not None],
                                    [a for a in want if a is not None], GRAD_TOL)
            if not ok_r or not ok_g:
                fail(f"the recompute entries disagree with their plain versions at {label}: "
                     f"{err_r}, {err_g}")
            gru_bwd_split(torch, f"{label}, gi mode",
                          lambda: cuda_gru.gru_scan_bwd(*saved, mode=mode), t)
            gru_bwd_split(torch, f"{label}, recompute", lambda: cuda_gru.gru_scan_xin_bwd(
                *saved_rc, mode=mode, dx=dx, bias=args[3]), t)
            rc = name + "_recompute"
            checks += [
                ("gru_scan_xin_fwd_res", rc, err_r, TOL,
                 cuda_ms(torch, lambda: cuda_gru.gru_scan_fused_xin_res(
                     *args, mode=mode, save_gates=False), 20),
                 cuda_ms(torch, lambda: cuda_gru.gru_scan_xin_fwd_res_plain(
                     *args, mode=mode, save_gates=False), 5),
                 cuda_gru.gru_scan_res_cost(*size, save_gates=False), lib_fwd_ms),
                ("gru_scan_xin_bwd", rc, err_g, GRAD_TOL,
                 cuda_ms(torch, lambda: cuda_gru.gru_scan_xin_bwd(*saved_rc, mode=mode, dx=dx,
                                                                  bias=args[3]), 20),
                 cuda_ms(torch, lambda: cuda_gru.gru_scan_xin_bwd_plain(
                     *saved_rc, mode=mode, dx=dx, bias=args[3]), 3),
                 (*cuda_gru.gru_scan_bwd_cost(*size, dx=dx, save_gates=False), 0,
                  cuda_gru.gru_gemm_ops(*size, save_gates=False)), lib_bwd_ms)]
        for entry, shape, e_err, tol, ms, plain_ms, cost, lib_ms in checks:
            variant = "recompute" if shape.endswith("_recompute") else "gi mode"
            rows[(entry, shape, b)] = kernel_row(entry, f"{label}, {variant}", e_err, tol, ms,
                                                 plain_ms, cost, lib_ms, lib_name)
            print(f"kernel {entry} {shape} B={b}: {1e3 * ms / t:.3f} us per step "
                  f"(whole call / T)")
    return rows


def gru_residual_memory(torch):
    """The peak memory of a main HAR GRU train step (B=81) under saved gates,
    the recompute policy and gi mode."""
    from vmlmf_tpu_torch.data.har import synthetic_har
    from vmlmf_tpu_torch.train.har import HARTrainer

    x, y, _, _ = synthetic_har("opp", n_train=GRU["b"], n_test=1, seed=2)
    out = {}
    for label, env in (("saved", {}), ("recompute", dict(VMLMF_PALLAS_SAVED_GATES="0")),
                       ("gi", dict(VMLMF_PALLAS_XIN="0"))):
        with switches(**env):
            har = HARTrainer(har_model("gru_main"), batch_size=GRU["b"])
            params, opt = har.init()
            out[label] = peak_step_mib(torch, lambda: har.train_step(params, opt, x, y))
    print(json.dumps({"gru_peak_step_mib": out}))
    return out


def phase_mixed_gru(torch):
    """The two HAR GRUs trained under VMLMF_PALLAS_XIN=0 (gi mode) and under
    VMLMF_PALLAS_SAVED_GATES=0 (recompute), with saved-gates x mode beside
    them in the same phase; each with exact launch counts of its entries
    and no other (no x-mode saved-gates launch), fused against loop
    gradients, accuracy and macro-F1. Then the dense "pre" GRU (mygru_w9)
    for a few steps under each switch, a GRU BDNet in gi mode, and the peak
    memory of a train step under each policy. -> [(form, launch counts)]."""
    from vmlmf_tpu_torch.data.har import synthetic_har

    data = har_data()
    x_tr, y_tr, _, _ = synthetic_har("opp", n_train=REDUCED_STEPS * HAR["b"], n_test=1, seed=3)
    runs, out = [], {}
    for label, env, forms in (
            ("gi", dict(VMLMF_PALLAS_XIN="0"),
             {"gru_main": "gru_gi:lowrank_pre", "gru_group": "gru_gi:dense_post",
              "mygru_w9": "gru_gi:dense_pre"}),
            ("recompute", dict(VMLMF_PALLAS_SAVED_GATES="0"),
             {"gru_main": "gru:recompute", "gru_group": "gru:recompute_dense_post",
              "mygru_w9": "gru:recompute_dense_pre"}),
            ("saved", {}, {"gru_main": None, "gru_group": None})):
        with switches(**env):
            for name, form in forms.items():
                if name in HAR_PATHS:
                    form, launches, out[f"{name}_{label}"] = har_path(torch, name, data, form)
                else:
                    launches = reduced_run(torch, name, form, x_tr, y_tr)
                if label == "recompute":
                    res, bwd = (entries()[e][0] for e in ("gru_scan_xin_fwd_res",
                                                          "gru_scan_xin_bwd"))
                    if set(res.variants) != {"recompute"} or set(bwd.variants) != {"recompute"}:
                        fail(f"{name} under recompute launched other variants: "
                             f"{dict(res.variants)}, {dict(bwd.variants)}")
                if label != "saved":
                    runs.append((form, launches))
            if label == "gi":
                form = "gru_gi:lowrank_pre"
                runs.append((form, bdnet_train(torch, form, "gi bdnet")[0]))
    memory = gru_residual_memory(torch)
    print(json.dumps({"har_gru_variants": {k: dict(step_ms=v["step_ms"], accuracy=v["accuracy"],
                                                   macro_f1=v["macro_f1"])
                                           for k, v in out.items()}, "peak_step_mib": memory}))
    return runs


def phase_mixed_wavefront(torch):
    """The PTB LM in mixed precision (VMLMF_PALLAS_PRECISION=bf16, head_bf16)
    on "fused_pipelined": the bf16 stack kernels' checks; served at B =
    1/20/128 and trained at B = 20/128 with exact stack launch counts, every
    launch of the "bf16" variant; its first step's gradients held to the f32
    wavefront's; prefill and step ms beside the mixed-precision "fused" LM.
    -> (rows, [(form, launch counts)])."""
    from vmlmf_tpu_torch.serve import Decoder
    from vmlmf_tpu_torch.train.lm import LMTrainer

    rows = phase_stack_kernels(torch, "bf16")
    form, runs = "lstm_stack:bf16", []
    with switches(VMLMF_PALLAS_PRECISION="bf16"):
        wave = wavefront_lm("fused_pipelined", head_bf16=True)
        params = wave.init(torch.Generator().manual_seed(0), device="cuda")
        dec = Decoder(wave)
        for bb in LM_BATCHES:
            prompt = prompt_ids(torch, bb)
            reset_launch_counts()
            logits, states = dec.prefill(params, prompt, wave.state0(bb))
            prefill_counts = launch_counts()
            greedy, _ = dec.decode(params, logits, states, steps=64)
            torch.cuda.synchronize()
            served = only_variant("bf16")
            if prefill_counts != eval_counts(form, 1) or served != prefill_counts:
                fail(f"a mixed-precision wavefront prefill at B={bb} must launch the bf16 no-grad "
                     f"stack once and decode nothing: {prefill_counts}, {served}")
            lo, hi = int(greedy.min()), int(greedy.max())
            if tuple(greedy.shape) != (64, bb) or not 0 <= lo <= hi < LM["vocab"] or \
                    not bool(torch.isfinite(logits).all()):
                fail(f"mixed wavefront greedy tokens at B={bb}: {tuple(greedy.shape)}, "
                     f"[{lo}, {hi}]")
            runs.append((form, served))
        print(f"mixed wavefront: each prefill launches {nonzero(eval_counts(form, 1))}")
        for bb in TRAIN_BATCHES:
            trn, vld = lm_chunks(bb)
            trainer = LMTrainer(wavefront_lm("fused_pipelined", head_bf16=True), batch_size=bb,
                                seq_length=LM["prompt"], learning_rate=1.0, max_grad_norm=5.0)
            reset_launch_counts()
            _, tparams = lm_train_run(torch, trainer, trn, TRAIN_CHUNKS, train_counts(form, 1),
                                      f"mixed wavefront train B={bb}")
            before = launch_counts()
            ppl = trainer.perplexity(tparams, vld[:4])
            if count_delta(before) != eval_counts(form, len(vld[:4])):
                fail(f"mixed wavefront perplexity must launch only the bf16 no-grad stack: "
                     f"{count_delta(before)}")
            runs.append((form, only_variant("bf16")))
            print(f"mixed wavefront B={bb}: valid perplexity on {len(vld[:4])} chunks {ppl:.2f}")
        trn, _ = lm_chunks(MAIN_BATCH)
        g_mixed = step_grads(torch, wavefront_lm("fused_pipelined", 0.0, head_bf16=True), params,
                             trn[0], seed=3)
    with switches():
        g_f32 = step_grads(torch, wavefront_lm("fused_pipelined", 0.0), params, trn[0], seed=3)
    rel = [float((a - c).abs().max() / c.abs().max()) for a, c in zip(g_mixed, g_f32)]
    print(f"mixed wavefront: first-step gradients against the f32 wavefront's, largest "
          f"max|diff| / max|f32 grad| over {len(rel)} tensors {max(rel):.3g} "
          f"(tol {BF16_GRAD_TOL})")
    if not max(rel) <= BF16_GRAD_TOL:
        fail(f"the mixed-precision wavefront gradients part from the f32 ones: {rel}")

    # -- speed beside the mixed-precision per-layer "fused" LM, same params
    perf = {}
    with switches(VMLMF_PALLAS_PRECISION="bf16"):
        models = {be: wavefront_lm(be, head_bf16=True) for be in ("fused_pipelined", "fused")}
        for bb in LM_BATCHES:
            ids = prompt_ids(torch, bb)
            perf[f"prefill_b{bb}"] = {
                be: replay_ms(torch, lambda d=Decoder(m), s0=m.state0(bb): d.prefill(params, ids, s0),
                            5) for be, m in models.items()}
        for bb in TRAIN_BATCHES:
            chunks, _ = lm_chunks(bb)
            for be in models:
                tr = LMTrainer(wavefront_lm(be, head_bf16=True), batch_size=bb,
                               seq_length=LM["prompt"])
                ms = train_step_ms(torch, tr, tr.init(), chunks, 5,
                                   torch.Generator(device="cuda").manual_seed(1))
                perf[f"train_b{bb}_{be}"] = dict(step_ms=ms,
                                                 words_per_s=bb * LM["prompt"] / ms * 1e3)
    for k, v in perf.items():
        print(f"mixed wavefront {k}: {v}")
    print(json.dumps({"mixed_wavefront": dict(perf, gradient_rel=max(rel))}))
    return rows, runs


def phase_plans(torch):
    """Faults 9 and 10: the PTB VMLMF LM layer at B=PLAN_BATCH in f32 and in
    bf16, which runs in chunks of rows (`scan_chunks`, printed; one launch a
    chunk, counted), and the dense "pre" GRU layer GRU_WIDE with fewer rows
    a CTA (`gru_plan`, printed): every entry against its plain version,
    with ms, bound and cuDNN's at that batch. -> rows for PERF.md."""
    from vmlmf_tpu_torch.ops import cuda_scan

    rows = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lm = dict(t=LM["prompt"], b=PLAN_BATCH, f=LM["hidden"], h=LM["hidden"], rx=LM["rank"],
              r=LM["rank"])
    for name, policy in (("lm_chunked", F32), ("lm_chunked_bf16", ("bf16", "f32", True))):
        precision = policy[0]
        chunks = cuda_scan.scan_chunks(PLAN_BATCH, lm["h"], lm["r"], sms,
                                       2 if precision == "bf16" else 4)
        print(f"plans {name}: scan_chunks at B={PLAN_BATCH}: "
              f"{[(b0, n) for b0, n, _ in chunks]}")
        if len(chunks) < 2:
            fail(f"{name}: B={PLAN_BATCH} was meant to run past one launch's plan")
        args = scan_inputs(torch, **lm)
        dys = 0.1 * torch.randn((lm["t"], lm["b"], lm["h"]),
                                generator=torch.Generator().manual_seed(5)).cuda()
        reset_launch_counts()
        cuda_scan.lstm_scan_fused_xin(*args, precision)
        res = cuda_scan.lstm_scan_fused_xin_res(*args, *policy)
        cuda_scan.lstm_scan_xin_bwd(*args[:4], *args[5:], *res, dys, None, precision=precision)
        torch.cuda.synchronize()
        n = len(chunks)
        counts = launch_counts()
        if counts != only(lstm_scan_xin_fwd=n, lstm_scan_xin_fwd_res=n, lstm_scan_xin_bwd=n):
            fail(f"{name}: each entry must launch once a chunk of rows ({n}): {nonzero(counts)}")
        print(f"plans {name}: launches of one call of each entry {nonzero(counts)}")
        lstm_check(torch, rows, name, lm, True, True, policy, own_residuals=True)

    t, b, f, h, rx, r = GRU_WIDE
    gru_check(torch, rows, "gru_wide_pre", GRU_WIDE, "pre", False, True, True)
    # cuDNN's GRU computes another function ("post"); its time at the same
    # shape, for scale
    xs = torch.randn((t, b, f), generator=torch.Generator().manual_seed(3)).cuda()
    gru = torch.nn.GRU(f, h).cuda()

    def lib_fwd():
        with torch.no_grad():
            gru(xs)

    x_leaf = xs.detach().requires_grad_()
    dys = torch.randn((t, b, h), generator=torch.Generator().manual_seed(4)).cuda()
    lib_ms = (cuda_ms(torch, lib_fwd, 10),
              *library_train_ms(torch, lambda: gru(x_leaf), dys, 10))
    print(f"library: cuDNN GRU (mode \"post\", another function) at T={t} B={b} F={f} h={h}: "
          f"no-grad {lib_ms[0]:.4f} ms, training forward {lib_ms[1]:.4f} ms, backward "
          f"{lib_ms[2]:.4f} ms")
    print(json.dumps({"plans": {f"{k[0]} {k[1]} B={k[2]}": {
        key: row[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}
        for k, row in rows.items()}}))
    return rows


# Fault 11: layers too wide for the shared memory of all SMs. The PTB
# "large" LM of Zaremba et al. (2014), "Recurrent Neural Network
# Regularization", section 4.1, dense (the uncompressed baseline that VMLMF
# compresses): 2 x 1500 units, dropout 0.65, init +-0.04, T=35, B=20,
# gradient-norm clip 10, lr 1 divided by 1.15 after epoch 14; vocab 10000.
# Its 1500 x 6000 U (36 MB f32) does not fit in the SMs' 30 MB of shared
# memory: the LSTM scans stream the rows that do not fit through L2. The
# kernel checks also take a low-rank layer of that width (r = 750) and the
# GRU's three forms at h=3200, past the width where one row's walk state
# fitted in dense "post".
LARGE = dict(lstm_type="custom", hidden_size=1500, layer_num=2, dropout=0.65, winit=0.04,
             max_grad_norm=10, factor=1.15, factor_epoch=14)
WIDE = dict(t=LM["prompt"], f=LARGE["hidden_size"], h=LARGE["hidden_size"])
WIDE_RANK = 750
GRU_WIDE_H = dict(t=GRU["t"], b=GRU["b"], f=GRU["f"], h=3200, rx=GRU["rx"])
# (name, HARConfig fields) of the HAR GRU nets at that width, by kernel form
GRU_WIDE_NETS = {"wide_lowrank_pre": dict(model="mygru", layer_sizes=(3200,), w_rank=9,
                                          u_ranks=(800,)),
                 "wide_post": dict(model="mygru_group", layer_sizes=(3200,), w_rank=9,
                                   u_ranks=(12, 6)),
                 "wide_pre": dict(model="mygru", layer_sizes=(3200,), w_rank=9)}
# train steps of the large LM: lr 1 under a clip of 10 makes its first
# steps' losses spike (the loop backend's alike), which settle within 60
WIDE_STEPS = 60


def large_lm(backend="fused", dropout=None, head_bf16=False, **over):
    """The PTB "large" LM through `LMConfig` (dropout 0.65 unless given)."""
    from vmlmf_tpu_torch.config import LMConfig

    fields = dict(LARGE, backend=backend, head_bf16=head_bf16, **over)
    if dropout is not None:
        fields["dropout"] = dropout
    return LMConfig(**fields).build_model(LM["vocab"])


def large_trainer(model, b):
    from vmlmf_tpu_torch.train.lm import LMTrainer

    return LMTrainer(model, batch_size=b, seq_length=LM["prompt"], learning_rate=1.0,
                     max_grad_norm=LARGE["max_grad_norm"])


def phase_wide_kernels(torch):
    """The kernel checks of fault 11, each shape's plan printed first: the six
    LSTM entries at dense h=1500 and at low-rank h=1500, r=750, at B=20 and
    128 in f32 (streamed plans) and at B=20 in bf16 (the tensor-core walk;
    dense: a resident plan; at B=128 one streamed launch on the ring; at
    B=1 the FMA loop), the bf16 walk's product alone (`mma_walk_control`),
    the gi-mode entries at the dense
    layer; a streamed plan forced at the LM layer with the resident plan's layout,
    bit-equal to it; the large layer's ring at B=128 with stages of another
    size, bit-equal to the chosen one (`ring_pieces_keep_the_bits`); the GRU's
    grid layout forced at an odd shape (`gru_grid_entries`); the GRU's three
    forms at h=3200, on the grid and its TMA ring: every entry against its
    plain version and another ring's stages bit-equal (`gru_wide_entries`),
    the BPTT's products on the Hopper tile against float64 beside
    gemm_tile.cuh (`gru_tc_control`), the peak MiB of a BPTT call and a HAR
    train step (`gru_wide_memory`), each entry's kernel check.
    -> rows."""
    rows = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bf16 = ("bf16", "f32", True)
    for name, over, diagonals in (("wide_dense", dict(rx=0, r=0), False),
                                  ("wide_lowrank", dict(rx=WIDE_RANK, r=WIDE_RANK), True)):
        for b in TRAIN_BATCHES:
            lstm_check(torch, rows, name, dict(WIDE, b=b, **over), True, diagonals, F32)
        lstm_check(torch, rows, f"{name}_bf16", dict(WIDE, b=MAIN_BATCH, **over), True,
                   diagonals, bf16)
    for b in (1, 128):  # B=1 on the FMA loop (groups of 4 rows), B=128 on the ring
        lstm_check(torch, rows, "wide_dense_bf16", dict(WIDE, b=b, rx=0, r=0), True, False,
                   bf16)
    # a dense width whose bf16 plan streams
    lstm_check(torch, rows, "wide_dense_bf16_streamed", dict(WIDE, b=MAIN_BATCH, f=1600, h=1600,
                                                            rx=0, r=0), True, False, bf16)
    gi_check(torch, rows, sms, "wide_dense_gi", WIDE["h"], 0)
    tc_f32_control(torch)
    tc_bf16_control(torch)
    mma_walk_control(torch)
    streamed_equals_resident(torch, sms)
    ring_pieces_keep_the_bits(torch, sms)
    gru_spill_equals_unspilled(torch, sms)
    gru_grid_entries(torch, sms)
    gru_wide_entries(torch, sms)
    gru_tc_control(torch)
    gru_wide_memory(torch)
    for name, fields in GRU_WIDE_NETS.items():
        lowrank = name == "wide_lowrank_pre"
        shape = (*(GRU_WIDE_H[k] for k in ("t", "b", "f", "h", "rx")),
                 fields["u_ranks"][0] if lowrank else 0)
        gru_check(torch, rows, name, shape, "post" if name == "wide_post" else "pre", lowrank,
                  True, True, iters=3)
    print(json.dumps({"wide": {f"{k[0]} {k[1]} B={k[2]}": {
        key: row[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}
        for k, row in rows.items() if k[1].startswith("wide")}}))
    return rows


def tc_products(torch, b):
    """The dense h=1500 layer's four products at batch b, on seeded operands:
    name -> (a_kind, b_kind, a0, a1, nfirst, lda, b0, ldb, m, n, k) of
    csrc/gemm_tc_check.cu: the x-side projection X Ux; dU = [h0; ys]^T
    dPre; dx = dPre Ux^T; dUx = X^T dPre."""
    m, h = WIDE["t"] * b, WIDE["h"]
    g = torch.Generator().manual_seed(5)

    def n(*shape):
        return torch.randn(shape, generator=g).cuda()

    x, ux, d_pre, h0 = n(m, h), n(h, 4 * h), n(m, 4 * h), n(b, h)
    return {"project": (0, 0, x, None, 0, h, ux, 4 * h, m, 4 * h, h),
            "dU": (3, 0, h0, x[:m - b], b, h, d_pre, 4 * h, h, 4 * h, m),
            "dx": (0, 1, d_pre, None, 0, 4 * h, ux, 4 * h, m, h, 4 * h),
            "dUx": (1, 0, x, None, 0, h, d_pre, 4 * h, h, 4 * h, m)}


def tc_f32_control(torch):
    """The tensor-core tile alone (csrc/gemm_tc_check.cu, the Hopper tile by
    the plan) at the dense h=1500 layer's four products at B=20 and 128 in
    f32, each within TC_TOL of a float64 product, as max abs error over max
    abs output, and bit-equal on a second call. The scan checks' TOL and
    GRAD_TOL could pass a tile that lost 3xTF32's small terms; this one
    fails it, and the control shows so: cuBLAS in one-pass TF32 on the same
    operands must miss TC_TOL."""
    from vmlmf_tpu_torch.ops.tc_check import operands, relative_error, tc_product

    report, tf32 = {}, torch.backends.cuda.matmul.allow_tf32
    for b in (MAIN_BATCH, 128):
        for name, (ak, bk, a0, a1, nfirst, lda, b0, ldb, pm, pn, pk) in tc_products(torch,
                                                                                    b).items():
            a, bb = operands(ak, bk, a0, a1, b0)
            got = tc_product(ak, bk, a0, a1, nfirst, lda, b0, ldb, pm, pn, pk, False)
            again = tc_product(ak, bk, a0, a1, nfirst, lda, b0, ldb, pm, pn, pk, False)
            try:
                torch.backends.cuda.matmul.allow_tf32 = True
                one_pass = a @ bb
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
            report[f"{name} B={b}"] = dict(shape=(pm, pn, pk), tile=relative_error(got, a, bb),
                                           tf32_one_pass=relative_error(one_pass, a, bb),
                                           repeat_equal=bool(torch.equal(got, again)))
    print(f"control: the tensor-core tile in f32 (3xTF32) at the dense h=1500 layer's products, "
          f"max abs error over max abs float64 output (tol {TC_TOL}), beside cuBLAS in one-pass "
          f"TF32 (must exceed it): {report}")
    for name, r in report.items():
        if not r["tile"] <= TC_TOL:
            fail(f"the tensor-core tile's f32 {name} product misses float64 by {r['tile']:.3g}")
        if not r["repeat_equal"]:
            fail(f"the tensor-core tile's f32 {name} product changed bits on a second call")
        if not r["tf32_one_pass"] > TC_TOL:
            fail(f"control: one-pass TF32's {name} product is within {TC_TOL} of float64 "
                 f"({r['tf32_one_pass']:.3g}): the tile check cannot tell 3xTF32 from it")


def tc_bf16_control(torch):
    """tc_f32_control's twin in bf16: the tile's bf16 products at the same
    shapes, each within TC_TOL of a float64 product of the bf16-rounded
    operands and bit-equal on a second call; the control: the float64
    product of the unrounded operands must miss TC_TOL, so the check sees
    whether the tile rounded its operands to bf16."""
    from vmlmf_tpu_torch.ops.tc_check import operands, relative_error, tc_product

    report = {}
    for b in (MAIN_BATCH, 128):
        for name, (ak, bk, a0, a1, nfirst, lda, b0, ldb, pm, pn, pk) in tc_products(torch,
                                                                                    b).items():
            a, bb = operands(ak, bk, a0, a1, b0)
            got = tc_product(ak, bk, a0, a1, nfirst, lda, b0, ldb, pm, pn, pk, True)
            again = tc_product(ak, bk, a0, a1, nfirst, lda, b0, ldb, pm, pn, pk, True)
            report[f"{name} B={b}"] = dict(
                shape=(pm, pn, pk),
                tile=relative_error(got, a.bfloat16().float(), bb.bfloat16().float()),
                unrounded=relative_error(got, a, bb), repeat_equal=bool(torch.equal(got, again)))
    print(f"control: the tensor-core tile in bf16 at the dense h=1500 layer's products, max abs "
          f"error over max abs float64 output of the bf16-rounded operands (tol {TC_TOL}), "
          f"beside that of the unrounded operands (must exceed it): {report}")
    for name, r in report.items():
        if not r["tile"] <= TC_TOL:
            fail(f"the tensor-core tile's bf16 {name} product misses float64 by {r['tile']:.3g}")
        if not r["repeat_equal"]:
            fail(f"the tensor-core tile's bf16 {name} product changed bits on a second call")
        if not r["unrounded"] > TC_TOL:
            fail(f"control: the bf16 {name} product is within {TC_TOL} of the unrounded "
                 f"operands' ({r['unrounded']:.3g}): the check cannot see the rounding")


def mma_walk_control(torch):
    """The bf16 walk's tensor-core product alone (csrc/mma_walk_check.cu) at
    the dense h=1500 layer's forward and BPTT products, B=20 and 128, each
    within TC_TOL of a float64 product of the same bf16 operands (max abs
    error over max abs output), staged and on the ring (every block
    streamed, then half of them) bit-equal."""
    from vmlmf_tpu_torch.ops import cuda_scan
    from vmlmf_tpu_torch.ops.mma_check import mma_walk_product, relative_error

    g = torch.Generator().manual_seed(9)
    report = {}
    for depth, cols, b in ((1500, 48, 20), (6000, 12, 20), (1500, 48, 128), (6000, 12, 128)):
        rpad = -(-b // 8) * 8
        w, a = torch.randn(depth, cols, generator=g).cuda(), torch.randn(depth, rpad,
                                                                         generator=g).cuda()
        staged = mma_walk_product(w, a, rpad)
        half = depth // 2 // cuda_scan.MMA_K * cuda_scan.MMA_K
        rings = [mma_walk_product(w, a, rpad, resident=res, piece=piece)
                 for res, piece in ((0, cuda_scan.RING_PIECE_FLOATS), (half, 6144))]
        again = mma_walk_product(w, a, rpad)
        torch.cuda.synchronize()
        err = relative_error(staged, w, a)
        equal = all(torch.equal(staged, x) for x in (*rings, again))
        report[f"{depth}x{cols} B={b}"] = dict(err=err, ring_and_repeat_bit_equal=equal)
        if not err <= TC_TOL or not equal:
            fail(f"the bf16 walk's mma product {depth}x{cols} at B={b}: error {err:.3g} "
                 f"(tol {TC_TOL}), ring and repeat bit-equal {equal}")
    print(f"control: the bf16 walk's tensor-core product at the dense h=1500 layer, max abs "
          f"error over max abs float64 output of the same bf16 operands (tol {TC_TOL}): {report}")


RING_CHECK_PIECE = 6144  # floats a stage of the ring that ring_pieces_keep_the_bits compares
# (precision, residuals, save_gates) of each variant the LSTM scan kernels
# compile, each forced onto a streamed plan
SCAN_VARIANTS = {"f32": F32, "bf16": ("bf16", "f32", True), "bf16_res": ("f32", "bf16", True),
                 "recompute": ("f32", "f32", False)}


def ring_pieces_keep_the_bits(torch, sms):
    """The streamed plans' ring at the large LM's layer, B=128, dense and
    r=750 in f32, dense in bf16 (the tensor-core walk): the plan the
    wrappers chose against one with stages of RING_CHECK_PIECE floats (more
    pieces a product, more resident rows; in bf16 half of each slice
    resident; the same CTAs, chunks, slices and red), every output of the
    six entries bit-equal."""
    from vmlmf_tpu_torch.ops import cuda_scan

    b, t, h = 128, WIDE["t"], WIDE["h"]
    for r, precision in ((0, "f32"), (WIDE_RANK, "f32"), (0, "bf16")):
        args = scan_inputs(torch, t, b, h, h, r, r)
        gi = cuda_scan._gi_plain(*args[:5], h, False)[1].contiguous()
        dys = 0.1 * torch.randn((t, b, h), generator=torch.Generator().manual_seed(5)).cuda()
        chosen = cuda_scan._chunks_for(b, h, r, torch.device("cuda", 0), precision == "bf16")[0][2]
        if precision == "bf16":
            half = tuple(tuple(d // 2 for d, _ in chosen.slices(k)) for k in ("fwd", "bwd"))
            other = cuda_scan.plan_layout(b, h, r, chosen.groups, chosen.ctas, 2, resident=half,
                                          piece=RING_CHECK_PIECE)
        else:
            other = cuda_scan.streamed_plan(b, h, r, sms, piece=RING_CHECK_PIECE)

        def run(plan):
            keep = cuda_scan._chunks_for
            cuda_scan._chunks_for = lambda *a, **k: ((0, b, plan),)
            try:
                res = cuda_scan.lstm_scan_fused_xin_res(*args, precision)
                gi_res = cuda_scan.lstm_scan_fused_res(gi, *args[5:], precision)
                out = [*cuda_scan.lstm_scan_fused_xin(*args, precision), *res,
                       *cuda_scan.lstm_scan_xin_bwd(*args[:4], *args[5:], *res, dys, None,
                                                    precision=precision),
                       *cuda_scan.lstm_scan_fused(gi, *args[5:], precision), *gi_res,
                       *cuda_scan.lstm_scan_bwd(*args[5:], *gi_res, dys, None, precision)]
            finally:
                cuda_scan._chunks_for = keep
            return [a for a in out if a is not None]

        got, want = run(chosen), run(other)
        torch.cuda.synchronize()
        equal = len(got) == len(want) and all(torch.equal(a, c) for a, c in zip(got, want))
        print(f"wide: the ring at the large LM layer B={b} r={r or 'dense'} {precision}"
              f"{' (tensor-core walk)' if chosen.mma else ''}: stages of "
              f"{chosen.piece('fwd')} / {chosen.piece('bwd')} floats (resident "
              f"{chosen.resident_fwd} / {chosen.resident_bwd}) against {other.piece('fwd')} / "
              f"{other.piece('bwd')} ({other.resident_fwd} / {other.resident_bwd}) on "
              f"{chosen.n_ctas} CTAs, {len(got)} outputs: bit-equal {equal}")
        if not chosen.streamed or (chosen.n_ctas, chosen.stage_fwd, chosen.stage_bwd) != (
                other.n_ctas, other.stage_fwd, other.stage_bwd):
            fail(f"the large LM layer's plans at B={b} r={r or 'dense'} do not share CTAs and "
                 f"chunks")
        if not equal:
            fail(f"the ring's stages of {other.piece('fwd')} floats give other bits than the "
                 f"chosen ones at B={b} r={r or 'dense'}")


def streamed_equals_resident(torch, sms):
    """In each variant the scan kernels compile, a streamed plan forced at
    the LM layer (B=20) with the resident plan's groups, CTAs, stage and
    red, half of each slice's depth resident: every output of the variant's
    entries (x mode, and gi mode where the variant has one) bit-equal to
    the resident plan's; and bf16 at B=256, whose groups of 32 rows run the
    tensor-core walk, a resident ring against a streamed one."""
    from vmlmf_tpu_torch.ops import cuda_scan

    h, r = LM["hidden"], LM["rank"]
    cases = [(name, policy, MAIN_BATCH) for name, policy in SCAN_VARIANTS.items()]
    for name, (precision, residuals, save), b in cases + [("bf16_mma", SCAN_VARIANTS["bf16"],
                                                           256)]:
        args = scan_inputs(torch, LM["prompt"], b, h, h, r, r)
        gi = cuda_scan._gi_plain(*args[:5], h, False)[1].contiguous()
        dys = 0.1 * torch.randn((LM["prompt"], b, h),
                                generator=torch.Generator().manual_seed(5)).cuda()
        elsize = 2 if precision == "bf16" else 4
        base = cuda_scan.scan_plan(b, h, r, sms, elsize)
        half = tuple(tuple(d // 2 for d, _ in base.slices(k)) for k in ("fwd", "bwd"))
        forced = cuda_scan.plan_layout(b, h, r, base.groups, base.ctas, elsize, resident=half)
        if (forced.stage_fwd, forced.red_fwd, forced.stage_bwd, forced.red_bwd) != (
                base.stage_fwd, base.red_fwd, base.stage_bwd, base.red_bwd):
            fail(f"the forced streamed plan ({name}) lays out its stage and red otherwise")
        if base.mma != (name == "bf16_mma"):
            fail(f"the LM layer's {name} plan at B={b}: the tensor-core walk runs bf16 groups "
                 f"of 24 rows or more")
        bias = None if save else args[4]

        def run(plan):
            keep = cuda_scan._chunks_for
            cuda_scan._chunks_for = lambda *a, **k: ((0, b, plan),)
            try:
                res = cuda_scan.lstm_scan_fused_xin_res(*args, precision, residuals, save)
                out = [*res, *cuda_scan.lstm_scan_xin_bwd(*args[:4], *args[5:], *res, dys, None,
                                                          bias=bias, precision=precision)]
                if residuals == "f32" and save:  # the no-grad entries' variants: precisions
                    out += [*cuda_scan.lstm_scan_fused_xin(*args, precision),
                            *cuda_scan.lstm_scan_fused(gi, *args[5:], precision)]
                if save:  # gi mode always saves the gates
                    gi_res = cuda_scan.lstm_scan_fused_res(gi, *args[5:], precision, residuals)
                    out += [*gi_res, *cuda_scan.lstm_scan_bwd(*args[5:], *gi_res, dys, None,
                                                              precision)]
            finally:
                cuda_scan._chunks_for = keep
            return [a for a in out if a is not None]

        one, two = run(base), run(forced)
        torch.cuda.synchronize()
        equal = len(one) == len(two) and all(torch.equal(a, c) for a, c in zip(one, two))
        print(f"wide: a streamed plan forced at the LM layer B={b}, variant {name} (resident "
              f"depths {forced.resident_fwd} / {forced.resident_bwd}, streamed "
              f"{4 * cuda_scan.stream_floats(forced, 'fwd') / 1e6:.3f} / "
              f"{4 * cuda_scan.stream_floats(forced, 'bwd') / 1e6:.3f} MB) against the "
              f"resident plan, {len(one)} outputs: bit-equal {equal}")
        if not equal:
            fail(f"a streamed plan gives other bits than the resident plan with the same layout "
                 f"in variant {name}")


# (T, B, F, h, rx, r, mode, low-rank recurrent side) of the grid checks
# at an odd shape in each form, where `gru_layout` keeps the row kernels and
# the grid is forced: no dimension a multiple of anything
GRU_GRID_ODD = {"lowrank_pre": (6, 37, 20, 197, 5, 23, "pre", True),
                "dense_pre": (6, 37, 20, 197, 0, 0, "pre", False),
                "dense_post": (6, 37, 20, 197, 5, 0, "post", False)}


def gru_grid_entries(torch, sms):
    """The GRU's grid layout forced at an odd shape in each form: the six
    entries and the recompute policy against their plain versions (TOL
    for outputs and residuals, GRAD_TOL for gradients), two calls to equal
    bits, and a plan with a third of each slice's rows streamed (the same
    groups and CTAs, on the TMA ring) bit-equal to the resident one."""
    from vmlmf_tpu_torch.ops import cuda_gru

    for name, (t, b, f, h, rx, r, mode, lowrank) in GRU_GRID_ODD.items():
        form = cuda_gru.form_of(object() if lowrank else None, mode)
        resident = cuda_gru.gru_grid_plan(t, b, f, rx, h, r, form, sms=sms)
        part = tuple(tuple(d // 3 for d, _ in resident.slices(k)) for k in ("fwd", "bwd"))
        streamed = cuda_gru.grid_plan_layout(b, h, r, form, resident.groups, resident.ctas,
                                             resident=part)
        grid_entries_agree(torch, name, (t, b, f, h, rx, r, mode, lowrank), resident, streamed,
                           "the streamed plan")


def gru_wide_entries(torch, sms):
    """The GRU's three forms at h=3200 (T=24, B=81, the HAR GRU nets' layer),
    on the grid, every kernel on the TMA ring: the six entries and the
    recompute policy against their plain versions, two calls to equal bits,
    a ring of RING_CHECK_PIECE-float stages (more pieces a product, more
    rows resident; the same groups, CTAs, chunks, items and red) bit-equal to
    the chosen one, and the chosen plan's items of R rows within TOL
    (outputs) and GRAD_TOL (gradients) of the same plan's items of 4 rows."""
    from vmlmf_tpu_torch.ops import cuda_gru

    t, b, f, h, rx = (GRU_WIDE_H[k] for k in ("t", "b", "f", "h", "rx"))
    for name, fields in GRU_WIDE_NETS.items():
        lowrank = name == "wide_lowrank_pre"
        r, mode = (fields["u_ranks"][0], "pre") if lowrank else (0, "post" if name == "wide_post"
                                                                 else "pre")
        form = cuda_gru.form_of(object() if lowrank else None, mode)
        chosen = cuda_gru.gru_grid_plan(t, b, f, rx, h, r, form, sms=sms)
        other = cuda_gru.grid_streamed_plan(b, h, r, form, sms, piece=RING_CHECK_PIECE)
        if not (chosen.piece_fwd and chosen.piece_bwd) or any(
                getattr(chosen, k) != getattr(other, k) for k in (
                    "groups", "ctas", "stage_fwd", "red_fwd", "stage_bwd", "red_bwd", "tile_fwd",
                    "tile_bwd")):
            fail(f"wide: GRU {name} at h=3200: the plans must share groups, CTAs, stage and red, "
                 f"on a ring: {chosen} / {other}")
        routes, _ = gru_routes(cuda_gru, (t, b, f, rx, h, r, form), True, recompute=True)
        print(f"wide: GRU {name} h=3200 recompute BPTT routes: {', '.join(routes)}")
        grid_entries_agree(torch, f"{name} h=3200", (t, b, f, h, rx, r, mode, lowrank), chosen,
                           other, f"a ring of {RING_CHECK_PIECE}-float stages",
                           four=cuda_gru.grid_streamed_plan(b, h, r, form, sms, tile=4))


def grid_entries_agree(torch, name, shape, plan, other, what, four=None):
    """At ``shape`` (T, B, F, h, rx, r, mode, low-rank) on grid plan
    ``plan``: the six entries and the recompute policy against their plain
    versions (TOL for outputs and residuals, GRAD_TOL for gradients), two
    calls to equal bits, and on ``other`` (its groups and CTAs) to the same
    bits; where ``plan`` has items of more than 4 rows and ``four`` (the same
    plan with items of 4 rows) is given, within those tolerances of it."""
    from vmlmf_tpu_torch.ops import cuda_gru

    t, b, f, h, rx, r, mode, lowrank = shape
    args = gru_scan_inputs(torch, t, b, f, h, rx, r, lowrank)
    dys = torch.randn((t, b, h), generator=torch.Generator().manual_seed(5)).cuda()
    gi = cuda_gru._x_side(*args[:4])[1].contiguous()
    rec = (gi, *args[4:])

    def calls():
        res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode)
        rc = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode, save_gates=False)
        res_gi = cuda_gru.gru_scan_fused_res(*rec, mode=mode)
        return {"x": (cuda_gru.gru_scan_fused_xin(*args, mode=mode), *res,
                      *cuda_gru.gru_scan_xin_bwd(*args[:3], *args[4:], *res, dys, mode=mode)),
                "recompute": (*rc, *cuda_gru.gru_scan_xin_bwd(*args[:3], *args[4:], *rc, dys,
                                                              mode=mode, bias=args[3])),
                "gi": (cuda_gru.gru_scan_fused(*rec, mode=mode), *res_gi,
                       *cuda_gru.gru_scan_bwd(*args[4:], *res_gi, dys, mode=mode))}

    four = four if four is not None and max(plan.tile_fwd, plan.tile_bwd) > 4 else None
    runs, keep = [], cuda_gru._plan_for
    try:
        for p in (plan, plan, other) + ((four,) if four else ()):
            cuda_gru._plan_for = lambda *a, gi=False, p=p: ((0, b, p),)
            runs.append(calls())
    finally:
        cuda_gru._plan_for = keep
    torch.cuda.synchronize()
    res_p = cuda_gru.gru_scan_xin_fwd_res_plain(*args, mode=mode)
    grads_p = cuda_gru.gru_scan_xin_bwd_plain(*args[:3], *args[4:], *res_p, dys, mode=mode)
    rec_p = cuda_gru.gru_recurrence_plain(*rec, mode=mode)
    plain = {"x": (res_p[0], *res_p, *grads_p), "recompute": (res_p[0], *[None] * 5, *grads_p),
             "gi": (rec_p[0], *rec_p, *cuda_gru.gru_scan_bwd_plain(*args[4:], *rec_p, dys,
                                                                    mode=mode))}
    worst = {}
    for path, outs in runs[0].items():
        n_fwd = {"x": 7, "recompute": 6, "gi": 6}[path]  # ys and residuals, then grads
        for i, (got, want) in enumerate(zip(outs, plain[path])):
            if got is None or want is None:
                continue
            tol = TOL if i < n_fwd else GRAD_TOL
            ok, err = close(torch, got, want, tol)
            worst[tol] = max(worst.get(tol, 0.0), err)
            if not ok:
                fail(f"wide: GRU grid {name} {path}: output {i} disagrees with its plain "
                     f"version: max abs err {err}")
        for again, label in ((runs[1], "a second call"), (runs[2], what)):
            if not all((a is None and c is None) or torch.equal(a, c)
                       for a, c in zip(outs, again[path])):
                fail(f"wide: GRU grid {name} {path}: {label} gives other bits")
        for i, (got, at4) in enumerate(zip(outs, runs[3][path] if four else ())):
            if got is None:
                continue
            ok, err = close(torch, got, at4, TOL if i < n_fwd else GRAD_TOL)
            worst["R=4"] = max(worst.get("R=4", 0.0), err)
            if not ok:
                fail(f"wide: GRU grid {name} {path}: output {i} with items of "
                     f"{plan.tile_fwd} / {plan.tile_bwd} rows disagrees with items of 4: max abs "
                     f"err {err}")
    against4 = (f"; against items of 4 rows (rpad {four.rpad}): max abs err "
                f"{worst['R=4']:.3g}" if four else "")
    print(f"wide: GRU grid {name} T={t} B={b} F={f} h={h} rx={rx or 'dense'} r={r}: "
          f"{plan.groups} groups x {plan.ctas} CTAs, items of R={plan.tile_fwd} / "
          f"{plan.tile_bwd} rows (forward / walk; rpad "
          f"{plan.rpad}), resident {plan.resident_fwd} / "
          f"{plan.resident_bwd}, rings {plan.piece_fwd} / {plan.piece_bwd}; {what}: resident "
          f"{other.resident_fwd} / {other.resident_bwd}, rings {other.piece_fwd} / "
          f"{other.piece_bwd}; max abs err outputs {worst.get(TOL, 0.0):.3g}, gradients "
          f"{worst.get(GRAD_TOL, 0.0):.3g}; six entries and recompute bit-equal over two calls "
          f"and to {what}{against4}")


def gru_tc_control(torch):
    """Each GRU BPTT product that gemm_tc.cuh's rule sends to the Hopper tile
    at the HAR GRU nets' h=3200 (T=24, B=81, r=800), on seeded residuals,
    through `tc_check.gru_product`: in 3xTF32 on that tile and on
    gemm_tile.cuh's CUDA-core split-k, each error against float64 (max abs
    over the output's max abs, `tc_check.relative_error`), the tile's
    within 1e-5 and within twice gemm_tile.cuh's."""
    from vmlmf_tpu_torch.ops import tc_check
    from vmlmf_tpu_torch.ops.cuda_scan import tc_route

    t, b, h, r = GRU_WIDE_H["t"], GRU_WIDE_H["b"], GRU_WIDE_H["h"], 800
    m = t * b
    g = torch.Generator().manual_seed(3)

    def n(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).cuda()

    h0, ys, gates = n(b, h, scale=0.5), torch.tanh(n(t, b, h)), torch.sigmoid(n(t, b, 3 * h))
    dpre = n(m, 3 * h, scale=0.1)
    v = dict(hu=n(m, r), rhu=n(m, r), dhu=n(m, r, scale=0.1), drhu=n(m, r, scale=0.1),
             w=n(h, r, scale=h ** -0.5))
    for p, (label, shape, _, _) in enumerate(tc_check.GRU_PRODUCTS):
        if not tc_route(*shape(m, h, r, r)):
            fail(f"wide: the GRU product {label} at h=3200 must take the Hopper tile")
        a, bb = tc_check.gru_sources(p, h0, ys, gates, dpre, **v)
        errs = [tc_check.relative_error(tc_check.gru_product(p, tile, h0, ys, gates, dpre, **v),
                                        a, bb)
                for tile in (tc_check.GRU_HOPPER, tc_check.GRU_TILE)]
        print(f"wide: GRU product {label} {tuple(a.shape)} @ {tuple(bb.shape)} at h=3200: error "
              f"over float64 on the Hopper tile (3xTF32) {errs[0]:.3g}, on gemm_tile.cuh "
              f"{errs[1]:.3g}")
        if not errs[0] <= min(1e-5, 2 * errs[1]):
            fail(f"wide: the GRU product {label} on the Hopper tile: error {errs[0]:.3g} against "
                 f"float64, gemm_tile.cuh's {errs[1]:.3g}")
        del a, bb


def gru_wide_memory(torch):
    """The peak device MiB of the h=3200 "post" BPTT call (T=24, B=81,
    `peak_step_mib`) with saved gates and under the recompute policy
    (whose pre-pass fills the gates' scratch), and of one train step of
    the HAR GRU "post" net at h=3200, the Hopper tile's staged copies
    included."""
    from vmlmf_tpu_torch.config import HARConfig
    from vmlmf_tpu_torch.data.har import synthetic_har
    from vmlmf_tpu_torch.ops import cuda_gru
    from vmlmf_tpu_torch.train.har import HARTrainer

    t, b, f, h, rx = (GRU_WIDE_H[k] for k in ("t", "b", "f", "h", "rx"))
    args = gru_scan_inputs(torch, t, b, f, h, rx, 0, False)
    res = cuda_gru.gru_scan_fused_xin_res(*args, mode="post")
    dys = 0.1 * torch.randn((t, b, h), generator=torch.Generator().manual_seed(5)).cuda()
    out = {"bwd_h3200_post": peak_step_mib(torch, lambda: cuda_gru.gru_scan_xin_bwd(
        *args[:3], *args[4:], *res, dys, mode="post"))}
    del res
    res = cuda_gru.gru_scan_fused_xin_res(*args, mode="post", save_gates=False)
    out["bwd_h3200_post_recompute"] = peak_step_mib(torch, lambda: cuda_gru.gru_scan_xin_bwd(
        *args[:3], *args[4:], *res, dys, mode="post", bias=args[3]))
    har = HARTrainer(HARConfig(**GRU_WIDE_NETS["wide_post"]).build_model(), batch_size=b)
    params, opt = har.init()
    x, y, _, _ = synthetic_har("opp", n_train=b, n_test=1, seed=2)
    out["har_step_h3200_post"] = peak_step_mib(torch, lambda: har.train_step(params, opt, x, y))
    staged = cuda_gru.gru_tc_stage_floats(t, b, f, rx, h, 0, cuda_gru.DENSE_POST)
    print(json.dumps({"gru_wide_peak_mib": {k: round(v, 1) for k, v in out.items()},
                      "staged_mib": round(4 * staged / 2 ** 20, 1)}))
    return out


def gru_spill_equals_unspilled(torch, sms):
    """A spill forced at a small width (h=64, T=24, B=81, one row a CTA,
    every weight through L2, one step a block) in each GRU form, in x mode,
    gi mode and the recompute policy: with the first non-empty region and
    with every region of each kernel in device memory, every output
    bit-equal to the same layout with none."""
    from vmlmf_tpu_torch.ops import cuda_gru

    t, b, f, h, rx = GRU["t"], GRU["b"], GRU["f"], 64, GRU["rx"]
    dys = torch.randn((t, b, h), generator=torch.Generator().manual_seed(5)).cuda()
    for name, mode, lowrank, r in (("post", "post", False, 0), ("pre", "pre", False, 0),
                                   ("lowrank_pre", "pre", True, 16)):
        form = (cuda_gru.DENSE_POST if mode == "post" else
                cuda_gru.LOWRANK_PRE if lowrank else cuda_gru.DENSE_PRE)
        args = gru_scan_inputs(torch, t, b, f, h, rx, r, lowrank)
        gi = cuda_gru._x_side(*args[:4])[1].contiguous()
        rec = (gi, *args[4:])

        def x_mode():
            res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode)
            return (cuda_gru.gru_scan_fused_xin(*args, mode=mode), *res,
                    *cuda_gru.gru_scan_xin_bwd(*args[:3], *args[4:], *res, dys, mode=mode))

        def gi_mode():
            res = cuda_gru.gru_scan_fused_res(*rec, mode=mode)
            return (cuda_gru.gru_scan_fused(*rec, mode=mode), *res,
                    *cuda_gru.gru_scan_bwd(*args[4:], *res, dys, mode=mode))

        def recompute():
            res = cuda_gru.gru_scan_fused_xin_res(*args, mode=mode, save_gates=False)
            return (*res, *cuda_gru.gru_scan_xin_bwd(*args[:3], *args[4:], *res, dys, mode=mode,
                                                     bias=args[3]))

        paths = {"x": x_mode, "gi": gi_mode, "recompute": recompute}
        for path, call in paths.items():
            outs, spills = [], []
            for regions in ((0, 0), (1, 1), (99, 99)):
                plans = {g: cuda_gru.spill_plan(t, b, 0 if g else f, 0 if g else rx, h, r, form,
                                                regions, gi=g, sms=sms) for g in (False, True)}
                keep = cuda_gru._plan_for
                cuda_gru._plan_for = lambda *a, gi=False: plans[gi]
                try:
                    outs.append([a for a in call() if a is not None])
                finally:
                    cuda_gru._plan_for = keep
                spills.append((plans[path == "gi"].spill_fwd, plans[path == "gi"].spill_bwd))
            torch.cuda.synchronize()
            equal = all(len(o) == len(outs[0]) and all(torch.equal(a, c)
                                                       for a, c in zip(outs[0], o))
                        for o in outs[1:])
            print(f"wide: GRU {name} {path}: spills (forward, walk floats a CTA) {spills[1:]} "
                  f"against none, {len(outs[0])} outputs: bit-equal {equal}")
            if not equal:
                fail(f"wide: a forced GRU spill ({name}, {path}) gives other bits than the same "
                     f"layout unspilled")


def wide_chunks(torch, b, r=0):
    """The chunks of rows of a 1500-wide layer at batch ``b`` (rank ``r``),
    in the precision the environment selects."""
    from vmlmf_tpu_torch.ops import cuda_scan

    bf16 = os.environ.get("VMLMF_PALLAS_PRECISION") == "bf16"
    return print_scan_chunks(torch, f"large LM layer B={b} r={r or 'dense'}"
                             f"{' bf16' if bf16 else ''}", b, WIDE["h"], r, bf16)


def wide_serve(torch, label, model, params, batches, form, report, r=0):
    """The graphed prefill at each batch (`graph_prefill`, bit-equal to its
    eager calls, a no-grad launch a layer and chunk of rows a call) -> runs."""
    runs, layers = [], LARGE["layer_num"]
    for b in batches:
        chunks = len(wide_chunks(torch, b, r))
        report[f"prefill_{label}_b{b}"], counts = graph_prefill(torch, f"large {label}", model,
                                                               params, b)
        want = eval_counts("lstm:dense", layers * chunks * GRAPH["prefills"])
        if counts != want:
            fail(f"wide: a large {label} prefill at B={b} must launch the no-grad kernel once a "
                 f"layer and chunk of rows ({chunks}): {nonzero(counts)}")
        runs.append((form, counts))
    return runs


def phase_wide_lm(torch):
    """The dense PTB "large" LM on the card: the graphed prefill at B = 1, 20,
    128 and greedy decode, training (eager steps with exact launch counts
    and a falling loss, a block of chunks graphed through `fit`'s path),
    one `lm_main` epoch with its flags; on "fused_pipelined" (each dense
    layer a singleton group through the per-layer scans); in the JAX
    package's mixed precision (bf16 products and head); a low-rank layer
    of that width (r=750) served and trained; the HAR GRU nets at h=3200.
    -> runs for the kernels line."""
    import math

    from vmlmf_tpu_torch.cli import lm_main

    runs, report, layers = [], {}, LARGE["layer_num"]
    form = "lstm:wide_dense"
    model = large_lm("fused")
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    runs += wide_serve(torch, "fused", model, params, LM_BATCHES, form, report)
    report["greedy_b20"], counts = graph_decode(torch, model, params, MAIN_BATCH, "greedy")
    if counts != only():
        fail(f"wide: the large LM's decode must launch no scan kernel: {nonzero(counts)}")

    trn, vld = lm_chunks(MAIN_BATCH)
    reset_launch_counts()
    losses, _ = lm_train_run(torch, large_trainer(model, MAIN_BATCH), trn, WIDE_STEPS,
                             train_counts("lstm:dense", layers), "wide: large fused")
    runs.append((form, launch_counts()))
    report["fused_losses"] = losses[::5]
    held_to_loop(torch, "large LM", large_lm, losses, trn)
    report["fit_block"], counts, _ = graph_lm(torch, "fused", MAIN_BATCH, model=model,
                                              label="large LM")
    if counts != train_counts("lstm:dense", layers * GRAPH["chunks"]):
        fail(f"wide: the graphed block must launch the training kernels once a layer and chunk: "
             f"{nonzero(counts)}")
    runs.append((form, counts))
    report["step_ms"] = train_step_ms(torch, large_trainer(model, MAIN_BATCH), params, trn, 5,
                                      torch.Generator(device="cuda").manual_seed(1))

    # the per-layer path of "fused_pipelined": no stack plan takes a dense layer
    piped = large_lm("fused_pipelined")
    lf = prefill_outputs(torch, model, params, MAIN_BATCH)
    lp = prefill_outputs(torch, piped, params, MAIN_BATCH)
    ok, err = all_close(torch, lf, lp, 0.0)
    print(f"wide: fused_pipelined prefill against fused at B={MAIN_BATCH}: max abs err {err:.3g}")
    if not ok:
        fail("wide: the large LM's fused_pipelined prefill differs from fused")
    runs += wide_serve(torch, "fused_pipelined", piped, params, (MAIN_BATCH,), form, report)
    reset_launch_counts()
    losses_p, _ = lm_train_run(torch, large_trainer(piped, MAIN_BATCH), trn, WIDE_STEPS,
                               train_counts("lstm:dense", layers), "wide: large fused_pipelined")
    runs.append((form, launch_counts()))
    ok, err = all_close(torch, [torch.tensor(losses_p)], [torch.tensor(losses)], 0.0)
    print(f"wide: fused_pipelined's losses against fused's over {WIDE_STEPS} steps: max abs err "
          f"{err:.3g}")
    if not ok:
        fail(f"wide: fused_pipelined's losses {losses_p} differ from fused's {losses}")

    # mixed precision on the tensor-core walk: a resident bf16 plan at B=20,
    # one streamed launch on the ring at B=128 (`scan_chunks`' measured rule)
    with switches(VMLMF_PALLAS_PRECISION="bf16"):
        for b in TRAIN_BATCHES:  # the forms "wide_dense_bf16_mma" and "..._mma_ring"
            if not all(plan.mma for _, _, plan in wide_chunks(torch, b)):
                fail(f"wide: the large LM's bf16 layer at B={b} must run the tensor-core walk")
        mixed = large_lm("fused", head_bf16=True)
        reset_launch_counts()
        runs += wide_serve(torch, "mixed bf16+head", mixed, params, (MAIN_BATCH,),
                           "lstm:wide_dense_bf16_mma", report)
        runs += wide_serve(torch, "mixed bf16+head", mixed, params, (128,),
                           "lstm:wide_dense_bf16_mma_ring", report)
        only_variant("bf16")
        for b in TRAIN_BATCHES:
            chunks = len(wide_chunks(torch, b))
            reset_launch_counts()
            mixed_losses, _ = lm_train_run(
                torch, large_trainer(mixed, b), lm_chunks(b)[0], 10,
                train_counts("lstm:dense", layers * chunks),
                f"wide: large mixed bf16+head B={b} ({chunks} chunks of rows)", falling=False)
            runs.append(("lstm:wide_dense_bf16_mma" if b == MAIN_BATCH
                         else "lstm:wide_dense_bf16_mma_ring", only_variant("bf16")))
            if b == MAIN_BATCH:  # the f32 run's first steps, within bf16's tolerance
                ok, err = all_close(torch, [torch.tensor(mixed_losses)],
                                    [torch.tensor(losses[:10])], BF16_TOL)
                print(f"wide: mixed losses against f32's over 10 steps: max abs err {err:.3g}")
                if not ok:
                    fail(f"wide: the mixed LM's losses {mixed_losses} part from f32's")

    # a low-rank layer of that width: VMLMF, w_rank = u_rank = 750, streamed
    lowrank = large_lm("fused", lstm_type="vmlmf", w_rank=WIDE_RANK, u_ranks=(WIDE_RANK,))
    lp_params = lowrank.init(torch.Generator().manual_seed(0), device="cuda")
    runs += wide_serve(torch, "VMLMF r=750", lowrank, lp_params, (MAIN_BATCH,),
                       "lstm:wide_lowrank", report, WIDE_RANK)
    reset_launch_counts()
    lr_losses, _ = lm_train_run(torch, large_trainer(lowrank, MAIN_BATCH), trn, 10,
                                train_counts("lstm:lowrank", layers), "wide: VMLMF 2x1500 r=750",
                                falling=False)
    runs.append(("lstm:wide_lowrank", launch_counts()))
    held_to_loop(torch, "VMLMF 2x1500 r=750",
                 lambda be: large_lm(be, lstm_type="vmlmf", w_rank=WIDE_RANK,
                                     u_ranks=(WIDE_RANK,)),
                 lr_losses, trn, chaos=True)

    # the CLI, one epoch of the synthetic corpus at the large LM's flags
    argv = ["--synthetic", "--vocab_size", str(LM["vocab"]), "--total_epochs", "1",
            "--log_every", "25", "--lstm_type", "custom", "--hidden_size", "1500",
            "--layer_num", "2", "--dropout", "0.65", "--winit", "0.04", "--max_grad_norm", "10",
            "--factor", "1.15", "--factor_epoch", "14"]
    history, _, counts, wall = cli_run(torch, lm_main.main, argv)
    fwd, res, bwd = FAMILIES["lstm"]
    if not (counts[fwd] and counts[res] and counts[bwd]) or \
            sum(counts.values()) != counts[fwd] + counts[res] + counts[bwd]:
        fail(f"wide: cli lm large: the LSTM scan kernels, and only they, must launch: "
             f"{nonzero(counts)}")
    val_ppl = history[0]["val_ppl"]
    if not (math.isfinite(val_ppl) and val_ppl < LM["vocab"]):
        fail(f"wide: cli lm large: validation perplexity {val_ppl}")
    print(f"wide: cli lm large: validation perplexity {val_ppl:.3f}, test "
          f"{history[-1]['test_ppl']:.3f}, {wall:.2f} s, launches {nonzero(counts)}")
    runs.append((form, counts))
    report["cli"] = dict(val_ppl=val_ppl, test_ppl=history[-1]["test_ppl"], wall_s=wall)

    runs += wide_gru_nets(torch)
    print(json.dumps({"wide_lm": report}))
    return runs


def held_to_loop(torch, label, make, losses, chunks, steps=PARTING_STEPS, chaos=False):
    """The loop backend's first ``steps`` losses from the same init and
    generator, against the fused run's ``losses`` within TOL. With
    ``chaos`` (a run whose lr-1 spikes amplify f32 sums in another order),
    a witness says how far the dynamics carry a perturbation of that size:
    the loop run again from weights each moved by one ulp. The fused run
    must agree within TOL over the steps before the witness parts by more
    than TOL, and after them part by no more than CHAOS_RATIO times the
    witness's largest parting."""
    reset_launch_counts()
    loop, _ = lm_train_run(torch, large_trainer(make("loop"), MAIN_BATCH), chunks, steps,
                           only(), f"wide: {label} on the loop backend", falling=False)
    fused, calm = losses[:steps], steps
    diffs = [abs(u - v) for u, v in zip(fused, loop)]
    print(f"wide: {label}: losses over {steps} steps, fused {fused}, loop {loop}")
    if chaos:
        nudged, _ = lm_train_run(torch, large_trainer(make("loop"), MAIN_BATCH), chunks, steps,
                                 only(), f"wide: {label} on the loop backend, weights nudged",
                                 falling=False, start=lambda p: ulp_nudged(torch, p))
        witness = [abs(u - v) for u, v in zip(nudged, loop)]
        calm = next((i for i, (w, v) in enumerate(zip(witness, loop))
                     if w > TOL + TOL * abs(v)), steps)
        print(f"wide: {label}: witness (loop from weights moved by one ulp) {nudged}; abs "
              f"parting by step, fused {diffs}, witness {witness}; steps before the witness "
              f"parts by more than TOL {calm}")
        late = diffs[calm:]
        if late and not max(late) <= CHAOS_RATIO * max(witness):
            fail(f"wide: {label}: fused losses part from the loop backend's by {max(late):.3g} "
                 f"after step {calm}, more than {CHAOS_RATIO}x the one-ulp witness's "
                 f"{max(witness):.3g}")
    ok, err = all_close(torch, [torch.tensor(fused[:calm])], [torch.tensor(loop[:calm])], TOL)
    print(f"wide: {label}: fused losses against the loop backend's over {calm} steps: max abs "
          f"err {err:.3g}")
    if not ok:
        fail(f"wide: {label}: fused losses {fused[:calm]} part from the loop backend's "
             f"{loop[:calm]}")


def ulp_nudged(torch, params, seed=7):
    """``params`` with every weight moved by one ulp, up or down by a seeded
    coin: a perturbation of the size of f32 sums taken in another order."""
    from vmlmf_tpu_torch.utils.tree import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(seed)
    moved = []
    for q in tree_leaves(params):
        up = torch.rand(q.shape, generator=gen, device=q.device) < 0.5
        inf = torch.full_like(q, float("inf"))
        moved.append(torch.nextafter(q, torch.where(up, inf, -inf)))
    return params_like(params, iter(moved))


def prefill_outputs(torch, model, params, b):
    """An eager prefill's logits and states, flattened."""
    from vmlmf_tpu_torch.serve import Decoder

    logits, states = Decoder(model).prefill(params, prompt_ids(torch, b), model.state0(b))
    torch.cuda.synchronize()
    return [logits] + [a for s in states for a in s]


def wide_gru_nets(torch):
    """The HAR GRU nets at h=3200 (T=24, B=81): two train steps and
    `evaluate`, each with its exact launch counts (one a chunk of rows of
    the grid layout) and finite results -> runs."""
    from vmlmf_tpu_torch.config import HARConfig
    from vmlmf_tpu_torch.data.har import synthetic_har
    from vmlmf_tpu_torch.ops import cuda_gru
    from vmlmf_tpu_torch.train.har import HARTrainer, evaluate

    runs, b = [], GRU["b"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    form_ids = {"wide_lowrank_pre": cuda_gru.LOWRANK_PRE, "wide_post": cuda_gru.DENSE_POST,
                "wide_pre": cuda_gru.DENSE_PRE}
    x_tr, y_tr, x_te, y_te = synthetic_har("opp", n_train=2 * b, n_test=EVAL_BATCH, seed=0)
    for name, fields in GRU_WIDE_NETS.items():
        form = f"gru:{name}"
        model = HARConfig(**fields).build_model()
        trainer = HARTrainer(model, batch_size=b)
        params, opt = trainer.init()
        reset_launch_counts()
        losses = []
        for i in range(2):
            params, opt, loss = trainer.train_step(params, opt, x_tr[i * b:(i + 1) * b],
                                                   y_tr[i * b:(i + 1) * b])[:3]
            losses.append(float(loss))
        train = launch_counts()
        metrics = evaluate(model, params, x_te, y_te)
        evald = count_delta(train)
        # one cooperative launch a chunk of rows (`gru_grid_chunks`)
        chunks = {n: len(cuda_gru.gru_layout(GRU["t"], n, GRU["f"], GRU_WIDE_H["rx"], 3200,
                                             fields["u_ranks"][0] if "lowrank" in name else 0,
                                             form_ids[name], sms=sms))
                  for n in (b, EVAL_BATCH)}
        print(f"wide: HAR GRU {name} (h=3200): losses {losses}, accuracy "
              f"{metrics['accuracy']:.4f}, launches in 2 steps {nonzero(train)}, in evaluate "
              f"{nonzero(evald)} (chunks of rows at B={b} / {EVAL_BATCH}: {chunks[b]} / "
              f"{chunks[EVAL_BATCH]})")
        if train != train_counts(form, 2 * chunks[b]) or \
                evald != eval_counts(form, chunks[EVAL_BATCH]):
            fail(f"wide: HAR GRU {name}: two steps must launch the residual forward and the "
                 f"BPTT once a chunk of rows each, evaluate the no-grad kernel once a chunk: "
                 f"{train}, {evald}")
        if not all(v == v and abs(v) != float("inf") for v in losses):
            fail(f"wide: HAR GRU {name}: losses {losses}")
        runs.append((form, launch_counts()))
    return runs


def phase_wide(torch):
    """Fault 11 on the card -> (rows, runs)."""
    rows = phase_wide_kernels(torch)
    return rows, phase_wide_lm(torch)


class StampedOutput:
    """A stdout stand-in that passes every write on and keeps each line with
    the host clock when it was written."""

    def __init__(self, out):
        self.out, self.lines, self.part = out, [], ""

    def write(self, text):
        self.out.write(text)
        self.part += text
        *done, self.part = self.part.split("\n")
        now = time.perf_counter()
        self.lines += [(now, line) for line in done]
        return len(text)

    def flush(self):
        self.out.flush()


def cli_run(torch, main, argv):
    """main(argv) of a CLI module, in this process, with the launch counts
    set to 0 just before it and read just after -> (its result, its stamped
    output lines, the launch counts, wall seconds)."""
    import contextlib

    out = StampedOutput(sys.stdout)
    print(f"cli: {main.__module__} {' '.join(argv)}")
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    torch.cuda.synchronize()
    return result, [(t - t0, line) for t, line in out.lines], launch_counts(), \
        time.perf_counter() - t0


def har_epoch_seconds(lines):
    """The seconds of each epoch, from `HARTrainer.fit`'s log lines."""
    return [float(line.rsplit("(", 1)[1].split()[0]) for _, line in lines
            if line.startswith("Epoch ") and "cross_entropy" in line]


def phase_cli(torch):
    """The port's entry points in this process, through each CLI module's
    main(argv), with a temporary --ckpt_dir: the HAR CLI trains and tests
    the VMLMF flagship, then tests its checkpoint in a second run (equal
    metrics); the HAR GRU; the UCI-HAR shape (T=128, F=9); the PTB LM CLI at
    the "medium" width on "fused" and on "fused_pipelined", whose validation
    perplexity must be finite and below a uniform guess's (the vocabulary
    size); then "fused" once more, as the first LM run also pays the
    process's warm-up. Each run's launches, seconds an epoch and (LM)
    words/s. -> runs for the kernels line."""
    import math
    import tempfile

    from vmlmf_tpu_torch.cli import har_main, lm_main

    runs, report = [], {}
    har_runs = (("vmlmf", "lstm:lowrank", ["--model", "vmmodel", "--layer_sizes", "180",
                                           "--wRank", "8", "--uRanks", "6"]),
                ("gru", "gru:lowrank_pre", ["--model", "mygru", "--layer_sizes", "64", "64",
                                            "--wRank", "9", "--uRanks", "9"]),
                # HARConfig's default width: a dense GRU of 180 units (grid layout)
                ("gru180", "gru:har180_dense_pre", ["--model", "mygru"]),
                ("gru180_group", "gru:har180_dense_post", ["--model", "mygru_group",
                                                           "--uRanks", "12", "6"]),
                ("uci", "lstm:lowrank", ["--data", "UCI", "--model", "vmmodel", "--layer_sizes",
                                         "180", "--wRank", "8", "--uRanks", "6"]))
    with tempfile.TemporaryDirectory() as ckpt:
        for label, form, flags in har_runs:
            argv = ["--synthetic", "--max_epochs", "2", "--ckpt_dir", ckpt, *flags]
            metrics, lines, counts, wall = cli_run(torch, har_main.main, ["--total", *argv])
            family = form.split(":")[0]
            fwd, res, bwd = FAMILIES[family]
            if not (counts[fwd] and counts[res] and counts[bwd]) or \
                    sum(counts.values()) != counts[fwd] + counts[res] + counts[bwd]:
                fail(f"cli har {label}: the fused {family} kernels, and only they, must launch: "
                     f"{nonzero(counts)}")
            runs.append((form, counts))
            epochs = har_epoch_seconds(lines)
            entry = dict(accuracy=metrics["accuracy"], macro_f1=metrics["macro_f1"],
                         epoch_seconds=epochs, wall_seconds=wall, launches=nonzero(counts))
            if label in ("vmlmf", "gru180"):  # evaluate from the checkpoint
                tested, _, counts_t, _ = cli_run(torch, har_main.main, argv)
                if tested != metrics:
                    fail(f"cli har: the checkpoint's test run reports {tested}, the training run "
                         f"{metrics}")
                if counts_t != only(**{fwd: counts_t[fwd]}) or not counts_t[fwd]:
                    fail(f"cli har: the test run must launch only the no-grad kernel: "
                         f"{nonzero(counts_t)}")
                runs.append((form, counts_t))
                entry["checkpoint_run"] = dict(tested, launches=nonzero(counts_t))
            print(f"cli har {label}: accuracy {metrics['accuracy']:.4f}, macro-F1 "
                  f"{metrics['macro_f1']:.4f}, seconds an epoch {epochs}, launches "
                  f"{nonzero(counts)}")
            report[f"har_{label}"] = entry

    # "fused" again last: the first LM run of a process also pays its warm-up
    for i, (backend, form) in enumerate((("fused", "lstm:lowrank"),
                                         ("fused_pipelined", "lstm_stack:lowrank"),
                                         ("fused", "lstm:lowrank"))):
        argv = ["--synthetic", "--vocab_size", str(LM["vocab"]), "--total_epochs", "1",
                "--log_every", "25", "--backend", backend]
        history, lines, counts, wall = cli_run(torch, lm_main.main, argv)
        family = form.split(":")[0]
        fwd, res, bwd = FAMILIES[family]
        if not (counts[fwd] and counts[res] and counts[bwd]) or \
                sum(counts.values()) != counts[fwd] + counts[res] + counts[bwd]:
            fail(f"cli lm {backend}: the {family} kernels, and only they, must launch: "
                 f"{nonzero(counts)}")
        runs.append((form, counts))
        # one line a block of fuse_chunks chunks ("chunks n/N, ..."), or one a
        # log_every chunks ("batch i/N, ...") where the trainer steps one by one
        logged = [(t, line) for t, line in lines if line.startswith(("chunks ", "batch "))]
        first_ppl = math.exp(float(logged[0][1].split("train loss = ")[1].split(",")[0]))
        wps = int(logged[-1][1].split("wps = ")[1].split(",")[0])
        start = next(t for t, line in lines if line.startswith("*parameters"))
        epoch_end = next(t for t, line in lines if "Validation set perplexity" in line)
        val_ppl = history[0]["val_ppl"]
        # the untrained model guesses about uniformly (winit 0.05): a perplexity
        # of about the vocabulary's size, which a log line at chunk 0 reported
        # before the epoch ran as one block of fuse_chunks chunks, logged once
        if not (math.isfinite(val_ppl) and val_ppl < LM["vocab"]):
            fail(f"cli lm {backend}: validation perplexity {val_ppl} is not finite and below "
                 f"a uniform guess's, {LM['vocab']}")
        print(f"cli lm {backend}: first logged training perplexity {first_ppl:.1f}, validation "
              f"{val_ppl:.3f}, test {history[-1]['test_ppl']:.3f}; {epoch_end - start:.3f} s "
              f"for the epoch and its validation, {wps} words/s (the trainer's last log line); "
              f"launches {nonzero(counts)}")
        report[f"lm_{backend}_{i}"] = dict(first_train_ppl=first_ppl, val_ppl=val_ppl,
                                       test_ppl=history[-1]["test_ppl"],
                                       epoch_seconds=epoch_end - start, words_per_s=wps,
                                       wall_seconds=wall, launches=nonzero(counts))
    print(json.dumps({"cli": report}))
    return runs


PROFILE_SESSIONS = 3  # profiled runs of one call before an empty trace fails


def ranker_model(backend, items=RANKER["items"]):
    from vmlmf_tpu_torch.serve.ranker import SessionRanker

    return SessionRanker.create(items, hidden_size=RANKER["hidden"], num_layers=1,
                                w_rank=RANKER["rank"], u_rank=RANKER["rank"], backend=backend)


def median_event_ms(torch, fn, calls):
    """The median over `calls` calls of fn() of each call's CUDA-event time."""
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def serving_rate(torch, ranker, params):
    """Sessions/s of chained `rank_next` calls: each call's next batch is the
    last one shifted by a step, with each session's top item appended."""
    n, t, b = ranker.num_items, RANKER["t"], RANKER["b"]
    g = torch.Generator().manual_seed(3)
    state = {"sess": torch.randint(0, n, (t, b), generator=g).cuda()}

    def call():
        with torch.no_grad():
            _, top = ranker.rank_next(params, state["sess"], RANKER["k"])
        state["sess"] = torch.cat([state["sess"][1:], top[:, :1].T.long() % n])

    for _ in range(2):
        call()
    ms = median_event_ms(torch, call, RANKER["serve_calls"])
    print(f"ranker: serving at N={n}: {ms:.3f} ms a call (median of {RANKER['serve_calls']} "
          f"chained), {b / ms * 1e3:.1f} sessions/s")
    return dict(call_ms=ms, sessions_per_s=b / ms * 1e3)


def topk_times(torch, ranker, params, h):
    """The full-row torch.topk against blocked_topk on the score rows of h:
    equal values (and ids) and the ms of each."""
    from vmlmf_tpu_torch.serve.ranker import blocked_topk

    k = RANKER["k"]
    with torch.no_grad():
        scores = ranker.score(params, h)
    full_v, full_i = torch.topk(scores, k)
    blk_v, blk_i = blocked_topk(scores, k)
    if not torch.equal(full_v, blk_v) or not torch.equal(full_i.int(), blk_i):
        fail(f"blocked_topk disagrees with torch.topk at N={ranker.num_items}")
    full_ms = cuda_ms(torch, lambda: torch.topk(scores, k), 20)
    blk_ms = cuda_ms(torch, lambda: blocked_topk(scores, k), 20)
    print(f"ranker: top-{k} of [{scores.shape[0]}, {scores.shape[1]}] scores: torch.topk "
          f"{full_ms:.4f} ms, blocked_topk {blk_ms:.4f} ms")
    return dict(full_row_ms=full_ms, blocked_ms=blk_ms)


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clone_tree(v) for v in tree]
    return tree.detach().clone()


def phase_ranker(torch):
    """-> the launch counts of the ranker's serving and training paths."""
    from vmlmf_tpu_torch.utils.tree import tree_leaves

    n, t, b, k, chunks = (RANKER[key] for key in ("items", "t", "b", "k", "chunks"))
    fused, loop = ranker_model("fused"), ranker_model("loop")
    params = fused.init(torch.Generator().manual_seed(0), device="cuda")
    sess = torch.randint(0, n, (t, b), generator=torch.Generator().manual_seed(1)).cuda()

    # -- serving: the main path, with the launch counts read around it
    reset_launch_counts()
    with torch.no_grad():
        vals, top = fused.rank_next(params, sess, k)
    torch.cuda.synchronize()
    serve_launches = launch_counts()
    print(f"ranker: rank_next launches {nonzero(serve_launches)}")
    if serve_launches != only(lstm_scan_xin_fwd=1):
        fail(f"a rank_next call must launch the no-grad scan once: {serve_launches}")
    with torch.no_grad():
        lvals, ltop = loop.rank_next(params, sess, k)
    ok, err = close(torch, vals, lvals)
    same = torch.equal(top, ltop)
    print(f"ranker: fused vs loop rank_next at N={n}, B={b}, k={k}: ids equal {same}, scores "
          f"max abs err {err:.3g} (tol {TOL})")
    if not (ok and same) or top.dtype != torch.int32:
        fail("the fused ranker disagrees with the loop backend")
    perf = {"serve": {str(n): serving_rate(torch, fused, params)}}
    with torch.no_grad():
        h, _ = fused.encode(params, sess)
    perf["topk"] = {str(n): topk_times(torch, fused, params, h)}
    big = ranker_model("fused", RANKER["items_big"])
    gen = torch.Generator(device="cuda").manual_seed(4)
    nb = RANKER["items_big"]
    big_params = {"embed": {"w": torch.empty(nb, RANKER["hidden"], device="cuda").uniform_(
                      -0.05, 0.05, generator=gen)},
                  "rnn": params["rnn"],
                  "fc": {"b": torch.empty(nb, device="cuda").uniform_(-0.05, 0.05,
                                                                       generator=gen)}}
    perf["serve"][str(nb)] = serving_rate(torch, big, big_params)
    perf["topk"][str(nb)] = topk_times(torch, big, big_params, h)
    del big_params

    # -- training: the sparse trainer, 8 chunks a call
    kw = dict(batch_size=b, seq_length=t, sampled_softmax=RANKER["negatives"],
              in_batch_negatives=True)
    sparse = fused.sparse_trainer(**kw)
    g = torch.Generator().manual_seed(5)
    xs = torch.randint(0, n, (chunks, t, b), generator=g).cuda()
    ys = torch.randint(0, n, (chunks, t, b), generator=g).cuda()
    negs = torch.randint(0, n, (chunks, RANKER["negatives"]), generator=g).cuda()
    p0 = sparse.init()
    p_train, s = clone_tree(p0), sparse.state0()
    reset_launch_counts()
    p_train, s, losses, gnorms = sparse.fused_chunks(p_train, s, xs, ys, 0.1, negatives=negs)
    torch.cuda.synchronize()
    train_launches = launch_counts()
    print(f"ranker: sparse trainer, {chunks} chunks: launches {nonzero(train_launches)}, "
          f"loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f}, last gnorm "
          f"{float(gnorms[-1]):.4f}")
    if train_launches != only(lstm_scan_xin_fwd_res=chunks, lstm_scan_xin_bwd=chunks):
        fail(f"each chunk must launch the residual forward and the BPTT once: {train_launches}")
    if not bool(torch.isfinite(losses).all()):
        fail(f"sparse trainer losses {losses.tolist()}")

    def fused_call():
        sparse.fused_chunks(p_train, s, xs, ys, 0.1, negatives=negs)

    fused_call()
    ms = median_event_ms(torch, fused_call, 5)
    perf["train"] = dict(call_ms=ms, chunks=chunks, sessions_per_s=chunks * b / ms * 1e3)
    print(f"ranker: sparse training, {ms:.3f} ms a call of {chunks} chunks (median of 5), "
          f"{perf['train']['sessions_per_s']:.1f} sessions/s")

    # -- the sparse steps against the dense sampled trainer on the same negatives
    dense = fused.trainer(**kw)
    pd, ps = clone_tree(p0), clone_tree(p0)
    sd, ss = dense.state0(), sparse.state0()
    worst = 0.0
    for i in range(3):
        pd, sd, ld, gd = dense.train_step(pd, sd, xs[i], ys[i], 0.1, negatives=negs[i])
        ps, ss, ls, gs = sparse.train_step(ps, ss, xs[i], ys[i], 0.1, negatives=negs[i])
        rel = max(abs(float(ld) - float(ls)) / abs(float(ld)),
                  abs(float(gd) - float(gs)) / abs(float(gd)))
        worst = max(worst, rel)
    ok, err = all_close(torch, [p.detach() for p in tree_leaves(ps)],
                        [p.detach() for p in tree_leaves(pd)], TOL)
    print(f"ranker: sparse vs dense sampled trainer over 3 steps: loss/gnorm largest relative "
          f"diff {worst:.3g} (tol 1e-5), parameters max abs err {err:.3g} (tol {TOL})")
    if not (worst <= 1e-5 and ok):
        fail("the sparse trainer disagrees with the dense sampled trainer")
    # two equal steps, equal bits (sorted, deterministic scatter-adds)
    outs = []
    for _ in range(2):
        p = clone_tree(p0)
        p, _, loss, gnorm = sparse.train_step(p, sparse.state0(), xs[0], ys[0], 0.1,
                                              negatives=negs[0])
        outs.append([loss, gnorm] + tree_leaves(p))
    equal = all(torch.equal(a, c) for a, c in zip(*outs))
    print(f"ranker: two equal sparse steps give equal bits: {equal} (tol 0)")
    if not equal:
        fail("two equal sparse steps differ")

    def step():
        sparse.train_step(p_train, s, xs[0], ys[0], 0.1, negatives=negs[0])

    perf["train"]["step_peak_mib"] = peak_step_mib(torch, step)
    tr = trace_step(torch, f"ranker sparse train step at B={b}", step)
    perf["train"]["trace"] = dict(tr, idle_share=1 - tr["busy_ms"] / tr["wall_ms"])
    print(f"ranker: train step peak {perf['train']['step_peak_mib']:.1f} MiB")
    print(json.dumps({"ranker": perf}))
    return [("lstm:lowrank", serve_launches), ("lstm:lowrank", train_launches)]


GRAPH = dict(chunks=8, decode_steps=64, beam_steps=16, beams=4, top_k=40, ppl_chunks=16,
             prefills=16, adam_steps=20, repeats=3, traced=16)


def graph_trace(torch, label, run, pad=0):
    """One profiled run() -> (Counter of the port's kernels by name, device
    busy ms), with the launches counted over the same run: its trace must
    hold one main kernel of the port for each. The window is padded
    (`profiler_pad`, 8 spin kernels and ``pad`` more at each edge: late in
    a run, 4 to 6 left an eager HAR GRU block's trace one or two of its
    first kernels short in every session); a session whose trace still
    lost kernel events is run again, with 8 more spin kernels at each edge
    (an identical session lost the same event again), up to
    PROFILE_SESSIONS sessions, and the script fails if each lost some."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    for session in range(1, PROFILE_SESSIONS + 1):
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiler_pad(torch, 8 * session + pad)
            run()
            torch.cuda.synchronize()
            profiler_pad(torch, 8 * session + pad)
        counts = launch_counts()
        launches = sum(counts.values())
        events = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
                  if is_device_work(e)]
        main = sum(1 for name, _ in events if any(k in name for k in MAIN_KERNELS))
        port = collections.Counter(name for name, _ in events if kernel_group(name) == "port")
        if main == launches:
            if session > 1:
                print(f"profiler: {label}: the trace agrees with the counters in session "
                      f"{session} of {PROFILE_SESSIONS}")
            return port, sum(ms for _, ms in events)
        print(f"profiler: {label}: session {session}'s trace holds {main} main kernels of the "
              f"port, the counters {launches} ({nonzero(counts)}; the trace's port kernels "
              f"{dict(port)})")
    fail(f"graphs: {label}: no trace of a run agrees with its {launches} counted launches")


def graph_side(torch, run, steps):
    """One side (eager or graphed) of a path: ``run(n)`` takes n steps, and
    one run was made already. -> dict of the launch counts of a run of
    ``steps`` steps and the memory it held at its peak beyond what was live
    (MiB); wall ms a step (the median of GRAPH["repeats"] CUDA-event timed
    runs of ``steps`` steps)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    run(steps)
    torch.cuda.synchronize()
    counts = launch_counts()
    memory = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    wall = median_event_ms(torch, lambda: run(steps), GRAPH["repeats"]) / steps
    return dict(counts=counts, wall_ms=wall, memory_mib=memory)


def traced_sides(torch, label, sides, steps):
    """A `graph_trace` of a run of at most GRAPH["traced"] steps of each of
    ``sides`` = {"eager": run, "graphed": run}, whose traces must hold the
    same kernels of the port. A pair that disagrees (a trace lost an event
    that the counters cannot show, a kernel other than a main one) is traced
    again, up to PROFILE_SESSIONS pairs, each with more padding than the one
    before and its sides in the other order (late in a run, identical pairs
    lost the same non-main event of the eager side three times); the script
    fails if each pair disagreed. -> {side: (port kernels, busy ms a step)}."""
    traced = min(steps, GRAPH["traced"])
    for pair in range(1, PROFILE_SESSIONS + 1):
        order = list(sides.items()) if pair % 2 else list(sides.items())[::-1]
        out = {side: graph_trace(torch, f"{label} ({side})", lambda run=run: run(traced),
                                 pad=4 * (pair - 1))
               for side, run in order}
        ports = [port for port, _ in out.values()]
        if all(port == ports[0] for port in ports):
            if pair > 1:
                print(f"profiler: {label}: the traces agree in pair {pair} of {PROFILE_SESSIONS}")
            return {side: (port, busy / traced) for side, (port, busy) in out.items()}
        print(f"profiler: {label}: pair {pair}'s traces hold other kernels of the port: "
              + "; ".join(f"{side} {dict(port)}" for side, (port, _) in out.items()))
    fail(f"graphs: {label}: no pair of traces agrees")


def graph_compare(torch, label, eager, graphed, steps, outs, graph, extra=None):
    """Hold a graphed path to its eager loop: ``outs`` = (eager outputs,
    graphed outputs), equal bit for bit; each side's `graph_side` over
    ``eager(n)`` and ``graphed(n)``, runs of n steps, whose launch counts
    must agree, and `traced_sides`, whose traced kernels must agree.
    ``graph``: the path's `StepGraph`. -> (its report, the graphed side's
    launch counts over ``steps`` steps)."""
    equal = trees_equal(torch, *outs)
    if not equal:
        fail(f"graphs: {label}: the graphed path's results differ from the eager loop's")
    e, g = graph_side(torch, eager, steps), graph_side(torch, graphed, steps)
    if e["counts"] != g["counts"]:
        fail(f"graphs: {label}: a replayed step launches {nonzero(g['counts'])}, the eager step "
             f"{nonzero(e['counts'])}")
    traces = traced_sides(torch, label, {"eager": eager, "graphed": graphed}, steps)
    for side, d in (("eager", e), ("graphed", g)):
        d["busy_ms"] = traces[side][1]
        d["idle_share"] = 1 - d["busy_ms"] / d["wall_ms"]
    runs = nonzero(g["counts"])
    out = dict(bit_equal=equal, steps=steps, launches_a_run=runs, capture_s=graph.capture_seconds,
               graph_pool_mib=graph.pool_bytes / 2 ** 20, **(extra or {}))
    for side, d in (("eager", e), ("graphed", g)):
        out[side] = {k: d[k] for k in ("wall_ms", "busy_ms", "idle_share", "memory_mib")}
    print(f"graphs: {label}: graphed bit-equal to eager {equal}; launches in a run of {steps} "
          f"steps {runs}, the eager run's (and the traces agree); capture "
          f"{graph.capture_seconds:.3f} s; wall ms a step "
          f"eager {e['wall_ms']:.4f} / graphed {g['wall_ms']:.4f}, busy {e['busy_ms']:.4f} / "
          f"{g['busy_ms']:.4f}, idle share {e['idle_share']:.3f} / {g['idle_share']:.3f}; "
          f"MiB a run holds above what was live eager {e['memory_mib']:.1f} / graphed "
          f"{g['memory_mib']:.1f}, graph pool {out['graph_pool_mib']:.1f} MiB"
          + "".join(f"; {k} {v}" for k, v in (extra or {}).items()))
    return out, g["counts"]


def eager_steps(module):
    """A context in which ``module``'s graphed paths run their step eagerly
    (its `on_card` reads False): the eager loop a graph is held to."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = module.on_card
        module.on_card = lambda device: False
        try:
            yield
        finally:
            module.on_card = saved

    return ctx()


def on_mesh(label, mesh):
    return label + (" on a 1x1 mesh" if mesh is not None else "")


def graph_lm(torch, backend, b, mesh=None, model=None, label="LM"):
    """`LMTrainer._fused_chunks` (fit's block) over GRAPH["chunks"] chunks at
    dropout 0.5 (or of ``model``), against the step loop from equal
    generators; under ``mesh`` with its collectives. -> (report, launch
    counts, a copy of the graphed run's results)."""
    from vmlmf_tpu_torch.train import lm
    from vmlmf_tpu_torch.train.lm import LMTrainer

    k = GRAPH["chunks"]
    if model is None:
        model = lm_model(backend, 0.5) if backend == "fused" else wavefront_lm(backend)
    trainer = LMTrainer(model, batch_size=b, seq_length=LM["prompt"], fuse_chunks=k, mesh=mesh)
    trn, _ = lm_chunks(b)
    xs, ys = trainer.commit_batch(*(torch.stack([torch.as_tensor(c[i]) for c in trn[:k]])
                                    for i in (0, 1)), stacked=True)
    sides = []
    for graphed in (False, True):
        params, states = trainer.init(), trainer.state0()
        gen = torch.Generator(device="cuda").manual_seed(1)
        if graphed:
            out = trainer._fused_chunks(params, states, xs, ys, 1.0, gen)
        else:
            with eager_steps(lm):
                out = trainer._fused_chunks(params, states, xs, ys, 1.0, gen)
        sides.append((out, params, states, gen))
    graph = trainer._graphs["train"][1].graph
    (_, pe, se, ge), (_, pg, sg, gg) = sides
    result = clone_tree(sides[1][0])

    def eager(n):
        with eager_steps(lm):
            trainer._fused_chunks(pe, se, xs[:n], ys[:n], 1.0, ge)

    return (*graph_compare(torch, on_mesh(f"{label} {backend} block of {k} chunks at B={b}",
                                          mesh),
                           eager,
                           lambda n: trainer._fused_chunks(pg, sg, xs[:n], ys[:n], 1.0, gg), k,
                           [sides[0][0], sides[1][0]], graph), result)


def graph_ppl(torch, mesh=None):
    from vmlmf_tpu_torch.train import lm
    from vmlmf_tpu_torch.train.lm import LMTrainer

    n = GRAPH["ppl_chunks"]
    trainer = LMTrainer(lm_model("fused", 0.5), batch_size=MAIN_BATCH, seq_length=LM["prompt"],
                        mesh=mesh)
    params = trainer.init()
    _, vld = lm_chunks(MAIN_BATCH)
    chunks = vld[:n]
    with eager_steps(lm):
        want = trainer.perplexity(params, chunks)
    got = trainer.perplexity(params, chunks)

    def eager(m):
        with eager_steps(lm):
            trainer.perplexity(params, chunks[:m])

    return (*graph_compare(torch, on_mesh(f"perplexity over {n} chunks at B={MAIN_BATCH}", mesh),
                           eager, lambda m: trainer.perplexity(params, chunks[:m]), n,
                           [torch.tensor(want), torch.tensor(got)],
                           trainer._graphs["eval"][1].graph, dict(perplexity=got)),
            torch.tensor(got))


def graph_decode(torch, model, params, b, mode):
    """Greedy or top-k decode, or beam search, graphed against the same step
    eagerly; tokens/s of each. A run of n steps is a call of n tokens (beam
    search: n + 1, its prefill and first pick included)."""
    from vmlmf_tpu_torch.serve import Decoder, decoder

    prompt = prompt_ids(torch, b)
    dec, plain = Decoder(model), Decoder(model)
    if mode == "beam":
        steps = GRAPH["beam_steps"] - 1

        def call(d, n):
            return d.beam_search(params, prompt, steps=n + 1, beams=GRAPH["beams"])
    else:
        steps = GRAPH["decode_steps"]
        logits, states = dec.prefill(params, prompt, model.state0(b, "cuda"))
        kw = {} if mode == "greedy" else dict(temperature=0.8, top_k=GRAPH["top_k"])

        def call(d, n):
            gen = torch.Generator(device="cuda").manual_seed(3)
            return d.decode(params, logits, states, steps=n, return_logits=True,
                            generator=gen if kw else None, **kw)

    got = call(dec, steps)
    with eager_steps(decoder):
        want = call(plain, steps)

    def eager(n):
        with eager_steps(decoder):
            call(plain, n)

    label = f"{'beam search' if mode == 'beam' else mode + ' decode'} at B={b}"
    (step,) = dec._graphs.values()
    report, counts = graph_compare(torch, label, eager, lambda n: call(dec, n), steps,
                                   [want, got], step.run)
    if mode != "beam":
        for side in ("eager", "graphed"):
            report[side]["tokens_per_s"] = b / report[side]["wall_ms"] * 1e3
        print(f"graphs: {label}: tokens/s eager {report['eager']['tokens_per_s']:.1f}, graphed "
              f"{report['graphed']['tokens_per_s']:.1f} (a call of {steps} tokens, its "
              f"per-call work included)")
    return report, counts


def graph_prefill(torch, label, model, params, b):
    """`Decoder.prefill` of a T=35 prompt, graphed against the same prefill
    run eagerly; the graphed side's results are taken from a replay (after
    `WARMUP` eager calls and the capture). A run of n steps is n calls."""
    from vmlmf_tpu_torch.serve import Decoder, decoder
    from vmlmf_tpu_torch.utils.graphs import WARMUP

    prompt = prompt_ids(torch, b)
    states = model.state0(b, "cuda")
    dec, plain = Decoder(model), Decoder(model)

    def calls(d, n):
        return [d.prefill(params, prompt, states) for _ in range(n)][-1]

    got = calls(dec, WARMUP + 2)
    (step,) = dec._prefills.values()
    if not step.run.captured:
        fail(f"graphs: prefill {label} at B={b}: no graph was captured")
    with eager_steps(decoder):
        want = calls(plain, 1)

    def eager(n):
        with eager_steps(decoder):
            calls(plain, n)

    return graph_compare(torch, f"prefill {label} at B={b}", eager, lambda n: calls(dec, n),
                         GRAPH["prefills"], [want, got], step.run)


def graph_prefills(torch, report):
    """Prefill graphed against eager at B = 1/20/128 on "fused" and on
    "fused_pipelined", and at B=20 in the mixed precision of "bf16+head"
    (every launch of the "bf16" variant) -> runs for the kernels line."""
    runs = []
    for label, form, make, env in (
            ("fused", "lstm:lowrank", lambda: lm_model("fused"), {}),
            ("fused_pipelined", "lstm_stack:lowrank",
             lambda: wavefront_lm("fused_pipelined", dropout=0.0), {}),
            ("mixed bf16+head", "lstm:bf16", lambda: mixed_lm(dropout=0.0),
             dict(VMLMF_PALLAS_PRECISION="bf16"))):
        with switches(**env):
            model = make()
            params = model.init(torch.Generator().manual_seed(0), device="cuda")
            for b in LM_BATCHES if not env else (MAIN_BATCH,):
                report[f"prefill_{form}_b{b}"], counts = graph_prefill(torch, label, model,
                                                                      params, b)
                if env:
                    only_variant("bf16")
                runs.append((form, counts))
    return runs


def graph_har(torch, name, mesh=None):
    """A block of `fuse_batches` (64) HAR Adam steps at B=81 through
    `HARTrainer._fused_steps`, against the step loop; under ``mesh`` with its
    collectives."""
    from vmlmf_tpu_torch.train import har
    from vmlmf_tpu_torch.train.har import HARTrainer

    b = HAR["b"]
    trainer = HARTrainer(har_model(name), batch_size=b, mesh=mesh)
    k = trainer.fuse_batches
    g = torch.Generator().manual_seed(7)
    xs, ys = trainer.commit_batch(torch.randn((k, b, HAR["t"], HAR["f"]), generator=g),
                                  torch.randint(0, 18, (k, b), generator=g), stacked=True)
    (pe, oe), (pg, og) = trainer.init(), trainer.init()
    with eager_steps(har):
        want = trainer._fused_steps(pe, oe, xs, ys)
    got = trainer._fused_steps(pg, og, xs, ys)
    state = [[s for st in o.state.values() for s in st.values()] for o in (oe, og)]
    want, got = (out[0::2] for out in (want, got))  # (params, losses)
    result = clone_tree([got, state[1]])

    def eager(n):
        with eager_steps(har):
            trainer._fused_steps(pe, oe, xs[:n], ys[:n])

    return (*graph_compare(torch, on_mesh(f"HAR {name} block of {k} steps at B={b}", mesh),
                           eager, lambda n: trainer._fused_steps(pg, og, xs[:n], ys[:n]), k,
                           [[want, state[0]], [got, state[1]]], trainer._graph[1].graph),
            result)


def adam_capturable_vs_default(torch):
    """GRAPH["adam_steps"] HAR flagship steps with the capturable Adam (the
    port's on CUDA) and with the default one, from one init: the relative
    difference of the parameters (as one vector, and of the worst tensor)."""
    from vmlmf_tpu_torch.train.har import HARTrainer
    from vmlmf_tpu_torch.utils.tree import trainable_leaves

    trainer = HARTrainer(har_model("vmlmf"), batch_size=HAR["b"])
    g = torch.Generator().manual_seed(8)
    xs = torch.randn((GRAPH["adam_steps"], HAR["b"], HAR["t"], HAR["f"]), generator=g).cuda()
    ys = torch.randint(0, 18, (GRAPH["adam_steps"], HAR["b"]), generator=g).cuda()
    finals = []
    for capturable in (True, False):
        params, opt = trainer.init()
        if not capturable:
            opt = torch.optim.Adam(trainable_leaves(params), lr=trainer.learning_rate)
        if opt.defaults["capturable"] != capturable:
            fail("HARTrainer.optimizer must build a capturable Adam on CUDA")
        for x, y in zip(xs, ys):
            params, opt, _ = trainer.train_step(params, opt, x, y)
        finals.append([p.detach() for p in trainable_leaves(params)])
    got, want = finals
    # the bias corrections are f32 on the card in the one, double on the host in
    # the other: a step's last bits differ, and the steps carry the difference
    rel = dict(
        parameters=float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(got, want)))
                         / torch.sqrt(sum((b ** 2).sum() for b in want))),
        worst_tensor_norm=max(float((a - b).norm() / b.norm()) for a, b in zip(got, want)),
        worst_tensor_max=max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(got, want)))
    print(f"graphs: capturable Adam vs the default Adam over {GRAPH['adam_steps']} HAR steps: "
          f"||diff|| / ||default|| over the parameters {rel['parameters']:.3g} (tol 1e-6); "
          f"the worst tensor's {rel['worst_tensor_norm']:.3g}, its max|diff| / max|default| "
          f"{rel['worst_tensor_max']:.3g}")
    if not rel["parameters"] <= 1e-6:
        fail(f"the capturable Adam parts from the default one: {rel}")
    return rel


def graph_ranker(torch, mesh=None):
    """`SparseSampledTrainer.fused_chunks` at the bench config, negatives
    drawn by the trainer's generator, against the step loop; under ``mesh``
    with its collectives (the negatives broadcast from rank 0)."""
    from vmlmf_tpu_torch.serve import ranker as rk

    n, t, b, chunks = (RANKER[key] for key in ("items", "t", "b", "chunks"))
    sparse = ranker_model("fused").sparse_trainer(batch_size=b, seq_length=t,
                                                  sampled_softmax=RANKER["negatives"],
                                                  fuse_chunks=chunks, mesh=mesh)
    g = torch.Generator().manual_seed(5)
    xs, ys = sparse.commit_batch(torch.randint(0, n, (chunks, t, b), generator=g),
                                 torch.randint(0, n, (chunks, t, b), generator=g), stacked=True)
    sides = []
    for graphed in (False, True):
        p, s = sparse.init(), sparse.state0()
        gen = torch.Generator(device="cuda").manual_seed(6)
        if graphed:
            out = sparse.fused_chunks(p, s, xs, ys, 0.1, gen)
        else:
            with eager_steps(rk):
                out = sparse.fused_chunks(p, s, xs, ys, 0.1, gen)
        sides.append((out, p, s, gen))
    (_, pe, se, ge), (_, pg, sg, gg) = sides
    result = clone_tree(sides[1][0])

    def eager(n):
        with eager_steps(rk):
            sparse.fused_chunks(pe, se, xs[:n], ys[:n], 0.1, ge)

    return (*graph_compare(
        torch, on_mesh(f"ranker sparse fused_chunks, {chunks} chunks at N={n}, B={b}", mesh),
        eager, lambda n: sparse.fused_chunks(pg, sg, xs[:n], ys[:n], 0.1, gg), chunks,
        [sides[0][0], sides[1][0]], sparse._graph[1].graph), result)


# the paths that run again on a 1x1 mesh in `phase_parallel`: (name, form,
# graph_* function, its arguments)
MESH_PATHS = (("lm_fused_b20", "lstm:lowrank", graph_lm, ("fused", MAIN_BATCH)),
              ("lm_fused_b128", "lstm:lowrank", graph_lm, ("fused", TRAIN_BATCHES[-1])),
              ("perplexity", "lstm:lowrank", graph_ppl, ()),
              ("har_vmlmf", "lstm:lowrank", graph_har, ("vmlmf",)),
              ("har_gru_main", "gru:lowrank_pre", graph_har, ("gru_main",)),
              ("ranker", "lstm:lowrank", graph_ranker, ()))


def phase_graphs(torch):
    """The one-dispatch-per-many-steps paths as CUDA graphs, each held bit for
    bit to its eager loop. -> (runs for the kernels line, {path: a copy of
    its graphed results} of `MESH_PATHS`)."""
    t0 = time.perf_counter()
    report, runs, results = {}, [], {}
    for name, form, fn, args in MESH_PATHS:
        report[name], counts, results[name] = fn(torch, *args)
        runs.append((form, counts))
    report["lm_fused_pipelined_b20"], counts, _ = graph_lm(torch, "fused_pipelined", MAIN_BATCH)
    runs.append(("lstm_stack:lowrank", counts))
    model = lm_model("fused")
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    for mode, b in [("greedy", b) for b in LM_BATCHES] + [("top_k", MAIN_BATCH),
                                                          ("beam", MAIN_BATCH)]:
        report[f"{mode}_b{b}"], _ = graph_decode(torch, model, params, b, mode)
    runs += graph_prefills(torch, report)
    report["adam_capturable_vs_default"] = adam_capturable_vs_default(torch)
    print(f"graphs: phase done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"graphs": report}))
    return runs, results


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def trees_equal(torch, a, b):
    from vmlmf_tpu_torch.utils.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def phase_parallel(torch, no_mesh):
    """The parallel layer on NCCL at world size 1, then the graphed paths on
    a 1x1 mesh (`mesh_graphs`) -> runs for the kernels line."""
    import gc

    import torch.distributed as dist

    from vmlmf_tpu_torch.data.har import synthetic_har
    from vmlmf_tpu_torch.parallel import mesh as pmesh
    from vmlmf_tpu_torch.parallel.dryrun import dryrun_multichip
    from vmlmf_tpu_torch.train.har import HARTrainer
    from vmlmf_tpu_torch.train.lm import LMTrainer

    pmesh.initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0, device_type="cuda", timeout=120)
    try:
        print(f"parallel: backend {dist.get_backend()}, world {dist.get_world_size()}")
        out = dryrun_multichip(1)
        print(f"parallel: dryrun_multichip(1) losses {out}")
        if out["pipeline"] is not None:
            fail("phase 2 of the dry run needs two ranks on 'model'")
        mesh = pmesh.make_mesh(1, 1)

        trn, _ = lm_chunks(MAIN_BATCH)
        model = lm_model("fused", dropout_rate=0.5)
        results = []
        for m in (None, mesh):
            t = LMTrainer(model, batch_size=MAIN_BATCH, seq_length=LM["prompt"], mesh=m)
            p, st = t.init(), t.state0()
            x, y = t.commit_batch(*trn[0]) if m is not None else trn[0]
            gen = torch.Generator(device="cuda").manual_seed(5)
            p, st, loss, gnorm = t.train_step(p, st, x, y, 1.0, gen)
            results.append((p, st, loss, gnorm))
        (p0, s0, l0, g0), (p1, s1, l1, g1) = results
        lm_equal = (torch.equal(l0, l1) and torch.equal(g0, g1) and trees_equal(torch, p0, p1)
                    and trees_equal(torch, s0, s1))
        print(f"parallel: LM step with a 1x1 mesh bit-equal to the step without: {lm_equal} "
              f"(loss {float(l1):.6f}, gnorm {float(g1):.6f})")

        x, y, _, _ = synthetic_har("opp", n_train=HAR["b"], n_test=1, seed=2)
        har = []
        for m in (None, mesh):
            t = HARTrainer(har_model("vmlmf"), batch_size=HAR["b"], mesh=m)
            p, opt = t.init()
            xb, yb = t.commit_batch(x, y) if m is not None else (x, y)
            for _ in range(2):
                p, opt, loss = t.train_step(p, opt, xb, yb)
            har.append((p, loss))
        har_equal = trees_equal(torch, har[0][0], har[1][0]) and torch.equal(har[0][1], har[1][1])
        print(f"parallel: HAR (two Adam steps) with a 1x1 mesh bit-equal to without: "
              f"{har_equal}")

        ranker = ranker_model("fused")
        params = ranker.init(torch.Generator().manual_seed(0), device="cuda")
        sess = torch.randint(0, ranker.num_items, (RANKER["t"], RANKER["b"]),
                             generator=torch.Generator().manual_seed(1)).cuda()
        with torch.no_grad():
            h, _ = ranker.encode(params, sess)
            want = ranker.topk(params, h, RANKER["k"], exclude=sess)
            got = ranker.topk_sharded(params, h, RANKER["k"], mesh, exclude=sess)
        topk_equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        print(f"parallel: topk_sharded at S=1 bit-equal to topk: {topk_equal}")
        if not (lm_equal and har_equal and topk_equal):
            fail("a step or a retrieval with a one-rank mesh differs from the one without")
        return mesh_graphs(torch, mesh, no_mesh)
    finally:
        gc.collect()  # the mesh graphs, which hold NCCL work, go before their group
        torch.cuda.synchronize()
        dist.destroy_process_group()


def mesh_graphs(torch, mesh, no_mesh):
    """`MESH_PATHS` graphed on ``mesh``, their NCCL collectives captured: each
    held bit for bit to its eager steps on the mesh (`graph_compare`, equal
    launch counts too) and to ``no_mesh``, the graphed results of the same
    path without a mesh (`phase_graphs`). -> runs for the kernels line."""
    t0 = time.perf_counter()
    report, runs = {}, []
    for name, form, fn, args in MESH_PATHS:
        report[name], counts, result = fn(torch, *args, mesh=mesh)
        equal = trees_equal(torch, result, no_mesh[name])
        print(f"parallel: {name} graphed on the 1x1 mesh bit-equal to graphed without: {equal}")
        if not equal:
            fail(f"parallel: {name}: the graphed path on a 1x1 mesh differs from the one without")
        report[name]["bit_equal_to_no_mesh"] = equal
        runs.append((form, counts))
    print(f"parallel: the mesh graphs done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"mesh_graphs": report}))
    return runs


def profiler_pad(torch, kernels=4):
    """A few `torch.cuda._sleep` kernels, synchronised: each profiler session
    opens and closes with them, so that no kernel of the work traced falls at
    an edge of the window, where the trace can lose events. Each spins about
    60 µs: spins of 6 µs left a graphed HAR GRU block's trace short of up to
    half its main kernels."""
    for _ in range(kernels):
        torch.cuda._sleep(100_000)
    torch.cuda.synchronize()


def is_device_work(event):
    """Whether a profiler event is work on the card: a kernel, copy or set;
    not a range a `record_function` draws on the device's timeline (as
    `Optimizer.step` does), which spans the gaps between kernels too, and
    not `profiler_pad`'s spin kernels."""
    from torch.autograd import DeviceType

    return (event.device_type == DeviceType.CUDA and "spin_kernel" not in event.name
            and not getattr(event, "is_user_annotation", False))


def device_events(torch, run, label, cpu=True):
    """run() once warm, then once under torch.profiler -> ([(kernel name, ms)]
    of its device events, wall ms of the profiled run). A session that
    recorded no device event at all is run again, up to PROFILE_SESSIONS
    sessions; fails if each came back empty."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    for session in range(1, PROFILE_SESSIONS + 1):
        with profile(activities=activities) as prof:
            profiler_pad(torch)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            profiler_pad(torch)
        events = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
                  if is_device_work(e)]
        if events:
            if session > 1:
                print(f"profiler: {label}: device events in session {session} of "
                      f"{PROFILE_SESSIONS}, none in the ones before")
            return events, wall_ms
    fail(f"trace: the profiler recorded no device time in one {label} in "
         f"{PROFILE_SESSIONS} sessions")


# the kernel each counted launch of an entry runs once (`stack_fwd_kernel`
# holds "fwd_kernel", the GRU forward's name)
MAIN_KERNELS = ("grid_scan_kernel", "grid_bptt_kernel", "fwd_kernel", "walk_kernel",
                "stack_bwd_kernel")


def kernel_group(name):
    """"port", "cublas" or "other": whose kernel a trace event is."""
    # "scan_kernel" and "bptt_kernel" also match the LSTM scans'
    # grid_scan_kernel and grid_bptt_kernel, "fwd_kernel" the GRU's and the
    # stack's forward; "vmlmf::" the tiled GEMMs
    if any(s in name for s in ("scan_kernel", "bptt_kernel", "colsum_kernel", "vmlmf::",
                               "fwd_kernel", "walk_kernel", "stack_bwd_kernel",
                               "widen_kernel")):
        return "port"
    if any(s in name for s in ("gemm", "xmma", "cutlass", "cublas", "splitK")):
        return "cublas"
    return "other"


def trace_step(torch, label, step):
    """One profiled call of step(), after a warm one: device time by kernel,
    the port's against cuBLAS's -> dict(wall_ms, busy_ms, groups)."""
    events, wall_ms = device_events(torch, step, label)
    kernels = {}
    for name, ms in events:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += ms
    group = kernel_group
    groups = {}
    for name, (n, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1]):
        groups[group(name)] = groups.get(group(name), 0.0) + ms
        print(f"trace: {ms:9.4f} ms  x{n:<3d} [{group(name)}] {name[:110]}")
    busy = sum(groups.values())
    print(f"trace: one {label}, wall {wall_ms:.3f} ms, device busy {busy:.3f} ms (idle share "
          f"{1 - busy / wall_ms:.3f}), by group "
          + ", ".join(f"{g} {ms:.3f} ms" for g, ms in sorted(groups.items())))
    # the port's GEMM launches by tile: the LSTM scans' and the stack's
    # tensor-core tiles (csrc/gemm_tc.cuh: "wgmma" the Hopper tile's share)
    # and the CUDA-core one the GRU kernels keep
    tiles = {"tc": sum(n for name, (n, _) in kernels.items()
                       if "tc_gemm_kernel" in name or "wg_gemm_kernel" in name),
             "wgmma": sum(n for name, (n, _) in kernels.items() if "wg_gemm_kernel" in name),
             "cuda_core": sum(n for name, (n, _) in kernels.items()
                              if "vmlmf::gemm_kernel" in name
                              or "vmlmf::group_partial_kernel" in name)}
    return dict(wall_ms=wall_ms, busy_ms=busy, groups=groups, gemm_tiles=tiles)


def phase_trace(torch):
    """One profiled train step each of the LM at B=20, the main HAR GRU at B=81
    and the dense LM at B=20."""
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

    har = HARTrainer(har_model("gru_main"), batch_size=GRU["b"])
    har_params, opt = har.init()
    x, y, _, _ = synthetic_har("opp", n_train=GRU["b"], n_test=1, seed=2)
    gru = trace_step(torch, f"main HAR GRU train step at B={GRU['b']}",
                     lambda: har.train_step(har_params, opt, x, y))

    from vmlmf_tpu_torch.config import LMConfig

    cfg = LMConfig(lstm_type="custom", hidden_size=LM["hidden"], layer_num=LM["layers"])
    dense = LMTrainer(cfg.build_model(LM["vocab"]), batch_size=MAIN_BATCH,
                      seq_length=LM["prompt"])
    d_params, d_states = dense.init(), dense.state0()
    lm_dense = trace_step(torch, f"dense LM train step at B={MAIN_BATCH}",
                          lambda: dense.train_step(d_params, d_states, *trn[1], 1.0, generator))
    wave = LMTrainer(wavefront_lm("fused_pipelined"), batch_size=MAIN_BATCH,
                     seq_length=LM["prompt"])
    w_params, w_states = wave.init(), wave.state0()
    lm_wave = trace_step(torch, f"wavefront LM train step at B={MAIN_BATCH}",
                         lambda: wave.train_step(w_params, w_states, *trn[1], 1.0, generator))
    # the LSTM scans' and the stack's products run on the tensor cores, never
    # on the old tile, the LM layers' (the stack's dV and dVx) on the Hopper
    # tile
    for label, tr in (("LM", lm), ("dense LM", lm_dense), ("wavefront LM", lm_wave)):
        tiles = tr["gemm_tiles"]
        if tiles["tc"] == 0 or tiles["cuda_core"] or tiles["wgmma"] == 0:
            fail(f"trace: the {label} train step's GEMMs by tile: {tiles}; "
                 f"every product of its LSTM kernels runs csrc/gemm_tc.cuh, some on wgmma")
    print(json.dumps({"trace": dict(lm=lm, har_gru=gru, lm_dense=lm_dense, lm_wavefront=lm_wave)}))


def kernel_report(rows, runs):
    """The kernels line: one row per kernel entry and form that the main paths
    ran, with its launches there and the numbers of its kernel check. Fails
    if an entry of a listed form was never launched."""
    kernels = []
    for family, forms in FORMS.items():
        for form, (shape, b_nograd, b_train) in forms.items():
            for name in FAMILIES[family]:
                if name.endswith("_fwd") and b_nograd is None:
                    continue  # a residual policy: the no-grad entry has no such variant
                module = entries()[name][1]
                launches = sum(c[name] for f, c in runs if f == f"{family}:{form}")
                if launches == 0:
                    fail(f"{name} in form {form} was never launched on the main paths")
                bwd = name.endswith("_bwd")
                src = module.BWD_KERNEL if bwd else module.KERNEL
                # the row's numbers: the kernel check at this form's main-path
                # shape, at the batch its launches ran at (`evaluate`'s for the
                # no-grad entry of a HAR path, the train step's for the others)
                row = rows[(name, shape, b_nograd if name.endswith("_fwd") else b_train)]
                plain = form in FIRST_FORMS and family not in NAMED_FORMS
                kernels.append(dict(
                    name=name if plain else f"{name}[{form}]", route="cuda",
                    source=f"vmlmf_tpu_torch/csrc/{src}.cu",
                    replaces=module.BWD_REPLACES if bwd else module.REPLACES,
                    launches=launches, **row))
    return kernels


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

    os.environ["VMLMF_EXPERIMENTAL_WAVEFRONT"] = "1"  # the wavefront backends' knob
    # keep CUPTI initialised between the run's two dozen profiler sessions:
    # torn down and brought up again after each, it can come back recording
    # no device activity (Kineto reads this at the end of every session)
    os.environ["TEARDOWN_CUPTI"] = "0"
    t0 = time.perf_counter()
    card = phase_device(torch)
    phase_build()
    rows = phase_kernels(torch)
    rows.update(phase_gru_kernels(torch))
    runs = []
    for phase in (phase_serve, phase_train, phase_har, phase_har_gru, phase_bdnet,
                  phase_har_dense, phase_lm_dense, phase_reduced):
        runs += phase(torch)
    stack_rows, stack_runs = phase_wavefront(torch)
    rows.update(stack_rows)
    runs += stack_runs
    mixed_rows, mixed_runs = phase_mixed(torch)
    rows.update(mixed_rows)
    runs += mixed_runs
    rows.update(phase_gru_variant_kernels(torch))
    runs += phase_mixed_gru(torch)
    wave_rows, wave_runs = phase_mixed_wavefront(torch)
    rows.update(wave_rows)
    runs += wave_runs
    phase_plans(torch)
    runs += phase_cli(torch)
    runs += phase_ranker(torch)
    graph_runs, no_mesh = phase_graphs(torch)
    runs += graph_runs
    runs += phase_parallel(torch, no_mesh)
    phase_trace(torch)
    wide_rows, wide_runs = phase_wide(torch)
    rows.update(wide_rows)
    runs += wide_runs

    kernels = kernel_report(rows, runs)
    print(f"done in {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
