"""HAR CLI: train and test compressed RNN classifiers (counterpart of
`vmlmf_tpu.cli.har_main`, with the same flags and defaults).

    python -m vmlmf_tpu_torch.cli.har_main --model vmmodel --layer_sizes 180 \
        --wRank 8 --uRanks 6 --total --synthetic
    python -m vmlmf_tpu_torch.cli.har_main --model vmmodel --layer_sizes 180 \
        --wRank 8 --uRanks 6 --synthetic          # test the checkpoint it saved

Two departures from the JAX package's CLI:
  * ``--backend`` takes the port's names, "fused" (the default: the fused
    scan kernels), "loop", "fused_pipelined" and "pipelined" (the two
    wavefront backends need VMLMF_EXPERIMENTAL_WAVEFRONT=1); the JAX names
    are aliases: xla -> loop, pallas -> fused, pallas_pipelined ->
    fused_pipelined;
  * ``--device`` (default "cuda") names the device to run on; pass "cpu"
    to run the plain versions on the CPU.

A checkpoint goes to ``--ckpt_dir/<run_name>`` in the JAX package's npz
layout, so either package reads the other's.
"""

from __future__ import annotations

import argparse

import torch

from vmlmf_tpu_torch.cli import BACKENDS
from vmlmf_tpu_torch.config import HARConfig
from vmlmf_tpu_torch.data.har import load_or_synthesize
from vmlmf_tpu_torch.nn.recurrence import backend_name
from vmlmf_tpu_torch.train.checkpoint import load_checkpoint, run_name, save_checkpoint
from vmlmf_tpu_torch.train.har import HARTrainer, evaluate
from vmlmf_tpu_torch.utils.analytics import compression_report, count_params, model_flops


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Compressed-RNN HAR training on the GPU")
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--batch-size", "--batch_size", type=int, default=81)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--model", type=str, default="myLSTM")
    p.add_argument("--layer_sizes", type=int, nargs="+", default=[180])
    p.add_argument("--wRank", type=int, default=None)
    p.add_argument("--uRanks", type=int, nargs="+", default=None)
    p.add_argument("--group", type=int, default=2)
    p.add_argument("--bidirectional", action="store_true")
    p.add_argument("--concatingmode", type=str, default="concat",
                   choices=["concat", "sum", "avg"])
    p.add_argument("--deepconv", action="store_true")
    p.add_argument("-train", "--is_train", action="store_true")
    p.add_argument("--total", action="store_true", help="train then test in one run")
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--data", type=str, default="OPP", choices=["OPP", "UCI", "opp", "uci"])
    p.add_argument("--dataset_folder", type=str, default=None)
    p.add_argument("--channels", type=int, default=77, choices=[77, 113],
                   help="OPP variant: 77 (challenge) or 113 (legacy)")
    p.add_argument("--task", type=str, default="gestures", choices=["gestures", "locomotion"],
                   help="label column for the 113-channel OPP pipeline")
    p.add_argument("--synthetic", action="store_true",
                   help="use shape-faithful synthetic data (no dataset needed)")
    p.add_argument("--ckpt_dir", type=str, default="./trained_models")
    p.add_argument("--backend", type=backend_name, default="fused", choices=BACKENDS,
                   help="recurrence: the fused scan kernels, the plain loop, or a wavefront "
                        "backend (VMLMF_EXPERIMENTAL_WAVEFRONT=1); the JAX names xla, "
                        "pallas and pallas_pipelined are aliases")
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    cfg = HARConfig(
        model=args.model, layer_sizes=tuple(args.layer_sizes),
        w_rank=args.wRank,
        u_ranks=tuple(args.uRanks) if args.uRanks else None,
        groups=args.group, bidirectional=args.bidirectional,
        merge=args.concatingmode, deepconv=args.deepconv,
        data=args.data, dataset_folder=args.dataset_folder,
        channels=args.channels, task=args.task,
        lr=args.lr, batch_size=args.batch_size, max_epochs=args.max_epochs,
        seed=args.seed, is_train=args.is_train or args.total,
        backend=args.backend,
    )

    if cfg.task == "locomotion" and cfg.channels != 113:
        raise SystemExit(
            "--task locomotion requires --channels 113 (the legacy OPP pipeline exposes the "
            "locomotion label column; the 77-col challenge pipeline is gestures-only)")

    folder = None if args.synthetic else cfg.dataset_folder
    syn_kw = {}
    if cfg.data.lower() == "opp" and cfg.channels != 77:
        syn_kw["channels"] = cfg.channels
        if cfg.task == "locomotion":
            syn_kw["num_classes"] = 5  # null + {stand, walk, sit, lie}
    x_tr, y_tr, x_te, y_te = load_or_synthesize(cfg.data, folder, seed=cfg.seed, **syn_kw)
    if x_tr.shape[-1] != cfg.input_size:
        raise SystemExit(
            f"dataset folder provides {x_tr.shape[-1]}-channel windows but the model expects "
            f"{cfg.input_size} (--data {cfg.data} --channels {cfg.channels}); the folder was "
            f"preprocessed with a different --channels: re-run "
            f"vmlmf_tpu_torch.data.opp_preprocess to match")

    model = cfg.build_model()
    trainer = HARTrainer(model, learning_rate=cfg.lr, batch_size=cfg.batch_size, seed=cfg.seed,
                         device=args.device)
    params, opt_state = trainer.init()
    name = run_name(cfg.model, layer_sizes=cfg.layer_sizes, w_rank=cfg.w_rank,
                    u_ranks=cfg.u_ranks, data=cfg.data, seed=cfg.seed)
    ckpt = f"{args.ckpt_dir}/{name}"

    if cfg.is_train:
        params, opt_state, _ = trainer.fit(params, opt_state, x_tr, y_tr, epochs=cfg.max_epochs)
        save_checkpoint(ckpt, params, meta={"config": vars(args)})
        print(f"saved checkpoint: {ckpt}")
        _report(cfg, params, x_tr.shape[1], args.device)
    else:
        params = load_checkpoint(ckpt, params)

    if (not cfg.is_train) or args.total:
        metrics = evaluate(model, params, x_te, y_te)
        print(f"Test accuracy:: {100.0 * metrics['accuracy']:.4f}")
        print(f"Test macro-F1:: {metrics['macro_f1']:.4f}")
        return metrics
    return None


def _report(cfg, params, seq_len, device="cuda"):
    """Parameters and FLOPs of the dense LSTM baseline and of the model
    (the reference's `main.py:141-149` report)."""
    base_cfg = HARConfig(model="mylstm", layer_sizes=cfg.layer_sizes, data=cfg.data,
                         channels=cfg.channels)
    base_params = base_cfg.build_model().init(torch.Generator().manual_seed(0), device)
    n_base, n_comp = count_params(base_params), count_params(params)
    f_base = model_flops(cfg.input_size, cfg.layer_sizes, seq_len, cfg.batch_size, vm=False)
    f_comp = model_flops(cfg.input_size, cfg.layer_sizes, seq_len, cfg.batch_size,
                         w_rank=cfg.w_rank, u_rank=cfg.u_ranks, vm=cfg.w_rank is not None)
    rep = compression_report(n_base, n_comp, baseline_flops=f_base, compressed_flops=f_comp)
    print("Baseline Model")
    print(f" + Number of params:{rep['params_baseline_K']:.2f}K")
    print(f"  + Number of FLOPs: {rep['flops_baseline_M']:.2f}M")
    if cfg.model.lower() != "mylstm":
        print("Compressed Model")
        print(f" + Number of params:{rep['params_compressed_K']:.2f}K")
        print(f"  + Number of FLOPs: {rep['flops_compressed_M']:.2f}M")
        print(f"  + Compression ratio: x{rep['compression_ratio']:.4f}")


if __name__ == "__main__":
    main()
