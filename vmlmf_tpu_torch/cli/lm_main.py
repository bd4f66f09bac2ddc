"""PTB language-model CLI: the Zaremba protocol on compressed cells
(counterpart of `vmlmf_tpu.cli.lm_main`, with the same flags and defaults).

    python -m vmlmf_tpu_torch.cli.lm_main --lstm_type vmlmf --wRank 300 --uRanks 300
    python -m vmlmf_tpu_torch.cli.lm_main --synthetic --vocab_size 10000 --total_epochs 1

Two departures from the JAX package's CLI:
  * ``--backend`` takes the port's names, "fused" (the default: the fused
    scan kernels), "loop", "fused_pipelined" and "pipelined" (the two
    wavefront backends need VMLMF_EXPERIMENTAL_WAVEFRONT=1); the JAX names
    are aliases: xla -> loop, pallas -> fused, pallas_pipelined ->
    fused_pipelined;
  * ``--device`` (default "cuda") names the device to run on; pass "cpu"
    to run the plain versions on the CPU.

Any ``--hidden_size`` runs on the fused backend: past the width whose
recurrent weights fit in the shared memory of the card's SMs, the scan
kernels stream the weight rows that do not fit through L2
(`cuda_scan.scan_plan`), as for the PTB "large" LM (``--lstm_type custom
--hidden_size 1500 --dropout 0.65 --winit 0.04 --max_grad_norm 10
--factor 1.15 --factor_epoch 14``).
"""

from __future__ import annotations

import argparse

from vmlmf_tpu_torch.cli import BACKENDS
from vmlmf_tpu_torch.config import LMConfig
from vmlmf_tpu_torch.data import ptb
from vmlmf_tpu_torch.nn.recurrence import backend_name
from vmlmf_tpu_torch.train.lm import LMTrainer
from vmlmf_tpu_torch.utils.analytics import count_params


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Compressed-LSTM language model on the GPU")
    p.add_argument("--layer_num", type=int, default=2)
    p.add_argument("--hidden_size", type=int, default=650)
    p.add_argument("--lstm_type", type=str, default="vmlmf",
                   choices=["pytorch", "custom", "vmlmf", "vm_group", "vmgroup"])
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--winit", type=float, default=0.05)
    p.add_argument("--batch_size", type=int, default=20)
    p.add_argument("--seq_length", type=int, default=35)
    p.add_argument("--learning_rate", type=float, default=1.0)
    p.add_argument("--total_epochs", type=int, default=39)
    p.add_argument("--factor_epoch", type=int, default=6)
    p.add_argument("--factor", type=float, default=1.2)
    p.add_argument("--max_grad_norm", type=float, default=5.0)
    p.add_argument("--wRank", type=int, default=300)
    p.add_argument("--uRanks", type=int, nargs="+", default=[300])
    p.add_argument("--group", type=int, default=2)
    p.add_argument("--tie", action="store_true", help="tie embedding and softmax weights")
    p.add_argument("--head_bf16", action="store_true",
                   help="bf16 softmax-projection matmul with f32 accumulation")
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--vocab_size", type=int, default=1000, help="synthetic vocab")
    p.add_argument("--log_every", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", type=backend_name, default="fused", choices=BACKENDS,
                   help="recurrence: the fused scan kernels, the plain loop, or a wavefront "
                        "backend (VMLMF_EXPERIMENTAL_WAVEFRONT=1); the JAX names xla, "
                        "pallas and pallas_pipelined are aliases")
    p.add_argument("--device", type=str, default="cuda", help="torch device to run on")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    cfg = LMConfig(
        lstm_type=args.lstm_type, layer_num=args.layer_num,
        hidden_size=args.hidden_size, dropout=args.dropout, winit=args.winit,
        w_rank=args.wRank, u_ranks=tuple(args.uRanks), groups=args.group,
        tie_embeddings=args.tie, batch_size=args.batch_size,
        seq_length=args.seq_length, learning_rate=args.learning_rate,
        total_epochs=args.total_epochs, factor_epoch=args.factor_epoch,
        factor=args.factor, max_grad_norm=args.max_grad_norm, seed=args.seed,
        data_dir=None if args.synthetic else args.data_dir,
        backend=args.backend, head_bf16=args.head_bf16,
    )

    trn_ids, vld_ids, tst_ids, vocab = ptb.load_or_synthesize(
        cfg.data_dir, vocab_size=args.vocab_size, seed=cfg.seed)
    trn = ptb.minibatch(trn_ids, cfg.batch_size, cfg.seq_length)
    vld = ptb.minibatch(vld_ids, cfg.batch_size, cfg.seq_length)
    tst = ptb.minibatch(tst_ids, cfg.batch_size, cfg.seq_length)

    model = cfg.build_model(vocab)
    trainer = LMTrainer(
        model, batch_size=cfg.batch_size, seq_length=cfg.seq_length,
        learning_rate=cfg.learning_rate, factor_epoch=cfg.factor_epoch,
        factor=cfg.factor, max_grad_norm=cfg.max_grad_norm, seed=cfg.seed,
        device=args.device)
    params = trainer.init()
    print("*" * 32)
    print(f"*parameters of model: {cfg.lstm_type}, {count_params(params) / 1e6:.3f}M")
    print("*" * 32)
    params, history = trainer.fit(params, (trn, vld, tst), epochs=cfg.total_epochs,
                                  log_every=args.log_every)
    return history


if __name__ == "__main__":
    main()
