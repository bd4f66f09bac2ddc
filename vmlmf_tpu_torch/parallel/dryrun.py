"""The multi-device dry run: one step of each parallel path at tiny shapes on
a (data × model) mesh (counterpart of `__graft_entry__.dryrun_multichip`).

    1. one LM training step (SGD, clip, dropout, carried state) with the
       towers data parallel and the vocabulary tables split on ``model``, on
       the "fused" backend: each rank runs the fused kernels on its rows;
    2. one SGD step through the pipeline-parallel recurrence (layer l on rank
       l of ``model``), only when ``model`` has two ranks or more;
    3. the session ranker on the row-sharded item table: one full-CE step and
       one sampled-softmax step through `LMTrainer`, and `rank_next` over the
       sharded table.

Every process of the group calls `dryrun_multichip` with the group's size.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from vmlmf_tpu_torch.parallel.mesh import axis_size, initialize, make_mesh


def dryrun_multichip(world, *, device_type="cuda"):
    """Run the three phases on a mesh over ``world`` processes (initialising
    a one-process group where none exists and ``world`` is 1).
    -> {"lm": loss, "pipeline": loss or None, "ranker_full": loss,
    "ranker_sampled": loss}; raises where a loss is not finite or a result
    has the wrong shape."""
    from vmlmf_tpu_torch.cells import VMLMFCell
    from vmlmf_tpu_torch.nn.losses import lm_loss
    from vmlmf_tpu_torch.nn.models import LMModel
    from vmlmf_tpu_torch.serve.ranker import SessionRanker
    from vmlmf_tpu_torch.train.lm import LMTrainer

    initialize(device_type=device_type)
    if dist.get_world_size() != world:
        raise ValueError(f"dryrun_multichip({world}) in a group of {dist.get_world_size()}")
    model_axis = 2 if world % 2 == 0 and world >= 2 else 1
    mesh = make_mesh(model=model_axis, device_type=device_type)
    dp = axis_size(mesh, "data")
    vocab, hidden, t = 64, 16, 8
    batch = 2 * dp  # divides the data axis
    dev = torch.device(device_type)

    def finite(name, loss):
        value = float(loss)
        if not math.isfinite(value):
            raise AssertionError(f"dryrun phase {name}: loss {value}")
        return value

    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, vocab, (t, batch), generator=g)
    targets = torch.randint(0, vocab, (t, batch), generator=g)
    out = {}

    # ---- phase 1: data-parallel towers, vocabulary split on 'model'
    model = LMModel(vocab_size=vocab, hidden_size=hidden, num_layers=2,
                    cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=8, u_rank=8),
                    dropout_rate=0.1, winit=0.05, backend="fused")
    trainer = LMTrainer(model, batch_size=batch, seq_length=t, mesh=mesh)
    params, states = trainer.init(), trainer.state0()
    x, y = trainer.commit_batch(ids, targets)
    gen = torch.Generator(device=dev).manual_seed(3 + 7919 * mesh.get_local_rank("data"))
    params, states, loss, _ = trainer.train_step(params, states, x, y, 0.1, gen)
    out["lm"] = finite("lm", loss)

    # ---- phase 2: pipeline parallelism (layer l on rank l of 'model')
    out["pipeline"] = None
    if model_axis >= 2:
        from vmlmf_tpu_torch.parallel.pipeline_parallel import pipeline_parallel_scan
        from vmlmf_tpu_torch.parallel.spmd import allreduce_grads
        from vmlmf_tpu_torch.utils.tree import trainable_leaves

        cells = tuple(VMLMFCell(hidden, hidden, w_rank=8, u_rank=8) for _ in range(model_axis))
        cparams = [c.init(torch.Generator().manual_seed(10 + i), dev)
                   for i, c in enumerate(cells)]
        emb_w = 0.05 * torch.randn(vocab, hidden, generator=torch.Generator().manual_seed(20))
        fc_w = 0.05 * torch.randn(hidden, vocab, generator=torch.Generator().manual_seed(21))
        tree = [cparams, emb_w.to(dev), fc_w.to(dev)]
        leaves = trainable_leaves(tree)
        xb, yb = x.to(dev), y.to(dev)
        xs = tree[1][xb]
        preps = [c.prepare(p) for c, p in zip(cells, tree[0])]
        pstates = [c.state0(xb.shape[1], dev) for c in cells]
        ys, _ = pipeline_parallel_scan(cells, preps, xs, pstates, mesh)
        loss = lm_loss(ys @ tree[2], yb)
        # every data group's loss is its rows' share: sum the gradients over 'data'
        grads = allreduce_grads(torch.autograd.grad(loss, leaves), mesh)
        with torch.no_grad():
            for p, gr in zip(leaves, grads):
                p.sub_(0.1 * gr)
        out["pipeline"] = finite("pipeline", loss)

    # ---- phase 3: the ranker on the row-sharded item table
    n_items, k = 16 * model_axis, 3
    ranker = SessionRanker.create(n_items, hidden_size=hidden, num_layers=1, w_rank=8,
                                  u_rank=8, backend="loop")
    sess = torch.randint(0, n_items, (t, batch), generator=g)
    nxt = torch.randint(0, n_items, (t, batch), generator=g)
    for name, kw in (("ranker_full", {}),
                     ("ranker_sampled", dict(sampled_softmax=8, in_batch_negatives=True))):
        rtr = ranker.trainer(batch_size=batch, seq_length=t, mesh=mesh, **kw)
        rparams, rstates = rtr.init(), rtr.state0()
        xb, yb = rtr.commit_batch(sess, nxt)
        rgen = torch.Generator(device=dev).manual_seed(7)
        rparams, rstates, rloss, _ = rtr.train_step(rparams, rstates, xb, yb, 0.5, rgen)
        out[name] = finite(name, rloss)
        if name == "ranker_full":
            scores, top = ranker.rank_next(rparams, sess.to(dev), k, mesh=mesh)
            if tuple(scores.shape) != (batch, k) or tuple(top.shape) != (batch, k):
                raise AssertionError(f"rank_next shapes {scores.shape}, {top.shape}")
            if not bool(torch.isfinite(scores).all()) or not (
                    bool((top >= 0).all()) and bool((top < n_items).all())):
                raise AssertionError(f"rank_next: scores {scores}, ids {top}")
    return out
