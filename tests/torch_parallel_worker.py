"""One rank of the port's multi-process tests (`tests/test_torch_parallel.py`,
`tests/test_torch_mesh_graphs.py`).

    python tests/torch_parallel_worker.py RANK WORLD PORT DATA MODEL OUT_DIR [SUITE]

Joins a gloo group of WORLD processes at tcp://127.0.0.1:PORT, builds a
DATA x MODEL mesh, runs every case of SUITE ("parallel", the default, or
"graphs") that applies to it, each against the port's single-process result
or its eager steps computed in this process, and writes {case: "ok" or the
failure's traceback} to OUT_DIR/rank<RANK>.json. Imports no JAX: the JAX
oracle runs in the test process. `spawn` starts a group's ranks.

The "graphs" suite runs the trainers' graphed paths under the mesh: gloo
captures no CUDA graph, so `graphed` swaps `utils.graphs.StepGraph` for
`EagerGraph`, which keeps its contract (static inputs, one step a call) and
runs the step eagerly, collectives included.
"""

import contextlib
import json
import os
import subprocess
import sys
import traceback
import warnings

import numpy as np

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vmlmf_tpu_torch.cells import VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.nn.models import HARNet, LMModel  # noqa: E402
from vmlmf_tpu_torch.nn.recurrence import scan_layer  # noqa: E402
from vmlmf_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from vmlmf_tpu_torch.parallel import sharding  # noqa: E402
from vmlmf_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from vmlmf_tpu_torch.parallel.pipeline_parallel import pipeline_parallel_scan  # noqa: E402
from vmlmf_tpu_torch.serve import decoder  # noqa: E402
from vmlmf_tpu_torch.serve import ranker as ranker_module  # noqa: E402
from vmlmf_tpu_torch.serve.ranker import SessionRanker  # noqa: E402
from vmlmf_tpu_torch.train import har, lm  # noqa: E402
from vmlmf_tpu_torch.train.har import HARTrainer  # noqa: E402
from vmlmf_tpu_torch.train.lm import LMTrainer  # noqa: E402
from vmlmf_tpu_torch.utils import graphs  # noqa: E402
from vmlmf_tpu_torch.utils.tree import tree_leaves, trainable_leaves  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
V, H, T = 32, 12, 5


def close(a, b, what):
    torch.testing.assert_close(torch.as_tensor(a).detach().float(),
                               torch.as_tensor(b).detach().float(), msg=what, **TOL)


def trees_close(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        close(x, y, f"{what}: leaf {i}")


def chunks(b, n, high=V, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randint(0, high, (T, b), generator=g), torch.randint(0, high, (T, b),
                                                                        generator=g))
            for _ in range(n)]


def lm_model(tie):
    return LMModel(vocab_size=V, hidden_size=H, num_layers=2, dropout_rate=0.0, winit=0.3,
                   tie_embeddings=tie, backend="fused",
                   cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=4, u_rank=3))


def lm_steps(mesh, tie, b=4):
    """Two SGD steps and a perplexity with the mesh against without it."""
    model = lm_model(tie)
    kw = dict(batch_size=b, seq_length=T, max_grad_norm=0.5)   # the clip is active
    ref, tm = LMTrainer(model, device="cpu", **kw), LMTrainer(model, mesh=mesh, **kw)
    p_ref, s_ref, p, s = ref.init(), ref.state0(), tm.init(), tm.state0()
    data = chunks(b, 2)
    for x, y in data:
        p_ref, s_ref, l_ref, g_ref = ref.train_step(p_ref, s_ref, x, y, 1.0)
        xb, yb = tm.commit_batch(x, y)
        p, s, loss, gnorm = tm.train_step(p, s, xb, yb, 1.0)
        close(loss, l_ref, "loss")
        close(gnorm, g_ref, "gnorm")
    assert float(g_ref) > 0.5
    trees_close(sharding.gather_params(p, sharding.lm_param_sharding(p, mesh), mesh), p_ref,
                "params")
    close(tm.perplexity(p, data), ref.perplexity(p_ref, data), "perplexity")


def case_lm_untied(mesh):
    lm_steps(mesh, tie=False)


def case_lm_tied(mesh):
    lm_steps(mesh, tie=True)


def case_indivisible_batch(mesh):
    """A batch of 3 on a 2-way data axis: one warning, every rank computes the
    whole batch, the same numbers."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        lm_steps(mesh, tie=False, b=3)
    assert any("does not divide" in str(w.message) for w in caught), caught


def case_har_step(mesh):
    model = HARNet(6, (8,), cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=3, u_rank=2),
                   num_classes=5)
    ref, tm = HARTrainer(model, batch_size=4, device="cpu"), HARTrainer(model, batch_size=4,
                                                                        mesh=mesh)
    (p_ref, o_ref), (p, o) = ref.init(), tm.init()
    g = torch.Generator().manual_seed(1)
    for _ in range(2):
        x, y = torch.randn(4, T, 6, generator=g), torch.randint(0, 5, (4,), generator=g)
        p_ref, o_ref, l_ref = ref.train_step(p_ref, o_ref, x, y)
        xb, yb = tm.commit_batch(x, y)
        p, o, loss = tm.train_step(p, o, xb, yb)
        close(loss, l_ref, "loss")
    trees_close(p, p_ref, "params")
    assert torch.equal(tm.predict(p, x), ref.predict(p_ref, x))


def ranker_pair(mesh, n=2048):
    r = SessionRanker.create(n, hidden_size=16, num_layers=1, w_rank=4, u_rank=4,
                             backend="fused")
    full = r.init(torch.Generator().manual_seed(0), "cpu")
    return r, full, sharding.shard_params(full, sharding.lm_param_sharding(full, mesh), mesh)


def case_topk_sharded(mesh):
    r, full, local = ranker_pair(mesh)
    g = torch.Generator().manual_seed(2)
    sess = torch.randint(0, 2048, (7, 6), generator=g)
    h = torch.randn(6, 16, generator=g)
    for exclude in (None, sess):
        want_v, want_i = r.topk(full, h, 10, exclude=exclude)
        for data_sharded in (True, False):
            got_v, got_i = r.topk_sharded(local, h, 10, mesh, exclude=exclude,
                                          data_sharded=data_sharded)
            assert torch.equal(got_i, want_i) and got_i.dtype == torch.int32
            close(got_v, want_v, "topk values")
    for exclude_seen in (False, True):
        want = r.rank_next(full, sess, 12, exclude_seen=exclude_seen)
        got = r.rank_next(local, sess, 12, mesh=mesh, exclude_seen=exclude_seen)
        assert torch.equal(got[1], want[1])
        close(got[0], want[0], "rank_next values")
    tgt = torch.randint(0, 2048, (6,), generator=g)
    assert r.eval_metrics(local, sess, tgt, mesh=mesh) == r.eval_metrics(full, sess, tgt)
    small = SessionRanker.create(61, hidden_size=16, num_layers=1, w_rank=4, u_rank=4)
    if pmesh.axis_size(mesh, "model") > 1:
        for ranker, k, msg in ((small, 4, "not divisible"), (r, 2048, "exceeds the per-shard")):
            try:
                ranker.topk_sharded(local, h, k, mesh)
            except ValueError as e:
                assert msg in str(e), e
            else:
                raise AssertionError(f"no ValueError for {msg}")


def sampled_negs(k, n=128, num=16):
    return torch.randint(0, n, (k, num), generator=torch.Generator().manual_seed(9))


def case_sampled_dense(mesh):
    r, _, _ = ranker_pair(mesh, n=128)
    kw = dict(batch_size=4, seq_length=T, sampled_softmax=16, in_batch_negatives=True)
    ref, tm = r.trainer(device="cpu", **kw), r.trainer(mesh=mesh, **kw)
    p_ref, s_ref, p, s = ref.init(), ref.state0(), tm.init(), tm.state0()
    negs = sampled_negs(2)
    for i, (x, y) in enumerate(chunks(4, 2, high=128, seed=3)):
        p_ref, s_ref, l_ref, g_ref = ref.train_step(p_ref, s_ref, x, y, 0.5, negatives=negs[i])
        xb, yb = tm.commit_batch(x, y)
        p, s, loss, gnorm = tm.train_step(p, s, xb, yb, 0.5, negatives=negs[i])
        close(loss, l_ref, "loss")
        close(gnorm, g_ref, "gnorm")
    trees_close(sharding.gather_params(p, sharding.lm_param_sharding(p, mesh), mesh), p_ref,
                "params")


def case_sparse_sharded(mesh):
    """The sparse trainer on the row-sharded table, three steps."""
    r, _, _ = ranker_pair(mesh, n=128)
    kw = dict(batch_size=4, seq_length=T, sampled_softmax=16)
    ref, tm = r.sparse_trainer(device="cpu", **kw), r.sparse_trainer(mesh=mesh, **kw)
    p_ref, s_ref, p, s = ref.init(), ref.state0(), tm.init(), tm.state0()
    negs = sampled_negs(3)
    for i, (x, y) in enumerate(chunks(4, 3, high=128, seed=4)):
        p_ref, s_ref, l_ref, g_ref = ref.train_step(p_ref, s_ref, x, y, 0.5, negatives=negs[i])
        xb, yb = tm.commit_batch(x, y)
        p, s, loss, gnorm = tm.train_step(p, s, xb, yb, 0.5, negatives=negs[i])
        close(loss, l_ref, "loss")
        close(gnorm, g_ref, "gnorm")
    assert tuple(p["embed"]["w"].shape) == (128 // pmesh.axis_size(mesh, "model"), 16)
    trees_close(sharding.gather_params(p, sharding.lm_param_sharding(p, mesh), mesh), p_ref,
                "params")


def case_pipeline(mesh):
    """Forward and gradients of the layer-per-rank pipeline against the
    per-layer scan, at dropout 0, on this data group's rows."""
    cells = tuple(VMLMFCell(H, H, w_rank=4, u_rank=4) for _ in range(2))
    g = torch.Generator().manual_seed(5)
    params = [c.init(torch.Generator().manual_seed(10 + i), "cpu") for i, c in enumerate(cells)]
    xs = torch.randn(T, 3, H, generator=g) + pmesh.axis_rank(mesh, "data")
    states = [(0.1 * torch.randn(3, H, generator=g), 0.1 * torch.randn(3, H, generator=g))
              for _ in cells]
    w = torch.randn(T, 3, H, generator=g)

    def run(pipelined):
        leaves = trainable_leaves([params, xs])
        preps = [c.prepare(p) for c, p in zip(cells, params)]
        if pipelined:
            ys, finals = pipeline_parallel_scan(cells, preps, xs, states, mesh)
        else:
            ys, finals = xs, []
            for c, p, s0 in zip(cells, preps, states):
                ys, sf = scan_layer(c, p, ys, s0, backend="loop")
                finals.append(sf)
        loss = (ys * w).sum() + sum((h * h).sum() + c.sum() for h, c in finals)
        return [ys, *[t for f in finals for t in f]], torch.autograd.grad(loss, leaves)

    (outs, grads), (want_outs, want_grads) = run(True), run(False)
    for a, b in zip(outs, want_outs):
        close(a, b, "pipeline outputs")
    for i, (a, b) in enumerate(zip(grads, want_grads)):
        close(a, b, f"pipeline gradient {i}")


def case_dryrun(mesh):
    world = dist.get_world_size()
    out = dryrun_multichip(world, device_type="cpu")
    assert (out["pipeline"] is None) == (world % 2 == 1), out   # model = 2 on even worlds


class EagerGraph:
    """`utils.graphs.StepGraph`'s contract, run eagerly: each call copies its
    arguments into the static inputs and runs the step on them. ``made``:
    every one built inside `graphed`."""

    made = []

    def __init__(self, step, inputs=(), *, device, generators=()):
        self.step, self.inputs, self.calls = step, tuple(a.clone() for a in inputs), 0
        EagerGraph.made.append(self)

    def __call__(self, *values):
        for buf, v in zip(self.inputs, values):
            buf.copy_(v)
        self.calls += 1
        return self.step(*self.inputs)


@contextlib.contextmanager
def graphed():
    """The graphed paths on the CPU, through `EagerGraph`: the modules'
    `on_card` reads True. -> the list of the graphs built inside."""
    patched = [(m, "on_card") for m in (lm, har, ranker_module, decoder)]
    patched += [(graphs, "StepGraph"), (decoder, "StepGraph")]
    saved = [getattr(m, name) for m, name in patched]
    for m, name in patched:
        setattr(m, name, EagerGraph if name == "StepGraph" else (lambda device: True))
    EagerGraph.made = []
    try:
        yield EagerGraph.made
    finally:
        for (m, name), value in zip(patched, saved):
            setattr(m, name, value)


def equal(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) and all(torch.equal(x.detach(), y.detach())
                                      for x, y in zip(la, lb)), what


def lm_data(b, n_train, n_eval=3):
    return chunks(b, n_train, seed=11), chunks(b, n_eval, seed=12), chunks(b, n_eval, seed=13)


def case_lm_fit_blocks(mesh):
    """`fit` in blocks of 2 over 5 chunks (two blocks and one chunk left
    over, two epochs; the clip active) and `perplexity`, graphed under the
    mesh, against the single-process `fit`; the block log line."""
    model = lm_model(tie=False)
    data = lm_data(4, 5)
    kw = dict(batch_size=4, seq_length=T, max_grad_norm=0.5, fuse_chunks=2, factor_epoch=0)
    with graphed() as made:
        ref = LMTrainer(model, device="cpu", **kw)
        p_ref, h_ref = ref.fit(ref.init(), data, epochs=2, log_fn=None)
        n_ref = len(made)
        tm = LMTrainer(model, mesh=mesh, **kw)
        logs = []
        p, hist = tm.fit(tm.init(), data, epochs=2, log_every=1, log_fn=logs.append)
        # one train graph (2 epochs of 2 blocks of 2), one eval graph (2 epochs
        # of 3 validation chunks, then 3 test chunks)
        assert [g.calls for g in made[n_ref:]] == [8, 9], [g.calls for g in made]
        close(tm.perplexity(p, data[1]), ref.perplexity(p_ref, data[1]), "perplexity")
        assert [g.calls for g in made[n_ref:]] == [8, 12]
    assert [h.keys() for h in hist] == [h.keys() for h in h_ref]
    for got, want in zip(hist, h_ref):
        for k in got:
            close(got[k], want[k], f"history {k}")
    trees_close(sharding.gather_params(p, sharding.lm_param_sharding(p, mesh), mesh), p_ref,
                "params")
    blocks = [line.split(",")[0] for line in logs if line.startswith("chunks")]
    assert blocks == ["chunks 2/5", "chunks 4/5"] * 2, logs


def har_pair(mesh, fuse):
    model = HARNet(6, (8,), cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=3, u_rank=2),
                   num_classes=5)
    kw = dict(batch_size=4, fuse_batches=fuse)
    return HARTrainer(model, device="cpu", **kw), HARTrainer(model, mesh=mesh, **kw)


def case_har_blocks(mesh):
    """HAR `fit` in blocks of 2 over 5 batches an epoch, graphed under the
    mesh, against the single-process `fit`; a block of 3 steps under the mesh
    against its eager step loop, bit for bit."""
    g = np.random.default_rng(3)
    x = g.standard_normal((20, T, 6)).astype(np.float32)
    y = g.integers(0, 5, 20)
    ref, tm = har_pair(mesh, fuse=2)
    with graphed() as made:
        p_ref, o_ref = ref.init()
        p_ref, _, h_ref = ref.fit(p_ref, o_ref, x, y, epochs=2, log_fn=None)
        n_ref = len(made)
        p, o = tm.init()
        p, o, hist = tm.fit(p, o, x, y, epochs=2, log_fn=None)
        assert [g.calls for g in made[n_ref:]] == [2 * 2 * 2], [g.calls for g in made]
        for got, want in zip(hist, h_ref):
            close(got["loss"], want["loss"], "loss")
        trees_close(p, p_ref, "params")
        xs, ys = x[:12].reshape(3, 4, T, 6), y[:12].reshape(3, 4)
        (pa, oa), (pb, ob) = tm.init(), tm.init()
        pa, oa, la = tm._fused_steps(pa, oa, *tm.commit_batch(xs, ys, stacked=True))
    lb = []
    for xb, yb in zip(xs, ys):
        pb, ob, loss = tm.train_step(pb, ob, *tm.commit_batch(xb, yb))
        lb.append(loss)
    equal([la, pa], [torch.stack(lb), pb], "the HAR block against its step loop")


def case_sparse_fused(mesh):
    """The sparse ranker's `fused_chunks` graphed under the mesh: with its
    negatives drawn (rank 0's, broadcast, inside the step) against its eager
    step loop, bit for bit; with given negatives against the single-process
    `fused_chunks`."""
    r, _, _ = ranker_pair(mesh, n=128)
    kw = dict(batch_size=4, seq_length=T, sampled_softmax=16, fuse_chunks=3)
    ref, tm = r.sparse_trainer(device="cpu", **kw), r.sparse_trainer(mesh=mesh, **kw)
    data = chunks(4, 3, high=128, seed=4)
    xs, ys = (torch.stack([c[i] for c in data]) for i in (0, 1))
    ga, gb = (torch.Generator().manual_seed(9) for _ in range(2))
    with graphed() as made:
        pa, sa = tm.init(), tm.state0()
        pa, sa, la, na = tm.fused_chunks(pa, sa, *tm.commit_batch(xs, ys, stacked=True), 0.5, ga)
        assert [g.calls for g in made] == [3]
        negs = sampled_negs(3)
        p_ref, _, l_ref, n_ref = ref.fused_chunks(ref.init(), ref.state0(), xs, ys, 0.5,
                                                  negatives=negs)
        p, _, loss, gnorm = tm.fused_chunks(tm.init(), tm.state0(),
                                            *tm.commit_batch(xs, ys, stacked=True), 0.5,
                                            negatives=negs)
    pb, sb, lb, nb = tm.init(), tm.state0(), [], []
    for x, y in data:
        pb, sb, loss_b, gnorm_b = tm.train_step(pb, sb, *tm.commit_batch(x, y), 0.5, gb)
        lb.append(loss_b)
        nb.append(gnorm_b)
    equal([la, na, pa, sa], [torch.stack(lb), torch.stack(nb), pb, sb],
          "the ranker's chunks against its step loop")
    close(loss, l_ref, "loss")
    close(gnorm, n_ref, "gnorm")
    trees_close(sharding.gather_params(p, sharding.lm_param_sharding(p, mesh), mesh), p_ref,
                "params")


CASES = {"lm_untied": case_lm_untied, "lm_tied": case_lm_tied, "har_step": case_har_step,
         "topk_sharded": case_topk_sharded, "sampled_dense": case_sampled_dense,
         "sparse_sharded": case_sparse_sharded, "pipeline": case_pipeline,
         "indivisible_batch": case_indivisible_batch, "dryrun": case_dryrun}
GRAPH_CASES = {"lm_fit_blocks": case_lm_fit_blocks, "har_blocks": case_har_blocks,
               "sparse_fused": case_sparse_fused}
SUITES = {"parallel": CASES, "graphs": GRAPH_CASES}


def applies(case, data, model):
    if case == "pipeline":
        return model == 2
    if case == "indivisible_batch":
        return data == 2
    return True


def spawn(world, data, model, out_dir, port, suite="parallel", timeout=120):
    """Start the WORLD ranks of a DATA x MODEL group running ``suite``, join
    them within ``timeout`` seconds (a hung group is killed), and return each
    rank's {case: "ok" or traceback}; a rank that wrote no result reports
    its output under "_failed"."""
    env = {k: v for k, v in os.environ.items() if k not in pmesh.CLUSTER_ENV}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               str(port), str(data), str(model), str(out_dir), suite], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs, hung = [], False
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            hung = True
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
    out = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                out.append(json.load(f))
        else:
            out.append({"_failed": f"rank {r} wrote no result (hung: {hung}):\n"
                                   + "\n".join(logs)})
    return out


def main():
    rank, world, port, data, model = map(int, sys.argv[1:6])
    out_dir = sys.argv[6]
    cases = SUITES[sys.argv[7] if len(sys.argv) > 7 else "parallel"]
    torch.manual_seed(0)
    pmesh.initialize(f"tcp://127.0.0.1:{port}", world, rank, device_type="cpu", timeout=60)
    mesh = pmesh.make_mesh(data, model, device_type="cpu")
    results = {}
    for name, fn in cases.items():
        if not applies(name, data, model):
            continue
        try:
            fn(mesh)
            results[name] = "ok"
        except Exception:  # reported per case; the ranks go on in step
            results[name] = traceback.format_exc()
        dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
