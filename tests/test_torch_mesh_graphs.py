"""The port's last eager paths as graphs, on the CPU: the trainers' fused steps
under a mesh and the decoder's graphed prefill.

A CUDA graph captures only on the card, and gloo, the CPU's backend, has no
graph capture. So the graphed paths run here through `EagerGraph` (from
`tests/torch_parallel_worker.py`), which keeps `StepGraph`'s contract
(static inputs, one step a call) and runs the step eagerly: the code path is
the card's, the collectives inside the step included.

  * gloo groups of 2 (data), 2 (model) and 4 (2x2) spawned ranks run the
    worker's "graphs" suite: `LMTrainer.fit` in blocks and `perplexity`
    under the mesh against the single-process run at 1e-5, with the block
    log line; the HAR block and the sparse ranker's chunks under the mesh
    against their eager step loops, bit for bit, and against the
    single-process run at 1e-5;
  * in this process, on a one-process gloo mesh: `fit` in blocks against the
    JAX package's fused `fit` on its 8-device CPU mesh (data 4 x model 2 for
    the LM, data 8 for HAR) at dropout 0, with the JAX block log lines; the
    gradient sum's layouts, which keep the clip's sums in the order of the
    run without a mesh;
  * the graphed prefill against the eager one, bit for bit, and against the
    JAX package's prefill; its graph reused for a prompt of one shape and
    captured anew for another; its cache apart from the decode graphs'.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu.cells import VMLMFCell as JaxVMLMFCell  # noqa: E402
from vmlmf_tpu.data.ptb import minibatch, synthetic_corpus  # noqa: E402
from vmlmf_tpu.nn.models import HARNet as JaxHARNet  # noqa: E402
from vmlmf_tpu.nn.models import LMModel as JaxLMModel  # noqa: E402
from vmlmf_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from vmlmf_tpu.serve import Decoder as JaxDecoder  # noqa: E402
from vmlmf_tpu.train.har import HARTrainer as JaxHARTrainer  # noqa: E402
from vmlmf_tpu.train.lm import LMTrainer as JaxLMTrainer  # noqa: E402
from vmlmf_tpu_torch.cells import VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.data.har import synthetic_har  # noqa: E402
from vmlmf_tpu_torch.nn.models import HARNet, LMModel  # noqa: E402
from vmlmf_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from vmlmf_tpu_torch.serve import Decoder, decoder  # noqa: E402
from vmlmf_tpu_torch.train.har import HARTrainer  # noqa: E402
from vmlmf_tpu_torch.train.lm import LMTrainer  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402
from vmlmf_tpu_torch.utils.tree import tree_leaves  # noqa: E402

from test_torch_parallel import CONFIGS, free_port  # noqa: E402
from torch_parallel_worker import GRAPH_CASES, graphed, spawn  # noqa: E402

JOIN_SECONDS = 120
STEP_TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_torch_train.py
# parameters after the steps of a mesh, whose sums XLA takes in another order
# (tests/test_torch_parallel.py's mesh step; HAR: tests/test_torch_train.py)
MESH_PARAM_TOL = dict(atol=3e-4, rtol=3e-4)
HAR_PARAM_TOL = dict(atol=1e-4, rtol=1e-4)
FWD_TOL = dict(atol=2e-5, rtol=2e-5)  # tests/test_pallas.py
BF16_FWD_TOL = dict(atol=5e-3, rtol=5e-3)  # tests/test_pallas.py:97

GROUPS = [(c, case) for c in CONFIGS for case in GRAPH_CASES]
_results = {}


@pytest.mark.parametrize("config,case", GROUPS, ids=[f"{c}-{k}" for c, k in GROUPS])
def test_graphed_paths_under_a_gloo_mesh(config, case, tmp_path_factory):
    if config not in _results:
        _results[config] = spawn(*CONFIGS[config], tmp_path_factory.mktemp(config), free_port(),
                                 suite="graphs", timeout=JOIN_SECONDS)
    for rank, res in enumerate(_results[config]):
        assert res.get(case) == "ok", f"rank {rank}: {res.get(case, res)}"


@pytest.fixture
def world1_mesh(monkeypatch):
    """A one-process gloo mesh (`make_mesh` with no cluster environment)."""
    import torch.distributed as dist

    for v in pmesh.CLUSTER_ENV:
        monkeypatch.delenv(v, raising=False)
    mesh = pmesh.make_mesh(device_type="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture
def stand_in():
    with graphed() as made:
        yield made


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_close(got, want, tol):
    want = jax.tree_util.tree_leaves(to_np(want))
    got = tree_leaves(got)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().numpy(), w, err_msg=f"leaf {i}", **tol)


@pytest.mark.parametrize("mean", [False, True])
def test_allreduce_grads_keeps_each_gradients_layout(world1_mesh, mean):
    """A gradient that arrives transposed, or as a transposed slice of a
    wider buffer (as the BPTT's gradients of V do), comes back in its own
    dimension order, so that a reduction over it (the clip's sum of squares)
    adds in the same order as without a mesh."""
    from vmlmf_tpu_torch.parallel import spmd

    g = torch.Generator().manual_seed(0)
    wide = torch.randn(260, 260, generator=g)
    grads = [torch.randn(5, 7, generator=g), wide[:, :30].T, torch.randn(9, generator=g),
             torch.randn(3, 4, 6, generator=g).permute(2, 0, 1), wide.T]
    out = spmd.allreduce_grads(grads, world1_mesh, mean=mean)
    for a, b in zip(grads, out):
        assert torch.equal(a, b)
        assert torch.square(a).stride() == torch.square(b).stride()
        assert torch.equal(torch.sum(torch.square(a)), torch.sum(torch.square(b)))


def test_lm_fit_in_blocks_under_a_mesh_matches_jax_fused_fit(world1_mesh, stand_in):
    """fuse_chunks=2 over 5 chunks (two blocks and a chunk left over), two
    epochs, the clip active; JAX on data 4 x model 2."""
    vocab, hidden, t, b = 48, 16, 6, 8
    kw = dict(vocab_size=vocab, hidden_size=hidden, num_layers=2, dropout_rate=0.0, winit=0.3)
    jm = JaxLMModel(cell_factory=lambda n, h: JaxVMLMFCell(n, h, w_rank=5, u_rank=4),
                    backend="pallas", **kw)
    m = LMModel(cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=5, u_rank=4), **kw)
    cut, eval_len = b * (t * 5 + 2), b * (t * 2 + 2)
    corpus = synthetic_corpus(vocab_size=vocab, length=cut + 2 * eval_len, seed=2)
    data = tuple(minibatch(part, b, t) for part in
                 (corpus[:cut], corpus[cut : cut + eval_len], corpus[cut + eval_len :]))
    tkw = dict(batch_size=b, seq_length=t, fuse_chunks=2, factor_epoch=0, max_grad_norm=0.5)
    jt = JaxLMTrainer(jm, mesh=jax_make_mesh(data=4, model=2), **tkw)
    tm = LMTrainer(m, mesh=world1_mesh, **tkw)
    jparams = jt.init()
    params = params_from_jax(to_np(jparams), device="cpu")
    jlogs, logs = [], []
    jparams, jhist = jt.fit(jparams, data, epochs=2, log_every=1, log_fn=jlogs.append)
    params, hist = tm.fit(params, data, epochs=2, log_every=1, log_fn=logs.append)
    for got, want in zip(hist, jhist):
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], **STEP_TOL, err_msg=k)
    assert_trees_close(params, jparams, MESH_PARAM_TOL)
    blocks = [line.split(",")[0] for line in logs if line.startswith("chunks")]
    assert blocks == [line.split(",")[0] for line in jlogs if line.startswith("chunks")]
    assert blocks == ["chunks 2/5", "chunks 4/5"] * 2
    # the train graph took 2 blocks of 2 an epoch; the eval graph 2 validation
    # chunks an epoch and 2 test chunks
    assert [g.calls for g in stand_in] == [8, 6]


def test_har_fit_in_blocks_under_a_mesh_matches_jax_fused_fit(world1_mesh, stand_in):
    """fuse_batches=2 over 5 batches an epoch; JAX on data 8."""
    n_feat, hidden, classes, b = 12, 20, 5, 8
    jmodel = JaxHARNet(n_feat, (hidden,), num_classes=classes, backend="pallas",
                       cell_factory=lambda n, h: JaxVMLMFCell(n, h, w_rank=4, u_rank=3))
    model = HARNet(n_feat, (hidden,), num_classes=classes, backend="fused",
                   cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=4, u_rank=3))
    x_tr, y_tr, _, _ = synthetic_har("opp", n_train=5 * b + 3, n_test=2, seed=1,
                                     channels=n_feat, num_classes=classes)
    x_tr = x_tr[:, :8]
    jt = JaxHARTrainer(jmodel, batch_size=b, fuse_batches=2, mesh=jax_make_mesh(data=8))
    t = HARTrainer(model, batch_size=b, fuse_batches=2, mesh=world1_mesh)
    jparams, jopt = jt.init()
    params = params_from_jax(to_np(jparams), device="cpu")
    jparams, _, jhist = jt.fit(jparams, jopt, x_tr, y_tr, epochs=2, log_fn=None)
    params, _, hist = t.fit(params, t.optimizer(params), x_tr, y_tr, epochs=2, log_fn=None)
    for got, want in zip(hist, jhist):
        np.testing.assert_allclose(got["loss"], want["loss"], **STEP_TOL)
    assert_trees_close(params, jparams, HAR_PARAM_TOL)
    assert [g.calls for g in stand_in] == [2 * 2 * 2]


# ------------------------------------------------------------- prefill
VOCAB, HIDDEN, T = 48, 16, 7
VARIANTS = {"fused": ("fused", False, {}), "fused_pipelined": ("fused_pipelined", False, {}),
            "mixed": ("fused", True, {"VMLMF_PALLAS_PRECISION": "bf16"})}


def serve_pair(backend="fused", head_bf16=False):
    kw = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=2, dropout_rate=0.0, winit=1.0,
              head_bf16=head_bf16)
    jm = JaxLMModel(cell_factory=lambda n, h: JaxVMLMFCell(n, h, w_rank=5, u_rank=4),
                    backend={"fused": "pallas", "fused_pipelined": "pallas_pipelined"}[backend],
                    **kw)
    m = LMModel(cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=5, u_rank=4), backend=backend,
                **kw)
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, jparams, m, params_from_jax(to_np(jparams), device="cpu")


def prompt(b, t=T, seed=1):
    return np.random.default_rng(seed).integers(0, VOCAB, (t, b)).astype(np.int32)


def states(b, seed=2):
    rng = np.random.default_rng(seed)
    return [tuple((0.2 * rng.standard_normal((b, HIDDEN))).astype(np.float32)
                  for _ in range(2)) for _ in range(2)]


def eager_prefill(m, params, ids, st):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decoder, "on_card", lambda device: False)
        return Decoder(m).prefill(params, ids, st)


def torch_args(ids, st):
    return torch.from_numpy(ids).long(), [tuple(map(torch.from_numpy, s)) for s in st]


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_graphed_prefill_equals_eager_and_jax(variant, b, stand_in, monkeypatch):
    backend, head_bf16, switches = VARIANTS[variant]
    monkeypatch.setenv("VMLMF_EXPERIMENTAL_WAVEFRONT", "1")
    for k, v in switches.items():
        monkeypatch.setenv(k, v)
    jm, jparams, m, params = serve_pair(backend, head_bf16)
    ids, st = prompt(b), states(b)
    want = eager_prefill(m, params, *torch_args(ids, st))
    dec = Decoder(m)
    for _ in range(2):  # the second call replays the first's graph on new copies
        args = torch_args(ids, st)
        got = dec.prefill(params, *args)
        assert all(torch.equal(a, w) for a, w in zip(tree_leaves(got), tree_leaves(want)))
        # the results are copies: the graph's own tensors are not handed out
        graph_leaves = {t.data_ptr() for t in tree_leaves(list(dec._prefills.values())[0].tensors)}
        assert not graph_leaves & {t.data_ptr() for t in tree_leaves(got)}
        assert torch.equal(args[0], torch.from_numpy(ids).long())  # the prompt is not written
    assert [g.calls for g in stand_in] == [2]
    jlogits, jstates = JaxDecoder(jm).prefill(jparams, jnp.asarray(ids),
                                             [tuple(map(jnp.asarray, s)) for s in st])
    tol = BF16_FWD_TOL if switches else FWD_TOL
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jlogits), **tol)
    for a, w in zip(tree_leaves(got[1]), jax.tree_util.tree_leaves(jstates)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **tol)


def test_prefill_graph_is_reused_for_one_shape_and_captured_for_another(stand_in):
    _, _, m, params = serve_pair()
    dec = Decoder(m)
    for seed in (1, 5):  # two prompts of one shape: one graph
        args = torch_args(prompt(3, seed=seed), states(3, seed=seed))
        got = dec.prefill(params, *args)
        want = eager_prefill(m, params, *args)
        assert all(torch.equal(a, w) for a, w in zip(tree_leaves(got), tree_leaves(want)))
    assert [g.calls for g in stand_in] == [2]
    for b, t in ((3, T + 2), (4, T)):  # a new length, then a new batch: a graph each
        got = dec.prefill(params, *torch_args(prompt(b, t), states(b)))
        want = eager_prefill(m, params, *torch_args(prompt(b, t), states(b)))
        assert all(torch.equal(a, w) for a, w in zip(tree_leaves(got), tree_leaves(want)))
    assert [g.calls for g in stand_in] == [2, 1, 1] and len(dec._prefills) == 3
    # generate starts with the graphed prefill: the first prompt's shape again
    ids = torch.from_numpy(prompt(3)).long()
    tokens = dec.generate(params, ids, max_new_tokens=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decoder, "on_card", lambda device: False)
        assert torch.equal(tokens, Decoder(m).generate(params, ids, max_new_tokens=4))
    assert [g.calls for g in stand_in][:3] == [3, 1, 1]


def test_prefill_graphs_leave_the_decode_graphs_in_place(stand_in):
    """More prompt shapes than the cache holds: the oldest prefill graphs go,
    the decode graph stays, and the next decode captures nothing."""
    _, _, m, params = serve_pair()
    dec = Decoder(m)
    logits, st = dec.prefill(params, *torch_args(prompt(3), states(3)))
    dec.decode(params, logits, st, steps=3)
    (step,) = dec._graphs.values()
    for t in range(1, decoder.CACHED_GRAPHS + 3):
        logits, st = dec.prefill(params, *torch_args(prompt(3, t), states(3)))
    assert len(dec._prefills) == decoder.CACHED_GRAPHS
    assert list(dec._graphs.values()) == [step]
    made = len(stand_in)
    dec.decode(params, logits, st, steps=3)
    assert len(stand_in) == made and list(dec._graphs.values()) == [step]
