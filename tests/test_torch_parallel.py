"""The port's parallel layer (`vmlmf_tpu_torch.parallel`) and the trainers'
and ranker's ``mesh`` hooks.

Multi-rank behaviour runs in gloo groups of spawned processes
(`tests/torch_parallel_worker.py`, which imports no JAX): at world 2 on the
``data`` axis, world 2 on ``model`` and world 4 as 2x2, each case held in
every rank to the port's single-process result at 1e-5. Each group is spawned
once, on a free port, with a time limit; a hung rendezvous fails its tests.
In this process: the mesh helpers, the initialisation's failure semantics,
and the port's single-process results against the JAX package's on a mesh
of the 8 CPU devices.
"""

import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu.cells import VMLMFCell as JaxVMLMFCell  # noqa: E402
from vmlmf_tpu.nn.models import LMModel as JaxLMModel  # noqa: E402
from vmlmf_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from vmlmf_tpu.parallel.sharding import lm_param_sharding as jax_lm_param_sharding  # noqa: E402
from vmlmf_tpu.serve.ranker import SessionRanker as JaxSessionRanker  # noqa: E402
from vmlmf_tpu.train.lm import LMTrainer as JaxLMTrainer  # noqa: E402
from vmlmf_tpu_torch.cells import VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.nn.models import LMModel  # noqa: E402
from vmlmf_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from vmlmf_tpu_torch.parallel import sharding, spmd  # noqa: E402
from vmlmf_tpu_torch.serve.ranker import SessionRanker  # noqa: E402
from vmlmf_tpu_torch.train.lm import LMTrainer  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402
from vmlmf_tpu_torch.utils.tree import tree_leaves  # noqa: E402

from torch_parallel_worker import spawn  # noqa: E402

JOIN_SECONDS = 120
# (world, data, model) -> the cases its worker runs
CONFIGS = {"data2": (2, 2, 1), "model2": (2, 1, 2), "mesh2x2": (4, 2, 2)}
COMMON = ["lm_untied", "lm_tied", "har_step", "topk_sharded", "sampled_dense",
          "sparse_sharded", "dryrun"]
CASES = [(c, case) for c in CONFIGS for case in COMMON]
CASES += [("model2", "pipeline"), ("mesh2x2", "pipeline"), ("data2", "indivisible_batch"),
          ("mesh2x2", "indivisible_batch")]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_results = {}


def group_results(config, tmp_dir):
    """Spawn the config's ranks once (first call), join them within
    JOIN_SECONDS, and return each rank's {case: "ok" or traceback}."""
    if config not in _results:
        _results[config] = spawn(*CONFIGS[config], tmp_dir, free_port(), timeout=JOIN_SECONDS)
    return _results[config]


@pytest.mark.parametrize("config,case", CASES, ids=[f"{c}-{k}" for c, k in CASES])
def test_sharded_equals_single_process(config, case, tmp_path_factory):
    results = group_results(config, tmp_path_factory.mktemp(config))
    for rank, res in enumerate(results):
        assert res.get(case) == "ok", f"rank {rank}: {res.get(case, res)}"


# ---------------------------------------------------------------- in process
def test_local_batch_slice_and_make_global_batch_without_a_group():
    assert pmesh.local_batch_slice(12) == slice(0, 12)
    x = np.arange(12).reshape(3, 4)
    got = pmesh.make_global_batch(None, x, dim=1)
    assert got.device.type == "cpu" and np.array_equal(got.numpy(), x)
    assert np.array_equal(pmesh.make_global_batch(None, x, local=True).numpy(), x)


class FakeMesh:
    """The DeviceMesh surface the helpers read, at a given coordinate."""

    mesh_dim_names = ("data", "model")
    device_type = "cpu"

    def __init__(self, data, model, coord=(0, 0)):
        self.shape, self.coord = (data, model), coord

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, axis):
        return self.coord[self.mesh_dim_names.index(axis)]


@pytest.mark.parametrize("coord", [(0, 1), (2, 0)])
def test_batch_helpers_cut_this_data_coordinate(coord):
    mesh = FakeMesh(4, 2, coord)
    assert pmesh.local_batch_slice(12, mesh) == slice(3 * coord[0], 3 * coord[0] + 3)
    x = np.arange(24).reshape(2, 12)
    got = pmesh.make_global_batch(mesh, x, dim=1)
    assert np.array_equal(got.numpy(), x[:, 3 * coord[0]:3 * coord[0] + 3])
    assert np.array_equal(pmesh.make_global_batch(mesh, x, dim=1, local=True).numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.make_global_batch(mesh, np.zeros((2, 10)), dim=1)
    spmd_ = (mesh, "data")
    assert spmd.local_batch(12, spmd_) == 3 and spmd.is_split(12, spmd_)
    assert spmd.local_batch(10, spmd_) == 10 and not spmd.is_split(10, spmd_)
    t = torch.arange(24).reshape(2, 12)
    assert torch.equal(spmd.shard_batch(t, 1, spmd_), t[:, 3 * coord[0]:3 * coord[0] + 3])
    spmd._warned_indivisible.clear()  # the warning comes once a shape
    with pytest.warns(UserWarning, match="does not divide"):
        assert spmd.shard_batch(t[:, :10], 1, spmd_).shape == (2, 10)


def test_spmd_context_and_shardings():
    mesh = FakeMesh(2, 2)
    # the context is the explicit (mesh, axis) pair; mesh=None is one process
    assert spmd.local_batch(12, (None, "data")) == 12 and not spmd.is_split(12, (None, "data"))
    assert spmd.local_batch(12, (mesh, "data")) == 6 and spmd.is_split(12, (mesh, "data"))
    t = torch.arange(12)
    assert spmd.shard_batch(t, 0, (None, "data")) is t
    assert spmd.gather_batch(t, 0, (None, "data")) is t
    # a step's rows are its share of the batch: split rows, or a one-rank axis
    assert spmd.holds_share(6, 12, mesh) and not spmd.holds_share(12, 12, mesh)
    assert spmd.holds_share(12, 12, None) and spmd.holds_share(12, 12, FakeMesh(1, 2))
    params = {"embed": {"w": 0}, "rnn": [{"u": 0}], "fc": {"b": 0}}
    specs = sharding.lm_param_sharding(params, mesh)
    assert specs == {"embed": {"w": ("model", None)}, "rnn": [{"u": ()}],
                     "fc": {"b": ("model",)}}
    params["fc"]["w"] = 0
    assert sharding.lm_param_sharding(params, mesh)["fc"]["w"] == (None, "model")
    assert sharding.har_param_sharding([{"a": 0}]) == [{"a": ()}]
    assert sharding.lm_state_sharding([(0, 0)]) == [[("data", None), ("data", None)]]


def test_make_mesh_and_initialize_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.initialize()


def test_initialize_raises_on_explicit_arguments_that_fail():
    import torch.distributed as dist

    with pytest.raises(ValueError, match="world_size and rank"):
        pmesh.initialize("tcp://127.0.0.1:1", device_type="cpu")
    # rank 1 of 2 at a port where no rank 0 listens: the rendezvous times out
    with pytest.raises(Exception):
        pmesh.initialize(f"tcp://127.0.0.1:{free_port()}", 2, 1, device_type="cpu",
                         timeout=2)
    assert not dist.is_initialized()


@pytest.fixture
def world1_mesh(monkeypatch):
    """A one-process gloo mesh: `make_mesh` with no cluster environment falls
    back to a group held in memory."""
    import torch.distributed as dist

    for v in pmesh.CLUSTER_ENV:
        monkeypatch.delenv(v, raising=False)
    mesh = pmesh.make_mesh(device_type="cpu")
    assert dist.get_world_size() == 1
    yield mesh
    dist.destroy_process_group()


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_topk_sharded_matches_jax_on_a_model2_mesh(world1_mesh):
    n, b, k = 1024, 6, 10
    kw = dict(hidden_size=16, num_layers=1, w_rank=4, u_rank=4)
    jr = JaxSessionRanker.create(n, backend="xla", **kw)
    r = SessionRanker.create(n, backend="fused", **kw)
    jp = jr.init(jax.random.PRNGKey(0))
    params = params_from_jax(to_np(jp), device="cpu")
    sess = np.random.default_rng(1).integers(0, n, (7, b)).astype(np.int32)
    h = np.random.default_rng(2).standard_normal((b, 16)).astype(np.float32)
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    p_sh = jax.device_put(jp, jax_lm_param_sharding(jp, mesh))
    for exclude in (None, sess):
        jv, ji = jax.jit(lambda p, hh, e: jr.topk_sharded(p, hh, k, mesh, exclude=e,
                                                          data_sharded=False))(
            p_sh, jnp.asarray(h), None if exclude is None else jnp.asarray(exclude))
        got_v, got_i = r.topk_sharded(params, torch.from_numpy(h), k, world1_mesh,
                                      exclude=exclude)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(got_v.numpy(), np.asarray(jv), atol=2e-5, rtol=2e-5)
        # at S = 1 the merge leaves `topk`'s result as it is
        want = r.topk(params, torch.from_numpy(h), k, exclude=exclude)
        assert torch.equal(got_i, want[1]) and torch.equal(got_v, want[0])


def test_mesh_lm_step_matches_jax_on_a_data4_model2_mesh(world1_mesh):
    vocab, hidden, t, b = 48, 16, 6, 8
    kw = dict(vocab_size=vocab, hidden_size=hidden, num_layers=2, dropout_rate=0.0, winit=0.3)
    jm = JaxLMModel(cell_factory=lambda n, h: JaxVMLMFCell(n, h, w_rank=5, u_rank=4),
                    backend="pallas", **kw)
    m = LMModel(cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=5, u_rank=4), **kw)
    jt = JaxLMTrainer(jm, batch_size=b, seq_length=t, fuse_chunks=1, max_grad_norm=0.5,
                      mesh=jax_make_mesh(data=4, model=2))
    tm = LMTrainer(m, batch_size=b, seq_length=t, max_grad_norm=0.5, mesh=world1_mesh)
    jp = jt.init()
    params = params_from_jax(to_np(jp), device="cpu")
    rng = np.random.default_rng(3)
    js, s = jt.state0(), tm.state0()
    for _ in range(2):
        x, y = (rng.integers(0, vocab, (t, b)).astype(np.int32) for _ in range(2))
        jx, jy = jt.commit_batch(x, y)
        jp, js, jl, jg = jt._train_step(jp, js, jx, jy, jnp.float32(1.0),
                                        jax.random.PRNGKey(1))
        xb, yb = tm.commit_batch(x, y)
        params, s, loss, gnorm = tm.train_step(params, s, xb, yb, 1.0)
        np.testing.assert_allclose(float(loss), float(jl), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(gnorm), float(jg), atol=1e-5, rtol=1e-5)
    want = jax.tree_util.tree_leaves(to_np(jp))
    got = tree_leaves(params)
    assert len(got) == len(want)
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.detach().numpy(), w, atol=3e-4, rtol=3e-4)
