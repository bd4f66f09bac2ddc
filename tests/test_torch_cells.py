"""The port's cell core (`vmlmf_tpu_torch.cells`, `.ops.lowrank`) against the
JAX package's, on the same numpy inputs and transplanted parameters."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu.cells import VMLMFCell as JaxVMLMFCell  # noqa: E402
from vmlmf_tpu.cells import base as jax_base  # noqa: E402
from vmlmf_tpu.ops import lowrank as jax_lowrank  # noqa: E402
from vmlmf_tpu_torch.cells import VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.cells import base  # noqa: E402
from vmlmf_tpu_torch.ops import lowrank  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
SIZES = {"n_eq_h": (16, 16), "n_lt_h": (9, 20), "n_gt_h": (24, 12)}


def close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_lstm_update_matches_jax():
    rng = np.random.default_rng(0)
    pre = rng.standard_normal((3, 4 * 7)).astype(np.float32)
    c = rng.standard_normal((3, 7)).astype(np.float32)
    h_t, c_t = base.lstm_update(torch.from_numpy(pre), torch.from_numpy(c))
    h_j, c_j = jax_base.lstm_update(jnp.asarray(pre), jnp.asarray(c))
    close(h_t, h_j)
    close(c_t, c_j)


@pytest.mark.parametrize("size", [5, 8, 11])
def test_pad_features_matches_jax(size):
    x = np.arange(16, dtype=np.float32).reshape(2, 8)
    np.testing.assert_array_equal(base.pad_features(torch.from_numpy(x), size).numpy(),
                                  np.asarray(jax_base.pad_features(jnp.asarray(x), size)))


@pytest.mark.parametrize("n,h", list(SIZES.values()), ids=list(SIZES))
def test_lowrank_matches_jax(n, h):
    rng = np.random.default_rng(1)
    u = rng.standard_normal((n, 5)).astype(np.float32)
    v = rng.standard_normal((4 * h, 5)).astype(np.float32)
    x = rng.standard_normal((3, n)).astype(np.float32)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    close(lowrank.lowrank_proj(torch.from_numpy(x), tu, tv),
          jax_lowrank.lowrank_proj(jnp.asarray(x), jnp.asarray(u), jnp.asarray(v)))
    close(lowrank.gate_diag_rowsum(tu, tv, 4, h),
          jax_lowrank.gate_diag_rowsum(jnp.asarray(u), jnp.asarray(v), 4, h))


@pytest.mark.parametrize("n,h", list(SIZES.values()), ids=list(SIZES))
def test_vmlmf_cell_matches_jax(n, h):
    jcell, cell = JaxVMLMFCell(n, h, w_rank=4, u_rank=3), VMLMFCell(n, h, w_rank=4, u_rank=3)
    jparams = jcell.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    assert params.keys() == jparams.keys()
    jprep, prep = jcell.prepare(jparams), cell.prepare(params)
    for k in ("dcorr_x", "dcorr_h"):
        close(prep[k], jprep[k])

    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 3, n)).astype(np.float32)
    h0 = (0.3 * rng.standard_normal((3, h))).astype(np.float32)
    c0 = (0.3 * rng.standard_normal((3, h))).astype(np.float32)
    gi, gi_j = cell.inp(prep, torch.from_numpy(x)), jcell.inp(jprep, jnp.asarray(x))
    close(gi, gi_j)
    (h1, c1), y = cell.step(prep, gi[0], (torch.from_numpy(h0), torch.from_numpy(c0)))
    (h1_j, c1_j), y_j = jcell.step(jprep, gi_j[0], (jnp.asarray(h0), jnp.asarray(c0)))
    close(h1, h1_j)
    close(c1, c1_j)
    close(y, y_j)
    # the fused kernel's inputs are the same function as inp/step
    for a, b in zip(cell.fused_x_inputs(prep) + cell.fused_rec_inputs(prep),
                    jcell.fused_x_inputs(jprep) + jcell.fused_rec_inputs(jprep)):
        assert a.is_contiguous()
        close(a, b)


def test_cell_init_layout_and_uniform_reset():
    cell = VMLMFCell(9, 20, w_rank=4, u_rank=3)
    jparams = JaxVMLMFCell(9, 20, w_rank=4, u_rank=3).init(jax.random.PRNGKey(0))
    params = cell.init(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in jparams.items()}
    again = cell.init(torch.Generator().manual_seed(0), device="cpu")
    for k in params:
        torch.testing.assert_close(params[k], again[k], atol=0, rtol=0)
    reset = base.reinit_uniform(params, torch.Generator().manual_seed(1), 0.05)
    for k, v in reset.items():
        assert v.shape == params[k].shape and float(v.abs().max()) <= 0.05
