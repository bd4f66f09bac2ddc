"""The port's config builders (`vmlmf_tpu_torch.config`) and `DeepConvNet`
against the JAX package's: for every `HARConfig.model`, for `deepconv` and
`bidirectional`, and for each `LMConfig.lstm_type`, the port builds a model
whose parameter tree matches the JAX builder's key for key, and whose
logits at the transplanted JAX weights match the JAX model's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu import config as jconfig  # noqa: E402
from vmlmf_tpu.nn.layers import ConvFeatures as JaxConvFeatures  # noqa: E402
from vmlmf_tpu_torch import config  # noqa: E402
from vmlmf_tpu_torch.nn.layers import ConvFeatures  # noqa: E402
from vmlmf_tpu_torch.nn.models import DeepConvNet, HARNet, LMModel  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_gru, cuda_scan  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

FWD_TOL = dict(atol=2e-5, rtol=2e-5)    # tests/test_pallas.py, f32 forward

# HARConfig fields of each case (data="UCI": 9 input features)
HAR_CASES = {
    "mylstm": dict(model="mylstm"),
    "mylstm_lmf": dict(model="mylstm", w_rank=4, u_ranks=(3,)),
    "vmmodel": dict(model="vmmodel", w_rank=4, u_ranks=(3,)),
    "vmmodel_group2": dict(model="vmmodel_group2", w_rank=4, u_ranks=(2, 3)),
    "vmgroup_novm": dict(model="vmgroup_novm", w_rank=4, u_ranks=(2, 2)),
    "mygru": dict(model="mygru"),
    "mygru_lowrank": dict(model="mygru", w_rank=4, u_ranks=(3,)),
    "mygru_group": dict(model="mygru_group", u_ranks=(3, 2)),
    "mylstm_group": dict(model="mylstm_group", u_ranks=(2, 3)),
    "dualdiag": dict(model="dualdiag"),
    "diag": dict(model="diag"),
    "bidirectional": dict(model="mylstm", bidirectional=True, merge="sum"),
    "deepconv": dict(model="mylstm", deepconv=True),
}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), to_np(tree))


@pytest.mark.parametrize("case", list(HAR_CASES))
def test_har_config_builds_the_jax_model(case):
    kw = dict(HAR_CASES[case], data="UCI", layer_sizes=(12, 8), num_classes=5)
    jm = jconfig.HARConfig(**kw, backend="xla").build_model()
    cfg = config.HARConfig(**kw)
    assert cfg.backend == "fused" and cfg.input_size == 9
    m = cfg.build_model()
    assert type(m).__name__ == type(jm).__name__
    jparams = jm.init(jax.random.PRNGKey(0))
    own = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert shapes(own) == shapes(jparams)
    t = 17 if cfg.deepconv else 6  # the four valid convolutions need 17 steps
    x = np.random.default_rng(1).standard_normal((4, t, 9)).astype(np.float32)
    want = np.asarray(jm.apply(jparams, jnp.asarray(x)))
    params = params_from_jax(to_np(jparams), device="cpu")
    counts = (cuda_scan.lstm_scan_fused_xin.launches, cuda_gru.gru_scan_fused_xin.launches)
    with torch.no_grad():
        got = m.apply(params, torch.from_numpy(x))
    assert counts == (cuda_scan.lstm_scan_fused_xin.launches, cuda_gru.gru_scan_fused_xin.launches)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


LM_CASES = {"custom": dict(lstm_type="custom"),
            "vmlmf": dict(lstm_type="vmlmf", w_rank=5, u_ranks=(4,)),
            "vmgroup": dict(lstm_type="vmgroup", w_rank=5, u_ranks=(3, 2), groups=2)}


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_config_builds_the_jax_model(case):
    kw = dict(LM_CASES[case], hidden_size=12, layer_num=2, winit=0.5)
    jm = jconfig.LMConfig(**kw, backend="xla").build_model(30)
    m = config.LMConfig(**kw).build_model(30)
    assert isinstance(m, LMModel) and m.backend == "fused"
    assert [type(c).__name__ for c in m.rnn.cells] == [type(c).__name__ for c in jm.rnn.cells]
    jparams = jm.init(jax.random.PRNGKey(0))
    assert shapes(m.init(torch.Generator().manual_seed(0), device="cpu")) == shapes(jparams)
    ids = np.random.default_rng(2).integers(0, 30, (7, 3)).astype(np.int32)
    jstates = jm.rnn.state0(3)
    want, _ = jm.apply(jparams, jnp.asarray(ids), jstates)
    params = params_from_jax(to_np(jparams), device="cpu")
    with torch.no_grad():
        got, _ = m.apply(params, torch.from_numpy(ids).long(), m.state0(3, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_configs_refuse_what_they_cannot_build():
    assert config.LMConfig(head_bf16=True).build_model(10).head_bf16  # a bf16 head, not a refusal
    with pytest.raises(ValueError, match="unsupported lstm_type"):
        config.LMConfig(lstm_type="gru").cell_factory()
    with pytest.raises(ValueError, match="per-tier recurrent ranks"):
        config.HARConfig(model="mygru_group").cell_factory()
    with pytest.raises(ValueError, match="unsupported cell model"):
        config.HARConfig(model="transformer").cell_factory()
    with pytest.raises(ValueError, match="unknown backend"):
        config.HARConfig(backend="pallas").build_model()


def test_har_config_defaults_match_jax():
    want = {f.name: f.default for f in jconfig.HARConfig.__dataclass_fields__.values()}
    got = {f.name: f.default for f in config.HARConfig.__dataclass_fields__.values()}
    assert want.pop("backend") == "xla" and got.pop("backend") == "fused"
    assert got == want
    want = {f.name: f.default for f in jconfig.LMConfig.__dataclass_fields__.values()}
    got = {f.name: f.default for f in config.LMConfig.__dataclass_fields__.values()}
    assert want.pop("backend") == "xla" and got.pop("backend") == "fused"
    assert got == want
    m = config.HARConfig().build_model()  # the CLI default: dense LSTMCell(77, 180)
    assert isinstance(m, HARNet) and type(m.rnn.cells[0]).__name__ == "LSTMCell"
    assert (m.rnn.cells[0].input_size, m.rnn.cells[0].w_rank, m.rnn.cells[0].u_rank) == (
        77, None, None)


def test_conv_features_match_jax_and_deepconvnet_needs_17_steps():
    jconv, conv = JaxConvFeatures(channels=6), ConvFeatures(channels=6)
    jparams = jconv.init(jax.random.PRNGKey(3))
    assert shapes(conv.init(torch.Generator().manual_seed(0), device="cpu")) == shapes(jparams)
    x = np.random.default_rng(4).standard_normal((2, 19, 5)).astype(np.float32)
    got = conv(params_from_jax(to_np(jparams), device="cpu"), torch.from_numpy(x))
    assert tuple(got.shape) == (2, 3, 5 * 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jconv(jparams, jnp.asarray(x))),
                               **FWD_TOL)
    relu = ConvFeatures(channels=6, activation=True)
    assert float(relu(params_from_jax(to_np(jparams), device="cpu"),
                      torch.from_numpy(x)).min()) >= 0
    m = DeepConvNet(5, (8,), cell_factory=config.HARConfig().cell_factory(), channels=6)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert tuple(m.apply(params, torch.from_numpy(x)).shape) == (2, 18)
    with pytest.raises(ValueError, match="at least 17 timesteps"):
        m.apply(params, torch.zeros(2, 16, 5))
