"""The port's trainers (`vmlmf_tpu_torch.train`) against the JAX package's, from
the same transplanted parameters on the same batches, with the fused scan on
both sides (the port's plain versions on the CPU, Pallas interpret mode in
JAX). Dropout is 0 on the LM, since the two frameworks draw different masks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu.cells import VMLMFCell as JaxVMLMFCell  # noqa: E402
from vmlmf_tpu.data.batching import batch_iterator as jax_batch_iterator  # noqa: E402
from vmlmf_tpu.data.ptb import minibatch, synthetic_corpus  # noqa: E402
from vmlmf_tpu.nn.models import HARNet as JaxHARNet  # noqa: E402
from vmlmf_tpu.nn.models import LMModel as JaxLMModel  # noqa: E402
from vmlmf_tpu.train.har import HARTrainer as JaxHARTrainer  # noqa: E402
from vmlmf_tpu.train.har import evaluate as jax_evaluate  # noqa: E402
from vmlmf_tpu.train.lm import LMTrainer as JaxLMTrainer  # noqa: E402
from vmlmf_tpu.train.lm import lm_loss as jax_lm_loss  # noqa: E402
from vmlmf_tpu_torch.cells import VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.data.batching import batch_iterator  # noqa: E402
from vmlmf_tpu_torch.data.har import synthetic_har  # noqa: E402
from vmlmf_tpu_torch.nn.layers import Dense  # noqa: E402
from vmlmf_tpu_torch.nn.models import HARNet, LMModel  # noqa: E402
from vmlmf_tpu_torch.ops import cuda_scan  # noqa: E402
from vmlmf_tpu_torch.train.har import HARTrainer, evaluate  # noqa: E402
from vmlmf_tpu_torch.train.lm import LMTrainer, clip_by_global_norm, lm_loss  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

STEP_TOL = dict(atol=1e-5, rtol=1e-5)     # loss, gnorm: one forward's f32 sums
LM_PARAM_TOL = dict(atol=3e-4, rtol=3e-4)  # after SGD steps: the gradient tolerance
# Adam's g / sqrt(v) magnifies f32 sum-order noise where a gradient is near
# zero, so the parameters after Adam steps get a wider tolerance than the loss.
HAR_PARAM_TOL = dict(atol=1e-4, rtol=1e-4)

VOCAB, HIDDEN, LAYERS, T, B = 48, 24, 2, 8, 5


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_close(port, jax_tree, tol):
    want = jax.tree_util.tree_leaves_with_path(to_np(jax_tree))
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_leaves_with_path(
               jax.tree_util.tree_map(lambda p: p.detach().numpy(), port))}
    assert len(got) == len(want)
    for k, w in want:
        np.testing.assert_allclose(got[jax.tree_util.keystr(k)], w,
                                   err_msg=jax.tree_util.keystr(k), **tol)


def lm_setup():
    kw = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS, dropout_rate=0.0,
              winit=0.3)
    jm = JaxLMModel(cell_factory=lambda n, h: JaxVMLMFCell(n, h, w_rank=5, u_rank=4),
                    backend="pallas", **kw)
    m = LMModel(cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=5, u_rank=4),
                backend="fused", **kw)
    chunks = minibatch(synthetic_corpus(vocab_size=VOCAB, length=B * T * 4 + 1, seed=2), B, T)
    return jm, m, chunks[:3]


def test_lm_train_steps_and_perplexity_match_jax():
    jm, m, chunks = lm_setup()
    # a clip norm below the gradients' norm, so that the clip is exercised
    jt = JaxLMTrainer(jm, batch_size=B, seq_length=T, fuse_chunks=1, max_grad_norm=0.5)
    t = LMTrainer(m, batch_size=B, seq_length=T, max_grad_norm=0.5, device="cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(to_np(jparams), device="cpu")
    jstates, states = jt.state0(), t.state0()
    counts = (cuda_scan.lstm_scan_fused_xin_res.launches, cuda_scan.lstm_scan_xin_bwd.launches)
    for x, y in chunks:
        jparams, jstates, jloss, jgnorm = jt._train_step(
            jparams, jstates, jnp.asarray(x), jnp.asarray(y), jnp.float32(1.0),
            jax.random.PRNGKey(1))
        params, states, loss, gnorm = t.train_step(params, states, x, y, 1.0)
        np.testing.assert_allclose(float(loss), float(jloss), **STEP_TOL)
        np.testing.assert_allclose(float(gnorm), float(jgnorm), **STEP_TOL)
        assert all(not s.requires_grad for st in states for s in st)  # TBPTT: detached
    assert counts == (cuda_scan.lstm_scan_fused_xin_res.launches,
                      cuda_scan.lstm_scan_xin_bwd.launches)  # CPU: no kernel
    assert float(gnorm) > t.max_grad_norm  # the clip was active
    assert_trees_close(params, jparams, LM_PARAM_TOL)
    for (h, c), (jh, jc) in zip(states, jstates):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **LM_PARAM_TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **LM_PARAM_TOL)
    assert t.perplexity(params, chunks) == pytest.approx(jt.perplexity(jparams, chunks),
                                                         rel=1e-5)


def test_lm_fit_trains_with_dropout_and_decay():
    _, m, _ = lm_setup()
    m = LMModel(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS, dropout_rate=0.5,
                winit=0.1, cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=5, u_rank=4))
    corpus = synthetic_corpus(vocab_size=VOCAB, length=4000, seed=0)
    data = [minibatch(corpus[a:b], B, T) for a, b in ((0, 3000), (3000, 3500), (3500, 4000))]
    t = LMTrainer(m, batch_size=B, seq_length=T, factor_epoch=0, device="cpu")
    logs = []
    params, history = t.fit(t.init(), data, epochs=2, log_every=40, log_fn=logs.append)
    assert [h["lr"] for h in history[:2]] == [1.0, pytest.approx(1.0 / 1.2)]
    assert history[1]["val_ppl"] < history[0]["val_ppl"] < VOCAB
    assert np.isfinite(history[-1]["test_ppl"])
    # fuse_chunks (256) covers the epoch: one block, logged once at its end
    n = len(data[0])
    assert any(line.startswith(f"chunks {n}/{n}, train loss = ") for line in logs)


def test_lm_loss_and_clip_match_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((T, B, VOCAB))).astype(np.float32)
    y = rng.integers(0, VOCAB, (T, B)).astype(np.int32)
    want = float(jax_lm_loss(jnp.asarray(logits), jnp.asarray(y)))
    got = float(lm_loss(torch.from_numpy(logits), torch.from_numpy(y).long()))
    assert got == pytest.approx(want, rel=1e-6)
    grads = [torch.full((3,), 4.0), torch.full((4,), -3.0)]
    clipped, norm = clip_by_global_norm(grads, 5.0)
    assert float(norm) == pytest.approx(np.sqrt(3 * 16 + 4 * 9))
    assert float(torch.sqrt(sum((g * g).sum() for g in clipped))) == pytest.approx(5.0, rel=1e-5)
    small, _ = clip_by_global_norm(grads, 100.0)
    assert all(torch.equal(a, b) for a, b in zip(small, grads))


def har_setup(backend="fused"):
    n_feat, hidden, classes = 12, 20, 5  # F < h, as on OPP (77 < 180)
    jmodel = JaxHARNet(n_feat, (hidden,), num_classes=classes,
                       cell_factory=lambda n, h: JaxVMLMFCell(n, h, w_rank=4, u_rank=3),
                       backend={"fused": "pallas", "loop": "xla"}[backend])
    model = HARNet(n_feat, (hidden,), num_classes=classes, backend=backend,
                   cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=4, u_rank=3))
    x_tr, y_tr, x_te, y_te = synthetic_har("opp", n_train=40, n_test=23, seed=1,
                                           channels=n_feat, num_classes=classes)
    return jmodel, model, x_tr[:, :8], y_tr, x_te[:, :8], y_te  # T = 8


def test_har_train_steps_match_jax():
    jmodel, model, x_tr, y_tr, _, _ = har_setup()
    jt = JaxHARTrainer(jmodel, batch_size=9, fuse_batches=1)
    t = HARTrainer(model, batch_size=9, device="cpu")
    jparams, jopt = jt.init()
    params = params_from_jax(to_np(jparams), device="cpu")
    opt = t.optimizer(params)
    steps = zip(jax_batch_iterator(x_tr, y_tr, 9, shuffle=True, drop_last=True, seed=3),
                batch_iterator(x_tr, y_tr, 9, shuffle=True, drop_last=True, seed=3))
    n = 0
    for (jx, jy), (x, y) in steps:
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        jparams, jopt, jloss = jt._train_step(jparams, jopt, jx, jy)
        params, opt, loss = t.train_step(params, opt, x, y)
        np.testing.assert_allclose(float(loss), float(jloss), **STEP_TOL)
        n += 1
    assert n == 4
    assert_trees_close(params, jparams, HAR_PARAM_TOL)


def test_har_fit_and_evaluate_match_jax():
    jmodel, model, x_tr, y_tr, x_te, y_te = har_setup()
    jt = JaxHARTrainer(jmodel, batch_size=9, fuse_batches=1)
    t = HARTrainer(model, batch_size=9, device="cpu")
    jparams, jopt = jt.init()
    params = params_from_jax(to_np(jparams), device="cpu")
    jparams, _, jhist = jt.fit(jparams, jopt, x_tr, y_tr, epochs=1, log_fn=None)
    params, _, hist = t.fit(params, t.optimizer(params), x_tr, y_tr, epochs=1, log_fn=None)
    np.testing.assert_allclose(hist[0]["loss"], jhist[0]["loss"], **STEP_TOL)
    assert_trees_close(params, jparams, HAR_PARAM_TOL)
    # evaluation on the same parameters: the same predictions, so the same
    # accuracy and macro-F1 exactly (23 rows in batches of 10: padded tail)
    same = params_from_jax(to_np(jparams), device="cpu")
    assert evaluate(model, same, x_te, y_te, batch_size=10) == jax_evaluate(
        jmodel, jparams, x_te, y_te, batch_size=10)
    preds = t.predict(same, x_te)
    assert preds.shape == (len(y_te),)


@pytest.mark.parametrize("backend", ["fused", "loop"])
def test_harnet_apply_and_transplant_match_jax(backend):
    jmodel, model, _, _, x_te, _ = har_setup(backend)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    params = params_from_jax(to_np(jparams), device="cpu")
    assert set(params) == {"rnn", "head"} and set(params["head"]) == {"w", "b"}
    np.testing.assert_allclose(model.apply(params, torch.from_numpy(x_te)).numpy(),
                               np.asarray(jmodel.apply(jparams, jnp.asarray(x_te))),
                               atol=2e-5, rtol=2e-5)
    own = model.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), to_np(jparams))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), own) == shapes
    assert torch.equal(own["head"]["b"], torch.full((5,), 0.1))


def test_dense_bias_fill():
    g = torch.Generator().manual_seed(0)
    assert torch.equal(Dense(3, 4).init(g, device="cpu")["b"], torch.zeros(4))
    p = Dense(3, 4, bias_fill=0.1).init(g, device="cpu")
    assert torch.equal(p["b"], torch.full((4,), 0.1))
    assert p["w"].shape == (3, 4) and 0 < float(p["w"].abs().max()) < 0.1


def test_trainers_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    _, m, _ = lm_setup()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMTrainer(m).init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HARTrainer(har_setup()[1]).init()
