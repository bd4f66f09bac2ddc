"""The port's session ranker (`vmlmf_tpu_torch.serve.ranker`) against the JAX
package's (`vmlmf_tpu.serve.ranker`), from transplanted parameters on the same
inputs: encoding, scoring, retrieval, metrics, the full-CE and sampled losses
with their gradients on JAX's negatives, and the sparse and dense sampled
trainers over several steps. The JAX side runs its "xla" backend, the port
"fused" (its plain versions on the CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu.serve import ranker as jr  # noqa: E402
from vmlmf_tpu_torch.serve import ranker as tr  # noqa: E402
from vmlmf_tpu_torch.train.lm import LMTrainer  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402
from vmlmf_tpu_torch.utils.tree import tree_leaves  # noqa: E402

FWD = dict(atol=2e-5, rtol=2e-5)    # forward values
GRAD = dict(atol=3e-4, rtol=3e-4)   # gradients, and parameters after steps
N, H, T, B = 64, 16, 7, 5
KEY = jax.random.PRNGKey(0)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(num_items=N, hidden=H, tie=True, jax_backend="xla"):
    """(JAX ranker, port ranker, JAX params, the same params in the port)."""
    kw = dict(hidden_size=hidden, num_layers=1, w_rank=4, u_rank=4, tie_items=tie)
    jrk = jr.SessionRanker.create(num_items, backend=jax_backend, **kw)
    prk = tr.SessionRanker.create(num_items, backend="fused", **kw)
    jp = jrk.init(KEY)
    return jrk, prk, jp, params_from_jax(to_np(jp), device="cpu")


def ids(shape, high=N, seed=1):
    return np.random.default_rng(seed).integers(0, high, shape).astype(np.int32)


def assert_trees_close(port, jax_tree, tol):
    want = jax.tree_util.tree_leaves(to_np(jax_tree))
    got = [p.detach().numpy() for p in tree_leaves(port)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol)


def jax_negatives(key, num, n=N):
    """The negatives JAX's sampled loss and sparse step draw from ``key``."""
    return np.asarray(jax.random.randint(jax.random.split(key)[1], (num,), 0, n))


class TestEncodeAndScore:
    def test_encode_carries_state_and_matches_jax(self):
        jrk, prk, jp, pp = pair()
        a, b = ids((T, B)), ids((4, B), seed=2)
        h, states = prk.encode(pp, a)
        jh, jstates = jrk.encode(jp, jnp.asarray(a))
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **FWD)
        torch.testing.assert_close(h, states[-1][0], rtol=0, atol=0)
        h2, _ = prk.encode(pp, b, states)
        h_full, _ = prk.encode(pp, np.concatenate([a, b]))
        torch.testing.assert_close(h2, h_full, atol=1e-6, rtol=1e-6)
        jh2, _ = jrk.encode(jp, jnp.asarray(b), jstates)
        np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), **FWD)

    def test_score_matches_lm_logits_and_jax(self):
        jrk, prk, jp, pp = pair()
        a = ids((T, B))
        h, _ = prk.encode(pp, a)
        logits, _ = prk.model.apply(pp, torch.as_tensor(a).long(), prk.model.state0(B, "cpu"))
        torch.testing.assert_close(prk.score(pp, h), logits[-1], atol=1e-6, rtol=1e-6)
        jh, _ = jrk.encode(jp, jnp.asarray(a))
        np.testing.assert_allclose(prk.score(pp, h).numpy(), np.asarray(jrk.score(jp, jh)),
                                   **FWD)

    @pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
    def test_item_table_tied_and_untied(self, tie):
        jrk, prk, jp, pp = pair(tie=tie)
        assert ("w" in pp["fc"]) == (not tie)
        assert tuple(prk.item_table(pp).shape) == (N, H)
        np.testing.assert_array_equal(prk.item_table(pp).numpy(),
                                      np.asarray(jrk.item_table(jp)))
        h = torch.randn(B, H, generator=torch.Generator().manual_seed(0))
        np.testing.assert_allclose(prk.score(pp, h).numpy(),
                                   np.asarray(jrk.score(jp, jnp.asarray(h.numpy()))), **FWD)


class TestTopK:
    def test_topk_matches_argsort_oracle_and_jax(self):
        jrk, prk, jp, pp = pair()
        h = torch.randn(B, H, generator=torch.Generator().manual_seed(1))
        vals, top = prk.topk(pp, h, 8)
        assert top.dtype == torch.int32
        scores = prk.score(pp, h).numpy()
        oracle = np.argsort(-scores, axis=1)[:, :8]
        np.testing.assert_array_equal(top.numpy(), oracle)
        np.testing.assert_allclose(vals.numpy(), np.take_along_axis(scores, oracle, 1),
                                   rtol=1e-6)
        jv, ji = jrk.topk(jp, jnp.asarray(h.numpy()), 8)
        np.testing.assert_array_equal(top.numpy(), np.asarray(ji))
        np.testing.assert_allclose(vals.numpy(), np.asarray(jv), **FWD)

    def test_exclude_seen_masks_session_items_as_jax(self):
        jrk, prk, jp, pp = pair()
        seen = ids((T, B))
        h, _ = prk.encode(pp, seen)
        _, top = prk.topk(pp, h, 40, exclude=seen)
        for b in range(B):
            n_unseen = N - len(set(seen[:, b]))
            assert not set(top[b, :n_unseen].tolist()) & set(seen[:, b].tolist())
        _, jtop = jrk.topk(jp, jnp.asarray(h.numpy()), 40, exclude=jnp.asarray(seen))
        np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))

    def test_mask_seen_drops_ids_below_and_above_the_shard(self):
        """A shard of 10 columns at offset 20: id 5 lies below it (it would
        wrap under torch indexing), 23 inside, 40 above (it would raise)."""
        scores = np.arange(30, dtype=np.float32).reshape(3, 10)
        seen = np.array([[5, 23, 40], [29, 20, 5]], dtype=np.int64)   # [T=2, B=3]
        got = tr.SessionRanker._mask_seen(torch.from_numpy(scores), torch.from_numpy(seen), 20)
        want = jr.SessionRanker._mask_seen(jnp.asarray(scores), jnp.asarray(seen), 20)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        low = np.finfo(np.float32).min
        assert got[1, 3] == low and got[0, 9] == low and got[1, 0] == low
        assert int((got.numpy() == low).sum()) == 3

    def test_approx_runs_the_exact_path_and_unknown_methods_raise(self):
        _, prk, _, pp = pair(num_items=2048)
        h = torch.randn(6, H, generator=torch.Generator().manual_seed(2))
        exact = prk.topk(pp, h, 32)
        approx = prk.topk(pp, h, 32, method="approx", recall_target=0.5)
        for a, e in zip(approx, exact):
            torch.testing.assert_close(a, e, rtol=0, atol=0)
        with pytest.raises(ValueError, match="unknown retrieval method"):
            prk.topk(pp, h, 4, method="fancy")
        with pytest.raises(ValueError, match="exceeds the catalog"):
            prk.topk(pp, h, 4096)


class TestBlockedTopK:
    @pytest.mark.parametrize("n,k,block", [(100, 10, 2048), (5000, 100, 2048), (4096, 7, 2048),
                                           (3000, 2048, 2048), (10000, 1, 512)])
    def test_matches_full_topk_and_jax(self, n, k, block):
        scores = np.array(jax.random.normal(jax.random.PRNGKey(n + k), (6, n)))
        bv, bi = tr.blocked_topk(torch.from_numpy(scores), k, block=block)
        assert bi.dtype == torch.int32
        tv, ti = torch.topk(torch.from_numpy(scores), k)
        torch.testing.assert_close(bv, tv, rtol=0, atol=0)
        np.testing.assert_array_equal(bi.numpy(), ti.numpy())
        jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
        np.testing.assert_array_equal(bi.numpy(), np.asarray(ji))
        np.testing.assert_allclose(bv.numpy(), np.asarray(jv), rtol=1e-7)

    def test_padding_never_wins(self):
        _, idx = tr.blocked_topk(torch.full((2, 3000), -1e30), 5, block=2048)
        assert (idx < 3000).all()


class TestEvalMetrics:
    def test_metrics_against_hand_computation(self):
        _, prk, _, pp = pair()
        sessions = ids((T, 10))
        _, top = prk.rank_next(pp, sessions, 20)
        top = top.numpy()
        targets = np.where(np.arange(10) % 2 == 0, top[:, 0], top[:, 4])
        m = prk.eval_metrics(pp, sessions, targets, ks=(1, 5, 10))
        assert m["recall@1"] == 0.5 and m["recall@5"] == 1.0 and m["recall@10"] == 1.0
        assert m["mrr"] == pytest.approx(0.5 * 1.0 + 0.5 * (1 / 5))

    def test_metrics_match_jax(self):
        jrk, prk, jp, pp = pair(num_items=256)
        sessions, targets = ids((T, 8), high=256), ids((8,), high=256, seed=3)
        got = prk.eval_metrics(pp, sessions, targets, exclude_seen=True)
        want = jrk.eval_metrics(jp, jnp.asarray(sessions), jnp.asarray(targets),
                                exclude_seen=True)
        assert got == want

    def test_rank_next_fused_equals_loop(self):
        _, prk, _, pp = pair()
        loop = tr.SessionRanker.create(N, hidden_size=H, num_layers=1, w_rank=4, u_rank=4,
                                       backend="xla")
        assert loop.model.backend == "loop"
        sessions = ids((T, B))
        for a, b in zip(prk.rank_next(pp, sessions, 6), loop.rank_next(pp, sessions, 6)):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def grads_of(fn, params):
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = fn(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def jax_grads(fn, params):
    loss, g = jax.value_and_grad(fn)(params)
    return loss, [np.asarray(a) for a in jax.tree_util.tree_leaves(g)]


def check_grads(got, want):
    (loss, grads), (jloss, jgrads) = got, want
    np.testing.assert_allclose(float(loss), float(jloss), **FWD)
    assert len(grads) == len(jgrads)
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), w, **GRAD)


class TestLosses:
    def test_full_ce_loss_and_grads_match_jax(self):
        jrk, prk, jp, pp = pair()
        x, y = ids((T, B)), ids((T, B), seed=2)
        got = grads_of(lambda p: prk.loss(p, x, y, prk.model.state0(B, "cpu"))[0], pp)
        want = jax_grads(lambda p: jrk.loss(p, jnp.asarray(x), jnp.asarray(y),
                                            jrk.model.state0(B))[0], jp)
        check_grads(got, want)

    @pytest.mark.parametrize("in_batch", [False, True], ids=["uniform", "in_batch"])
    def test_sampled_softmax_loss_and_grads_match_jax(self, in_batch):
        jrk, prk, jp, pp = pair()
        rng = np.random.default_rng(4)
        hs = rng.standard_normal((10, H)).astype(np.float32)
        targets = ids((10,), seed=5)
        key = jax.random.PRNGKey(3)
        neg = np.asarray(jax.random.randint(key, (32,), 0, N))
        got = grads_of(lambda p: prk.sampled_softmax_loss(
            p, torch.from_numpy(hs), targets, None, 32, in_batch=in_batch, negatives=neg), pp)
        want = jax_grads(lambda p: jrk.sampled_softmax_loss(
            p, jnp.asarray(hs), jnp.asarray(targets), key, 32, in_batch=in_batch), jp)
        check_grads(got, want)

    def test_sampled_loss_over_a_chunk_matches_jax(self):
        jrk, prk, jp, pp = pair()
        x, y = ids((T, B)), ids((T, B), seed=2)
        key = jax.random.PRNGKey(7)
        neg = jax_negatives(key, 16)
        got = grads_of(lambda p: prk.sampled_loss(
            p, x, y, prk.model.state0(B, "cpu"), None, 16, in_batch=True, negatives=neg)[0], pp)
        want = jax_grads(lambda p: jrk.sampled_loss(
            p, jnp.asarray(x), jnp.asarray(y), jrk.model.state0(B), key, 16,
            in_batch=True)[0], jp)
        check_grads(got, want)

    @pytest.mark.parametrize("case", ["all_hits_and_one_row", "one_in_batch_column"])
    def test_fully_masked_blocks_keep_a_finite_gradient(self, case):
        """T = B = 1 with in-batch negatives masks the whole in-batch block;
        negatives that all hit the target mask the whole sampled block."""
        _, prk, _, pp = pair()
        hs = torch.randn(1, H, generator=torch.Generator().manual_seed(0))
        neg = [3, 3, 3] if case == "all_hits_and_one_row" else [1, 2, 4]
        loss, grads = grads_of(lambda p: prk.sampled_softmax_loss(
            p, hs, [3], None, 3, in_batch=True, negatives=neg), pp)
        assert torch.isfinite(loss)
        assert all(torch.isfinite(g).all() for g in grads)

    def test_dedup_sq_norm_equals_dense_scatter_and_jax(self):
        rng = np.random.default_rng(0)
        i = rng.integers(0, 7, (20,))
        rows = rng.standard_normal((20, 3)).astype(np.float32)
        got = float(tr._dedup_sq_norm(torch.from_numpy(i), torch.from_numpy(rows)))
        dense = torch.zeros(7, 3).index_add_(0, torch.from_numpy(i), torch.from_numpy(rows))
        assert got == pytest.approx(float((dense * dense).sum()), rel=1e-6)
        assert got == pytest.approx(float(jr._dedup_sq_norm(jnp.asarray(i), jnp.asarray(rows))),
                                    rel=1e-6)


def sample_chunks(k, num_items=128, seed=1):
    xs = np.random.RandomState(seed).randint(0, num_items, (k, 5, 4)).astype(np.int32)
    return xs, ((xs * 3 + 7) % num_items).astype(np.int32)


class TestTrainers:
    def test_loss_fn_hook_replaces_the_training_loss(self):
        _, prk, _, pp = pair()
        calls = []

        def loss_fn(p, x, y, states, generator, scale=1.0):
            calls.append(scale)
            loss, new_states = prk.loss(p, x, y, states, generator=generator)
            return scale * loss, new_states

        t = LMTrainer(prk.model, batch_size=B, seq_length=T, device="cpu", loss_fn=loss_fn)
        x, y = ids((T, B)), ids((T, B), seed=2)
        ref = LMTrainer(prk.model, batch_size=B, seq_length=T, device="cpu")
        p2 = params_from_jax(jax.tree_util.tree_map(lambda a: a.detach().numpy(), pp), "cpu")
        _, _, loss, _ = t.train_step(pp, t.state0(), x, y, 0.5, scale=2.0)
        _, _, want, _ = ref.train_step(p2, ref.state0(), x, y, 0.5)
        assert calls == [2.0]
        assert float(loss) == pytest.approx(2 * float(want), rel=1e-6)

    def test_train_step_keywords_without_a_loss_fn_raise(self):
        _, prk, _, pp = pair()
        t = LMTrainer(prk.model, batch_size=B, seq_length=T, device="cpu")
        with pytest.raises(TypeError, match="negatives"):
            t.train_step(pp, t.state0(), ids((T, B)), ids((T, B), seed=2), 0.5,
                         negatives=np.arange(4))

    def test_sparse_trainer_matches_jax_over_three_steps(self):
        jrk, prk, jp, pp = pair(num_items=128)
        jt = jrk.sparse_trainer(batch_size=4, seq_length=5, fuse_chunks=1, sampled_softmax=16,
                                in_batch_negatives=True)
        t = prk.sparse_trainer(batch_size=4, seq_length=5, sampled_softmax=16,
                               in_batch_negatives=True, device="cpu")
        xs, ys = sample_chunks(3)
        js, s = jt.state0(), t.state0()
        for i in range(3):
            key = jax.random.PRNGKey(i)
            jp, js, jl, jg = jt._train_step(jp, js, jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                                            jnp.float32(0.5), key)
            pp, s, loss, gnorm = t.train_step(pp, s, xs[i], ys[i], 0.5,
                                              negatives=jax_negatives(key, 16, 128))
            np.testing.assert_allclose(float(loss), float(jl), **FWD)
            np.testing.assert_allclose(float(gnorm), float(jg), **FWD)
        assert_trees_close(pp, jp, GRAD)

    def test_dense_sampled_trainer_matches_jax_over_three_steps(self):
        jrk, prk, jp, pp = pair(num_items=128)
        jt = jrk.trainer(batch_size=4, seq_length=5, fuse_chunks=1, sampled_softmax=16,
                         in_batch_negatives=True, learning_rate=0.5)
        t = prk.trainer(batch_size=4, seq_length=5, sampled_softmax=16,
                        in_batch_negatives=True, device="cpu")
        xs, ys = sample_chunks(3)
        js, s = jt.state0(), t.state0()
        for i in range(3):
            key = jax.random.PRNGKey(i)
            jp, js, jl, jg = jt._train_step(jp, js, jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                                            jnp.float32(0.5), key)
            pp, s, loss, gnorm = t.train_step(pp, s, xs[i], ys[i], 0.5,
                                              negatives=jax_negatives(key, 16, 128))
            np.testing.assert_allclose(float(loss), float(jl), **FWD)
            np.testing.assert_allclose(float(gnorm), float(jg), **FWD)
        assert_trees_close(pp, jp, GRAD)

    def test_sparse_trainer_equals_dense_sampled_trainer(self):
        """Step for step, with one generator's negatives on both sides."""
        _, prk, _, _ = pair(num_items=128)
        dense = prk.trainer(batch_size=4, seq_length=5, sampled_softmax=16,
                            in_batch_negatives=True, device="cpu")
        sparse = prk.sparse_trainer(batch_size=4, seq_length=5, sampled_softmax=16,
                                    in_batch_negatives=True, device="cpu")
        pd, ps = dense.init(), sparse.init()
        sd, ss = dense.state0(), sparse.state0()
        gd, gs = (torch.Generator().manual_seed(5) for _ in range(2))
        xs, ys = sample_chunks(4)
        for i in range(4):
            pd, sd, ld, nd = dense.train_step(pd, sd, xs[i], ys[i], 0.5, gd)
            ps, ss, ls, ns = sparse.train_step(ps, ss, xs[i], ys[i], 0.5, gs)
            assert float(ld) == pytest.approx(float(ls), rel=1e-5)
            assert float(nd) == pytest.approx(float(ns), rel=1e-5)
        for a, b in zip(tree_leaves(pd), tree_leaves(ps)):
            torch.testing.assert_close(a.detach(), b.detach(), atol=2e-6, rtol=2e-6)

    def test_fused_chunks_equals_stepping(self):
        _, prk, _, _ = pair(num_items=128)
        t = prk.sparse_trainer(batch_size=4, seq_length=5, sampled_softmax=16, device="cpu")
        xs, ys = sample_chunks(3)
        negs = np.random.RandomState(2).randint(0, 128, (3, 16))
        pa, sa = t.init(), t.state0()
        pa, sa, losses, gnorms = t.fused_chunks(pa, sa, xs, ys, 0.5, negatives=negs)
        pb, sb = t.init(), t.state0()
        for i in range(3):
            pb, sb, loss, gnorm = t.train_step(pb, sb, xs[i], ys[i], 0.5, negatives=negs[i])
            assert float(losses[i]) == float(loss) and float(gnorms[i]) == float(gnorm)
        for a, b in zip(tree_leaves(pa), tree_leaves(pb)):
            torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=0)

    def test_sparse_step_passes_unknown_keys_through(self):
        _, prk, _, _ = pair(num_items=128)
        t = prk.sparse_trainer(batch_size=4, seq_length=5, sampled_softmax=16, device="cpu")
        p = t.init()
        p["extra"] = {"w": torch.ones(3)}
        xs, ys = sample_chunks(1)
        p, _, loss, _ = t.train_step(p, t.state0(), xs[0], ys[0], 0.5,
                                     torch.Generator().manual_seed(0))
        assert torch.equal(p["extra"]["w"], torch.ones(3)) and torch.isfinite(loss)

    def test_untied_table_rejected(self):
        _, prk, _, _ = pair(tie=False)
        with pytest.raises(ValueError, match="tie_items"):
            prk.sparse_trainer()
