"""Session-based next-item ranking: a VMLMF session encoder over an item
table, with top-K retrieval on one device or over a row-sharded table
(counterpart of `vmlmf_tpu.serve.ranker`).

  * **model** — a `SessionRanker` is an item-vocabulary `LMModel` with tied
    embeddings by default, so one ``[N, H]`` table is both the input
    embedding and the scoring matrix; full-CE training is `LMTrainer`'s.
  * **encode** — the session prefix ``[T, B]`` runs through the recurrence
    (on "fused", the no-grad scan kernel, one launch a layer) and the last
    layer's final hidden state ``[B, H]`` is the session vector.
  * **top-K** — scores ``h·tableᵀ + b`` ``[B, N]`` and retrieves the k best.
    Over a table split by rows on a mesh's ``model`` axis
    (`topk_sharded`), each shard scores its N/S rows, keeps its own top-k,
    and only the S·k candidates cross the ``model`` group to a second top-k.
  * **retrieval** — ``method="exact"`` is exact. The JAX package's
    ``method="approx"`` calls `lax.approx_max_k`, which PyTorch lacks; here
    it runs the exact path, so its recall is 1, and ``recall_target`` is
    accepted and ignored.
  * **sampled softmax** — uniform negatives shared across the batch with the
    logQ correction, accidental hits masked, optionally the batch's own
    targets as in-batch negatives (`_sampled_ce`).
  * **sparse updates** — `SparseSampledTrainer` takes gradients with respect
    to the gathered table rows and scatter-adds the update.

Masked logits take the dtype's lowest finite value, as in the JAX package,
never −inf: a block masked whole then has a finite logsumexp and a finite
(zero) gradient, where −inf would give NaN.

Scatter-adds are deterministic on both devices (`utils.rows.add_rows`): on
CUDA, `index_put_(accumulate=True)`, whose kernel sorts the indices and walks
each run of equal ones in order (no float atomics); on the CPU, `index_add_`,
which adds each row's updates in the order of the ids (there
`index_put_(accumulate=True)` adds with atomics across threads). Gathers
backpropagate through the same adds (`utils.rows.take_rows`). Two equal steps
give equal bits on the same device and thread count.

Negatives come from a `torch.Generator` on the parameters' device, drawn after
the encoder's dropout masks; every entry that draws them also takes them
(``negatives=``), so that a run can reuse another's. Under a mesh they are
broadcast from rank 0, so that every rank uses the same ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from vmlmf_tpu_torch.nn.losses import lm_loss
from vmlmf_tpu_torch.nn.models import LMModel
from vmlmf_tpu_torch.nn.recurrence import backend_name
from vmlmf_tpu_torch.parallel import sharding, spmd
from vmlmf_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size
from vmlmf_tpu_torch.train.lm import LMTrainer
from vmlmf_tpu_torch.utils.device import resolve_device
from vmlmf_tpu_torch.utils.graphs import CarriedSteps, graph_key, on_card, steps_eagerly
from vmlmf_tpu_torch.utils.rows import add_rows
from vmlmf_tpu_torch.utils.tree import first_device, trainable_leaves, tree_leaves


def _neg_inf(dtype):
    return torch.finfo(dtype).min


def _ids(a, device):
    return torch.as_tensor(a if torch.is_tensor(a) else np.array(a), device=device).long()


def blocked_topk(scores, k, block=2048):
    """Exact top-k over the last axis by a top-k in each block of ``block``
    columns, then one over the blocks' candidates.

    The union of the blocks' top-k holds the global top-k, so the second
    top-k reproduces a full sort. The tail is padded with the lowest finite
    value, so padding never wins. Index order for exactly tied scores may
    differ from the unblocked sort. -> (values [B, k], indices [B, k] int32)."""
    b, n = scores.shape
    if n <= max(2 * k, block):
        vals, idx = torch.topk(scores, k)
        return vals, idx.int()
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        scores = torch.cat([scores, scores.new_full((b, pad), _neg_inf(scores.dtype))], 1)
    kb = min(k, block)
    bv, bi = torch.topk(scores.reshape(b, nb, block), kb)
    gi = bi + (torch.arange(nb, device=scores.device) * block)[None, :, None]
    vals, sel = torch.topk(bv.reshape(b, nb * kb), k)
    return vals, torch.gather(gi.reshape(b, nb * kb), 1, sel).int()


def _retrieve(scores, k, method, recall_target):
    """A retrieval method over a [B, N] score block -> (values, int32 ids).

    "exact" is one `torch.topk` over the whole row: on the card it beats
    `blocked_topk` at 100k and at 1M items (PERF.md §6). "approx" runs
    the exact path too (PyTorch has no `approx_max_k`); ``recall_target`` is
    ignored."""
    if method not in ("exact", "approx"):
        raise ValueError(f"unknown retrieval method {method!r}; choose 'exact' or 'approx'")
    vals, idx = torch.topk(scores, k)
    return vals, idx.int()


def _sampled_ce(hs, sub_t, sub_n, b_t, b_n, targets, neg, n_items, in_batch, batch_cols=None):
    """Sampled-softmax CE from gathered table rows (the shared core of
    `sampled_softmax_loss` and the sparse trainer).

    hs: [M, H] hidden states; sub_t: [M, H] table rows at the targets; sub_n:
    [S, H] rows at the sampled negatives; b_t / b_n their biases. The CE is
    assembled piecewise: each block's logsumexp, then one over the [M, 2-3]
    column of block results, equal to the CE over the concatenated blocks.
    ``batch_cols`` = (rows, biases, ids) of the in-batch columns, default the
    batch's own targets (under data parallelism, every rank's). -> the mean
    loss."""
    neg_logit = hs @ sub_n.T + b_n
    # logQ correction: uniform q = num_samples / N per negative draw
    logq = torch.log(torch.full((), neg.shape[0] / n_items, dtype=hs.dtype, device=hs.device))
    neg_logit = neg_logit - logq
    pos_logit = torch.sum(hs * sub_t, -1) + b_t
    # mask accidental hits (a sampled negative equal to the target)
    neg_logit = neg_logit.masked_fill(neg[None, :] == targets[:, None], _neg_inf(hs.dtype))
    pieces = [pos_logit, torch.logsumexp(neg_logit, 1)]
    if in_batch:
        cols, col_b, col_ids = batch_cols if batch_cols is not None else (sub_t, b_t, targets)
        ib = hs @ cols.T + col_b
        # duplicates, the diagonal included: the positive is its own piece
        ib = ib.masked_fill(col_ids[None, :] == targets[:, None], _neg_inf(ib.dtype))
        pieces.append(torch.logsumexp(ib, 1))
    lse_all = torch.logsumexp(torch.stack(pieces, 1), 1)
    return (lse_all - pos_logit).mean()


def _dedup_sq_norm(ids, rows):
    """Exact ‖Σ over occurrences‖² of a scattered gradient: sort the ids,
    sum the rows of equal ids, and return the squared norm of the sums, the
    norm of the dense scatter-add of ``rows`` at ``ids`` without the [N, H]
    gradient."""
    sid, order = torch.sort(ids, stable=True)
    first = torch.ones_like(sid, dtype=torch.bool)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first, 0) - 1
    summed = add_rows(torch.zeros_like(rows), seg, rows[order])
    return torch.sum(summed * summed)


def _negatives(n_items, num, device, generator, negatives, mesh):
    """The sampled negatives: ``negatives`` when given, else ``num`` uniform
    ids from ``generator``; under a mesh, rank 0's."""
    if negatives is not None:
        return _ids(negatives, device)
    neg = torch.randint(0, n_items, (num,), generator=generator, device=device)
    if mesh is not None:
        dist.broadcast(neg, src=0)
    return neg


def _gather_ids(ids, dim, mesh):
    """Every data rank's ids concatenated along ``dim`` (the global batch)."""
    return spmd.gather_batch(ids, dim, (mesh, "data"))


@dataclasses.dataclass(frozen=True)
class SessionRanker:
    """Next-item ranking over an `LMModel` with an item vocabulary.

    ``model.vocab_size`` is the catalog size N; with tied embeddings (the
    default of `create`) ``params['embed']['w']`` is the one [N, H] table.
    Under a mesh, ``params`` are this process's shards
    (`parallel.sharding.lm_param_sharding`).
    """

    model: LMModel

    @classmethod
    def create(cls, num_items, hidden_size=650, num_layers=1, cell_factory=None, *,
               w_rank=None, u_rank=None, dropout_rate=0.0, tie_items=True, backend="fused",
               head_bf16=False):
        """VMLMF cells at (w_rank, u_rank) unless a ``cell_factory`` is given.
        ``backend`` takes the port's names, or the JAX package's ("pallas" is
        "fused", "xla" is "loop")."""
        if cell_factory is None:
            from vmlmf_tpu_torch.cells import VMLMFCell

            w_rank = w_rank or max(8, hidden_size // 8)
            u_rank = u_rank or w_rank

            def cell_factory(n, h):
                return VMLMFCell(n, h, w_rank=w_rank, u_rank=u_rank)

        return cls(LMModel(vocab_size=num_items, hidden_size=hidden_size,
                           num_layers=num_layers, cell_factory=cell_factory,
                           dropout_rate=dropout_rate, winit=0.05, tie_embeddings=tie_items,
                           backend=backend_name(backend), head_bf16=head_bf16))

    # ------------------------------------------------------------- params
    @property
    def num_items(self):
        return self.model.vocab_size

    def init(self, generator, device="cuda", dtype=torch.float32):
        """Parameters from ``generator`` (a CPU `torch.Generator`), on ``device``."""
        return self.model.init(generator, device, dtype)

    def item_table(self, params):
        """[N, H] item table (the scoring matrix)."""
        if self.model.tie_embeddings:
            return params["embed"]["w"]
        return params["fc"]["w"].T

    def _head(self, params):
        """(w [H, N], b [N]): the scoring projection (a transpose of the table
        when tied); under a mesh, this shard's columns."""
        w = params["embed"]["w"].T if self.model.tie_embeddings else params["fc"]["w"]
        return w, params["fc"]["b"]

    # ------------------------------------------------------------- encode
    def encode(self, params, ids, states=None, *, mesh=None):
        """Session prefix ids [T, B] -> (session vector h [B, H], states).

        The last layer's hidden state at the final position, with no dropout.
        ``mesh``: the table is split by rows on its ``model`` axis."""
        m = self.model
        ids = _ids(ids, first_device(params))
        if states is None:
            states = m.state0(ids.shape[1], ids.device)
        x = sharding.embed(params["embed"]["w"], ids, axis_group(mesh, "model"))
        ys, states = m.rnn(params["rnn"], x, states, time_major=True)
        return ys[-1], states

    # -------------------------------------------------------------- score
    def score(self, params, h):
        """The full score row h [B, H] -> [B, N] (the single-device oracle)."""
        return self.model._logits(params, h)

    def topk(self, params, h, k, *, exclude=None, method="exact", recall_target=0.95):
        """Single-device top-K -> (scores [B, k], item ids [B, k] int32).
        ``exclude``: optional [T, B] session ids to mask out. ``method``:
        "exact"; "approx" runs the exact path too (module docstring)."""
        if k > self.num_items:
            raise ValueError(f"k={k} exceeds the catalog size {self.num_items}")
        scores = self.score(params, h)
        if exclude is not None:
            scores = self._mask_seen(scores, _ids(exclude, scores.device), offset=0)
        return _retrieve(scores, k, method, recall_target)

    @staticmethod
    def _mask_seen(scores, seen, offset):
        """The lowest value into scores [B, Nloc] at (seen.T − offset); ids
        outside [0, Nloc) belong to other shards and are dropped: those below
        the shard would wrap under torch indexing and those past it would
        raise, so both go to a spare column that is cut off."""
        b, nloc = scores.shape
        local = seen.T - offset                                       # [B, T]
        local = torch.where((local >= 0) & (local < nloc), local, torch.full_like(local, nloc))
        padded = torch.cat([scores, scores.new_zeros(b, 1)], 1)
        padded.scatter_(1, local, _neg_inf(scores.dtype))
        return padded[:, :nloc]

    def _check_sharded(self, k, mesh):
        n, shards = self.num_items, axis_size(mesh, "model")
        if n % shards != 0:
            raise ValueError(f"num_items={n} not divisible by model-axis size {shards}")
        if k > n // shards:
            raise ValueError(f"k={k} exceeds the per-shard row count {n // shards}; "
                             f"lower k or the model-axis size")

    def _merge_topk(self, params, h, k, mesh, exclude, method, recall_target):
        """Each ``model`` shard's top-k of its rows for the rows ``h``, with ids
        offset by the shard, then a top-k of the S·k candidates gathered over
        the ``model`` group."""
        w, bias = self._head(params)
        scores = h @ w + bias                                         # [B, N/S]
        off = axis_rank(mesh, "model") * scores.shape[1]
        if exclude is not None:
            scores = self._mask_seen(scores, exclude, offset=off)
        vals, ids = _retrieve(scores, k, method, recall_target)
        ids = ids + off
        group = mesh.get_group("model")
        parts_v = [torch.empty_like(vals) for _ in range(axis_size(mesh, "model"))]
        parts_i = [torch.empty_like(ids) for _ in parts_v]
        dist.all_gather(parts_v, vals.contiguous(), group=group)
        dist.all_gather(parts_i, ids.contiguous(), group=group)
        top, sel = torch.topk(torch.cat(parts_v, 1), k)               # the global merge
        return top, torch.gather(torch.cat(parts_i, 1), 1, sel)

    def topk_sharded(self, params, h, k, mesh, *, exclude=None, data_sharded=True,
                     method="exact", recall_target=0.95):
        """Top-K over the table split by rows on ``mesh``'s ``model`` axis.

        ``h`` [B, H] (and ``exclude`` [T, B]) are the whole batch on every rank;
        with ``data_sharded`` each ``data`` rank ranks its rows and the result
        is gathered over ``data``. Each model shard scores its N/S rows and
        contributes its local top-k; only the S·k (score, id) pairs of a
        session cross the ``model`` group. -> (scores [B, k], ids [B, k]
        int32), the whole batch's, on every rank."""
        self._check_sharded(k, mesh)
        if exclude is not None:
            exclude = _ids(exclude, h.device)
        rows, seen = h, exclude
        if data_sharded:
            rows = spmd.shard_batch(h, 0, (mesh, "data"))
            if exclude is not None:
                seen = spmd.shard_batch(exclude, 1, (mesh, "data"))
        vals, ids = self._merge_topk(params, rows, k, mesh, seen, method, recall_target)
        if data_sharded and spmd.is_split(h.shape[0], (mesh, "data")):
            vals, ids = _gather_ids(vals, 0, mesh), _gather_ids(ids, 0, mesh)
        return vals, ids

    # ------------------------------------------------------------ serving
    def rank_next(self, params, session_ids, k, *, mesh=None, exclude_seen=False,
                  method="exact", recall_target=0.95):
        """Encode the session prefixes [T, B] and return the top-K next items
        -> (scores [B, k], item ids [B, k] int32).

        Under a mesh each ``data`` rank encodes its rows of the sessions (the
        fused kernels on those rows), ranks them (over the table split on
        ``model`` when that axis has more than one rank), and the whole
        batch's result comes back on every rank."""
        ids = _ids(session_ids, first_device(params))
        split = spmd.is_split(ids.shape[1], (mesh, "data"))
        rows = spmd.shard_batch(ids, 1, (mesh, "data"))
        h, _ = self.encode(params, rows, mesh=mesh)
        exclude = rows if exclude_seen else None
        if axis_size(mesh, "model") > 1:
            self._check_sharded(k, mesh)
            vals, top = self._merge_topk(params, h, k, mesh, exclude, method, recall_target)
        else:
            vals, top = self.topk(params, h, k, exclude=exclude, method=method,
                                  recall_target=recall_target)
        if split:
            vals, top = _gather_ids(vals, 0, mesh), _gather_ids(top, 0, mesh)
        return vals, top

    # --------------------------------------------------------- evaluation
    def eval_metrics(self, params, sessions, targets, *, ks=(1, 5, 10, 20), mesh=None,
                     exclude_seen=False, method="exact", recall_target=0.95):
        """Next-item retrieval metrics over the full catalog: ``recall@k`` for
        each k in ``ks`` and ``mrr`` (truncated at max(ks)), through the same
        retrieval `rank_next` serves with. sessions [T, B]; targets [B]."""
        kmax = max(ks)
        with torch.no_grad():
            _, top = self.rank_next(params, sessions, kmax, mesh=mesh,
                                    exclude_seen=exclude_seen, method=method,
                                    recall_target=recall_target)
        top = top.cpu().numpy()
        tgt = np.asarray(targets.cpu() if torch.is_tensor(targets) else targets).reshape(-1, 1)
        hit = top == tgt
        rank = np.where(hit.any(axis=1), hit.argmax(axis=1), kmax)
        out = {f"recall@{k}": float((rank < k).mean()) for k in ks}
        out["mrr"] = float(np.where(rank < kmax, 1.0 / (rank + 1), 0.0).mean())
        return out

    # ----------------------------------------------------------- training
    def loss(self, params, ids, targets, states, *, generator=None, train=True):
        """Full-CE next-item loss, `LMTrainer`'s objective -> (loss, states)."""
        dev = first_device(params)
        logits, new_states = self.model.apply(params, _ids(ids, dev), states,
                                              generator=generator, train=train)
        return lm_loss(logits, _ids(targets, dev)), new_states

    def sampled_softmax_loss(self, params, hs, targets, generator, num_samples, *,
                             in_batch=False, negatives=None, mesh=None, split=False):
        """Sampled-softmax CE: ``num_samples`` uniform negatives shared across
        the batch (``negatives`` when given), logQ-corrected, plus the batch's
        own target columns as negatives with ``in_batch`` (duplicates masked,
        no logQ correction). hs [M, H]; targets [M]. -> the mean loss.

        ``mesh``: the table is split by rows on ``model`` (rows gathered over
        that group). ``split``: ``hs`` and ``targets`` are this rank's share
        of a batch split over the mesh's ``data`` axis (`parallel.spmd.
        holds_share` with more than one rank), so the in-batch columns are
        every ``data`` rank's targets."""
        n = self.num_items
        targets = _ids(targets, hs.device)
        neg = _negatives(n, num_samples, hs.device, generator, negatives, mesh)
        group = axis_group(mesh, "model")
        table, bias = self.item_table(params), params["fc"]["b"]
        sub_t, b_t = sharding.gather_rows(table, targets, group), sharding.gather_rows(
            bias, targets, group)
        sub_n, b_n = sharding.gather_rows(table, neg, group), sharding.gather_rows(
            bias, neg, group)
        cols = None
        if in_batch and split:
            dgroup = mesh.get_group("data")
            cols = (sharding.gather_from_group(sub_t, dgroup), sharding.gather_from_group(
                b_t, dgroup), _gather_ids(targets, 0, mesh))
        return _sampled_ce(hs, sub_t, sub_n, b_t, b_n, targets, neg, n, in_batch, cols)

    def sampled_loss(self, params, ids, targets, states, generator, num_samples, *,
                     in_batch=False, negatives=None, mesh=None, split=False):
        """Sampled-softmax next-item loss over a [T, B] chunk: the encoder
        (dropout masks from ``generator``, then the negatives), flattened to
        [T·B, H], `sampled_softmax_loss` (``mesh``, ``split`` as there), times
        B (the Zaremba scale of `lm_loss`). -> (loss, new_states)."""
        dev = first_device(params)
        ids, targets = _ids(ids, dev), _ids(targets, dev)
        x = sharding.embed(params["embed"]["w"], ids, axis_group(mesh, "model"))
        hs, new_states = self.model.hidden_from_embedded(params, x, states,
                                                         generator=generator, train=True)
        t, b = targets.shape
        loss = self.sampled_softmax_loss(params, hs.reshape(t * b, -1), targets.reshape(-1),
                                         generator, num_samples, in_batch=in_batch,
                                         negatives=negatives, mesh=mesh, split=split)
        return loss * b, new_states

    def sparse_trainer(self, *, batch_size=20, seq_length=35, sampled_softmax=8192,
                       in_batch_negatives=True, learning_rate=1.0, max_grad_norm=5.0, seed=0,
                       fuse_chunks=8, device="cuda", mesh=None):
        """A `SparseSampledTrainer`: sampled-softmax SGD that updates the item
        table only at the rows a chunk touches. Needs one table (tied items)
        and plain SGD. ``fuse_chunks``: the chunks of one `fused_chunks`
        stack, as in the JAX package; 1 steps them one by one."""
        if not self.model.tie_embeddings:
            raise ValueError("sparse_trainer requires tie_items=True (a single item table); "
                             "the untied head would need its own sparse path")
        return SparseSampledTrainer(self, batch_size=batch_size, seq_length=seq_length,
                                    num_samples=sampled_softmax, in_batch=in_batch_negatives,
                                    learning_rate=learning_rate, max_grad_norm=max_grad_norm,
                                    seed=seed, fuse_chunks=fuse_chunks, device=device,
                                    mesh=mesh)

    def trainer(self, *, batch_size=20, seq_length=35, mesh=None, sampled_softmax=None,
                in_batch_negatives=False, **kw):
        """An `LMTrainer` over this ranker's model; ``mesh`` trains with the
        row-sharded table. ``sampled_softmax=<num_negatives>`` makes the
        training loss `sampled_loss` (the step's ``negatives=`` keyword
        reaches it); `perplexity` stays full-CE."""
        if sampled_softmax is not None:
            def loss_fn(p, x, y, states, generator, negatives=None):
                split = axis_size(mesh, "data") > 1 and spmd.holds_share(x.shape[1],
                                                                         batch_size, mesh)
                return self.sampled_loss(p, x, y, states, generator, sampled_softmax,
                                         in_batch=in_batch_negatives, negatives=negatives,
                                         mesh=mesh, split=split)

            kw["loss_fn"] = loss_fn
        return LMTrainer(self.model, batch_size=batch_size, seq_length=seq_length, mesh=mesh,
                         **kw)


@dataclasses.dataclass
class SparseSampledTrainer:
    """Sampled-softmax ranking trainer with sparse (gathered-row) table
    updates; see `SessionRanker.sparse_trainer`.

    A step equals the dense sampled trainer's (`SessionRanker.trainer(
    sampled_softmax=...)` with the same negatives): the global clip norm is
    exact (rows of equal ids summed first, `_dedup_sq_norm`), and rows no id
    touches are unchanged either way. Keys of ``params`` other than the table,
    the bias and ``rnn`` pass through. On CUDA, `fused_chunks` replays one
    captured CUDA graph of `train_step` per chunk (`utils.graphs.CarriedSteps`;
    the negatives, the sorts and the scatter-adds inside, and under a mesh
    the collectives), the counterpart of the JAX package's one-dispatch
    scan; on the CPU or with ``fuse_chunks=1`` it steps eagerly.

    Under a mesh the table is split by rows on ``model``: each step gathers
    its rows over that group, every ``data`` rank's rows and gradients are
    gathered or summed over ``data``, and each shard applies the updates of
    the rows it owns.
    """

    ranker: SessionRanker
    batch_size: int = 20
    seq_length: int = 35
    num_samples: int = 8192
    in_batch: bool = True
    learning_rate: float = 1.0
    max_grad_norm: float = 5.0
    seed: int = 0
    fuse_chunks: int = 8
    device: str = "cuda"
    mesh: object = None
    # the captured train step: (key, CarriedSteps, its learning-rate tensor)
    _graph: tuple = dataclasses.field(default=None, init=False, repr=False, compare=False)

    def _device(self):
        return resolve_device(self.mesh.device_type if self.mesh is not None else self.device)

    def init(self, dtype=torch.float32):
        params = self.ranker.init(torch.Generator().manual_seed(self.seed), self._device(),
                                  dtype)
        if self.mesh is not None:
            params = sharding.shard_params(
                params, sharding.lm_param_sharding(params, self.mesh), self.mesh)
        return params

    def state0(self, batch=None):
        b = spmd.local_batch(batch or self.batch_size, (self.mesh, "data"))
        return self.ranker.model.state0(b, self._device())

    def commit_batch(self, x, y, *, stacked=False):
        """This process's rows of chunks [T, B], or with ``stacked`` of a
        stack of them [k, T, B] (all of them without a mesh)."""
        dev, dim = self._device(), 2 if stacked else 1
        cut = (lambda a: spmd.shard_batch(_ids(a, dev), dim, (self.mesh, "data")))
        return cut(x), cut(y)

    def train_step(self, params, states, x, y, lr, generator=None, negatives=None):
        """One sampled-softmax SGD step with sparse table updates on a chunk
        ``x, y [T, B]`` (under a mesh, `commit_batch`'s rows); the negatives
        from ``generator`` (after the encoder's dropout masks) unless given.
        -> (params updated in place, new_states detached, loss, gnorm)."""
        model, n, mesh = self.ranker.model, self.ranker.num_items, self.mesh
        table, bias = params["embed"]["w"], params["fc"]["b"]
        dev = table.device
        x, y = _ids(x, dev), _ids(y, dev)
        group = axis_group(mesh, "model")
        data_n = axis_size(mesh, "data")
        share = mesh is not None and spmd.holds_share(x.shape[1], self.batch_size, mesh)
        split = share and data_n > 1
        t, b = y.shape

        sub_x = sharding.gather_rows_nograd(table, x, group).requires_grad_()
        rnn = trainable_leaves(params["rnn"])
        hs, new_states = model.hidden_from_embedded({"rnn": params["rnn"]}, sub_x, states,
                                                    generator=generator, train=True)
        neg = _negatives(n, self.num_samples, dev, generator, negatives, mesh)
        y_all = _gather_ids(y, 1, mesh) if split else y               # [T, B], global order
        tgt_all = y_all.reshape(-1)
        sub_t = sharding.gather_rows_nograd(table, tgt_all, group).requires_grad_()
        b_t = sharding.gather_rows_nograd(bias, tgt_all, group).requires_grad_()
        sub_n = sharding.gather_rows_nograd(table, neg, group).requires_grad_()
        b_n = sharding.gather_rows_nograd(bias, neg, group).requires_grad_()
        if split:  # this rank's targets: its columns of the [T, B] batch
            lo = axis_rank(mesh, "data") * b
            pos_t = sub_t.view(t, -1, sub_t.shape[-1])[:, lo:lo + b].reshape(t * b, -1)
            pos_b = b_t.view(t, -1)[:, lo:lo + b].reshape(-1)
            cols = (sub_t, b_t, tgt_all)
        else:
            pos_t, pos_b, cols = sub_t, b_t, None
        loss = _sampled_ce(hs.reshape(t * b, -1), pos_t, sub_n, pos_b, b_n, y.reshape(-1), neg,
                           n, self.in_batch, cols) * b
        d_sub_x, d_sub_t, d_sub_n, d_b_t, d_b_n, *d_rnn = torch.autograd.grad(
            loss, [sub_x, sub_t, sub_n, b_t, b_n, *rnn])
        loss = loss.detach()
        x_all = x
        if share:
            d_sub_t, d_sub_n, d_b_t, d_b_n, *d_rnn = spmd.allreduce_grads(
                [d_sub_t, d_sub_n, d_b_t, d_b_n, *d_rnn], mesh)
            loss = loss.clone()
            dist.all_reduce(loss, group=mesh.get_group("data"))
            if split:
                x_all, d_sub_x = _gather_ids(x, 1, mesh), _gather_ids(d_sub_x, 1, mesh)

        # the exact global clip norm: equal ids' rows summed first
        m = x_all.numel()
        table_ids = torch.cat([x_all.reshape(-1), tgt_all, neg])
        table_rows = torch.cat([d_sub_x.reshape(m, -1), d_sub_t, d_sub_n])
        bias_ids = torch.cat([tgt_all, neg])
        bias_vals = torch.cat([d_b_t, d_b_n])
        sq = (_dedup_sq_norm(table_ids, table_rows)
              + _dedup_sq_norm(bias_ids, bias_vals[:, None])
              + sum(torch.sum(torch.square(g)) for g in d_rnn))
        gnorm = torch.sqrt(sq)
        step = lr * torch.clamp(self.max_grad_norm / (gnorm + 1e-6), max=1.0)
        with torch.no_grad():
            _scatter_add(table, table_ids, -step * table_rows, group)
            _scatter_add(bias, bias_ids, -step * bias_vals, group)
            for p, g in zip(rnn, d_rnn):
                p.sub_(step * g)
        return params, [tuple(s.detach() for s in st) for st in new_states], loss, gnorm.detach()

    def fused_chunks(self, params, states, xs, ys, lr, generator=None, negatives=None):
        """`train_step` over a stack of chunks ``[k, T, B]`` with the
        parameters and the states carried (the JAX package's one-dispatch
        scan): on CUDA, one replay of the captured step a chunk, under a
        mesh with its collectives (every rank draws the negatives and takes
        rank 0's, so every rank's graph issues the same collectives); on the
        CPU or with ``fuse_chunks=1``, the eager steps. Under a mesh the
        stacks are `commit_batch`'s rows (``stacked=True``). ``lr``: a float
        or a 0-d tensor; ``negatives``: [k, S] or None.
        -> (params, states, losses [k], gnorms [k])."""
        def step_at(rate):
            def step(states, gen, x, y, *neg):
                return self.train_step(params, states, x, y, rate, gen, *neg)[1:]
            return step

        dev = params["embed"]["w"].device
        stacks = (_ids(xs, dev), _ids(ys, dev))
        if negatives is not None:
            stacks += (_ids(negatives, dev),)
        if self.fuse_chunks <= 1 or not on_card(dev):
            states, (losses, gnorms) = steps_eagerly(step_at(lr), states, generator, *stacks)
            return params, states, losses, gnorms
        row = tuple(s[0] for s in stacks)
        key = (graph_key(tree_leaves(params), *row, *tree_leaves(states)), generator is None)
        if self._graph is None or self._graph[0] != key:
            lr_buf = torch.zeros((), dtype=torch.float32, device=dev)
            self._graph = (key, CarriedSteps(step_at(lr_buf), states, row, device=dev,
                                             draws=generator is not None), lr_buf)
        _, steps, lr_buf = self._graph
        lr_buf.fill_(lr)
        states, (losses, gnorms) = steps(states, generator, *stacks)
        return params, states, losses, gnorms


def _scatter_add(dst, ids, rows, group):
    """``dst[ids] += rows``, deterministic (`utils.rows.add_rows`); on a table
    split by rows over ``group``, only the ids this shard owns."""
    if group is not None:
        local, own = sharding._owned(ids, group, dst.shape[0])
        ids = local
        rows = rows * own.reshape(own.shape + (1,) * (rows.dim() - 1)).to(rows.dtype)
    add_rows(dst, ids, rows)
