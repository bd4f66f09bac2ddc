"""Pipeline parallelism: one recurrent layer per rank of a mesh axis, the
wavefront carried by point-to-point sends (counterpart of
`vmlmf_tpu.parallel.pipeline_parallel`).

Rank ``l`` of the ``model`` group owns layer ``l`` and, over ``T + L - 1``
beats, runs time step ``s - l`` at beat ``s``: it receives the [B, h] output
of layer ``l - 1`` for that step, runs one plain LSTM step (the JAX package's
stage body, no kernel: the units of `ops.pipeline`), and sends its own [B, h]
output on to rank ``l + 1``. Stage 0 reads the input projection hoisted out
of the loop, ``cells[0].inp`` over all T steps at once.

`pipeline_parallel_scan` is one autograd Function over replicated inputs
(every rank passes the whole stack's parameters, as the JAX call takes them)
with replicated outputs (the last layer's outputs and every layer's final
state, gathered from their stages). Its backward walks the steps in reverse
on every stage, sending each step's input gradient back to rank ``l - 1``
(the transpose of the forward sends), then sums the input gradients over the
group, so that every rank returns the whole gradient. Every rank's loss must
therefore be the same function of the outputs (a replicated head), and every
rank must call backward.

As in the JAX package, the stack must be uniform (`ops.pipeline._units`) and
the number of layers must equal the size of the axis. With a ``data`` axis
each data group runs the pipeline on its own rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vmlmf_tpu_torch.cells.base import lstm_update
from vmlmf_tpu_torch.nn.layers import dropout_mask
from vmlmf_tpu_torch.ops.pipeline import _units


def stack_pipeline_params(cells, preps):
    """Per-layer pipeline units stacked into leading-L tensors. Layer 0's
    x-path factors are zeros (its input is the hoisted ``inp`` projection);
    they keep the stacked shapes uniform."""
    units = _units(cells, preps)
    assert units is not None, "stack not pipelineable (see pipelined_available)"
    u0 = units[1]  # shape template for layer 0's unused x unit
    first = {"u_x": torch.zeros_like(u0["u_x"]), "v_x": torch.zeros_like(u0["v_x"]),
             "d_x": torch.zeros_like(u0["d_x"]), "bias": torch.zeros_like(u0["bias"]),
             "u_h": units[0]["u_h"], "v_h": units[0]["v_h"], "d_h": units[0]["d_h"]}
    rows = [first] + units[1:]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def _stage_step(unit, first, inp, h, c):
    """One step of a stage: the gate input from the hoisted projection
    (stage 0) or from the previous layer's output, plus the recurrent path."""
    b, hidden = h.shape
    if first:
        pre = inp
    else:
        y = (inp @ unit["u_x"]) @ unit["v_x"]
        pre = (y.reshape(b, 4, hidden) + inp[:, None, :] * unit["d_x"]).reshape(
            b, 4 * hidden) + unit["bias"]
    gr = (h @ unit["u_h"]) @ unit["v_h"]
    gr = (gr.reshape(b, 4, hidden) + h[:, None, :] * unit["d_h"]).reshape(b, 4 * hidden)
    return lstm_update(pre + gr, c)


def _leaf(t):
    return t.detach().requires_grad_()


class _PipelineScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, meta, xs, hs0, cs0, *prep_flat):
        cells, keys, group, l = meta["cells"], meta["keys"], meta["group"], meta["stage"]
        n_stage, t_len = len(cells), xs.shape[0]
        prev = dist.get_global_rank(group, l - 1) if l > 0 else None
        nxt = dist.get_global_rank(group, l + 1) if l < n_stage - 1 else None
        rate, gen = meta["dropout_rate"], meta["generator"]
        with torch.enable_grad():
            xs_l, hs_l, cs_l = _leaf(xs), _leaf(hs0), _leaf(cs0)
            flat = [_leaf(p) for p in prep_flat]
            it = iter(flat)
            preps = [{k: next(it) for k in ks} for ks in keys]
            stacked = stack_pipeline_params(cells, preps)
            unit_nodes = {k: v[l] for k, v in stacked.items()}
            unit = {k: _leaf(v) for k, v in unit_nodes.items()}
            gi0 = cells[0].inp(preps[0], xs_l) if l == 0 else None
            h, c = hs_l[l].detach(), cs_l[l].detach()
            steps, sends, ys = [], [], []
            for t in range(t_len):
                if l == 0:
                    inp = _leaf(gi0[t])
                else:
                    inp = torch.empty_like(h)
                    dist.recv(inp, src=prev, group=group, tag=t)
                    inp.requires_grad_()
                h_in, c_in = _leaf(h), _leaf(c)
                h_new, c_new = _stage_step(unit, l == 0, inp, h_in, c_in)
                mask = None
                if nxt is not None:
                    msg = h_new.detach()
                    if rate > 0.0 and gen is not None:
                        mask = dropout_mask(msg.shape, rate, gen, msg.device, msg.dtype)
                        msg = msg * mask
                    sends.append(dist.isend(msg.contiguous(), dst=nxt, group=group, tag=t))
                steps.append((h_in, c_in, inp, h_new, c_new, mask))
                ys.append(h_new.detach())
                h, c = h_new.detach(), c_new.detach()
        for w in sends:
            w.wait()
        # the outputs, replicated: the last stage's ys, every stage's final state
        ys = torch.stack(ys)
        dist.broadcast(ys, src=dist.get_global_rank(group, n_stage - 1), group=group)
        finals = [torch.empty_like(torch.stack([h, c])) for _ in range(n_stage)]
        dist.all_gather(finals, torch.stack([h, c]).contiguous(), group=group)
        finals = torch.stack(finals)                                  # [L, 2, B, h]
        ctx.meta, ctx.steps, ctx.unit, ctx.unit_nodes = meta, steps, unit, unit_nodes
        ctx.leaves = (xs_l, hs_l, cs_l, flat)
        ctx.gi0 = gi0
        return ys, finals[:, 0].contiguous(), finals[:, 1].contiguous()

    @staticmethod
    def backward(ctx, g_ys, g_hs, g_cs):
        meta = ctx.meta
        group, l, cells = meta["group"], meta["stage"], meta["cells"]
        n_stage = len(cells)
        prev = dist.get_global_rank(group, l - 1) if l > 0 else None
        nxt = dist.get_global_rank(group, l + 1) if l < n_stage - 1 else None
        t_len = len(ctx.steps)
        names = list(ctx.unit)
        unit_leaves = [ctx.unit[k] for k in names]
        g_unit = [torch.zeros_like(u) for u in unit_leaves]
        gh, gc = g_hs[l], g_cs[l]
        g_inp, sends = [None] * t_len, []
        for t in range(t_len - 1, -1, -1):
            h_in, c_in, inp, h_new, c_new, mask = ctx.steps[t]
            gh_t = gh + g_ys[t] if l == n_stage - 1 else gh
            if nxt is not None:
                g_msg = torch.empty_like(gh)
                dist.recv(g_msg, src=nxt, group=group, tag=t_len + t)
                gh_t = gh_t + (g_msg * mask if mask is not None else g_msg)
            grads = torch.autograd.grad([h_new, c_new], [h_in, c_in, inp, *unit_leaves],
                                        [gh_t, gc], allow_unused=True)
            gh, gc, g_inp[t] = grads[0], grads[1], grads[2]
            for acc, g in zip(g_unit, grads[3:]):
                if g is not None:
                    acc.add_(g)
            if prev is not None:
                sends.append(dist.isend(g_inp[t].contiguous(), dst=prev, group=group,
                                        tag=t_len + t))
        for w in sends:
            w.wait()
        xs_l, hs_l, cs_l, flat = ctx.leaves
        g_xs, g_flat = torch.zeros_like(xs_l), [torch.zeros_like(p) for p in flat]
        g_hs0, g_cs0 = torch.zeros_like(hs_l), torch.zeros_like(cs_l)
        g_hs0[l], g_cs0[l] = gh, gc
        # the units and (stage 0) the hoisted projection back to their inputs
        outs = [ctx.unit_nodes[k] for k in names]
        grads_out = list(g_unit)
        if ctx.gi0 is not None:
            outs.append(ctx.gi0)
            grads_out.append(torch.stack(g_inp))
        inputs = [xs_l, *flat]
        got = torch.autograd.grad(outs, inputs, grads_out, allow_unused=True)
        for acc, g in zip([g_xs, *g_flat], got):
            if g is not None:
                acc.add_(g)
        # each stage holds its own part of every input's gradient: sum them
        parts = [g_xs, g_hs0, g_cs0, *g_flat]
        buf = torch.cat([p.reshape(-1) for p in parts])
        dist.all_reduce(buf, group=group)
        parts = [b.view_as(p) for b, p in zip(buf.split([p.numel() for p in parts]), parts)]
        return (None, *parts)


def pipeline_parallel_scan(cells, preps, xs, states0, mesh, *, axis="model", dropout_rate=0.0,
                           generator=None):
    """Run a uniform stack with layer l on rank l of ``mesh``'s ``axis``.

    xs: time-major [T, B, n0] (this data group's rows); states0: per-layer
    (h, c). ``dropout_rate`` with a ``generator``: each stage's output to the
    next is dropped out with a fresh mask per step, drawn by the sender.
    -> (ys [T, B, h], finals), the same on every rank of the axis.
    """
    group = mesh.get_group(axis)
    n_stage = dist.get_world_size(group)
    n_layers = len(cells)
    assert n_layers == n_stage, (
        f"pipeline needs layers == mesh '{axis}' size; got {n_layers} layers on "
        f"{n_stage} devices")
    keys = [list(p) for p in preps]
    meta = dict(cells=tuple(cells), keys=keys, group=group, stage=mesh.get_local_rank(axis),
                dropout_rate=dropout_rate if generator is not None else 0.0,
                generator=generator)
    hs0 = torch.stack([s[0] for s in states0])
    cs0 = torch.stack([s[1] for s in states0])
    flat = [p[k] for p, ks in zip(preps, keys) for k in ks]
    ys, h_end, c_end = _PipelineScan.apply(meta, xs, hs0, cs0, *flat)
    return ys, [(h_end[i], c_end[i]) for i in range(n_layers)]
