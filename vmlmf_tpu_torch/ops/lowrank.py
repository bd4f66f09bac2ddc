"""Low-rank / diagonal-correction primitives of the VMLMF math
(counterpart of `vmlmf_tpu.ops.lowrank`).

Each stacked gate matrix ``W_eff [G*h, n]`` is ``V U^T`` with its per-gate
diagonal removed; the learned vector ``d`` takes the diagonal's place. The
functions here are weight-only or batched over leading dims.
"""

from __future__ import annotations

import torch


def lowrank_proj(x, u, v):
    """``x @ (V U^T)^T = (x @ U) @ V^T`` without building the dense matrix.

    x: [..., n]; u: [n, r]; v: [G*h, r]  ->  [..., G*h]
    """
    return (x @ u) @ v.T


def gate_diag_rowsum(u, v, num_gates, hidden_size):
    """Per-gate diagonal of the low-rank product.

    diag_g[j] = sum_r u[j, r] * v[g*h + j, r]   for j < min(n, h)

    u: [n, r]; v: [G*h, r]  ->  [G, m] with m = min(n, h).
    """
    m = min(u.shape[0], hidden_size)
    v_g = v.reshape(num_gates, hidden_size, v.shape[-1])
    return torch.einsum("jr,gjr->gj", u[:m], v_g[:, :m, :])


def group_lowrank_proj(h_bgk, u, v):
    """One rotation tier of the group low-rank recurrent product.

    h_bgk: [..., g, h/g] (already rotated); u: [g, h/g, r]; v: [g, r, M]
    -> [..., g, M]
    """
    return torch.einsum("...gk,gkr,grm->...gm", h_bgk, u, v)


def group_diag_rowsum(u0, v0, num_gates):
    """Diagonal of the rotation-0 group recurrent matrix, per gate.

    At rotation 0 group p of the state feeds output group p, so gate k's
    diagonal sits in rows k*(h/g):(k+1)*(h/g) of each group's output block.

    u0: [g, h/g, r]; v0: [g, r, G*(h/g)]  ->  [G, h]
    """
    g, k, r = u0.shape
    v0_g = v0.reshape(g, r, num_gates, k)
    return torch.einsum("pjr,prkj->kpj", u0, v0_g).reshape(num_gates, g * k)


def dense_from_lowrank(u, v, num_gates, hidden_size, d=None, subtract_diag=True):
    """The dense stacked gate matrix of a low-rank cell -> [G*h, n].

    ``V U^T`` with its per-gate diagonal removed (``subtract_diag``) and the
    learned vector ``d`` put on the diagonal (if given), over the first
    min(n, h) features: the matrix the compressed cell is equivalent to, for
    tests. u: [n, r]; v: [G*h, r].
    """
    n = u.shape[0]
    m = min(n, hidden_size)
    w = (v @ u.T).reshape(num_gates, hidden_size, n)
    eye = torch.zeros(hidden_size, n, dtype=w.dtype, device=w.device)
    idx = torch.arange(m, device=w.device)
    eye[idx, idx] = 1.0
    if subtract_diag:
        w = w - torch.einsum("ghn,hn->gh", w, eye)[:, :, None] * eye
    if d is not None:
        dvec = torch.zeros(hidden_size, dtype=w.dtype, device=w.device)
        dvec[:m] = d.reshape(-1)[:m]
        w = w + dvec[None, :, None] * eye
    return w.reshape(num_gates * hidden_size, n)


def dense_from_group(u_tiers, v_tiers, num_gates, hidden_size):
    """The dense recurrent matrix of a group cell -> [G*h, h], gate-major.

    u_tiers[i]: [g, h/g, r_i]; v_tiers[i]: [g, r_i, G*(h/g)]. Tier i places
    the factor of output group p against input group (p + i) % g, so each
    (p, q) block comes from exactly one tier. The blocks are joined with
    `torch.cat` and `torch.stack`, so gradients reach every tier.
    """
    g = u_tiers[0].shape[0]
    k = hidden_size // g
    rows = []
    for p in range(g):
        # block (p, q) is tier (q - p) % g: [G, h/g out, h/g in]
        blocks = [(u_tiers[(q - p) % g][p] @ v_tiers[(q - p) % g][p]).T.reshape(num_gates, k, k)
                  for q in range(g)]
        rows.append(torch.cat(blocks, dim=-1))  # [G, h/g, h]
    w = torch.stack(rows, dim=1)  # [G, out group, h/g, h]
    return w.reshape(num_gates * hidden_size, hidden_size)
