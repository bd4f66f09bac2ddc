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
