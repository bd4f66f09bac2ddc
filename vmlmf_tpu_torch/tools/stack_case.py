"""Seeded inputs of the wavefront stack's entries at the PTB LM stack, the
one builder that `ab_scan` and `scan_phases` time the stack on.

The stack: L=2 layers, T=35 steps, h=650, low-rank r=rx=300, batch b, a
dropout mask at rate 0.5 on the upper layer's input, as in training.
`ab_scan` runs each checkout in a child program that imports that
checkout's `vmlmf_tpu_torch` and prepends this file's source to its own, so
the file imports only `torch` and, inside its function, `cuda_stack`, and
has no `from __future__` line.
"""

import torch

STACK_T, STACK_H, STACK_R = 35, 650, 300
STACK_RANKS, STACK_XRANKS = (STACK_R, STACK_R), (STACK_R,)


def stack_case(b, precision=None):
    """-> ((gi0, layers, h0s, c0s, mk, prec), res, bwd_args) on the card:
    the no-grad and residual forwards' inputs (``prec``: the precision
    argument, none where ``precision`` is None, as every checkout's stack
    takes it), the residual forward's outputs and the BPTT's arguments,
    from dys with the final states' cotangents absent."""
    from vmlmf_tpu_torch.ops import cuda_stack

    t, h, r = STACK_T, STACK_H, STACK_R
    g = torch.Generator().manual_seed(0)

    def n(*shape, scale):
        return (scale * torch.randn(shape, generator=g)).cuda()

    layers = []
    for l in range(2):
        lay = dict(u=n(h, r, scale=h ** -0.5), v=n(r, 4 * h, scale=r ** -0.5),
                   dvec=n(4 * h, scale=0.1))
        if l:
            lay.update(ux=n(h, r, scale=h ** -0.5), vx=n(r, 4 * h, scale=r ** -0.5),
                       dxvec=n(4 * h, scale=0.1), bias=n(4 * h, scale=0.1))
        layers.append(lay)
    gi0 = n(t, b, 4 * h, scale=1.0)
    h0s, c0s = [n(b, h, scale=0.5) for _ in range(2)], [n(b, h, scale=0.5) for _ in range(2)]
    prec = () if precision is None else (precision,)
    mk = [(torch.rand((t, b, h), generator=torch.Generator().manual_seed(7)) < 0.5)
          .float().cuda() / 0.5]
    res = cuda_stack.lstm_stack_scan_fused_res(gi0, layers, h0s, c0s, mk, *prec)
    dys = torch.randn(*res[0][0].shape, generator=torch.Generator().manual_seed(5)).cuda()
    bwd_args = (layers, h0s, c0s, mk, *res, dys, [None] * 2, [None] * 2, *prec)
    return (gi0, layers, h0s, c0s, mk, prec), res, bwd_args
