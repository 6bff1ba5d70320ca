"""The ``spline`` flow's reference: the plain inverse of the default
single-speed spline flow, read from a state dict, and its operation counts.

The flow is the port's default: [ActNorm, invertible 1x1 convolution,
neural-spline coupling] x blocks, with rational-quadratic splines
(Durkan et al. 2019, arXiv:1906.04032) of K bins on [-B, B] and identity
tails. This file is written from those equations and the conventions the
state dict encodes, and imports nothing of the program:

- ActNorm: z = x * exp(s) + t, so x = (z - t) * exp(-s), logdet -sum(s);
- 1x1 convolution: z = x W with W = P (tril(L, -1) + I) (triu(U, 1) +
  diag(S)), so x solves x W = z, logdet -sum(log|S|);
- coupling: the lower half (the first ceil(d/2) dims) is inverted first,
  its knots from ``f2`` of the upper half, then the upper half with knots
  from ``f1`` of the new lower half; each conditioner is a 4-layer MLP
  (x @ w + b, LeakyReLU(0.2) between layers) whose output per dim is K
  widths, K heights and K - 1 interior derivatives, normalised twice as
  the flow does (2B softmax and softplus, then the spline's own softmax
  with minimum bin sizes 1e-3 and minimum derivative 1e-3, the boundary
  derivatives pinned to 1).

``inverse(state, z)`` computes in ``z``'s dtype and device. In float64 it
is the benchmark's reference for the spline kernel; in float32 with TF32
matmuls it is the control that has to fail the comparison. The operations
are ``harness/costs.py``'s: the kernel's ``inverse_cost`` and the forward's
``flow_forward_ops``, at the configuration's d, hidden width and blocks.
"""

from __future__ import annotations

import math

import torch

from harness import costs

MIN_BIN = 1e-3
MIN_DERIVATIVE = 1e-3


def _softplus(x):
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0.0)


def _mlp(x, ws, bs):
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w + b
        if i < len(ws) - 1:
            x = torch.where(x >= 0, x, 0.2 * x)
    return x


def _knot_positions(raw, bound):
    """Positions of the K + 1 knots on [-B, B] from K unnormalised sizes."""
    k = raw.shape[-1]
    sizes = MIN_BIN + (1.0 - MIN_BIN * k) * torch.softmax(raw, dim=-1)
    inner = 2.0 * bound * torch.cumsum(sizes, dim=-1)[..., :-1] - bound
    lo = torch.full_like(raw[..., :1], -bound)
    return torch.cat([lo, inner, -lo], dim=-1)


def spline_inverse(y, out, num_bins, bound):
    """Inverse RQS of ``y`` (n, m) with conditioner output ``out``
    (n, m, 3K - 1): (x, logdet summed over the m dims)."""
    k = num_bins
    w = 2.0 * bound * torch.softmax(out[..., :k], dim=-1)
    h = 2.0 * bound * torch.softmax(out[..., k:2 * k], dim=-1)
    dr = _softplus(out[..., 2 * k:])
    xk = _knot_positions(w, bound)
    yk = _knot_positions(h, bound)
    edge = math.log(math.exp(1.0 - MIN_DERIVATIVE) - 1.0)
    pad = torch.full_like(dr[..., :1], edge)
    deriv = MIN_DERIVATIVE + _softplus(torch.cat([pad, dr, pad], dim=-1))

    inside = (y >= -bound) & (y <= bound)
    yc = torch.clamp(y, -bound, bound)
    # the bin whose height interval holds y (the last one for y = B)
    idx = torch.sum((yc[..., None] >= yk[..., 1:-1]).to(torch.int64), dim=-1)

    def at(a, shift=0):
        return torch.gather(a, -1, (idx + shift)[..., None])[..., 0]

    x0, x1, y0, y1 = at(xk), at(xk, 1), at(yk), at(yk, 1)
    d0, d1 = at(deriv), at(deriv, 1)
    width, height = x1 - x0, y1 - y0
    slope = height / width
    rel = yc - y0
    curv = d0 + d1 - 2.0 * slope
    a = height * (slope - d0) + rel * curv
    b = height * d0 - rel * curv
    c = -slope * rel
    disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
    denom = -b - torch.sqrt(disc)
    safe = torch.abs(denom) > 1e-12
    theta = torch.where(safe, 2.0 * c / torch.where(safe, denom,
                                                   torch.ones_like(denom)),
                        torch.zeros_like(denom))
    theta = torch.clamp(theta, 0.0, 1.0)
    x = x0 + theta * width
    t1 = theta * (1.0 - theta)
    num = slope ** 2 * (d1 * theta ** 2 + 2.0 * slope * t1
                        + d0 * (1.0 - theta) ** 2)
    den = slope + curv * t1
    logdet = -(torch.log(num) - 2.0 * torch.log(den))
    x = torch.where(inside, x, y)
    logdet = torch.where(inside, logdet, torch.zeros_like(logdet))
    return x, torch.sum(logdet, dim=-1)


def num_blocks(state):
    return sum(1 for key in state if key.endswith('.S'))


def inverse(state, z, num_bins=8, bound=3.0):
    """(x, logdet) of the flow in ``state`` (a state dict of tensors) at
    latent points ``z`` (n, d), computed in ``z``'s dtype."""
    dt, dev = z.dtype, z.device

    def p(key):
        return state[key].to(device=dev, dtype=dt)

    n, d = z.shape
    cut = d - d // 2
    logdet = torch.zeros(n, dtype=dt, device=dev)
    for blk in reversed(range(num_blocks(state))):
        act, conv, cpl = ('chain.bijectors.%d.' % (3 * blk + i)
                          for i in range(3))

        def net(name):
            ws = [p(cpl + '%s.w.%d' % (name, i)) for i in range(4)]
            bs = [p(cpl + '%s.b.%d' % (name, i)) for i in range(4)]
            return ws, bs

        lower, upper = z[:, :cut], z[:, cut:]
        out = _mlp(upper, *net('f2')).reshape(n, cut, 3 * num_bins - 1)
        lower, ld1 = spline_inverse(lower, out, num_bins, bound)
        out = _mlp(lower, *net('f1')).reshape(n, d - cut, 3 * num_bins - 1)
        upper, ld2 = spline_inverse(upper, out, num_bins, bound)
        z = torch.cat([lower, upper], dim=1)
        logdet = logdet + ld1 + ld2

        eye = torch.eye(d, dtype=dt, device=dev)
        S = p(conv + 'S')
        w = (p(conv + '_P') @ (torch.tril(p(conv + 'L'), -1) + eye)
             @ (torch.triu(p(conv + 'U'), 1) + torch.diag(S)))
        z = torch.linalg.solve(w.T, z.T).T
        logdet = logdet - torch.sum(torch.log(torch.abs(S)))

        s, t = p(act + 's'), p(act + 't')
        z = (z - t) * torch.exp(-s)
        logdet = logdet - torch.sum(s)
    return z, logdet


def _shape(config):
    """(d, hidden, blocks) of the configuration's flow, which has to be the
    single-speed spline flow: another flow's operations are not these."""
    args = config.get('flow_args', {})
    if args.get('flow', 'spline') != 'spline' or args.get('num_slow', 0):
        raise ValueError('the spline reference is the single-speed spline '
                         'flow\'s, not that of %r' % args)
    return (config['likelihood']['x_dim'], config['hidden_dim'],
            args.get('num_blocks', costs.NUM_BLOCKS))


def inverse_ops(config, rows, calls):
    """``inverse_cost`` at ``rows`` rows, and its per-call part (each
    block's e^-s) for each further call."""
    if not calls:
        return 0
    d, h, blocks = _shape(config)
    return (costs.inverse_cost(rows, d, h, num_blocks=blocks)[0]
            + (calls - 1) * costs.inverse_cost(0, d, h,
                                               num_blocks=blocks)[0])


def forward_ops(config):
    d, h, blocks = _shape(config)
    return costs.flow_forward_ops(d, h, num_blocks=blocks)
