"""The ``gaussian`` kind: the configuration's Gaussian in float32 on the
device, written as a user writes it, with a count of the rows it evaluated
(what a user with an expensive likelihood pays, discarded generations
included); and the deep bands' start ``ellipsoid``, a live set drawn
exactly uniformly within {Mahalanobis radius < r} of the Gaussian, cut to
the box (a uniform draw in the ellipsoid, then rejection to the box), in
float32 cube coordinates, with its float32 likelihood."""

from __future__ import annotations

import math

import numpy as np
import torch

from harness import costs


class Gaussian:
    def __init__(self, dim, corr, device):
        cov = np.eye(dim) + corr * (1.0 - np.eye(dim))
        self.prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32,
                                    device=device)
        self.log_norm = -0.5 * (dim * math.log(2 * math.pi)
                                + float(np.linalg.slogdet(cov)[1]))
        self.rows = 0

    def __call__(self, x):
        self.rows += x.shape[0]
        return self.log_norm - 0.5 * torch.sum((x @ self.prec) * x, dim=-1)


class Scale:
    """The transform from the sampler's cube [-1, 1]^d to the box."""

    def __init__(self, lim):
        self.lim = float(lim)

    def __call__(self, u):
        return self.lim * u


def build(like_cfg, device):
    return (Gaussian(like_cfg['x_dim'], like_cfg['corr'], device),
            Scale(like_cfg['lim']))


def ops_per_row(like_cfg):
    return costs.likelihood_ops(like_cfg['x_dim'])


def ellipsoid_draw(dim, corr, lim, radius, n, seed, device):
    """(u, x) float64: ``n`` points uniform within {x^T C^-1 x < radius^2}
    and the open box (-lim, lim)^dim, ``u = x / lim`` rounded to float32
    values; the draws in blocks from one generator on ``device``."""
    cov = np.eye(dim) + corr * (1.0 - np.eye(dim))
    chol = torch.as_tensor(np.linalg.cholesky(cov), dtype=torch.float64,
                           device=device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    kept, have = [], 0
    block = 4 * n
    while have < n:
        y = torch.randn(block, dim, generator=g, dtype=torch.float64,
                        device=device)
        y = y / torch.linalg.norm(y, dim=1, keepdim=True)
        r = radius * torch.rand(block, generator=g, dtype=torch.float64,
                                device=device) ** (1.0 / dim)
        x = (r[:, None] * y) @ chol.T
        u = (x / lim).to(torch.float32)
        ok = torch.all(torch.abs(u) < 1.0, dim=1)
        kept.append(u[ok])
        have += int(ok.sum())
    return torch.cat(kept)[:n]


def ellipsoid_set(like, config, radius, n, seed, device):
    """(u float64 numpy (n, d), logl float64 numpy of float32 values,
    birth floor): the live set within Mahalanobis ``radius`` and the
    likelihood's value at that radius. A point whose float32 logl is not
    above the floor is replaced by a later draw."""
    lk = config['likelihood']
    floor = like.log_norm - 0.5 * radius * radius
    u = ellipsoid_draw(lk['x_dim'], lk['corr'], lk['lim'], radius, 2 * n,
                       seed, device)
    with torch.no_grad():
        logl = like(lk['lim'] * u)
    like.rows -= u.shape[0]   # the benchmark's own draws are not the run's
    ok = logl.double() > floor
    u, logl = u[ok][:n], logl[ok][:n]
    if u.shape[0] < n:
        raise RuntimeError('too few points above the birth floor')
    return (u.double().cpu().numpy(), logl.double().cpu().numpy(),
            float(floor))


def init_set(like, config, band, n, seed, device):
    """The live set of a band whose ``start`` is ``ellipsoid``, within its
    ``radius``."""
    if band['start'] != 'ellipsoid':
        raise ValueError('the gaussian kind has no start %r'
                         % band['start'])
    return ellipsoid_set(like, config, band['radius'], n, seed, device)
