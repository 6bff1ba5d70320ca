"""The general generator of the bands: every job's seed, and the live set a
deep band starts from, drawn exactly uniformly within {Mahalanobis radius <
r} of the Gaussian, cut to the box (a uniform draw in the ellipsoid, then
rejection to the box), in float32 cube coordinates, with its float32
likelihood. The same seed gives the same jobs."""

from __future__ import annotations

import numpy as np
import torch

MASK62 = (1 << 62) - 1


def job_seed(seed, index):
    """The seed of job ``index`` (an int, or a name such as 'warmup') of
    the run seeded ``seed``."""
    if isinstance(index, str):
        index = int.from_bytes(index.encode(), 'little')
    words = np.random.SeedSequence([int(seed) % (1 << 64), int(index)]
                                   ).generate_state(2, np.uint32)
    return (int(words[0]) << 32 | int(words[1])) & MASK62


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


def init_set(like, config, radius, n, seed, device):
    """(u float64 numpy (n, d), logl float64 numpy of float32 values,
    birth floor): the live set of a deep band and the likelihood's value
    at its radius. A point whose float32 logl is not above the floor is
    replaced by a later draw."""
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
