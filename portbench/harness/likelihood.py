"""The likelihood the benchmark hands the sampler: the configuration's
Gaussian in float32 on the device, written as a user writes it, with a
count of the rows it evaluated (what a user with an expensive likelihood
pays, discarded generations included)."""

from __future__ import annotations

import math

import numpy as np
import torch


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


def build(config, device):
    like = config['likelihood']
    if like['kind'] != 'gaussian':
        raise ValueError('unknown likelihood kind %r' % like['kind'])
    return (Gaussian(like['x_dim'], like['corr'], device),
            Scale(like['lim']))
