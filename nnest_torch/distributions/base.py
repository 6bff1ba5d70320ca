"""Base distributions for the latent space of a flow.

Port of ``DiagNormal`` from ``nnest_tpu/distributions/base.py``: the
standard normal N(0, I) with ``sample(num, generator)`` drawing on the
generator's device and ``log_prob(z)`` summed over dims.
"""

from __future__ import annotations

import math

import torch


class DiagNormal:

    def __init__(self, dim):
        self.dim = int(dim)

    def sample(self, num, generator=None, device=None):
        device = generator.device if generator is not None else device
        return torch.randn(num, self.dim, generator=generator,
                           device=device)

    def log_prob(self, z):
        return torch.sum(-0.5 * z ** 2 - 0.5 * math.log(2.0 * math.pi),
                         dim=-1)
