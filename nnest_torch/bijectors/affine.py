"""ActNorm: per-dim learned affine z = x * exp(s) + t.

Port of ``ActNorm`` in ``nnest_tpu/bijectors/affine.py`` with its
data-dependent init: ``s = -log(max(std, 1e-6))`` and
``t = -mean(x * exp(s))`` over the first data batch (population std).
"""

from __future__ import annotations

import torch
from torch import nn

from nnest_torch.bijectors.base import Bijector


class ActNorm(Bijector):

    def __init__(self, dim):
        super().__init__()
        self.dim = int(dim)
        self.s = nn.Parameter(torch.zeros(self.dim))
        self.t = nn.Parameter(torch.zeros(self.dim))

    @torch.no_grad()
    def data_init(self, x):
        s = -torch.log(torch.clamp(torch.std(x, dim=0, unbiased=False),
                                   min=1e-6))
        self.s.copy_(s)
        self.t.copy_(-torch.mean(x * torch.exp(s), dim=0))

    def forward(self, x):
        z = x * torch.exp(self.s) + self.t
        return z, torch.sum(self.s).expand(x.shape[0])

    def inverse(self, z):
        x = (z - self.t) * torch.exp(-self.s)
        return x, (-torch.sum(self.s)).expand(z.shape[0])
