"""Affine bijectors: ActNorm, a global scale and the RealNVP coupling.

Port of ``nnest_tpu/bijectors/affine.py``:

- ``ActNorm``: per-dim z = x * exp(s) + t with its data-dependent init
  ``s = -log(max(std, 1e-6))``, ``t = -mean(x * exp(s))`` over the first
  data batch (population std);
- ``ScaleLayer``: z = x * exp(s) with one learned scalar and the logdet
  dim * s (the JAX package's correction of the reference's s);
- ``AffineCoupling``: the masked dims pass through and condition
  z = x * exp(log_s) + t on the others, with (log_s, t) from tanh and ReLU
  MLPs of ``num_layers + 1`` hidden layers; ``translate_only`` drops the
  scale net (the volume-preserving NICE coupling);
- ``alternating_mask``: the checkerboard mask of the NVP blocks.
"""

from __future__ import annotations

import torch
from torch import nn

from nnest_torch.bijectors.base import Bijector
from nnest_torch.bijectors.mlp import MLP


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


class ScaleLayer(Bijector):

    def __init__(self, dim):
        super().__init__()
        self.dim = int(dim)
        self.s = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return x * torch.exp(self.s), (self.dim * self.s).expand(x.shape[0])

    def inverse(self, z):
        return (z * torch.exp(-self.s),
                (-self.dim * self.s).expand(z.shape[0]))


class AffineCoupling(Bijector):

    def __init__(self, dim, hidden, mask, num_layers=2, s_act='tanh',
                 t_act='relu', translate_only=False, generator=None):
        super().__init__()
        self.dim = int(dim)
        self.translate_only = bool(translate_only)
        sizes = [self.dim] + [int(hidden)] * (num_layers + 1) + [self.dim]
        self.register_buffer('mask', torch.tensor(mask, dtype=torch.float32),
                             persistent=False)
        self.t_net = MLP(sizes, generator, act=t_act)
        self.s_net = (None if self.translate_only
                      else MLP(sizes, generator, act=s_act))

    def _shift_and_log_scale(self, v):
        """(t, log_s) from the masked dims of ``v``, zero on those dims
        (log_s None for a translation-only coupling)."""
        vm = v * self.mask
        keep = 1.0 - self.mask
        t = self.t_net(vm) * keep
        return t, None if self.s_net is None else self.s_net(vm) * keep

    def forward(self, x):
        t, log_s = self._shift_and_log_scale(x)
        if log_s is None:
            return x + t, x.new_zeros(x.shape[0])
        return x * torch.exp(log_s) + t, torch.sum(log_s, dim=-1)

    def inverse(self, z):
        t, log_s = self._shift_and_log_scale(z)
        if log_s is None:
            return z - t, z.new_zeros(z.shape[0])
        return (z - t) * torch.exp(-log_s), -torch.sum(log_s, dim=-1)


def alternating_mask(dim, start=0):
    """Checkerboard mask: dim i gets (i + start) % 2."""
    return tuple(float((i + start) % 2) for i in range(dim))
