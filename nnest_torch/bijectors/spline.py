"""Neural spline flow coupling layer (NSF-CL), Durkan et al. 2019.

Port of ``nnest_tpu/bijectors/spline.py``. Each call transforms one half
with an RQS whose knots come from a 4-layer LeakyReLU(0.2) MLP on the other
half. Kept exactly:

- odd ``dim``: the lower half gets the extra dim (``cut = ceil(dim / 2)``);
- conditioning: ``f1`` reads the lower half and writes the upper half's
  knots, ``f2`` reads the upper half and writes the lower half's knots;
- the last layer's columns per output dim are ``[K widths | K heights |
  K-1 derivatives]``;
- the reference's double normalisation: the conditioner output is
  ``2B * softmax`` (widths, heights) and ``softplus`` (derivatives) before
  the RQS normalises again.

The forward's transform of each half is ``ops.spline_coupling.coupling_rqs``:
this plain code for a CPU tensor, a hand-written CUDA kernel pair (forward
and backward) for a CUDA tensor. The inverse stays plain here; the hot
inverse has its own kernel (``ops/spline_inverse.py``).
"""

from __future__ import annotations

import torch

from nnest_torch.bijectors.base import Bijector
from nnest_torch.bijectors.mlp import MLP
from nnest_torch.bijectors.rqs import conditioner_knots, rqs


class SplineCoupling(Bijector):

    def __init__(self, dim, num_bins=5, tail_bound=3.0, hidden=8,
                 generator=None):
        super().__init__()
        self.dim = int(dim)
        self.num_bins = int(num_bins)
        self.tail_bound = float(tail_bound)
        self.hidden = int(hidden)
        self.cut = self.dim - self.dim // 2
        up = self.dim - self.cut
        self.f1 = MLP(self._net_sizes(self.cut, up), generator)
        self.f2 = MLP(self._net_sizes(up, self.cut), generator)

    def _net_sizes(self, n_in, n_out_dims):
        return [n_in, self.hidden, self.hidden, self.hidden,
                (3 * self.num_bins - 1) * n_out_dims]

    def _split(self, v):
        return v[:, :self.cut], v[:, self.cut:]

    def knots(self, net, cond, n_dims):
        """Conditioner → (W, H, D) with the reference's pre-normalization."""
        out = net(cond).reshape(cond.shape[0], n_dims, 3 * self.num_bins - 1)
        return conditioner_knots(out, self.num_bins, self.tail_bound)

    def forward(self, x):
        # imported here: nnest_torch.ops imports this package
        from nnest_torch.ops.spline_coupling import coupling_rqs
        lower, upper = self._split(x)
        upper, ld1 = coupling_rqs(self.f1(lower), upper, self.num_bins,
                                  self.tail_bound)
        lower, ld2 = coupling_rqs(self.f2(upper), lower, self.num_bins,
                                  self.tail_bound)
        return torch.cat([lower, upper], dim=1), ld1 + ld2

    def inverse(self, z):
        lower, upper = self._split(z)
        W, H, D = self.knots(self.f2, upper, lower.shape[1])
        lower, ld1 = rqs(lower, W, H, D, inverse=True,
                         tail_bound=self.tail_bound)
        W, H, D = self.knots(self.f1, lower, upper.shape[1])
        upper, ld2 = rqs(upper, W, H, D, inverse=True,
                         tail_bound=self.tail_bound)
        logdet = torch.sum(ld1, dim=-1) + torch.sum(ld2, dim=-1)
        return torch.cat([lower, upper], dim=1), logdet
