"""Flow models: a base distribution plus bijectors.

Port of ``FlowModel`` and ``FastSlowFlowModel`` in
``nnest_tpu/flows/model.py``. Convention: ``forward`` maps data x → latent
z, ``inverse`` maps z → x, logdets are (batch,) and antisymmetric.
"""

from __future__ import annotations

import torch
from torch import nn


class FlowModel(nn.Module):
    """Single-speed flow: z = chain(x); log p(x) = base.log_prob(z) + logdet."""

    def __init__(self, dim, chain, base_dist):
        super().__init__()
        self.dim = int(dim)
        self.chain = chain
        self.base_dist = base_dist

    def data_init(self, x):
        """Data-dependent init (ActNorm statistics) from a data batch."""
        self.chain.data_init(x)

    def forward(self, x):
        return self.chain(x)

    def inverse(self, z):
        return self.chain.inverse(z)

    def log_prob(self, x):
        z, logdet = self(x)
        return self.base_dist.log_prob(z) + logdet

    def sample_base(self, num, generator=None):
        return self.base_dist.sample(num, generator,
                                     device=next(self.parameters()).device)

    def sample(self, num, generator=None):
        """``num`` draws of the flow: base draws through the inverse."""
        return self.inverse(self.sample_base(num, generator))[0]


class FastSlowFlowModel(FlowModel):
    """Fast-slow flow: the slow dims [0:num_slow] and the fast dims
    [num_slow:] each go through their own chain (``slow``, ``fast``), then
    the ``combine`` coupling, which masks the slow dims, mixes them into
    the fast ones. Its inverse leaves the slow dims of z unchanged, so the
    slow half of x is exactly invariant to a latent move of the fast dims
    only (the fast-slow likelihood trick)."""

    def __init__(self, dim, num_slow, slow, fast, combine, base_dist):
        super().__init__(dim, None, base_dist)
        self.num_slow = int(num_slow)
        self.slow = slow
        self.fast = fast
        self.combine = combine

    @property
    def num_fast(self):
        return self.dim - self.num_slow

    @torch.no_grad()
    def data_init(self, x):
        xs, xf = x[:, :self.num_slow], x[:, self.num_slow:]
        self.slow.data_init(xs)
        self.fast.data_init(xf)
        self.combine.data_init(torch.cat([self.slow(xs)[0],
                                          self.fast(xf)[0]], dim=1))

    def forward(self, x):
        slow, ld_s = self.slow(x[:, :self.num_slow])
        fast, ld_f = self.fast(x[:, self.num_slow:])
        z, ld_c = self.combine(torch.cat([slow, fast], dim=1))
        return z, ld_s + ld_f + ld_c

    def inverse(self, z):
        h, ld_c = self.combine.inverse(z)
        slow, ld_s = self.slow.inverse(h[:, :self.num_slow])
        fast, ld_f = self.fast.inverse(h[:, self.num_slow:])
        return torch.cat([slow, fast], dim=1), ld_s + ld_f + ld_c
