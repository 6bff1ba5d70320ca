"""Flow model: a base distribution plus a bijector chain.

Port of ``FlowModel`` in ``nnest_tpu/flows/model.py``. Convention:
``forward`` maps data x → latent z, ``inverse`` maps z → x, logdets are
(batch,) and antisymmetric.
"""

from __future__ import annotations

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
        z, logdet = self.chain(x)
        return self.base_dist.log_prob(z) + logdet

    def sample_base(self, num, generator=None):
        return self.base_dist.sample(num, generator,
                                     device=next(self.parameters()).device)
