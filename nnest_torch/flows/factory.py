"""Flow factory: ``build_flow('spline')``.

Port of the spline branch of ``nnest_tpu/flows/factory.py``:
[ActNorm, Invertible1x1Conv, SplineCoupling] × blocks, K = 8 bins and tail
bound 3 by default. The weights are drawn on the CPU from ``seed`` (so a
seed gives the same flow on every device) and the module is then moved to
``device``: the GPU unless the caller asks for the CPU. The other flow
types (NVP, Cholesky, fast-slow) are not ported yet.
"""

from __future__ import annotations

import torch

from nnest_torch.bijectors import (
    ActNorm, Chain, Invertible1x1Conv, SplineCoupling)
from nnest_torch.distributions import DiagNormal
from nnest_torch.flows.model import FlowModel
from nnest_torch.utils.device import resolve_device


def _spline_chain(dim, hidden, num_blocks, num_bins, tail_bound, generator):
    flows = []
    for _ in range(num_blocks):
        flows.append(ActNorm(dim))
        flows.append(Invertible1x1Conv(dim, generator))
        flows.append(SplineCoupling(dim, num_bins=num_bins,
                                    tail_bound=tail_bound, hidden=hidden,
                                    generator=generator))
    return Chain(flows)


def build_flow(x_dim: int,
               flow: str = 'spline',
               hidden_dim: int = 16,
               num_blocks: int = 3,
               num_bins: int = 8,
               tail_bound: float = 3.0,
               seed: int = 0,
               device='cuda') -> FlowModel:
    if flow.lower() != 'spline':
        raise NotImplementedError(
            'Only the spline flow is ported so far, got %r' % flow)
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(int(seed))
    chain = _spline_chain(x_dim, hidden_dim, num_blocks, num_bins,
                          tail_bound, generator)
    return FlowModel(x_dim, chain, DiagNormal(x_dim)).to(device)
