"""Flow factory: ``build_flow`` from the reference's string keys.

Port of ``nnest_tpu/flows/factory.py``:

- ``'spline'``: [ActNorm, Invertible1x1Conv, SplineCoupling] × blocks,
  K = 8 bins and tail bound 3 by default;
- ``'nvp'``: alternating-mask RealNVP couplings × blocks (``scale``
  ``'translate'`` makes them translation-only, ``'constant'`` adds a
  ``ScaleLayer`` after each);
- ``'cholesky'`` (and the reference's spelling ``'choleksy'``): one
  learnable lower-triangular linear map;
- ``num_slow > 0`` with ``'spline'`` or ``'nvp'``: a fast-slow flow, a
  chain each for the slow and the fast dims and a slow-masking combine
  coupling (hidden 64, one layer). The reference's quirk is kept: the
  fast spline chain has hidden width 16 whatever ``hidden_dim`` is, and
  the fast-slow NVP chains have no scale layers.

The base distribution is the standard normal unless ``base_dist`` is
given. The weights are drawn on the CPU from ``seed`` (so a seed gives the
same flow on every device) and the module is then moved to ``device``: the
GPU unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

from nnest_torch.bijectors import (
    ActNorm, AffineCoupling, Chain, CholeskyLinear, Invertible1x1Conv,
    ScaleLayer, SplineCoupling, alternating_mask)
from nnest_torch.distributions import DiagNormal
from nnest_torch.flows.model import FastSlowFlowModel, FlowModel
from nnest_torch.utils.device import resolve_device


def _nvp_chain(dim, hidden, num_blocks, num_layers, scale, generator):
    translate_only = scale in ('translate', 'constant')
    flows = []
    for b in range(num_blocks):
        flows.append(AffineCoupling(
            dim, hidden, alternating_mask(dim, start=b % 2),
            num_layers=num_layers, s_act='tanh', t_act='relu',
            translate_only=translate_only, generator=generator))
        if scale == 'constant':
            flows.append(ScaleLayer(dim))
    return Chain(flows)


def _spline_chain(dim, hidden, num_blocks, num_bins, tail_bound, generator):
    flows = []
    for _ in range(num_blocks):
        flows.append(ActNorm(dim))
        flows.append(Invertible1x1Conv(dim, generator))
        flows.append(SplineCoupling(dim, num_bins=num_bins,
                                    tail_bound=tail_bound, hidden=hidden,
                                    generator=generator))
    return Chain(flows)


def _combine_coupling(num_slow, num_fast, generator):
    return AffineCoupling(num_slow + num_fast, 64,
                          (1.0,) * num_slow + (0.0,) * num_fast,
                          num_layers=1, s_act='tanh', t_act='relu',
                          generator=generator)


def build_flow(x_dim: int,
               flow: str = 'spline',
               hidden_dim: int = 16,
               num_slow: int = 0,
               num_blocks: int = 3,
               num_layers: int = 1,
               scale: str = '',
               base_dist=None,
               num_bins: int = 8,
               tail_bound: float = 3.0,
               seed: int = 0,
               device='cuda') -> FlowModel:
    if not 0 <= num_slow < x_dim:
        raise ValueError('num_slow must be in [0, x_dim), got %d' % num_slow)
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(int(seed))
    if base_dist is None:
        base_dist = DiagNormal(x_dim)
    num_fast = x_dim - num_slow
    name = flow.lower()

    if name in ('choleksy', 'cholesky'):
        model = FlowModel(x_dim, Chain([CholeskyLinear(x_dim)]), base_dist)
    elif name == 'nvp' and num_slow > 0:
        model = FastSlowFlowModel(
            x_dim, num_slow,
            _nvp_chain(num_slow, hidden_dim, num_blocks, num_layers, '',
                       generator),
            _nvp_chain(num_fast, hidden_dim, num_blocks, num_layers, '',
                       generator),
            _combine_coupling(num_slow, num_fast, generator), base_dist)
    elif name == 'nvp':
        model = FlowModel(x_dim, _nvp_chain(x_dim, hidden_dim, num_blocks,
                                            num_layers, scale, generator),
                          base_dist)
    elif name == 'spline' and num_slow > 0:
        model = FastSlowFlowModel(
            x_dim, num_slow,
            _spline_chain(num_slow, hidden_dim, num_blocks, num_bins,
                          tail_bound, generator),
            _spline_chain(num_fast, 16, num_blocks, num_bins, tail_bound,
                          generator),
            _combine_coupling(num_slow, num_fast, generator), base_dist)
    elif name == 'spline':
        model = FlowModel(x_dim, _spline_chain(x_dim, hidden_dim, num_blocks,
                                               num_bins, tail_bound,
                                               generator), base_dist)
    else:
        raise NotImplementedError('Unknown flow type: %r' % flow)
    return model.to(device)
