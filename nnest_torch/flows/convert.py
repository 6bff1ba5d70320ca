"""Parameter exchange with the JAX package's pytree layout.

A chain's JAX params are a tuple with one entry per bijector, in chain
order, each a dict with numpy (or array-like) leaves:

- ``ActNorm``: ``{'s', 't'}``; ``Invertible1x1Conv``: ``{'_P', 'L', 'S',
  'U'}``; ``SplineCoupling``: ``{'f1': [{'w', 'b'}, ...], 'f2': [...]}``;
- ``AffineCoupling``: ``{'t_net': [{'w', 'b'}, ...], 's_net': [...]}``
  (no ``'s_net'`` when translation-only); ``ScaleLayer``: ``{'s'}`` (a
  scalar); ``CholeskyLinear``: ``{'bias', 'lower', 'udiag'}``.

A fast-slow flow's params are ``{'slow': chain, 'fast': chain, 'combine':
coupling}``. The port keeps the same tensor layouts (MLP weights are
``(n_in, n_out)``), so conversion is a leaf-by-leaf copy. Nothing here
imports JAX: callers hand over numpy leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from nnest_torch.bijectors import (ActNorm, AffineCoupling, CholeskyLinear,
                                   Invertible1x1Conv, ScaleLayer,
                                   SplineCoupling)
from nnest_torch.flows.model import FastSlowFlowModel

# the tensors of each bijector type, by their JAX names; MLPs apart
_LEAVES = {ActNorm: ('s', 't'), Invertible1x1Conv: ('_P', 'L', 'S', 'U'),
           ScaleLayer: ('s',), CholeskyLinear: ('bias', 'lower', 'udiag')}


def _nets(b):
    """(name, MLP) pairs of a coupling, in the JAX layout."""
    if isinstance(b, SplineCoupling):
        return [('f1', b.f1), ('f2', b.f2)]
    if isinstance(b, AffineCoupling):
        return [('t_net', b.t_net)] + ([] if b.s_net is None
                                       else [('s_net', b.s_net)])
    return []


def _check(b):
    if type(b) not in _LEAVES and not _nets(b):
        raise TypeError('unsupported bijector %s' % type(b).__name__)


def _copy(dst, src):
    src = torch.from_numpy(np.array(src, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError('shape mismatch: %s vs %s'
                         % (tuple(src.shape), tuple(dst.shape)))
    dst.copy_(src.to(dst.device))


def _mlp_from(mlp, layers):
    if len(layers) != len(mlp.w):
        raise ValueError('MLP depth mismatch: %d vs %d'
                         % (len(layers), len(mlp.w)))
    for i, layer in enumerate(layers):
        _copy(mlp.w[i], layer['w'])
        _copy(mlp.b[i], layer['b'])


def _bijector_from(b, p):
    _check(b)
    for name in _LEAVES.get(type(b), ()):
        _copy(getattr(b, name), p[name])
    for name, mlp in _nets(b):
        _mlp_from(mlp, p[name])


def _chain_from(chain, tree):
    bijs = list(chain.bijectors)
    if len(tree) != len(bijs):
        raise ValueError('chain length mismatch: %d vs %d'
                         % (len(tree), len(bijs)))
    for b, p in zip(bijs, tree):
        _bijector_from(b, p)


@torch.no_grad()
def params_from_jax(model, tree):
    """Load a JAX flow param tree (numpy leaves) into ``model``."""
    if isinstance(model, FastSlowFlowModel):
        _chain_from(model.slow, tree['slow'])
        _chain_from(model.fast, tree['fast'])
        _bijector_from(model.combine, tree['combine'])
    else:
        _chain_from(model.chain, tree)
    return model


def _np(t):
    return t.detach().cpu().numpy().copy()


def _bijector_tree(b, leaf):
    _check(b)
    out = {name: leaf(getattr(b, name)) for name in _LEAVES.get(type(b), ())}
    for name, mlp in _nets(b):
        out[name] = [{'w': leaf(w), 'b': leaf(bias)}
                     for w, bias in zip(mlp.w, mlp.b)]
    return out


def _model_tree(model, leaf):
    """The JAX layout of ``model`` with ``leaf`` of each tensor."""
    def chain(c):
        return tuple(_bijector_tree(b, leaf) for b in c.bijectors)

    if isinstance(model, FastSlowFlowModel):
        return {'slow': chain(model.slow), 'fast': chain(model.fast),
                'combine': _bijector_tree(model.combine, leaf)}
    return chain(model.chain)


def params_to_jax(model):
    """The inverse of :func:`params_from_jax`: the JAX package's layout
    with numpy leaves."""
    return _model_tree(model, _np)


def _flatten(tree):
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for v in tree:
            yield from _flatten(v)


def param_tensors(model):
    """The model's tensors that :func:`params_to_jax` emits, frozen buffers
    included (the JAX package's leaves), as the live tensors themselves."""
    return list(_flatten(_model_tree(model, lambda t: t)))
