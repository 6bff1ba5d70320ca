"""Parameter exchange with the JAX package's pytree layout.

A single-speed spline flow's JAX params are a tuple with one entry per
bijector, in chain order::

    ({'s', 't'}, {'_P', 'L', 'S', 'U'}, {'f1': [{'w', 'b'}, ...],
                                         'f2': [...]}) × blocks

with numpy (or array-like) leaves. The port keeps the same tensor layouts
(MLP weights are ``(n_in, n_out)``), so conversion is a leaf-by-leaf copy.
Nothing here imports JAX: callers hand over numpy leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from nnest_torch.bijectors import ActNorm, Invertible1x1Conv, SplineCoupling


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


@torch.no_grad()
def params_from_jax(model, tree):
    """Load a JAX spline-flow param tree (numpy leaves) into ``model``."""
    bijs = list(model.chain.bijectors)
    if len(tree) != len(bijs):
        raise ValueError('chain length mismatch: %d vs %d'
                         % (len(tree), len(bijs)))
    for b, p in zip(bijs, tree):
        if isinstance(b, ActNorm):
            _copy(b.s, p['s'])
            _copy(b.t, p['t'])
        elif isinstance(b, Invertible1x1Conv):
            _copy(b._P, p['_P'])
            _copy(b.L, p['L'])
            _copy(b.S, p['S'])
            _copy(b.U, p['U'])
        elif isinstance(b, SplineCoupling):
            _mlp_from(b.f1, p['f1'])
            _mlp_from(b.f2, p['f2'])
        else:
            raise TypeError('unsupported bijector %s' % type(b).__name__)
    return model


def _np(t):
    return t.detach().cpu().numpy().copy()


def _mlp_to(mlp):
    return [{'w': _np(w), 'b': _np(b)} for w, b in zip(mlp.w, mlp.b)]


def params_to_jax(model):
    """The inverse of :func:`params_from_jax`: a tuple of per-bijector
    dicts with numpy leaves, in the JAX package's layout."""
    out = []
    for b in model.chain.bijectors:
        if isinstance(b, ActNorm):
            out.append({'s': _np(b.s), 't': _np(b.t)})
        elif isinstance(b, Invertible1x1Conv):
            out.append({'_P': _np(b._P), 'L': _np(b.L), 'S': _np(b.S),
                        'U': _np(b.U)})
        elif isinstance(b, SplineCoupling):
            out.append({'f1': _mlp_to(b.f1), 'f2': _mlp_to(b.f2)})
        else:
            raise TypeError('unsupported bijector %s' % type(b).__name__)
    return tuple(out)
