"""The import guard: no module of JAX or of the JAX package may be loaded
in a run, compared by whole top-level name (``nnest_torch`` is not
``nnest_tpu``)."""

from __future__ import annotations

import sys

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'nnest_tpu')


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), sorted."""
    names = sys.modules if names is None else names
    tops = {name.split('.', 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))


def keep_jax_out():
    """TensorBoard, which the trainer writes its scalars with, imports
    TensorFlow where it finds it, and TensorFlow imports JAX; its own
    marker module ``tensorboard.compat.notf`` makes it take its stub
    instead."""
    import types
    sys.modules.setdefault('tensorboard.compat.notf',
                           types.ModuleType('tensorboard.compat.notf'))
