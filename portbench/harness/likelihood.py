"""The likelihood the benchmark hands the sampler, built by the kind that
the configuration's ``likelihood.kind`` names (``harness/likelihoods/``).
``Gaussian`` and ``Scale`` are the ``gaussian`` kind's."""

from __future__ import annotations

from harness import cells
from harness.likelihoods.gaussian import Gaussian, Scale

__all__ = ['Gaussian', 'Scale', 'build']


def build(config, device):
    """(likelihood, transform) of the configuration's kind."""
    like = config['likelihood']
    return cells.kind(like['kind']).build(like, device)
