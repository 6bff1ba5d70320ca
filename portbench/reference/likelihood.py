"""The ``gaussian`` kind's float64 reference (``reference/likelihoods/``),
under the name it had before kinds were found by name."""

from reference.likelihoods.gaussian import Gaussian

__all__ = ['Gaussian']
