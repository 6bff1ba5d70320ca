from nnest_torch.distributions.base import (BaseDistribution, DiagNormal,
                                            GeneralisedNormal, LogitUniform)

__all__ = ['BaseDistribution', 'DiagNormal', 'GeneralisedNormal',
           'LogitUniform']
