from nnest_torch.distributions.base import (DiagNormal, GeneralisedNormal,
                                            LogitUniform)

__all__ = ['DiagNormal', 'GeneralisedNormal', 'LogitUniform']
