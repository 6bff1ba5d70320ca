from nnest_torch.distributions.base import DiagNormal

__all__ = ['DiagNormal']
