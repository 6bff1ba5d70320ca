from nnest_torch.bijectors.base import Bijector, Chain
from nnest_torch.bijectors.affine import ActNorm
from nnest_torch.bijectors.conv1x1 import Invertible1x1Conv
from nnest_torch.bijectors.spline import SplineCoupling

__all__ = ['Bijector', 'Chain', 'ActNorm', 'Invertible1x1Conv',
           'SplineCoupling']
