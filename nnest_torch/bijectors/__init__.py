from nnest_torch.bijectors.base import Bijector, Chain
from nnest_torch.bijectors.affine import (ActNorm, AffineCoupling, ScaleLayer,
                                          alternating_mask)
from nnest_torch.bijectors.cholesky import CholeskyLinear
from nnest_torch.bijectors.conv1x1 import Invertible1x1Conv
from nnest_torch.bijectors.spline import SplineCoupling

__all__ = ['Bijector', 'Chain', 'ActNorm', 'AffineCoupling', 'ScaleLayer',
           'alternating_mask', 'CholeskyLinear', 'Invertible1x1Conv',
           'SplineCoupling']
