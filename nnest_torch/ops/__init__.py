"""Hot-path ops: the packed spline-flow inverse, its CUDA kernel and the
pool-consumption kernel (``nnest_tpu.ops``' names)."""

from nnest_torch.ops.fused_spline import (is_fusable_spline,
                                          pack_inverse_consts)
from nnest_torch.ops.spline_inverse import fused_inverse_fn

__all__ = ['is_fusable_spline', 'pack_inverse_consts', 'fused_inverse_fn']
