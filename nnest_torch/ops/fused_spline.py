"""Hot-path spline-flow inverse with packed constants (plain PyTorch).

Port of ``nnest_tpu/ops/fused_spline.py``. ``pack_inverse_consts`` turns the
parameter-only pieces of the chain inverse into constants once per kernel
invocation (each 1x1-conv's dense W⁻¹, the ActNorm s/t, and the
data-independent logdet ``-Σs - Σlog|S|``), so a chain step never solves a
linear system. ``_inverse_body`` is the inverse on a batch with those
constants: the CPU path of ``ops.spline_inverse`` and the plain twin the
CUDA kernel is checked against.
"""

from __future__ import annotations

import torch

from nnest_torch.bijectors import ActNorm, Invertible1x1Conv, SplineCoupling
from nnest_torch.parallel.mesh import unshard

# Calls of the plain twin since import (or since a caller reset it):
# chip_smoke.py sets it to 0 before a path on the card and checks that the
# path never fell back to the twin.
calls = 0


def is_fusable_spline(model) -> bool:
    """True for single-speed spline chains: [ActNorm, Inv1x1Conv,
    SplineCoupling] × blocks (the factory's 'spline' layout)."""
    chain = getattr(model, 'chain', None)
    if chain is None:
        return False
    bijs = list(chain.bijectors)
    if len(bijs) == 0 or len(bijs) % 3 != 0:
        return False
    return all(isinstance(bijs[i], ActNorm)
               and isinstance(bijs[i + 1], Invertible1x1Conv)
               and isinstance(bijs[i + 2], SplineCoupling)
               for i in range(0, len(bijs), 3))


@torch.no_grad()
def pack_inverse_consts(model):
    """Per block {s, t, winv, sc}, plus the constant logdet. ``sc`` is the
    block's SplineCoupling module (its MLP weights are used as they are).
    Under tensor parallelism the constants come from the whole weights,
    gathered over the tp group once a packing (``parallel.unshard``), so
    the inverse needs no collective."""
    bijs = list(unshard(model).chain.bijectors)
    blocks = []
    const_logdet = bijs[0].s.new_zeros(())
    for i in range(0, len(bijs), 3):
        act, conv, sc = bijs[i], bijs[i + 1], bijs[i + 2]
        # inv_ex: the same inverse without the host read of its error flag
        winv = torch.linalg.inv_ex(conv.assemble())[0]
        const_logdet = const_logdet - torch.sum(act.s) \
            - torch.sum(torch.log(torch.abs(conv.S)))
        blocks.append({'s': act.s.detach(), 't': act.t.detach(),
                       'winv': winv, 'sc': sc})
    return {'blocks': blocks, 'const_logdet': const_logdet}


@torch.no_grad()
def _inverse_body(z, packed, first_block=0, num_blocks=None,
                  include_const=True):
    """Chain inverse on a batch using packed consts (plain PyTorch): blocks
    [first_block, first_block + num_blocks) from last to first (all of them
    by default), plus the constant logdet when ``include_const``."""
    global calls
    calls += 1
    blocks = packed['blocks']
    if num_blocks is None:
        num_blocks = len(blocks) - first_block
    logdet = torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)
    for blk in reversed(blocks[first_block:first_block + num_blocks]):
        z, ld = blk['sc'].inverse(z)
        logdet = logdet + ld
        z = z @ blk['winv']
        z = (z - blk['t']) * torch.exp(-blk['s'])
    if include_const:
        logdet = logdet + packed['const_logdet']
    return z, logdet
