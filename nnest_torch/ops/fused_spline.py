"""Hot-path spline-flow inverse with packed constants (plain PyTorch).

Port of ``nnest_tpu/ops/fused_spline.py``. ``pack_inverse_consts`` turns the
parameter-only pieces of the chain inverse into constants once per kernel
invocation (each 1x1-conv's dense W⁻¹, the ActNorm s/t, and the
data-independent logdet ``-Σs - Σlog|S|``), so a chain step never solves a
linear system. ``_inverse_body`` is the inverse on a batch with those
constants: the CPU path of ``ops.spline_inverse`` and the plain twin the
CUDA kernel is checked against.

A fast-slow flow whose slow and fast chains both have the spline layout
(:func:`is_fusable_fast_slow`) packs each chain the same way
(:func:`pack_fast_slow_consts`), beside its combine coupling, which stays
a module.
"""

from __future__ import annotations

import torch

from nnest_torch.bijectors import ActNorm, Invertible1x1Conv, SplineCoupling
from nnest_torch.flows.model import FastSlowFlowModel
from nnest_torch.parallel.mesh import unshard

# Calls of the plain twin since import (or since a caller reset it):
# chip_smoke.py sets it to 0 before a path on the card and checks that the
# path never fell back to the twin.
calls = 0


def is_spline_chain(chain) -> bool:
    """[ActNorm, Inv1x1Conv, SplineCoupling] × blocks (the factory's
    'spline' layout)."""
    if chain is None:
        return False
    bijs = list(chain.bijectors)
    if len(bijs) == 0 or len(bijs) % 3 != 0:
        return False
    return all(isinstance(bijs[i], ActNorm)
               and isinstance(bijs[i + 1], Invertible1x1Conv)
               and isinstance(bijs[i + 2], SplineCoupling)
               for i in range(0, len(bijs), 3))


def is_fusable_spline(model) -> bool:
    """True for single-speed spline chains: [ActNorm, Inv1x1Conv,
    SplineCoupling] × blocks (the factory's 'spline' layout)."""
    return is_spline_chain(getattr(model, 'chain', None))


def is_fusable_fast_slow(model) -> bool:
    """True for a fast-slow flow whose slow and fast chains each have the
    single-speed spline layout over two dims or more (a one-dim chain's
    conditioner reads no input, a shape the kernel has never run)."""
    return (isinstance(model, FastSlowFlowModel)
            and all(is_spline_chain(c) and c.bijectors[0].dim >= 2
                    for c in (model.slow, model.fast)))


@torch.no_grad()
def pack_chain_consts(chain):
    """Per block {s, t, winv, sc} of a spline-layout ``chain``, plus the
    constant logdet. ``sc`` is the block's SplineCoupling module (its MLP
    weights are used as they are)."""
    bijs = list(chain.bijectors)
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


def pack_inverse_consts(model):
    """:func:`pack_chain_consts` of a single-speed spline flow's chain.
    Under tensor parallelism the constants come from the whole weights,
    gathered over the tp group once a packing (``parallel.unshard``), so
    the inverse needs no collective."""
    return pack_chain_consts(unshard(model).chain)


def pack_fast_slow_consts(model):
    """A fast-slow spline flow's packing: ``slow`` and ``fast``, each
    chain's :func:`pack_chain_consts`, the ``combine`` coupling module and
    ``num_slow``."""
    model = unshard(model)
    return {'num_slow': model.num_slow, 'combine': model.combine,
            'slow': pack_chain_consts(model.slow),
            'fast': pack_chain_consts(model.fast)}


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
