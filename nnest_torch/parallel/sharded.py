"""Sharded training and sampling steps over a data-parallel mesh.

Port of ``nnest_tpu/parallel/sharded.py``: the reference's MPI fan-outs
(likelihood farming and candidate pooling, ``nnest/nested.py``) become
dp-sharded chain batches, and flow training becomes dp-sharded batches whose
gradients are summed over ranks. Where XLA inserts the collectives in the
JAX package, the steps here call :mod:`nnest_torch.parallel.mesh`'s.
"""

from __future__ import annotations

import torch

from nnest_torch.flows.convert import param_tensors
from nnest_torch.parallel.mesh import all_reduce_sum, real_rows, shard_batch


def all_reduce_grads(params, mesh, extra=None):
    """Sum the ``.grad`` of every tensor in ``params`` over the ranks in
    place, in one collective that also carries ``extra`` (a 1-D tensor,
    e.g. the batch's loss); returns ``extra`` summed. A tensor without a
    gradient contributes zeros and keeps none."""
    params = list(params)
    parts = [p.grad.reshape(-1) if p.grad is not None
             else torch.zeros(p.numel(), device=p.device) for p in params]
    if extra is not None:
        parts.append(extra.reshape(-1))
    flat = all_reduce_sum(torch.cat(parts), mesh)
    offset = 0
    for p in params:
        n = p.numel()
        if p.grad is not None:
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n
    return None if extra is None else flat[offset:]


def dp_rows(mesh, batch, w):
    """This rank's rows of an (n, d) batch and their weights: the rows of
    ``w`` (n,), with the pad rows weighing 0."""
    rows, _ = shard_batch(batch, mesh)
    w_rows, _ = shard_batch(w, mesh)
    return rows, w_rows * real_rows(mesh, w.shape[0], w.device)


def dp_backward(model, optimizer, mesh, rows, w_rows, w_total, l2_norm,
                l2_tensors):
    """Backpropagate this rank's share of the batch's weighted mean NLL,
    -sum(w_rows * log_prob(rows)) / ``w_total``, plus on rank 0 alone (so
    the sum over ranks counts it once) ``l2_norm`` times the sum of squares
    of ``l2_tensors``; returns the share."""
    with torch.enable_grad():
        nll = -torch.sum(model.log_prob(rows) * w_rows) / w_total
        loss = nll
        if l2_norm > 0 and mesh.rank == 0:
            loss = nll + l2_norm * sum(torch.sum(t ** 2) for t in l2_tensors)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    return nll.detach()


def make_sharded_train_step(model, optimizer, mesh, l2_norm=0.0):
    """One dp-sharded NLL training step: ``run(batch, weights=None,
    jitter=0.0, generator=None)`` adds ``jitter`` times normals of the
    whole batch (drawn from ``generator`` on every rank), takes this rank's
    rows (:func:`dp_rows`; ``weights`` (n,) weigh the rows, 1 by default),
    backpropagates its share of the batch's weighted mean NLL
    (:func:`dp_backward`), sums the gradients over ranks and steps
    ``optimizer``. The L2 term is ``l2_norm`` times the sum of squares of
    the tensors of ``nnest_tpu``'s parameter tree (``flows.convert.
    param_tensors``: frozen buffers included, as the JAX step sums every
    leaf). Returns the batch's weighted mean NLL, equal on every rank;
    the JAX step's loss adds the L2 term to it."""
    l2_tensors = param_tensors(model)

    def run(batch, weights=None, jitter=0.0, generator=None):
        if jitter:
            batch = batch + jitter * torch.randn(
                batch.shape, generator=generator, device=batch.device)
        if weights is None:
            weights = torch.ones(batch.shape[0], dtype=batch.dtype,
                                 device=batch.device)
        rows, w_rows = dp_rows(mesh, batch, weights)
        nll = dp_backward(model, optimizer, mesh, rows, w_rows,
                          torch.sum(weights), l2_norm, l2_tensors)
        nll = all_reduce_grads(model.parameters(), mesh,
                               extra=nll.reshape(1))
        optimizer.step()
        return nll[0]

    return run


def make_sharded_mcmc(kernels, mesh):
    """``kernels.mcmc`` (a :class:`~nnest_torch.samplers.kernels.
    LatentKernels`) with the chain axis sharded over dp: ``run(generator,
    z0, logl0, logl_prior0, **kw)`` takes the whole batch of starts on
    every rank; each rank steps its chains on the whole batch's draws and
    the outputs are gathered, equal on every rank."""

    def run(generator, z0, logl0, logl_prior0, **kw):
        return kernels.mcmc(generator, z0, logl0, logl_prior0, mesh=mesh,
                            **kw)

    return run
