"""Sharded training and sampling steps over a (dp, tp) mesh.

Port of ``nnest_tpu/parallel/sharded.py``: the reference's MPI fan-outs
(likelihood farming and candidate pooling, ``nnest/nested.py``) become
dp-sharded chain batches, and flow training becomes dp-sharded batches whose
gradients are summed over the dp shards. With tp > 1 the flow's wide
conditioner weights are column-sharded over the tp group
(``mesh.shard_params``): every tp replica of a dp shard computes the same
rows, so a replicated leaf's gradient is the same on each and a sharded
leaf's is its columns of the whole one; both are summed over dp only. Where
XLA inserts the collectives in the JAX package, the steps here call
:mod:`nnest_torch.parallel.mesh`'s.
"""

from __future__ import annotations

import torch

from nnest_torch.flows.convert import param_tensors
from nnest_torch.parallel.mesh import (_sum_over, all_reduce_sum, real_rows,
                                       shard_batch, shard_params)


class _TPTotal(torch.autograd.Function):
    """The sum of ``x`` over the tp group, whose gradient is this rank's
    own: each rank's ``x`` is its part of one whole."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _sum_over(x, mesh, mesh.tp_group, mesh.tp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def l2_term(tensors, mesh=None):
    """The sum of squares of ``tensors``, every leaf of the whole tree
    once: a tp-sharded tensor's (``mesh.shard_params``) summed over the
    tp group."""
    whole = sum(torch.sum(t ** 2) for t in tensors
                if getattr(t, 'tp_shard', None) is None)
    parts = [torch.sum(t ** 2) for t in tensors
             if getattr(t, 'tp_shard', None) is not None]
    if parts:
        whole = whole + _TPTotal.apply(sum(parts), mesh)
    return whole


def all_reduce_grads(params, mesh, extra=None):
    """Sum the ``.grad`` of every tensor in ``params`` over the dp shards in
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
    -sum(w_rows * log_prob(rows)) / ``w_total``, plus on dp shard 0 alone
    (so the sum over dp counts it once) ``l2_norm`` times the sum of
    squares of ``l2_tensors`` (:func:`l2_term`); returns the share."""
    with torch.enable_grad():
        nll = -torch.sum(model.log_prob(rows) * w_rows) / w_total
        loss = nll
        if l2_norm > 0 and mesh.dp_rank == 0:
            loss = nll + l2_norm * l2_term(l2_tensors, mesh)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    return nll.detach()


def make_sharded_train_step(model, optimizer, mesh, l2_norm=0.0):
    """One sharded NLL training step: ``run(batch, weights=None,
    jitter=0.0, generator=None)`` adds ``jitter`` times normals of the
    whole batch (drawn from ``generator`` on every rank), takes this rank's
    rows (:func:`dp_rows`; ``weights`` (n,) weigh the rows, 1 by default),
    backpropagates its share of the batch's weighted mean NLL
    (:func:`dp_backward`), sums the gradients over the dp shards and steps
    ``optimizer``. The L2 term is ``l2_norm`` times the sum of squares of
    the tensors of ``nnest_tpu``'s parameter tree (``flows.convert.
    param_tensors``: frozen buffers included, as the JAX step sums every
    leaf). Returns the batch's weighted mean NLL, equal on every rank;
    the JAX step's loss adds the L2 term to it. With tp > 1 the model is
    sharded here, in place (``mesh.shard_params``), before ``optimizer``
    holds any state."""
    shard_params(model, mesh)
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
    the outputs are gathered, equal on every rank. With tp > 1 the
    kernels' flow is sharded here, in place (``mesh.shard_params``); each
    tp replica of a dp shard steps that shard's chains, the spline kernel
    on the whole weights, gathered once a call."""
    shard_params(kernels.model, mesh)

    def run(generator, z0, logl0, logl_prior0, **kw):
        return kernels.mcmc(generator, z0, logl0, logl_prior0, mesh=mesh,
                            **kw)

    return run
