"""Data- and tensor-parallel mesh over ``torch.distributed`` ranks.

Port of ``nnest_tpu/parallel/mesh.py``. The JAX package shards batch axes
over a device mesh, within one process or across ``jax.distributed``
processes. Here the mesh is one process a rank: every rank runs the same
host loop from the same seed. A dp-sharded step draws the whole batch's
random numbers from the shared generator on every rank, computes on its own
rows, then all-gathers the results, so a rank's rows see the numbers one
process would give them. Process 0 owns the run directory, as the
reference's MPI rank 0 does.

Backends (:func:`initialize_distributed`):

- NCCL when each rank has a card of its own (``cuda:LOCAL_RANK``);
- gloo on CPU ranks;
- gloo when several ranks share one card (NCCL refuses two ranks on one
  device): each rank computes on ``cuda:LOCAL_RANK % cards``.

gloo takes CUDA tensors in ``broadcast`` and ``all_reduce`` only, so under
gloo the collectives here move a CUDA payload through the host; the
computation stays on the card either way. A mesh records the backend of its
process group and never switches.

A (dp, tp) mesh lays the ranks out as ``np.reshape(ranks, (dp, tp))``, the
reference's device order: rank r is dp shard r // tp and tp rank r % tp.
The ranks of one tp index form a dp group, those of one dp shard a tp
group. A sharding is the rows of a batch a rank holds:
:func:`batch_sharding` the dp shard's slice of a batch padded to a
multiple of dp by repeating row 0, :func:`replicated` all of them; the tp
replicas of a dp shard hold the same rows, and the batch collectives
(:func:`gather_rows`, :func:`all_reduce_sum`) run over the dp group.

Tensor parallelism (``tp > 1``): :func:`params_sharding_tree` marks the
leaves ``nnest_tpu`` shards over 'tp', the 2-D leaves of the JAX layout
whose output dimension (dimension 1 there and in the port, whose layouts
are the JAX package's) is a multiple of tp and at least ``min_dim`` wide;
:func:`shard_params` keeps this tp rank's columns of each (a
:class:`ColumnShard` on the tensor says which). A conditioner layer with a
sharded weight multiplies by its columns and all-gathers the activations
over the tp group (:meth:`ColumnShard.matmul`); any other sharded leaf is
gathered before use (``bijectors.base.whole``); :func:`unshard` gives a
copy with every leaf whole (the spline kernel's packing, the model file).
"""

from __future__ import annotations

import copy
import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist

# this rank's compute device, chosen by initialize_distributed
_DEVICE = None


class Mesh:
    """A (dp, tp) mesh over the ranks of ``group`` (None: one rank, no
    process group, every collective the identity). ``device`` is the
    rank's compute device, where an NCCL collective's payload lives.
    ``dp_group`` and ``tp_group`` are this rank's dp and tp groups (None
    where the group is this rank alone); with tp = 1 the dp group is
    ``group``."""

    def __init__(self, dp, tp, group, backend, device, rank, dp_group=None,
                 tp_group=None):
        self.dp, self.tp = int(dp), int(tp)
        self.group, self.backend = group, backend
        self.device, self.rank = torch.device(device), int(rank)
        self.dp_rank, self.tp_rank = divmod(self.rank, self.tp)
        self.dp_group = group if self.tp == 1 else dp_group
        self.tp_group = tp_group


def _choose(device, local_rank, local_world):
    """(backend, compute device) of a rank: NCCL when every local rank has
    a card of its own, gloo otherwise."""
    device = torch.device(device)
    if device.type == 'cpu':
        return 'gloo', device
    if not torch.cuda.is_available():
        raise RuntimeError('device %r requested but CUDA is not available; '
                           "pass device='cpu' for CPU ranks" % str(device))
    cards = torch.cuda.device_count()
    return ('nccl' if local_world <= cards else 'gloo',
            torch.device('cuda', local_rank % cards))


def initialize_distributed(device='cuda', init_method=None, world_size=None,
                           rank=None, local_rank=None, local_world_size=None,
                           timeout_s=600):
    """Join the process group: rank, world size, this host's rank and
    number of ranks from the arguments or from the ``torchrun``
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
    ``init_method`` defaults to ``tcp://MASTER_ADDR:MASTER_PORT``. The
    backend follows the module docstring, and on a card this rank's card
    becomes the current device; ranks on cards must say how many of them
    share the host when there is more than one rank. Returns the backend.
    Idempotent: with a process group already up it only returns its
    backend. A failed rendezvous raises; nothing falls back to one
    process."""
    global _DEVICE
    if dist.is_initialized():
        return dist.get_backend()
    env = os.environ
    rank = int(env['RANK'] if rank is None else rank)
    world_size = int(env['WORLD_SIZE'] if world_size is None else world_size)
    if local_world_size is None:
        local_world_size = env.get('LOCAL_WORLD_SIZE')
    if local_rank is None:
        local_rank = env.get('LOCAL_RANK')
    if local_world_size is None or local_rank is None:
        if torch.device(device).type == 'cuda' and world_size > 1:
            raise ValueError(
                'ranks on cards need local_rank and local_world_size (or '
                'LOCAL_RANK and LOCAL_WORLD_SIZE): the ranks on this host '
                'decide between NCCL and gloo')
        local_rank, local_world_size = rank, world_size
    local_rank, local_world = int(local_rank), int(local_world_size)
    chosen, dev = _choose(device, local_rank, local_world)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    if init_method is None:
        init_method = 'tcp://%s:%s' % (env.get('MASTER_ADDR', 'localhost'),
                                       env['MASTER_PORT'])
    dist.init_process_group(chosen, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev
    return chosen


def get_mesh(dp=None, tp=1):
    """The (dp, tp) mesh of the default process group, dp = world // tp
    by default; with no process group a one-rank mesh, whose results equal
    ``mesh=None``'s. With tp > 1 every rank makes every dp and tp group
    (``dist.new_group``), in the same order."""
    tp = int(tp)
    if tp < 1:
        raise ValueError('tp must be at least 1, got %d' % tp)
    if not dist.is_initialized():
        if dp not in (None, 1) or tp != 1:
            raise ValueError('dp=%r, tp=%d needs more ranks than the world '
                             'size 1 of a process without a process group; '
                             'call initialize_distributed first' % (dp, tp))
        return Mesh(1, 1, None, None, 'cpu', 0)
    world = dist.get_world_size()
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError('dp * tp = %d must equal the world size %d'
                         % (dp * tp, world))
    backend = dist.get_backend()
    device = _DEVICE
    if device is None:
        device = (torch.device('cuda', torch.cuda.current_device())
                  if backend == 'nccl' else torch.device('cpu'))
    rank = dist.get_rank()
    dp_group = tp_group = None
    if tp > 1:
        layout = np.arange(world).reshape(dp, tp)
        for b in range(tp):
            if dp > 1:
                g = dist.new_group(layout[:, b].tolist())
                if b == rank % tp:
                    dp_group = g
        for a in range(dp):
            g = dist.new_group(layout[a].tolist())
            if a == rank // tp:
                tp_group = g
    return Mesh(dp, tp, dist.group.WORLD, backend, device, rank, dp_group,
                tp_group)


def batch_sharding(mesh, n):
    """The rows this rank holds of an ``n``-row batch padded to a multiple
    of dp: (a slice of the padded batch, the pad)."""
    pad = (-n) % mesh.dp
    m = (n + pad) // mesh.dp
    return slice(mesh.dp_rank * m, (mesh.dp_rank + 1) * m), pad


def real_rows(mesh, n, device=None):
    """(m,) bool: which of this rank's rows of an ``n``-row batch are real
    rows, not the pad (:func:`batch_sharding`)."""
    rows, _ = batch_sharding(mesh, n)
    return torch.arange(rows.start, rows.stop, device=device) < n


def replicated(mesh):
    """The rows every rank holds of a replicated batch: all of them."""
    del mesh
    return slice(None)


def pad_rows(x, pad):
    """``x`` with row 0 repeated ``pad`` times at the end (numpy or a
    tensor)."""
    if not pad:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[:1].expand(pad, *x.shape[1:])])
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[:1], pad, axis=0)])


def shard_batch(x, mesh):
    """This rank's rows of the batch ``x`` (numpy or a tensor), padded to a
    multiple of dp by repeating row 0; returns (rows, pad)."""
    rows, pad = batch_sharding(mesh, x.shape[0])
    return pad_rows(x, pad)[rows], pad


class ColumnShard:
    """Columns [lo, hi) of a (rows, cols) leaf: this tp rank's share of
    ``cols`` split evenly over the mesh's tp group."""

    def __init__(self, mesh, cols):
        k = cols // mesh.tp
        self.mesh, self.cols = mesh, cols
        self.lo, self.hi = k * mesh.tp_rank, k * (mesh.tp_rank + 1)
        self.index = (slice(None), slice(self.lo, self.hi))

    def __deepcopy__(self, memo):
        # a copied tensor keeps its share; the process groups are not data
        return self

    def gather(self, x):
        """The whole (.., cols) tensor from every tp rank's columns ``x``
        (.., hi - lo), concatenated in tp-rank order; the backward keeps
        this rank's columns of the gradient (every tp rank holds the same
        downstream gradient)."""
        return _GatherColumns.apply(x, self)

    def matmul(self, x, w):
        """``x @ W`` for the whole weight W of which ``w`` holds this
        rank's columns, ``x`` replicated over tp: this rank's columns of
        the product, gathered; the backward sums ``x``'s gradient over the
        tp ranks (each holds the part from its columns)."""
        return self.gather(_SumGradient.apply(x, self) @ w)


class _GatherColumns(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        parts = _all_gather(x.reshape(1, *x.shape).contiguous(), shard.mesh,
                            shard.mesh.tp_group, shard.mesh.tp)
        return torch.cat(list(parts), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.shard.lo:ctx.shard.hi].contiguous(), None


class _SumGradient(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.shard.mesh
        return _sum_over(grad, mesh, mesh.tp_group, mesh.tp), None


def _sharded(leaf, mesh, min_dim):
    """Whether nnest_tpu shards ``leaf`` over 'tp': 2-D, its dimension 1
    (the output of a JAX-layout weight) a multiple of tp and at least
    ``min_dim``."""
    return (mesh.tp > 1 and hasattr(leaf, 'ndim') and leaf.ndim == 2
            and leaf.shape[1] % mesh.tp == 0 and leaf.shape[1] >= min_dim)


def params_sharding_tree(params, mesh, min_dim=128):
    """The sharding of each leaf of ``params``: a flow model (its tensors
    in ``nnest_tpu``'s parameter tree, ``flows/convert.py``'s layout), or
    a dict, list or tuple of tensors or arrays. A leaf ``nnest_tpu``
    shards over 'tp' gets the index of this tp rank's columns,
    ``(slice(None), slice(lo, hi))``; every other leaf ``slice(None)``,
    replicated (all of them with tp = 1). A tensor that
    :func:`shard_params` already sharded keeps its index."""
    def spec(leaf):
        shard = getattr(leaf, 'tp_shard', None)
        if shard is not None:
            return shard.index
        if _sharded(leaf, mesh, min_dim):
            return ColumnShard(mesh, leaf.shape[1]).index
        return replicated(mesh)

    if isinstance(params, torch.nn.Module):
        from nnest_torch.flows.convert import model_tree
        return model_tree(params, spec)
    if isinstance(params, dict):
        return {k: params_sharding_tree(v, mesh, min_dim)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_sharding_tree(v, mesh, min_dim)
                            for v in params)
    return spec(params)


def shard_params(params, mesh, min_dim=128):
    """``params`` laid out by :func:`params_sharding_tree`. A flow model
    is sharded in place: each sharded tensor keeps this tp rank's columns
    and carries its :class:`ColumnShard` as ``tp_shard`` (shard it before
    making its optimizer); the model is returned. A tree of tensors or
    arrays gives a tree of this rank's columns of each sharded leaf, the
    others as they are; with tp = 1 that is ``params`` itself."""
    if mesh.tp == 1:
        return params
    if isinstance(params, torch.nn.Module):
        from nnest_torch.flows.convert import param_tensors
        for t in param_tensors(params):
            if getattr(t, 'tp_shard', None) is None and _sharded(t, mesh,
                                                                 min_dim):
                shard = ColumnShard(mesh, t.shape[1])
                t.data = t.data[shard.index].contiguous()
                t.tp_shard = shard
        return params
    if isinstance(params, dict):
        return {k: shard_params(v, mesh, min_dim) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(shard_params(v, mesh, min_dim) for v in params)
    if _sharded(params, mesh, min_dim):
        return params[ColumnShard(mesh, params.shape[1]).index]
    return params


def unshard(model):
    """``model`` with every tensor whole: ``model`` itself when
    :func:`shard_params` sharded none, else a copy whose sharded tensors
    are gathered over the tp group (a collective: every tp rank calls
    it)."""
    tensors = list(model.parameters()) + list(model.buffers())
    if all(getattr(t, 'tp_shard', None) is None for t in tensors):
        return model
    out = copy.deepcopy(model)
    with torch.no_grad():
        for t, o in zip(tensors, list(out.parameters())
                        + list(out.buffers())):
            shard = getattr(t, 'tp_shard', None)
            if shard is not None:
                o.data = shard.gather(t.detach())
            if 'tp_shard' in vars(o):
                del o.tp_shard
    return out


def _stage(x, mesh):
    """``x`` on the device the backend moves: the rank's card under NCCL,
    the host under gloo."""
    if mesh.backend == 'nccl':
        return x.to(mesh.device)
    return x.cpu()


def _all_gather(x, mesh, group, size):
    """Every member's ``x`` (equal shapes) of ``group``, concatenated on
    dimension 0 in rank order, on ``x``'s device; ``x`` where the group is
    this rank alone (None)."""
    if group is None:
        return x
    src = _stage(x.contiguous(), mesh)
    out = torch.empty((size * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    if mesh.backend == 'nccl':
        dist.all_gather_into_tensor(out, src, group=group)
    else:
        dist.all_gather(list(out.chunk(size)), src, group=group)
    return out.to(x.device)


def _sum_over(x, mesh, group, size):
    """The elementwise sum of ``x`` over ``group``, added in rank order so
    that every member holds the same bits (an all-gather, then a sum)."""
    if group is None:
        return x
    parts = _all_gather(x.reshape((1,) + tuple(x.shape)), mesh, group, size)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def gather_rows(x, mesh, n=None):
    """Every dp shard's rows of ``x`` (a tensor with equal shapes on every
    rank), concatenated in dp order on ``x``'s device; the first ``n``
    rows when given (dropping a pad)."""
    x = _all_gather(x, mesh, mesh.dp_group, mesh.dp)
    return x if n is None else x[:n]


def gather_columns(xs, mesh, n):
    """Whole-batch tensors from this rank's rows of each of ``xs`` (rows
    first, any trailing shape; float or bool), the first ``n`` rows of the
    ranks' rows in rank order, in one collective: each is flattened to
    columns of their common float type (exact for every input type),
    gathered together, then split and cast back."""
    m = xs[0].shape[0]
    dtype = torch.float32
    for x in xs:
        dtype = torch.promote_types(dtype, x.dtype)
    cols = [x.reshape(m, math.prod(x.shape[1:])).to(dtype) for x in xs]
    full = gather_rows(torch.cat(cols, dim=1), mesh, n)
    out, offset = [], 0
    for x, c in zip(xs, cols):
        width = c.shape[1]
        out.append(full[:, offset:offset + width].reshape(
            (n,) + tuple(x.shape[1:])).to(x.dtype))
        offset += width
    return out


def all_reduce_sum(x, mesh):
    """The elementwise sum of ``x`` over the dp shards, added in dp order
    so that every rank holds the same bits (an all-gather, then a sum)."""
    return _sum_over(x, mesh, mesh.dp_group, mesh.dp)


def broadcast_exact(tree, mesh=None):
    """Rank 0's ``tree`` on every rank, each leaf of every dtype and shape
    (0-d and empty ones included) exact: a pickled broadcast. The other
    ranks' ``tree`` is ignored. Leaves are numpy, Python or CPU tensors.
    Without a process group the tree is returned as it is."""
    group = None if mesh is None else mesh.group
    if group is None and (mesh is not None or not dist.is_initialized()):
        return tree
    backend = dist.get_backend(group)
    device = (torch.device('cuda', torch.cuda.current_device())
              if backend == 'nccl' else None)
    box = [tree if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0, group=group, device=device)
    return box[0]
