"""Data-parallel mesh over ``torch.distributed`` ranks.

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

A sharding is the rows of a batch a rank holds: :func:`batch_sharding` the
rank's slice of a batch padded to a multiple of dp by repeating row 0,
:func:`replicated` all of them. Tensor parallelism (``tp > 1``) is not
ported (ROADMAP.md).
"""

from __future__ import annotations

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
    rank's compute device, where an NCCL collective's payload lives."""

    def __init__(self, dp, tp, group, backend, device, rank):
        self.dp, self.tp = int(dp), int(tp)
        self.group, self.backend = group, backend
        self.device, self.rank = torch.device(device), int(rank)


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
    """The (dp, tp) mesh of the default process group, all ranks on dp;
    with no process group a one-rank mesh, whose results equal
    ``mesh=None``'s. ``tp > 1`` raises: tensor parallelism is not ported."""
    if tp != 1:
        raise NotImplementedError(
            'tensor parallelism (tp > 1) is not ported to nnest_torch; it is '
            'the next item of ROADMAP.md section A')
    if not dist.is_initialized():
        if dp not in (None, 1):
            raise ValueError('dp=%r needs a process group; call '
                             'initialize_distributed first' % (dp,))
        return Mesh(1, 1, None, None, 'cpu', 0)
    world = dist.get_world_size()
    if dp is None:
        dp = world
    if dp * tp != world:
        raise ValueError('dp * tp = %d must equal the world size %d'
                         % (dp * tp, world))
    backend = dist.get_backend()
    device = _DEVICE
    if device is None:
        device = (torch.device('cuda', torch.cuda.current_device())
                  if backend == 'nccl' else torch.device('cpu'))
    return Mesh(dp, tp, dist.group.WORLD, backend, device, dist.get_rank())


def batch_sharding(mesh, n):
    """The rows this rank holds of an ``n``-row batch padded to a multiple
    of dp: (a slice of the padded batch, the pad)."""
    pad = (-n) % mesh.dp
    m = (n + pad) // mesh.dp
    return slice(mesh.rank * m, (mesh.rank + 1) * m), pad


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


def params_sharding_tree(params, mesh):
    """The sharding of each leaf of ``params`` (a dict of tensors, a
    ``state_dict`` or a pytree of dicts): under dp every leaf is
    replicated."""
    if isinstance(params, dict):
        return {k: params_sharding_tree(v, mesh) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_sharding_tree(v, mesh) for v in params)
    return replicated(mesh)


def shard_params(params, mesh):
    """``params`` laid out by :func:`params_sharding_tree`: replicated,
    so every rank keeps all of it (lockstep ranks hold equal copies)."""
    del mesh
    return params


def _stage(x, mesh):
    """``x`` on the device the backend moves: the rank's card under NCCL,
    the host under gloo."""
    if mesh.backend == 'nccl':
        return x.to(mesh.device)
    return x.cpu()


def gather_rows(x, mesh, n=None):
    """Every rank's rows of ``x`` (a tensor with equal shapes on every
    rank), concatenated in rank order on ``x``'s device; the first ``n``
    rows when given (dropping a pad)."""
    if mesh.group is not None:
        src = _stage(x.contiguous(), mesh)
        out = torch.empty((mesh.dp * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        if mesh.backend == 'nccl':
            dist.all_gather_into_tensor(out, src, group=mesh.group)
        else:
            dist.all_gather(list(out.chunk(mesh.dp)), src, group=mesh.group)
        x = out.to(x.device)
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
    """The elementwise sum of ``x`` over ranks, added in rank order so that
    every rank holds the same bits (an all-gather, then a sum)."""
    if mesh.group is None:
        return x
    parts = gather_rows(x.reshape((1,) + tuple(x.shape)), mesh)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


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
