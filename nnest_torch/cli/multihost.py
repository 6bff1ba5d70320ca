"""Multi-process nested sampling: the port of ``nnest_tpu``'s
``examples/distributed/run_multihost.py``.

One process a rank, the same command everywhere. Under ``torchrun``::

    torchrun --nproc_per_node 2 -m nnest_torch.cli.multihost --x_dim 10

or with the rank given by hand, one command a rank::

    python -m nnest_torch.cli.multihost --coordinator host0:8476 \\
        --num_processes 2 --process_id 0 --x_dim 10

A hand launch takes each process for the only rank on its host
(``--local_rank 0 --local_world_size 1``, the multi-host case); ranks
that share a host say so, e.g. ``--local_rank 1 --local_world_size 2``.
The flags are the JAX script's plus ``--device`` (``cuda`` unless ``cpu``
is asked for) and those two. Each rank computes on ``cuda:LOCAL_RANK``,
or on the one card when ranks outnumber cards; the backend is NCCL when
every rank of a host has a card of its own and gloo otherwise
(``nnest_torch.parallel.mesh``). With
``--num_processes 1`` and no ``torchrun`` environment there is no process
group and the run is a one-process run. Rank 0 writes the run directory
and prints the evidence.
"""

from __future__ import annotations

import argparse
import os


def main(args):
    """Join the process group as the flags or the ``torchrun`` environment
    say, then run the nested sampler on the mesh; returns the sampler."""
    from nnest_torch.parallel import get_mesh, initialize_distributed

    torchrun = 'RANK' in os.environ and 'WORLD_SIZE' in os.environ
    if torchrun or args.num_processes > 1:
        host, port = args.coordinator.rsplit(':', 1)
        kw = {} if torchrun else dict(
            init_method='tcp://%s:%s' % (host, port),
            world_size=args.num_processes, rank=args.process_id,
            local_rank=args.local_rank,
            local_world_size=args.local_world_size)
        backend = initialize_distributed(device=args.device, **kw)
    else:
        backend = None

    import torch
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    device = torch.device(args.device)
    if device.type == 'cuda' and device.index is None and \
            torch.cuda.is_available():
        # the card initialize_distributed chose for this rank
        device = torch.device('cuda', torch.cuda.current_device())
    print('process %d/%d: backend %s, device %s' % (rank, world, backend,
                                                    device), flush=True)

    from nnest_torch import NestedSampler
    from nnest_torch.likelihoods import Gaussian

    mesh = get_mesh()   # all ranks on the dp axis
    like = Gaussian(args.x_dim, 0.0, lim=3)
    sampler = NestedSampler(
        args.x_dim, like, transform=lambda x: 3 * x,
        num_live_points=args.num_live_points, flow='spline',
        log_dir=args.log_dir, mesh=mesh, seed=args.seed, device=device)
    sampler.run(mcmc_num_chains=args.mcmc_num_chains, dlogz=args.dlogz)
    if sampler.single_or_primary_process:
        print('logz %.3f +- %.3f (ncall %d)' % (
            sampler.logz, sampler.logzerr, sampler.total_calls), flush=True)
    return sampler


def build_parser():
    p = argparse.ArgumentParser(
        description='Multi-process nested sampling with nnest_torch.')
    p.add_argument('--coordinator', type=str, default='localhost:8476',
                   help='host:port of rank 0 (ignored under torchrun)')
    p.add_argument('--num_processes', type=int, default=1)
    p.add_argument('--process_id', type=int, default=0)
    p.add_argument('--local_rank', type=int, default=0,
                   help='this rank among the ranks of its host (hand '
                        'launch; torchrun sets LOCAL_RANK)')
    p.add_argument('--local_world_size', type=int, default=1,
                   help='the ranks on this host (hand launch; torchrun '
                        'sets LOCAL_WORLD_SIZE)')
    p.add_argument('--x_dim', type=int, default=10)
    p.add_argument('--num_live_points', type=int, default=1000)
    p.add_argument('--mcmc_num_chains', type=int, default=256)
    p.add_argument('--dlogz', type=float, default=0.5)
    p.add_argument('--log_dir', type=str, default='logs/multihost')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p


if __name__ == '__main__':
    main(build_parser().parse_args())
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
