"""Nested-sampling command line: the port of ``nnest_tpu``'s
``examples/nested/run.py``.

Example::

    python -m nnest_torch.cli.nested --likelihood rosenbrock --x_dim 2

The flags and their defaults are the JAX script's, plus ``--device``
(``cuda`` unless ``cpu`` is asked for; with no GPU, ``cuda`` raises). The
JAX script's ``--prewarm`` is not offered: it fills XLA's compilation
cache, which PyTorch does not have. The run directory is
``<log_dir>/<likelihood><log_suffix>/runN`` (``--resume`` pins it and
continues from its newest checkpoint).
"""

from __future__ import annotations

import argparse
import datetime
import time

import numpy as np

# likelihood name -> (zoo class, the factor of the unit cube's transform)
_LIKELIHOODS = {
    'himmelblau': ('Himmelblau', 5.0),
    'rosenbrock': ('Rosenbrock', 5.0),
    'gaussian': ('Gaussian', 3.0),
    'eggbox': ('Eggbox', 5.0 * np.pi),
    'shell': ('GaussianShell', 5.0),
    'mixture': ('GaussianMix', 10.0),
}

# the options a programmatic caller may leave out of its Namespace
_OPTIONAL = {'mcmc_gen_batch': 8, 'mcmc_speculate': False,
             'rejection_gen_batch': 8, 'slice_adapt': 'cov',
             'mcmc_adapt': 'cov', 'show_progress': False, 'device': 'cuda'}


def make_likelihood(name, x_dim, corr):
    """(likelihood, transform of the unit cube) of the zoo's ``name``."""
    from nnest_torch import likelihoods
    key = name.lower()
    if key not in _LIKELIHOODS:
        raise ValueError('Likelihood not found')
    cls_name, factor = _LIKELIHOODS[key]
    cls = getattr(likelihoods, cls_name)
    if key == 'gaussian':
        like = cls(x_dim, corr, lim=3)
    else:
        like = cls(x_dim)
    return like, lambda x: factor * x


def main(args):
    """Run the nested sampler as the flags in ``args`` say; returns the
    sampler."""
    import os

    from nnest_torch import NestedSampler
    from nnest_torch.distributions import GeneralisedNormal

    for k, v in _OPTIONAL.items():
        if not hasattr(args, k):
            setattr(args, k, v)
    base_dist = (GeneralisedNormal(dim=args.x_dim, beta=args.beta)
                 if args.base_dist == 'gen_normal' else None)
    like, transform = make_likelihood(args.likelihood, args.x_dim, args.corr)
    log_dir = os.path.join(args.log_dir, args.likelihood) + args.log_suffix

    sampler = NestedSampler(
        like.x_dim, like, transform=transform, log_dir=log_dir,
        num_live_points=args.num_live_points, hidden_dim=args.hidden_dim,
        num_layers=args.num_layers, num_blocks=args.num_blocks,
        num_slow=args.num_slow, base_dist=base_dist, scale=args.scale,
        flow=args.flow, seed=args.seed, append_run_num=not args.resume,
        resume=args.resume, device=args.device)
    start = time.time()
    sampler.run(train_iters=args.train_iters, mcmc_steps=args.mcmc_steps,
                max_iters=args.max_iters, volume_switch=args.switch,
                jitter=args.jitter, mcmc_num_chains=args.mcmc_num_chains,
                mcmc_dynamic_step_size=not args.mcmc_fixed_step_size,
                strategy=args.strategy.split(',') if args.strategy else None,
                dlogz=args.dlogz,
                rejection_batch_size=args.rejection_batch_size,
                mcmc_gen_batch=args.mcmc_gen_batch,
                mcmc_speculate=args.mcmc_speculate,
                slice_adapt=args.slice_adapt, mcmc_adapt=args.mcmc_adapt,
                rejection_gen_batch=args.rejection_gen_batch,
                show_progress=args.show_progress)
    print('Run time %s' % datetime.timedelta(seconds=time.time() - start))
    print('logz %.3f +/- %.3f (ncall %d)' % (
        sampler.logz, sampler.logzerr, sampler.total_calls))
    return sampler


def build_parser():
    parser = argparse.ArgumentParser(
        description='Neural nested sampling with nnest_torch.')
    parser.add_argument('--x_dim', type=int, default=2)
    parser.add_argument('--train_iters', type=int, default=2000)
    parser.add_argument('--mcmc_steps', type=int, default=0)
    parser.add_argument('--mcmc_num_chains', type=int, default=10)
    parser.add_argument('--num_live_points', type=int, default=1000)
    parser.add_argument('-mcmc_fixed_step_size', action='store_true')
    parser.add_argument('--switch', type=float, default=-1)
    parser.add_argument('--hidden_dim', type=int, default=0,
                        help='0 = auto (16 below 16-D, 32 below 32-D, '
                             '64 above)')
    parser.add_argument('--num_layers', type=int, default=1)
    parser.add_argument('--flow', type=str, default='spline')
    parser.add_argument('--num_blocks', type=int, default=3)
    parser.add_argument('--jitter', type=float, default=-1)
    parser.add_argument('--num_slow', type=int, default=0)
    parser.add_argument('--log_dir', type=str, default='logs')
    parser.add_argument('--likelihood', type=str, default='rosenbrock')
    parser.add_argument('--log_suffix', type=str, default='')
    parser.add_argument('--base_dist', type=str, default='')
    parser.add_argument('--scale', type=str, default='')
    parser.add_argument('--beta', type=float, default=8.0)
    parser.add_argument('--corr', type=float, default=0.99)
    parser.add_argument('--strategy', type=str, default='')
    parser.add_argument('--dlogz', type=float, default=0.5)
    parser.add_argument('--rejection_batch_size', type=int, default=512)
    parser.add_argument('--mcmc_gen_batch', type=int, default=8,
                        help='accepted for nnest_tpu parity; this port '
                             'dispatches one generation at a time (the '
                             'results do not depend on it)')
    parser.add_argument('--mcmc_speculate', action='store_true',
                        help='accepted for nnest_tpu parity; no effect '
                             'here')
    parser.add_argument('--rejection_gen_batch', type=int, default=8,
                        help='as --mcmc_gen_batch')
    parser.add_argument('--slice_adapt', choices=('cov', 'iso'),
                        default='cov',
                        help='slice direction law: live-set latent '
                             'covariance (default) or isotropic')
    parser.add_argument('--mcmc_adapt', choices=('cov', 'iso'),
                        default='cov',
                        help='Metropolis proposal law: covariance-'
                             'preconditioned (default) or isotropic')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--resume', action='store_true',
                        help='fixed run dir + bit-exact resume from its '
                             'newest checkpoint')
    parser.add_argument('--show_progress', action='store_true',
                        help='tqdm progress bar on the nested iteration '
                             'loop')
    parser.add_argument('--max_iters', type=int, default=1000000,
                        help='stop after N iterations (checkpointed; '
                             're-run with --resume to continue exactly)')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default) or 'cpu'")
    return parser


if __name__ == '__main__':
    main(build_parser().parse_args())
