"""MCMC and ensemble command line: the port of ``nnest_tpu``'s
``examples/ensemble/run.py``.

Example::

    python -m nnest_torch.cli.ensemble --sampler ensemble --x_dim 2

``--sampler mcmc`` trains on ``--num_training_samples`` rejection draws of
the likelihood under its box prior and runs ``--mcmc_num_chains`` chains;
``--sampler ensemble`` bootstraps the training set with
``--bootstrap_steps`` steps of ``--num_walkers`` walkers, then runs the
latent ensemble. The flags and defaults are the JAX script's, plus
``--device`` (``cuda`` unless ``cpu`` is asked for).
"""

from __future__ import annotations

import argparse

# likelihood name -> (zoo class, the box prior's bounds)
_PRIORS = {
    'himmelblau': ('Himmelblau', -5, 5),
    'rosenbrock': ('Rosenbrock', -2, 5),
    'gaussian': ('Gaussian', -5, 5),
    'eggbox': ('Eggbox', -15, 15),
    'shell': ('GaussianShell', -3, 3),
    'mixture': ('GaussianMix', -8, 8),
}


def main(args):
    """Run the sampler as the flags in ``args`` say; returns it."""
    import os

    from nnest_torch import EnsembleSampler, MCMCSampler
    from nnest_torch import likelihoods
    from nnest_torch.priors import UniformPrior

    if not hasattr(args, 'device'):
        args.device = 'cuda'
    name = args.likelihood.lower()
    if name not in _PRIORS:
        raise ValueError('Likelihood not found')
    cls_name, lo, hi = _PRIORS[name]
    cls = getattr(likelihoods, cls_name)
    like = (cls(args.x_dim, args.corr) if name == 'gaussian'
            else cls(args.x_dim))
    prior = UniformPrior(args.x_dim, lo, hi)
    log_dir = os.path.join(args.log_dir, args.likelihood) + args.log_suffix

    cls = EnsembleSampler if args.sampler == 'ensemble' else MCMCSampler
    sampler = cls(like.x_dim, like, prior=prior, log_dir=log_dir,
                  hidden_dim=args.hidden_dim, num_layers=args.num_layers,
                  num_blocks=args.num_blocks, num_slow=args.num_slow,
                  flow=args.flow, seed=args.seed, device=args.device)
    if args.sampler == 'ensemble':
        training = sampler.bootstrap(args.bootstrap_steps, args.num_walkers,
                                     iters=args.bootstrap_iters)
        sampler.run(args.mcmc_steps, args.num_walkers, training)
    else:
        training = like.sample(prior, args.num_training_samples)
        sampler.run(args.mcmc_steps, args.mcmc_num_chains, training)
    print('ncall %d' % sampler.total_calls)
    return sampler


def build_parser():
    parser = argparse.ArgumentParser(
        description='Flow-guided MCMC or ensemble sampling with '
                    'nnest_torch.')
    parser.add_argument('--sampler', type=str, default='mcmc',
                        choices=['mcmc', 'ensemble'])
    parser.add_argument('--x_dim', type=int, default=2)
    parser.add_argument('--mcmc_steps', type=int, default=10000)
    parser.add_argument('--mcmc_num_chains', type=int, default=16)
    parser.add_argument('--num_walkers', type=int, default=64)
    parser.add_argument('--bootstrap_steps', type=int, default=500)
    parser.add_argument('--bootstrap_iters', type=int, default=1)
    parser.add_argument('--num_training_samples', type=int, default=1000)
    parser.add_argument('--hidden_dim', type=int, default=0,
                        help='0 = auto-scaled with x_dim')
    parser.add_argument('--num_layers', type=int, default=1)
    parser.add_argument('--flow', type=str, default='spline')
    parser.add_argument('--num_blocks', type=int, default=3)
    parser.add_argument('--num_slow', type=int, default=0)
    parser.add_argument('--log_dir', type=str, default='logs')
    parser.add_argument('--likelihood', type=str, default='rosenbrock')
    parser.add_argument('--log_suffix', type=str, default='')
    parser.add_argument('--corr', type=float, default=0.99)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default) or 'cpu'")
    return parser


if __name__ == '__main__':
    main(build_parser().parse_args())
