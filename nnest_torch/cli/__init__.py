"""Command-line drivers of ``nnest_torch``, ports of ``nnest_tpu``'s
example scripts: ``python -m nnest_torch.cli.nested`` (nested sampling),
``python -m nnest_torch.cli.analyse`` (aggregate run directories) and
``python -m nnest_torch.cli.ensemble`` (MCMC or ensemble posterior
sampling). Each module's ``main(args)`` takes an ``argparse.Namespace``
and its ``build_parser()`` gives the flags."""
