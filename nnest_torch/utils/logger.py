"""Logging + run-directory factory.

A copy of ``nnest_tpu/utils/logger.py`` (the port imports nothing from the
JAX package): ``<log_dir>/runN/{info,results,chains,checkpoint,plots,
models,data}``, reused when ``info/`` already exists.
"""

from __future__ import annotations

import logging
import os
import sys


def create_logger(module_name: str, level=logging.INFO):
    logger = logging.getLogger(module_name)
    if logger.hasHandlers():
        logger.handlers.clear()
    logger.setLevel(level)
    handler = logging.StreamHandler(sys.stdout)
    handler.setLevel(level)
    handler.setFormatter(
        logging.Formatter('[{}] [%(levelname)s] %(message)s'.format(module_name)))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


def get_or_create_run_dir(run_dir: str, append_run_num: bool = True):
    """Create (or reuse) a numbered run directory with the standard artifact
    subdirectories."""
    if os.path.isdir(os.path.join(run_dir, 'info')):
        created = False
    else:
        created = True
        os.makedirs(run_dir, exist_ok=True)
        if append_run_num:
            run_num = sum(
                os.path.isdir(os.path.join(run_dir, i))
                for i in os.listdir(run_dir)) + 1
            run_dir = os.path.join(run_dir, 'run%s' % run_num)
        os.makedirs(run_dir, exist_ok=True)
        for sub in ('info', 'results', 'chains', 'checkpoint', 'plots',
                    'models', 'data'):
            os.makedirs(os.path.join(run_dir, sub), exist_ok=True)

    return {
        'run_dir': run_dir,
        'info': os.path.join(run_dir, 'info'),
        'results': os.path.join(run_dir, 'results'),
        'chains': os.path.join(run_dir, 'chains'),
        'checkpoint': os.path.join(run_dir, 'checkpoint'),
        'plots': os.path.join(run_dir, 'plots'),
        'created': created,
    }
