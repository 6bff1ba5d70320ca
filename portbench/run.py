"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic band, its limits and its
per-layer metrics' readers are found by name (``harness/cells.py``). The
run needs a CUDA card (``nvidia`` H100) and the port ``nnest_torch`` beside
this folder; it imports nothing of JAX or of the JAX package, and checks
so at its start and once its window has closed. The last line of standard
output is the result, one JSON object; the numbers compared, each with
its limit, are the last lines of standard error."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host's thread pools stay single, so
# runs on a shared host spread less
for _var in ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS', 'MKL_NUM_THREADS'):
    os.environ[_var] = '1'

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

from harness import cells, guard  # noqa: E402


def set_cache_dirs(root=ROOT):
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(root, '.cache', 'portbench')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache,
                                                      'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def print_result(result):
    for name, c in result['checks'].items():
        print('check %s %r limit %r' % (name, c['value'], c['limit']),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None):
    args = parse(argv)
    found = guard.forbidden_modules()
    if found:
        print('forbidden modules loaded: %s' % found, file=sys.stderr)
        return 4
    bench = cells.benchmark()
    cell = cells.cell(bench, args.workload)
    config = cells.config(bench, cell['config'])
    traffic = cells.traffic(cell['traffic'])
    limits = cells.limits(cell['name'])
    set_cache_dirs()
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell['chips']):
        print('this cell needs %d CUDA card(s); found %s' % (
            cell['chips'], torch.cuda.device_count()
            if torch.cuda.is_available() else 'none'), file=sys.stderr)
        return 3
    from harness.bench import run_cell
    result = run_cell(
        cell['name'], config, traffic, limits, args.seed, args.seconds,
        bool(args.trace), cells.metrics_for(bench['end_to_end'], cell['name']),
        cells.metrics_for(bench['per_layer'], cell['name']),
        t_start=T_START)
    print_result(result)
    return 0


if __name__ == '__main__':
    sys.exit(main())
