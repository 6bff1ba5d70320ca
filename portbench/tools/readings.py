"""The numbers a cell compares, on many seeds in one process: each seed
one run of the cell at its own sizes with a one-job window, its readings
printed as one JSON line. ``--control tf32`` runs the control instead
(TF32 matmuls, the flow's plain inverse in float32 in the hot
inverse's place), which has to read above the limits.

    python3 portbench/tools/readings.py --workload gauss16.deep \
        --seeds 101 102 103 [--control tf32]

The limits in ``limits/<cell>.json`` are set from these readings: above
the largest a sound run gives, below the smallest the control gives."""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import cells  # noqa: E402
from harness.bench import run_cell  # noqa: E402


def readings(workload, seed, control=None, device='cuda', seconds=0.0):
    bench = cells.benchmark()
    cell = cells.cell(bench, workload)
    result = run_cell(
        workload, cells.config(bench, cell['config']),
        cells.traffic(cell['traffic']), cells.limits(workload), seed,
        seconds, False, cells.metrics_for(bench['end_to_end'], workload),
        [], device=device, control=control)
    return {'workload': workload, 'seed': seed, 'control': control,
            'correct': result['correct'], 'attempted': result['attempted'],
            'failed': result['failed'],
            'values': {k: v['value'] for k, v in result['checks'].items()}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--control', choices=('tf32',), default=None)
    p.add_argument('--seconds', type=float, default=0.0)
    args = p.parse_args(argv)
    for seed in args.seeds:
        print('READING ' + json.dumps(readings(args.workload, seed,
                                               args.control,
                                               seconds=args.seconds)),
              flush=True)


if __name__ == '__main__':
    main()
