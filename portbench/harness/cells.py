"""Discovery by name: the cell in ``BENCHMARK.json``, its configuration
file, its traffic band (``traffic/<name>.json``), its limits
(``limits/<cell>.json``) and one reader a per-layer metric
(``metrics/<metric>.py``, a function ``read(ctx)``). A later change adds a
cell, a band or a metric as files of their own and edits none of these."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, 'BENCHMARK.json'))


def _named(entries, name, what):
    for e in entries:
        if e['name'] == name:
            return e
    raise KeyError('no %s named %r in BENCHMARK.json' % (what, name))


def cell(bench, name):
    return _named(bench['workloads'], name, 'workload')


def config(bench, name, root=ROOT):
    entry = _named(bench['configs'], name, 'config')
    return load_json(os.path.join(root, entry['file']))


def traffic(name, here=HERE):
    return load_json(os.path.join(here, 'traffic', name + '.json'))


def limits(workload, here=HERE):
    """The cell's limits file: ``limits`` ({} before they were measured)
    and ``not_compared`` (numbers shown with no limit, each with why)."""
    path = os.path.join(here, 'limits', workload + '.json')
    doc = load_json(path) if os.path.exists(path) else {}
    return {'limits': doc.get('limits', {}),
            'not_compared': doc.get('not_compared', {})}


def metrics_for(entries, workload):
    """The metrics of ``entries`` that this cell reports."""
    return [m for m in entries
            if 'workloads' not in m or workload in m['workloads']]


def reader(metric, here=HERE):
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    path = os.path.join(here, 'metrics', metric + '.py')
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + metric.replace('.', '_').replace('-', '_'),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
