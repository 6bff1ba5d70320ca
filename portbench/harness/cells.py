"""Discovery by name: the cell in ``BENCHMARK.json``, its configuration
file, its traffic band (``traffic/<name>.json``), its limits
(``limits/<cell>.json``), one reader a per-layer metric
(``metrics/<metric>.py``, a function ``read(ctx)``), the configuration's
likelihood kind (``harness/likelihoods/<kind>.py``) and its float64
reference (``reference/likelihoods/<kind>.py``), and its flow's keywords
and reference (``reference/flows/<name>.py``). A later change adds a cell,
a band, a metric, a kind or a flow reference as files of their own and
edits none of these."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

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


# The flow keywords of a configuration without ``flow_args``: the defaults
# of both ``NestedSampler`` and ``Trainer``.
FLOW_ARGS = {'flow': 'spline', 'num_blocks': 3, 'num_layers': 1}
MODULE_NAME = re.compile(r'[A-Za-z_][A-Za-z0-9_]*')


def _module(package, name):
    if not MODULE_NAME.fullmatch(name):
        raise ValueError('%r is not a module name' % name)
    return importlib.import_module('%s.%s' % (package, name))


def kind(name):
    """The likelihood kind ``harness/likelihoods/<name>.py``."""
    return _module('harness.likelihoods', name)


def reference_kind(name):
    """The kind's float64 reference ``reference/likelihoods/<name>.py``."""
    return _module('reference.likelihoods', name)


def flow_args(config):
    """The flow keywords given alike to the shared ``Trainer`` and to every
    job's ``NestedSampler``: ``FLOW_ARGS`` updated by ``flow_args``."""
    return dict(FLOW_ARGS, **config.get('flow_args', {}))


def flow_reference(config):
    """The flow reference ``reference/flows/<name>.py`` that the
    configuration's ``flow_reference`` names (``spline`` without it)."""
    return _module('reference.flows', config.get('flow_reference', 'spline'))
