"""A cell, a band, a configuration, a limit file and a metric added as
files of their own are found by name, and nothing else needs editing."""

import json

from harness import cells


def test_discovery_of_files_added_later(tmp_path):
    root = tmp_path
    here = root / 'portbench'
    for sub in ('configs', 'traffic', 'limits', 'metrics'):
        (here / sub).mkdir(parents=True)
    bench = {
        'configs': [{'name': 'mix10', 'file': 'portbench/configs/mix10.json'}],
        'workloads': [{'name': 'mix10.deep', 'config': 'mix10',
                       'traffic': 'band_new', 'chips': 1}],
        'end_to_end': [{'name': 'dead_points_per_s'}],
        'per_layer': [{'name': 'new_share', 'unit': '%'},
                      {'name': 'other', 'unit': 'ms',
                       'workloads': ['gauss16.deep']}]}
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    (here / 'configs' / 'mix10.json').write_text('{"num_live_points": 7}')
    (here / 'traffic' / 'band_new.json').write_text('{"max_iters": 9}')
    (here / 'limits' / 'mix10.deep.json').write_text(
        '{"limits": {"logl_gap": 0.5}}')
    (here / 'metrics' / 'new_share.py').write_text(
        'def read(ctx):\n    return ctx["x"] * 2\n')
    b = cells.benchmark(str(root))
    cell = cells.cell(b, 'mix10.deep')
    assert cells.config(b, cell['config'], str(root)) == {
        'num_live_points': 7}
    assert cells.traffic(cell['traffic'], str(here)) == {'max_iters': 9}
    assert cells.limits('mix10.deep', str(here)) == {
        'limits': {'logl_gap': 0.5}, 'not_compared': {}}
    assert cells.limits('nothing.yet', str(here)) == {'limits': {},
                                                      'not_compared': {}}
    layer = cells.metrics_for(b['per_layer'], 'mix10.deep')
    assert [m['name'] for m in layer] == ['new_share']
    assert cells.reader('new_share', str(here))({'x': 21}) == 42


def test_the_benchmark_names_a_file_for_everything():
    b = cells.benchmark()
    for w in b['workloads']:
        cell = cells.cell(b, w['name'])
        assert cells.config(b, cell['config'])['num_live_points'] > 0
        assert cells.traffic(cell['traffic'])['max_iters'] > 0
    for m in b['per_layer']:
        assert callable(cells.reader(m['name']))
