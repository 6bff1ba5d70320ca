"""The ``gauss50nvp`` configuration's files: the ``nvp`` flow reference, the
``band_r8.7_nvp`` band, the ``gauss50nvp.deep`` cell and the reader of
``nvp_inverse_roofline``.

- The cell is found by name, with its configuration, band, limits and
  metrics.
- A tiny copy of the cell (the same kind, flow and band at d 5) runs on the
  CPU and comes out correct; with the hot inverse's x +0.01, or a chain
  endpoint's logl +0.05, not correct.
- The reader returns None where the kernel never launched, or launched
  other than once a traced call.
- The reference counts the inverse's operations and bytes as a hand count
  does, and refuses a configuration that is not its flow's."""

import pytest
import torch

from harness import cells, costs
from harness.bench import run_cell

torch.set_num_threads(1)

CELL = 'gauss50nvp.deep'


def _config():
    return cells.config(cells.benchmark(), 'gauss50nvp')


def test_the_cell_is_discovered_with_its_files():
    bench = cells.benchmark()
    cell = cells.cell(bench, CELL)
    assert (cell['config'], cell['traffic'], cell['chips']) == (
        'gauss50nvp', 'band_r8.7_nvp', 1)
    config = cells.config(bench, cell['config'])
    assert cells.flow_args(config) == {'flow': 'nvp', 'num_blocks': 3,
                                       'num_layers': 1, 'scale': ''}
    assert cells.flow_reference(config).__name__ == 'reference.flows.nvp'
    # gauss50's likelihood, width and run
    gauss50 = cells.config(bench, 'gauss50')
    for key in ('likelihood', 'num_live_points', 'hidden_dim', 'run',
                'reduced'):
        assert config[key] == gauss50[key]
    # band_r8.7 but for the launches it requires
    band = cells.traffic(cell['traffic'])
    assert band['require_launches'] == ['consume_pool']
    spline_band = cells.traffic('band_r8.7')
    for key in spline_band:
        if key not in ('name', 'why', 'require_launches'):
            assert band[key] == spline_band[key], key
    assert [m['name'] for m in cells.metrics_for(bench['end_to_end'],
                                                 CELL)] == [
        'dead_points_per_s', 'setup_s']
    assert [m['name'] for m in cells.metrics_for(bench['per_layer'],
                                                 CELL)] == [
        'evidence_loop_share', 'consume_pool_roofline', 'device_idle_share',
        'mfu', 'fused_train_step_share', 'side_calls_per_dead_point',
        'nvp_inverse_roofline']
    limits = cells.limits(CELL)
    assert sorted(limits['limits']) == sorted([
        'logl_gap', 'logz_gap', 'h_gap', 'inverse_x_gap',
        'inverse_logdet_gap'])


# ------------------------------------------- the cell's files, tiny, CPU

def _tiny_config():
    config = dict(_config(), hidden_dim=8)
    config['likelihood'] = dict(config['likelihood'], x_dim=5)
    config['num_live_points'] = 100
    config['run'] = dict(config['run'], mcmc_steps=20, mcmc_num_chains=16,
                         train_iters=30, update_interval=50)
    return config


TINY_LIMITS = {'limits': {'logl_gap': 1e-3, 'logz_gap': 1e-3, 'h_gap': 1e-3,
                          'inverse_x_gap': 1e-3,
                          'inverse_logdet_gap': 1e-3},
               'not_compared': {}}


def _inverse_shifted(monkeypatch):
    """The NVP inverse's x altered where it is produced."""
    from nnest_torch.ops import nvp_inverse as nv
    real = nv.nvp_inverse_twin

    def shifted(z, packed):
        x, logdet = real(z, packed)
        return x + 1e-2, logdet
    monkeypatch.setattr(nv, 'nvp_inverse_twin', shifted)


def _logl_raised(monkeypatch):
    """A chain endpoint's likelihood altered where it is produced."""
    from nnest_torch.samplers.kernels import LatentKernels
    real = LatentKernels.mcmc

    def mcmc(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        if 'final_logl' in out:
            out['final_logl'] = out['final_logl'] + 0.05
        return out
    monkeypatch.setattr(LatentKernels, 'mcmc', mcmc)


@pytest.mark.parametrize('fault,failing', [
    (None, None), (_inverse_shifted, 'inverse_x_gap'),
    (_logl_raised, 'logl_gap')])
def test_a_tiny_copy_of_the_cell_runs_on_the_cpu(monkeypatch, fault,
                                                 failing):
    from nnest_torch.utils import profiling
    if fault is not None:
        fault(monkeypatch)
    band = dict(cells.traffic('band_r8.7_nvp'), radius=3.0, max_iters=150,
                warmup_iters=10, inverse_sample_stride=7)
    with profiling.recording() as rec:
        result = run_cell(CELL, _tiny_config(), band, TINY_LIMITS,
                          2 ** 31 + 23, 0.0, False, [], [], device='cpu')
    checks = result['checks']
    if fault is None:
        assert result['correct'] and not result['failed'], checks
        # the NVP path ran and its sampled calls met the reference
        assert rec.counters['hot_inverse'] == {
            'nvp': rec.counters['hot_inverse']['nvp']}
        assert checks['missing_samples']['value'] == 0
        assert 0 < checks['inverse_x_gap']['value'] < 1e-5
    else:
        assert not result['correct']
        assert checks[failing]['value'] > checks[failing]['limit'], checks


# ------------------------------------------------------------ the reader

def test_the_reader_reads_only_one_launch_a_traced_call():
    read = cells.reader('nvp_inverse_roofline')
    flow = cells.flow_reference(_config())
    rows = [256] * 10
    summary = {'ops': {'(anonymous namespace)::nvp_inverse_kernel(...)':
                       (10, 1e-4),
                       'void spline_inverse_kernel<8, 16>(...)': (3, 1.0)}}
    ctx = {'config': _config(), 'costs': costs, 'trace': summary,
           'traced_inverse_rows': rows}
    want = 100.0 * sum(costs.bound_s(*flow.inverse_cost(256, 50, 16, 3))[0]
                       for _ in rows) / 1e-4
    assert read(ctx) == pytest.approx(want)
    # the plain path: the kernel never launched
    assert read(dict(ctx, trace={'ops': {'void gemv(...)': (820, 1e-2)}})) \
        is None
    # launches other than once a traced call
    assert read(dict(ctx, traced_inverse_rows=rows * 2)) is None
    assert read(dict(ctx, trace=None)) is None


# --------------------------------------------------------- the reference

def test_the_reference_counts_as_a_hand_count():
    flow = cells.flow_reference(_config())
    # d 2, hidden 1, one coupling, one row: z m 2; each net 18 (three
    # layers' multiply-adds 4 + 2 + 4, biases 1 + 1 + 2, ReLU or tanh
    # 1 + 1, the product by 1 - m 2); z - t, -log_s, its exp and the
    # product 8, the logdet's sum 2 and its add 1; 1 - m once a call 2.
    # Bytes: z 2, the mask 2, each net 2 + 1 + 1 + 1 + 2 + 2, x 2 and
    # logdet 1 floats.
    assert flow.inverse_cost(1, 2, 1, 1) == (2 + 36 + 11 + 2, 4 * 25)
    # translation-only: one net, z - t, no logdet sum; a scale layer's
    # product and add a row, its e^-s and -d s 3 once a call
    assert flow.inverse_cost(1, 2, 1, 1, nets=1, scale=True) == (
        2 + 18 + 2 + 1 + 3 + 2 + 3, 4 * (2 + 2 + 9 + 1 + 3))
    config = _config()
    assert flow.shape(config) == (50, 16, 3, 2, False)
    one = flow.inverse_cost(256, 50, 16, 3)[0]
    assert flow.inverse_ops(config, 256, 1) == one
    # two calls of 256 rows: each call's own part twice
    assert flow.inverse_ops(config, 512, 2) == 2 * one
    assert flow.inverse_ops(config, 0, 0) == 0
    with pytest.raises(ValueError):
        flow.forward_ops(cells.config(cells.benchmark(), 'gauss50'))
