"""The ``mog30fs`` configuration's files: the ``mixture`` kind, its
``level`` start, the ``fastslow_spline`` flow reference and the
``mog30fs.deep`` cell.

- The ``level`` start is uniform within {logL > floor} and the box: its
  slow pairs' distribution over a grid of the plane against 2-D quadrature
  of the fast ball's volume, and each point's fast radius over the ball's
  (r / rho)^(d - 2) against the uniform law.
- The kind's float32 likelihood matches its float64 reference and the
  port's own ``GaussianMix``.
- The flow reference matches the port's fast-slow flow and counts its
  operations as the spline reference counts each chain's.
- The cell is found by name, with its band, limits and metrics, and its
  kind refuses at set-up a program whose hot inverse of the flow takes
  neither the spline kernel nor its twin.
- The cell's files, at a tiny size in a copy of ``portbench/``, run on
  the CPU and come out correct, and not correct with the hot inverse's x
  +0.01."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import stats
from scipy.special import gammaln, logsumexp

from harness import cells, costs

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CELL = 'mog30fs.deep'


def _config():
    return cells.config(cells.benchmark(), 'mog30fs')


def _slow_rho2(lk, floor, xs):
    """rho(x_s)^2 of the fast ball at slow pairs ``xs``, from the float64
    reference."""
    ref = cells.reference_kind('mixture').mixture(lk)
    return 2 * lk['sigma'] ** 2 * (ref.log_norm - floor + ref.slow_part(xs))


def test_the_level_start_is_uniform_within_the_contour_and_the_box():
    config = _config()
    lk = config['likelihood']
    floor = cells.traffic('band_f80')['floor']
    d, lim = lk['x_dim'], lk['lim']
    kind = cells.kind('mixture')
    n = 20000
    u = kind.level_draw(lk, floor, n, 2 ** 31 + 12345, 'cpu').numpy()
    x = lim * u
    assert np.all(np.abs(u) < 1.0)
    ref = cells.reference_kind('mixture').loglike(lk)
    assert np.all(ref(u) > floor - 1e-9)

    # the slow plane: counts on a 4 x 4 grid against quadrature of the
    # fast ball's volume, V(rho) ~ rho^(d - 2)
    edges = np.linspace(-lim, lim, 5)
    counts = np.histogram2d(x[:, 0], x[:, 1], bins=[edges, edges])[0]
    g = np.linspace(-lim, lim, 1601)
    mid = 0.5 * (g[1:] + g[:-1])
    gx, gy = np.meshgrid(mid, mid, indexing='ij')
    rho2 = _slow_rho2(lk, floor, np.stack([gx.ravel(), gy.ravel()], 1))
    logv = np.where(rho2 > 0, 0.5 * (d - 2) * np.log(np.maximum(rho2,
                                                                1e-300)),
                    -np.inf).reshape(gx.shape)
    w = np.exp(logv - logsumexp(logv))
    cell_of = np.digitize(mid, edges[1:-1])
    want = np.zeros((4, 4))
    np.add.at(want, (cell_of[:, None].repeat(len(mid), 1),
                     cell_of[None, :].repeat(len(mid), 0)), w)
    chi2 = float(np.sum((counts - n * want) ** 2 / (n * want)))
    assert chi2 < stats.chi2.ppf(1 - 1e-4, 15), (chi2, counts, n * want)

    # the fast dims: uniform in the ball of radius rho(x_s)
    rho = np.sqrt(_slow_rho2(lk, floor, x[:, :2]))
    r = np.linalg.norm(x[:, 2:], axis=1)
    assert np.all(r < rho * (1 + 1e-6))
    assert stats.kstest((r / rho) ** (d - 2), 'uniform').pvalue > 1e-4
    # and the set's volume is the one the configuration assumes
    log_x = (logsumexp(logv) + 2 * np.log(g[1] - g[0])
             + 0.5 * (d - 2) * np.log(np.pi) - gammaln(0.5 * (d - 2) + 1)
             - d * np.log(2 * lim))
    assert -30.5 < log_x < -29.5


def test_the_live_set_is_above_the_floor_in_float32():
    config = _config()
    lk = config['likelihood']
    band = cells.traffic('band_f80')
    like, _ = cells.kind('mixture').build(lk, 'cpu')
    u, logl, floor = cells.kind('mixture').init_set(like, config, band, 500,
                                                    2 ** 31 + 3, 'cpu')
    assert like.rows == 0
    assert u.shape == (500, lk['x_dim']) and floor == band['floor']
    assert np.all(logl > floor)
    assert np.array_equal(u, u.astype(np.float32).astype(np.float64))


def test_the_kind_refuses_a_program_without_the_kernel_path(monkeypatch):
    from nnest_torch.samplers.kernels import LatentKernels
    config = _config()
    band = cells.traffic('band_f80')
    kind = cells.kind('mixture')
    like, _ = kind.build(config['likelihood'], 'cpu')
    kind.require_kernel_path(like, config, band, 'cpu')
    # a program whose hot inverse of the fast-slow flow is its plain
    # inverse, as before the composed path: refused at set-up
    monkeypatch.setattr(LatentKernels, '_hot_inverse',
                        lambda self: self.model.inverse)
    with pytest.raises(RuntimeError, match='cannot run this cell'):
        kind.init_set(like, config, band, 10, 2 ** 31 + 3, 'cpu')
    # a band that requires no spline launches is not refused
    kind.require_kernel_path(like, config, dict(band, require_launches=[]),
                             'cpu')


def test_the_mixture_in_float32_matches_its_reference_and_the_port():
    from nnest_torch.likelihoods import GaussianMix
    lk = _config()['likelihood']
    d = lk['x_dim']
    like, transform = cells.kind('mixture').build(lk, 'cpu')
    g = torch.Generator().manual_seed(5)
    u = torch.cat([0.6 * torch.rand(256, d, generator=g) - 0.3,
                   2.0 * torch.rand(64, d, generator=g) - 1.0])
    u[:4, 2:] = 0.0
    u[:4, :2] = torch.tensor([[0.0, 0.4], [0.0, -0.4], [0.4, 0.0],
                              [-0.4, 0.0]])
    with torch.no_grad():
        got = like(transform(u)).double().numpy()
        port = GaussianMix(d, sep=lk['sep'], weights=lk['weights'],
                           sigma=lk['sigma'])(transform(u)).double().numpy()
    assert like.rows == u.shape[0]
    ref = cells.reference_kind('mixture').loglike(lk)(u.double().numpy())
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got, port, rtol=1e-6, atol=1e-4)
    assert cells.kind('mixture').ops_per_row(lk) == 111


def _fast_slow_flow(d, num_slow, seed=3):
    from nnest_torch.flows import build_flow
    model = build_flow(d, num_slow=num_slow, hidden_dim=16, seed=seed,
                       device='cpu')
    g = torch.Generator().manual_seed(seed)
    model.data_init(0.7 * torch.randn(256, d, generator=g) + 0.3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


@pytest.mark.parametrize('d,num_slow', [(5, 2), (30, 2)])
def test_the_flow_reference_is_the_ports_fast_slow_flow(d, num_slow):
    flow = cells.flow_reference(_config())
    model = _fast_slow_flow(d, num_slow)
    z = 2.0 * torch.randn(64, d, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        x, logdet = model.double().inverse(z.double())
        xr, ldr = flow.inverse(model.state_dict(), z.double())
    assert float(torch.max(torch.abs(x - xr))) < 1e-10
    assert float(torch.max(torch.abs(logdet - ldr))) < 1e-9


def test_the_flow_reference_counts_each_chain_as_the_spline_one():
    config = _config()
    flow = cells.flow_reference(config)
    assert flow.__name__ == 'reference.flows.fastslow_spline'
    one = (costs.inverse_cost(256, 2, 16)[0] + costs.inverse_cost(256, 28,
                                                                  16)[0]
           + 256 * (flow.combine_ops(30) + 2))
    assert flow.inverse_ops(config, 256, 1) == one
    # two calls of 256 rows: each call's own part (the blocks' e^-s) twice
    assert flow.inverse_ops(config, 512, 2) == 2 * one
    assert flow.inverse_ops(config, 0, 0) == 0
    assert flow.forward_ops(config) == (
        costs.flow_forward_ops(2, 16) - 7 + costs.flow_forward_ops(28, 16)
        - 85 + flow.combine_ops(30) + 2 + 91)
    single = cells.config(cells.benchmark(), 'gauss16')
    with pytest.raises(ValueError):
        flow.forward_ops(single)


def test_the_cell_is_discovered_with_its_files():
    bench = cells.benchmark()
    cell = cells.cell(bench, CELL)
    assert (cell['config'], cell['traffic'], cell['chips']) == (
        'mog30fs', 'band_f80', 1)
    config = cells.config(bench, cell['config'])
    assert cells.flow_args(config) == {'flow': 'spline', 'num_slow': 2,
                                       'num_blocks': 3, 'num_layers': 1}
    assert cells.kind(config['likelihood']['kind']).__name__ == \
        'harness.likelihoods.mixture'
    band = cells.traffic(cell['traffic'])
    assert band['require_launches'] == ['spline_inverse', 'consume_pool']
    assert [m['name'] for m in cells.metrics_for(bench['end_to_end'],
                                                 CELL)] == [
        'dead_points_per_s', 'setup_s']
    assert [m['name'] for m in cells.metrics_for(bench['per_layer'],
                                                 CELL)] == [
        'evidence_loop_share', 'consume_pool_roofline', 'device_idle_share',
        'mfu', 'fused_inverse_share', 'fastslow_inverse_roofline']
    limits = cells.limits(CELL)
    assert sorted(limits['limits']) == sorted([
        'logl_gap', 'logz_gap', 'h_gap', 'inverse_x_gap',
        'inverse_logdet_gap'])


def test_the_new_readers_read_their_counts():
    share = cells.reader('fused_inverse_share')
    roof = cells.reader('fastslow_inverse_roofline')
    config = _config()
    rows = [256] * 10
    summary = {'ops': {'void spline_inverse_kernel<8, 16>(...)': (20, 1e-3)}}
    ctx = {'config': config, 'costs': costs, 'trace': summary,
           'traced_inverse_rows': rows, 'jobs': []}
    want = 100.0 * sum(
        costs.bound_s(*costs.inverse_cost(256, 2, 16))[0]
        + costs.bound_s(*costs.inverse_cost(256, 28, 16))[0]
        for _ in rows) / 1e-3
    assert roof(ctx) == pytest.approx(want)
    # one launch a call: the flow ran another path
    assert roof(dict(ctx, traced_inverse_rows=rows * 2)) is None
    assert roof(dict(ctx, trace=None)) is None
    # no traced record: None
    assert share(ctx) is None


# ------------------------------------------- the cell's files, tiny, CPU

TINY_CONFIG = {
    'likelihood': {'kind': 'mixture', 'x_dim': 5, 'lim': 10.0, 'sep': 4.0,
                   'weights': [0.4, 0.3, 0.2, 0.1], 'sigma': 1.0},
    'num_live_points': 100, 'hidden_dim': 16,
    'flow_args': {'flow': 'spline', 'num_slow': 2, 'num_blocks': 3,
                  'num_layers': 1},
    'flow_reference': 'fastslow_spline',
    'run': {'mcmc_steps': 20, 'mcmc_num_chains': 16, 'mcmc_adapt': 'cov',
            'mcmc_gen_batch': 8, 'train_iters': 30, 'update_interval': 50,
            'dlogz': 0.5}}

TINY_BAND = dict(cells.traffic('band_f80'), floor=-14.0, max_iters=150,
                 warmup_iters=10, job_seconds=1.0, inverse_sample_stride=7)

TINY_LIMITS = {'limits': {'logl_gap': 1e-3, 'logz_gap': 1e-3, 'h_gap': 1e-3,
                          'inverse_x_gap': 1e-3,
                          'inverse_logdet_gap': 1e-3},
               'not_compared': {}}

RUNS = '''
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(1)
from harness import cells
from harness.bench import run_cell
from nnest_torch.ops import spline_inverse as si

bench = cells.benchmark()
cell = cells.cell(bench, 'mog5fs.deep')


def run():
    result = run_cell(cell['name'], cells.config(bench, cell['config']),
                      cells.traffic(cell['traffic']),
                      cells.limits(cell['name']), 2 ** 31 + 101, 0.0, False,
                      [], [], device='cpu')
    return {'correct': result['correct'], 'failed': result['failed'],
            'checks': result['checks']}


out = {'sound': run()}
fast_slow = si.fast_slow_inverse


def shifted(z, packed):
    x, logdet = fast_slow(z, packed)
    return x + 1e-2, logdet


si.fast_slow_inverse = shifted
out['inverse_shifted'] = run()
si.fast_slow_inverse = fast_slow
print('RESULT ' + json.dumps(out))
'''


def test_the_cells_files_run_tiny_on_the_cpu(tmp_path):
    copy = str(tmp_path / 'portbench')
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns(
        '__pycache__', '.pytest_cache'))
    bench = cells.benchmark()
    bench['configs'].append({'name': 'mog5fs',
                             'file': 'portbench/configs/mog5fs.json'})
    bench['workloads'].append({'name': 'mog5fs.deep', 'config': 'mog5fs',
                               'traffic': 'band_f14', 'chips': 1})
    with open(tmp_path / 'BENCHMARK.json', 'w') as f:
        json.dump(bench, f)
    for rel, doc in (('configs/mog5fs.json', TINY_CONFIG),
                     ('traffic/band_f14.json', TINY_BAND),
                     ('limits/mog5fs.deep.json', TINY_LIMITS)):
        with open(os.path.join(copy, rel), 'w') as f:
            json.dump(doc, f)
    script = tmp_path / 'runs.py'
    script.write_text(RUNS)
    proc = subprocess.run(
        [sys.executable, str(script), copy, ROOT], capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS='1', TMPDIR=str(tmp_path)))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1][len('RESULT '):])

    sound = out['sound']
    assert sound['correct'] and not sound['failed'], sound['checks']
    # the composed inverse was sampled and compared with the reference
    assert sound['checks']['missing_samples']['value'] == 0
    assert 0 < sound['checks']['inverse_x_gap']['value'] < 1e-5
    shifted = out['inverse_shifted']
    assert not shifted['correct']
    check = shifted['checks']['inverse_x_gap']
    assert check['value'] > check['limit'], shifted['checks']
