"""Likelihood kinds, flow keywords and flow references found by name.

- The ``gaussian`` kind and the ``spline`` flow reference read exactly what
  the harness read before they were found by name: on seeded CPU inputs,
  the float32 likelihood, the deep bands' live sets, the float64
  reference, the reference inverse and ``mfu`` equal the values frozen
  here, which the harness gave before (sha256 of the arrays' bytes; floats
  by ``repr``), and both cells' flow keywords are the ones the harness gave
  the ``Trainer`` before.
- A configuration with another likelihood and a flow whose steps take the
  flow's own ``inverse`` is added to a copy of ``portbench/`` as new files
  and entries in ``BENCHMARK.json`` only: a run of it on the CPU at a tiny
  size comes out correct, and not correct with the plain inverse's x
  +0.01 or a chain endpoint's logl +0.05."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from harness import cells, costs

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

FROZEN = {
    'gauss16': {
        'logl32': '2f1c5c93a755c2d57ab9537a2e6ba235:float32:(64,)',
        'init_u': '5f61879a04c1444cf6e2ac4f61e8a6f1:float64:(200, 16)',
        'init_logl': '94fec4040cba92b2a3ae0a404c160be1:float64:(200,)',
        'floor': '-31.545824886525722',
        'ref64': 'a09eec8e5666812345b40b9cf01a4c12:float64:(200,)',
        'inverse_x': 'b79593f822f49a1cba57ce79fac7bbb6:float64:(100, 16)',
        'inverse_logdet': '90ba72a7e2701968f1fbb558bc1b4d4c:float64:(100,)',
        'mfu': '0.02534076514122759',
        'mfu_nocalls': '0.018082510280859193'},
    'gauss50': {
        'logl32': '00544354b49612d6d581dfd8e2180fee:float32:(64,)',
        'init_u': 'fafc71b09ccd55cf4464156a842c40be:float64:(200, 50)',
        'init_logl': '824d1d81c08acd598428670cb5b27412:float64:(200,)',
        'floor': '-83.79192666023363',
        'ref64': 'b21e55e6e5db7b90a465384de855e8d3:float64:(200,)',
        'inverse_x': 'c28483511eb776a14ece2427fd53f0e8:float64:(100, 50)',
        'inverse_logdet': '65b70ae41fbc3a21b2bbd67c2e5a26c4:float64:(100,)',
        'mfu': '0.0776500903955452',
        'mfu_nocalls': '0.055444692094393296'},
}
BANDS = {'gauss16': 'band_r10', 'gauss50': 'band_r8.7'}


def _digest(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(a)
    return '%s:%s:%s' % (hashlib.sha256(a.tobytes()).hexdigest()[:32],
                         a.dtype, a.shape)


@pytest.mark.parametrize('name', sorted(FROZEN))
def test_the_gaussian_kind_and_the_spline_reference_read_as_before(name):
    from nnest_torch.flows import build_flow
    frozen, got = FROZEN[name], {}
    config = cells.config(cells.benchmark(), name)
    lk = config['likelihood']
    d = lk['x_dim']
    kind = cells.kind(lk['kind'])
    like, transform = kind.build(lk, 'cpu')
    g = torch.Generator().manual_seed(11)
    got['logl32'] = _digest(like(2.0 * torch.randn(64, d, generator=g)))
    like.rows = 0
    u, logl, floor = kind.init_set(like, config, cells.traffic(BANDS[name]),
                                   200, 2 ** 31 + 7, 'cpu')
    assert like.rows == 0
    got.update(init_u=_digest(u), init_logl=_digest(logl),
               floor=repr(floor))
    got['ref64'] = _digest(cells.reference_kind(lk['kind']).loglike(lk)(u))
    assert transform(torch.ones(1)).item() == lk['lim']

    model = build_flow(d, hidden_dim=16, seed=3, device='cpu').double()
    model.data_init(0.7 * torch.randn(256, d, generator=g,
                                      dtype=torch.float64) + 0.3)
    z = 2.0 * torch.randn(100, d, generator=g, dtype=torch.float64)
    with torch.no_grad():
        x, logdet = cells.flow_reference(config).inverse(model.state_dict(),
                                                         z)
    got.update(inverse_x=_digest(x), inverse_logdet=_digest(logdet))

    ctx = {'costs': costs, 'config': config, 'inverse_calls': 14401,
           'inverse_rows': 14401 * 256 - 77, 'epochs': 3317,
           'rows': 1290001, 'window_s': 47.123456789}
    mfu = cells.reader('mfu')
    got['mfu'] = repr(mfu(ctx))
    got['mfu_nocalls'] = repr(mfu(dict(ctx, inverse_calls=0,
                                       inverse_rows=0)))
    assert got == frozen


@pytest.mark.parametrize('name', sorted(FROZEN))
def test_the_cells_flow_keywords_are_the_ones_given_before(name):
    config = cells.config(cells.benchmark(), name)
    assert cells.flow_args(config) == {'flow': 'spline', 'num_blocks': 3,
                                       'num_layers': 1}
    assert cells.flow_reference(config).__name__ == 'reference.flows.spline'


def test_a_name_that_is_not_a_module_is_refused():
    with pytest.raises(ValueError):
        cells.kind('../harness/bench')


@pytest.mark.parametrize('flow_args', [{'flow': 'spline', 'num_slow': 2},
                                       {'flow': 'cholesky'}])
def test_the_spline_reference_counts_the_spline_flow_only(flow_args):
    config = dict(cells.config(cells.benchmark(), 'gauss16'),
                  flow_args=flow_args)
    flow = cells.flow_reference(config)
    with pytest.raises(ValueError):
        flow.forward_ops(config)
    with pytest.raises(ValueError):
        flow.inverse_ops(config, 256, 1)


# ------------------------------------------------- a kind added as files

KIND = '''
"""Two unit Gaussians on the box [-lim, lim]^d, weights ``weights``."""
import math

import torch


class TwoModes:
    def __init__(self, lk, device):
        self.mu = torch.tensor(lk['means'], dtype=torch.float32,
                               device=device)
        self.logw = torch.log(torch.tensor(lk['weights'],
                                           dtype=torch.float32,
                                           device=device))
        self.norm = -0.5 * lk['x_dim'] * math.log(2 * math.pi)
        self.rows = 0

    def __call__(self, x):
        self.rows += x.shape[0]
        r2 = torch.sum((x[:, None, :] - self.mu) ** 2, dim=-1)
        return torch.logsumexp(self.logw - 0.5 * r2, dim=-1) + self.norm


def build(lk, device):
    lim = float(lk['lim'])
    return TwoModes(lk, device), lambda u: lim * u


def init_set(like, config, band, n, seed, device):
    """``box``: uniform draws in the box, kept above ``band['floor']``."""
    assert band['start'] == 'box'
    lk = config['likelihood']
    g = torch.Generator(device=device).manual_seed(int(seed))
    kept, have = [], 0
    while have < n:
        u = 2.0 * torch.rand(4 * n, lk['x_dim'], generator=g,
                             device=device) - 1.0
        with torch.no_grad():
            logl = like(lk['lim'] * u)
        like.rows -= u.shape[0]
        ok = logl.double() > band['floor']
        kept.append((u[ok], logl[ok]))
        have += int(ok.sum())
    u = torch.cat([k[0] for k in kept])[:n]
    logl = torch.cat([k[1] for k in kept])[:n]
    return (u.double().cpu().numpy(), logl.double().cpu().numpy(),
            float(band['floor']))


def ops_per_row(lk):
    return 2 * (3 * lk['x_dim'] + 2) + 4
'''

REFERENCE_KIND = '''
import numpy as np


def loglike(lk):
    mu = np.asarray(lk['means'], dtype=np.float64)
    logw = np.log(np.asarray(lk['weights'], dtype=np.float64))
    norm = -0.5 * lk['x_dim'] * np.log(2 * np.pi)

    def f(u):
        x = lk['lim'] * np.asarray(u, dtype=np.float64)
        a = logw - 0.5 * np.sum((x[:, None, :] - mu) ** 2, axis=-1)
        top = np.max(a, axis=1)
        return top + np.log(np.sum(np.exp(a - top[:, None]), axis=1)) + norm
    return f
'''

FLOW_REFERENCE = '''
"""One lower-triangular linear map: x = L^-1 (z - b), L's diagonal
softplus(udiag) + 1e-3."""
import numpy as np
import torch


def inverse(state, z):
    dt, dev = z.dtype, z.device
    n, d = z.shape

    def p(key):
        return state['chain.bijectors.0.' + key].to(device=dev, dtype=dt)
    ud = p('udiag')
    diag = torch.log1p(torch.exp(-torch.abs(ud))) + torch.clamp(ud, min=0.0)
    diag = diag + 1e-3
    rows, cols = np.tril_indices(d, -1)
    L = torch.zeros(d, d, dtype=dt, device=dev)
    L[torch.as_tensor(rows), torch.as_tensor(cols)] = p('lower')
    L = L + torch.diag(diag)
    x = torch.linalg.solve_triangular(L, (z - p('bias')).T, upper=False).T
    return x, torch.full((n,), float(-torch.sum(torch.log(diag))),
                         dtype=dt, device=dev)


def inverse_ops(config, rows, calls):
    d = config['likelihood']['x_dim']
    return rows * (d * d + 2 * d) + calls * 3 * d


def forward_ops(config):
    d = config['likelihood']['x_dim']
    return 2 * d * d + 2 * d + 3 * d + 1
'''

CONFIG = {
    'likelihood': {'kind': 'twomodes', 'x_dim': 2, 'lim': 5.0,
                   'means': [[-2.0, 0.0], [2.0, 0.0]],
                   'weights': [0.6, 0.4]},
    'num_live_points': 100, 'hidden_dim': 16,
    'flow_args': {'flow': 'cholesky'}, 'flow_reference': 'cholesky',
    'run': {'mcmc_steps': 20, 'mcmc_num_chains': 16, 'mcmc_adapt': 'cov',
            'mcmc_gen_batch': 8, 'train_iters': 30, 'update_interval': 50,
            'dlogz': 0.5}}

BAND = {'start': 'box', 'floor': -6.0, 'strategy': ['mcmc'],
        'trainer': 'shared', 'max_iters': 150, 'warmup_iters': 10,
        'job_seconds': 1.0, 'inverse_sample_stride': 7,
        'require_launches': ['consume_pool'], 'forbid_generations': []}

LIMITS = {'limits': {'logl_gap': 1e-3, 'logz_gap': 1e-3, 'h_gap': 1e-3,
                     'inverse_x_gap': 1e-3, 'inverse_logdet_gap': 1e-3},
          'not_compared': {}}

RUNS = '''
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(1)
from harness import cells
from harness.bench import run_cell
from nnest_torch.flows.model import FlowModel
from nnest_torch.samplers.kernels import LatentKernels

bench = cells.benchmark()
cell = cells.cell(bench, 'mix2.deep')


def run():
    result = run_cell(cell['name'], cells.config(bench, cell['config']),
                      cells.traffic(cell['traffic']),
                      cells.limits(cell['name']), 2 ** 31 + 101, 0.0, False,
                      [], [], device='cpu')
    return {'correct': result['correct'], 'failed': result['failed'],
            'checks': result['checks']}


out = {'sound': run()}
inverse, mcmc = FlowModel.inverse, LatentKernels.mcmc


def shifted(self, z):
    x, logdet = inverse(self, z)
    return x + 1e-2, logdet


def altered(self, *args, **kwargs):
    res = mcmc(self, *args, **kwargs)
    if 'final_logl' in res:
        res['final_logl'] = res['final_logl'] + 0.05
    return res


FlowModel.inverse = shifted
out['inverse_shifted'] = run()
FlowModel.inverse = inverse
LatentKernels.mcmc = altered
out['logl_altered'] = run()
LatentKernels.mcmc = mcmc
print('RESULT ' + json.dumps(out))
'''


def _add(root, rel, text):
    """A new file of the copy: none is there under that name."""
    path = os.path.join(root, rel)
    assert not os.path.exists(path), rel
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        f.write(text)


def test_a_kind_and_a_flow_added_as_files_only(tmp_path):
    copy = str(tmp_path / 'portbench')
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns(
        '__pycache__', '.pytest_cache'))
    bench = cells.benchmark()
    bench['configs'].append({'name': 'mix2',
                             'file': 'portbench/configs/mix2.json'})
    bench['workloads'].append({'name': 'mix2.deep', 'config': 'mix2',
                               'traffic': 'band_mix', 'chips': 1})
    with open(tmp_path / 'BENCHMARK.json', 'w') as f:
        json.dump(bench, f)
    _add(copy, 'harness/likelihoods/twomodes.py', KIND)
    _add(copy, 'reference/likelihoods/twomodes.py', REFERENCE_KIND)
    _add(copy, 'reference/flows/cholesky.py', FLOW_REFERENCE)
    _add(copy, 'configs/mix2.json', json.dumps(CONFIG))
    _add(copy, 'traffic/band_mix.json', json.dumps(BAND))
    _add(copy, 'limits/mix2.deep.json', json.dumps(LIMITS))
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
    # the flow's own inverse was sampled and compared
    assert sound['checks']['missing_samples']['value'] == 0
    assert sound['checks']['inverse_x_gap']['value'] > 0
    for fault, caught_by in (('inverse_shifted', 'inverse_x_gap'),
                             ('logl_altered', 'logl_gap')):
        result = out[fault]
        assert not result['correct'], fault
        check = result['checks'][caught_by]
        assert check['value'] > check['limit'], (fault, result['checks'])


def test_the_flows_own_inverse_is_counted_sampled_and_controlled():
    """``LatentKernels._hot_inverse`` as the hooks wrap it: a flow that the
    spline kernel does not cover has its calls and rows counted and
    sampled with its parameters, and under the control its output is the
    flow reference's; a spline chain's callable is left as it is (the
    kernel's entry is sampled)."""
    from harness.hooks import Hooks
    from nnest_torch.flows import build_flow

    class Kernels:
        model = build_flow(3, flow='cholesky', seed=1, device='cpu')

    def real(kernels):
        return kernels.model.inverse

    z = torch.randn(5, 3, generator=torch.Generator().manual_seed(2))
    want = Kernels.model.inverse(z)
    marked = (torch.full((5, 3), 7.0), torch.full((5,), -1.0))
    for control, out in ((None, want), ('tf32', marked)):
        hooks = Hooks(2, control, lambda state, z: marked)
        hooks.begin_job(0, 4, None)
        hot = hooks._hot(real, lambda model: False)(Kernels())
        for _ in range(3):
            x, logdet = hot(z)
            assert torch.equal(x, out[0]) and torch.equal(logdet, out[1])
        assert (hooks.inverse_calls, hooks.inverse_rows) == (3, 15)
        assert len(hooks.samples) in (1, 2)
        job, zs, xs, _, state = hooks.samples[0]
        assert torch.equal(zs, z) and torch.equal(xs, out[0])
        assert sorted(state) == sorted(Kernels.model.state_dict())
    spline = object()
    assert hooks._hot(lambda k: spline, lambda model: True)(Kernels()) \
        is spline
