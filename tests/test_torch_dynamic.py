"""``DynamicNestedSampler`` and the dynamic-batch hooks of
``NestedSampler.run`` on the CPU, against ``nnest_tpu``.

The batch window (``batch_bounds``) and the batch seed draw (the pool of
points alive at the floor and the ``RandomState`` indices) equal the JAX
package's on the same parts, to the bit: both are the same float64 numpy.
The sampler itself is held to the JAX package's tests (``tests/
test_dynamic.py``): the floor and ceiling mechanics of one batch, the
refusal of ``init_points`` on a resumable directory, the analytic evidence
of the 2-D Gaussian, and resume between batches and mid-batch to the
uninterrupted (logz, h, ncall, niter). The 10-D dynamic-versus-static
comparison is ``slow``."""

import json
import math
import os

import numpy as np
import pytest
import torch

from nnest_tpu.samplers.dynamic import DynamicNestedSampler as JaxDynamic
from nnest_torch import DynamicNestedSampler, NestedSampler
from nnest_torch.likelihoods import Gaussian
from nnest_torch.utils import evaluation as te
from nnest_torch.utils.evaluation import merge_runs, thread_birth_logl
from tests.test_merge import _logl_of_vol, simulate_run

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

LIKE = Gaussian(2, 0.0, lim=3)
ANALYTIC = LIKE.analytic_logz([-3.0, -3.0], [3.0, 3.0])
RUN = dict(train_iters=30, mcmc_num_chains=10, mcmc_steps=10,
           rejection_batch_size=32)
DYN_KW = dict(G=0.5, num_batches=2, num_live_batch=50, dlogz=0.3,
              log_interval=20, **RUN)


def _parts():
    """A static run and a batch above a floor (simulated exact nested
    sampling), each with u-space points, in the dynamic sampler's form."""
    rs = np.random.RandomState(11)
    logl, slots = simulate_run(100, 1500, seed=3)
    parts = [{'logl': logl,
              'birth_logl': thread_birth_logl(logl, slots, 100)}]
    x_star = math.exp(-2.0)
    vols = rs.uniform(size=40) * x_star
    blogl, bslots = [], []
    for _ in range(600):
        worst = int(np.argmax(vols))
        blogl.append(_logl_of_vol(vols[worst]))
        bslots.append(worst)
        vols[worst] = rs.uniform() * vols[worst]
    blogl += [_logl_of_vol(v) for v in vols]
    bslots += list(range(40))
    blogl = np.asarray(blogl)
    parts.append({'logl': blogl, 'birth_logl': thread_birth_logl(
        blogl, np.asarray(bslots), 40, birth_floor=_logl_of_vol(x_star))})
    for p in parts:
        p['u'] = rs.uniform(-1.0, 1.0, size=(p['logl'].size, 2))
        p['samples'] = 3.0 * p['u']
    return parts


@pytest.mark.parametrize('G,maxfrac', [(0.0, 0.8), (0.25, 0.8), (0.5, 0.5),
                                       (1.0, 0.8), (1.0, 0.99)])
def test_batch_bounds_match_jax(G, maxfrac):
    parts = _parts()
    for ps in (parts[:1], parts):
        merged = merge_runs(ps)
        got = DynamicNestedSampler.batch_bounds(merged, ps, G, maxfrac)
        assert got == JaxDynamic.batch_bounds(merged, ps, G, maxfrac)
        assert got[1] is None or got[1] > got[0]


class _Refresh:
    """A stand-in batch sampler for ``_seed_batch``: records the starts
    the refresh would take and returns them unmoved."""
    x_dim = 2
    num_derived = 0

    def _mcmc_sample_final(self, mcmc_steps, **kw):
        self.kw = dict(kw, mcmc_steps=mcmc_steps)
        u = kw['init_samples']
        n = u.shape[0]
        return (u, kw['init_loglikes'], np.zeros((n, 0)), np.ones(n, bool),
                1.0, 0.0, 0)

    def transform(self, u):
        return 3.0 * np.asarray(u)


def test_seed_batch_draw_matches_jax():
    """The pool of points alive at the floor (a float32 tie at the floor
    excluded) and the RandomState indices equal the JAX package's, floor
    after floor on one stream; with ``refresh=False`` only the draw
    runs."""
    parts = _parts()
    port = DynamicNestedSampler(2, LIKE, log_dir=None, seed=5, device='cpu')
    ref = JaxDynamic(2, LIKE, log_dir=None, seed=5)
    port._parts = ref._parts = parts
    deaths = np.sort(np.concatenate([p['logl'] for p in parts]))
    floors = [DynamicNestedSampler.batch_bounds(merge_runs(parts), parts,
                                                1.0)[0],
              float(deaths[700]),
              # the next point ties the floor in float32
              float(np.nextafter(deaths[900], -np.inf))]
    for floor in floors:
        got, want = _Refresh(), _Refresh()
        pts = port._seed_batch(got, floor, 50, 7)
        assert ref._seed_batch(want, floor, 50, 7) is not None
        for k in ('init_samples', 'init_loglikes', 'loglstar',
                  'mcmc_steps'):
            np.testing.assert_array_equal(got.kw[k], want.kw[k])
        assert got.kw['dynamic_step_size'] and got.kw['loglstar'] == floor
        assert np.all(got.kw['init_loglikes'].astype(np.float32)
                      > np.float32(floor))
        np.testing.assert_array_equal(pts['v'], 3.0 * pts['u'])
        assert port._seed_batch(got, floor, 50, 7, refresh=False) is None
        assert ref._seed_batch(want, floor, 50, 7, refresh=False) is None
        a, b = port._rng.get_state(), ref._rng.get_state()
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]
    with pytest.raises(RuntimeError, match='no live-at-threshold'):
        port._seed_batch(_Refresh(), float(deaths[-1]), 50, 7)


def test_mcmc_sample_final_from_explicit_starts():
    """The seed refresh's chains: one a start, each end above loglstar,
    the starts' given likelihoods not paid again, no derived columns."""
    s = NestedSampler(2, LIKE, transform=lambda u: 3.0 * u,
                      num_live_points=50, log_dir=None, seed=2, device='cpu')
    u0 = np.random.RandomState(0).uniform(-0.3, 0.3, size=(20, 2))
    logl0, _ = s.loglike(u0)
    loglstar = float(np.min(logl0)) - 1e-3
    calls = s.total_calls
    u, logl, derived, moved, scale, jump, ncall = s._mcmc_sample_final(
        15, init_samples=u0, init_loglikes=logl0, loglstar=loglstar,
        dynamic_step_size=True)
    assert u.shape == (20, 2) and logl.shape == (20,)
    assert derived.shape == (20, 0) and moved.any()
    assert np.all(logl > loglstar) and np.all(np.abs(u) <= 1.0)
    np.testing.assert_allclose(logl, s.loglike(u)[0], rtol=1e-5)
    assert 0 < ncall <= 15 * 20 and s.total_calls == calls + ncall + 20
    assert scale > 0 and jump >= 0
    # the generation's mixing ratio against the null of its proposal
    for cov_from, null in ((None, te.metropolis_mix_null(15, 2)),
                           (torch.tensor(u0, dtype=torch.float32),
                            te.metropolis_mix_null(15, 2, adapt_cov=True))):
        s._mcmc_sample_final(15, init_samples=u0, init_loglikes=logl0,
                             loglstar=loglstar, cov_from=cov_from)
        assert s._mix_rels[-1] == s._mix_ratios_eig[-1] / null
        assert s._cond_infl[-1] == s._cond_rels[-1]


def test_batch_floor_ceiling_mechanics(tmp_path):
    """A batch with a floor and a ceiling: given live points taken without
    evaluating them again, every death above the floor, the floor in
    threads.npz with u, the run stopped once every live point exceeds the
    ceiling; the merged logz near the static run's."""
    s0 = NestedSampler(2, LIKE, transform=lambda u: 3.0 * u,
                       num_live_points=100, log_dir=str(tmp_path / 'base'),
                       resume=False, seed=1, device='cpu')
    s0.run(dlogz=0.3, **RUN)
    assert s0.saved_u.shape == (s0.loglikes.size, 2)
    np.testing.assert_allclose(s0.transform(s0.saved_u), s0.samples)
    births = thread_birth_logl(s0.loglikes, s0.thread_slots, 100)
    floor = float(np.median(s0.loglikes))
    alive = (births <= floor) & (s0.loglikes > floor)
    assert alive.sum() >= 50
    idx = np.nonzero(alive)[0][:50]
    ceiling = float(np.quantile(s0.loglikes, 0.9))
    s1 = NestedSampler(2, LIKE, transform=lambda u: 3.0 * u,
                       num_live_points=50, log_dir=str(tmp_path / 'batch'),
                       resume=False, seed=2, trainer=s0.trainer,
                       device='cpu')

    def no_host_calls(u):
        raise AssertionError('the given live points were evaluated again')

    s1.loglike = no_host_calls
    s1.run(dlogz=1e-3, strategy=['mcmc'],
           init_points={'u': s0.saved_u[idx], 'logl': s0.loglikes[idx]},
           birth_floor=floor, logl_ceiling=ceiling, **RUN)
    assert np.all(s1.loglikes > floor)
    assert np.min(s1.loglikes[-50:]) > ceiling
    rec = np.load(os.path.join(s1.log_dir, 'results', 'threads.npz'))
    assert float(rec['birth_floor']) == floor
    np.testing.assert_array_equal(rec['u'], s1.saved_u)
    merged = merge_runs([
        {'logl': s0.loglikes, 'birth_logl': births},
        {'logl': s1.loglikes, 'birth_logl': thread_birth_logl(
            s1.loglikes, s1.thread_slots, 50, birth_floor=floor)}])
    assert abs(merged['logz'] - s0.logz) < 5 * s0.logzerr + 0.2
    with pytest.raises(ValueError, match='exceed birth_floor'):
        NestedSampler(2, LIKE, num_live_points=50, log_dir=None,
                      device='cpu').run(
            init_points={'u': s0.saved_u[idx], 'logl': s0.loglikes[idx]},
            birth_floor=ceiling, **RUN)


def test_init_points_rejects_resumable_checkpoint(tmp_path):
    def sampler(resume):
        return NestedSampler(2, LIKE, transform=lambda u: 3.0 * u,
                             num_live_points=50, log_dir=str(tmp_path / 'r'),
                             append_run_num=False, resume=resume, seed=1,
                             device='cpu')

    sampler(False).run(dlogz=0.5, max_iters=30, **RUN)
    with pytest.raises(ValueError, match='init_points'):
        sampler(True).run(dlogz=0.5, init_points={
            'u': np.zeros((50, 2)), 'logl': np.zeros(50)}, **RUN)


def _dyn(path, resume):
    return DynamicNestedSampler(2, LIKE, transform=lambda u: 3.0 * u,
                                num_live_init=100, log_dir=str(path),
                                append_run_num=False, resume=resume, seed=3,
                                device='cpu')


def _final(d):
    return (d.logz, d.h, d.total_calls, d.niter)


@pytest.fixture(scope='module')
def whole(tmp_path_factory):
    d = _dyn(tmp_path_factory.mktemp('dyn') / 'whole', resume=False)
    d.run(**DYN_KW)
    return d


def test_dynamic_run_reaches_analytic_logz(whole):
    d = whole
    assert abs(d.logz - ANALYTIC) < 5 * d.logzerr + 0.2
    assert d.samples.shape == (d.loglikes.size, 2)
    np.testing.assert_allclose(np.sum(d.weights), 1.0, rtol=1e-9)
    assert int(np.max(d.n_live)) > 100    # the batches add live points
    assert 0.0 < d.insertion_p_value <= 1.0
    assert 0.0 < d.posterior_ess <= d.loglikes.size
    res = d.logs['results']
    with open(os.path.join(res, 'diagnostics.json')) as f:
        diag = json.load(f)
    assert diag['sampler'] == 'dynamic' and len(diag['batches']) == 3
    assert diag['logz'] == d.logz and diag['ncall'] == d.total_calls
    np.testing.assert_array_equal(np.load(os.path.join(res, 'n_live.npy')),
                                  d.n_live)
    chain = np.loadtxt(os.path.join(d.logs['chains'], 'chain.txt'))
    assert chain.shape == (d.loglikes.size, 4)
    assert os.path.exists(os.path.join(res, 'final.csv'))
    # the batches above a floor were seeded and ran without prior rejection
    floors = [float(np.load(os.path.join(
        d.logs['run_dir'], 'batches', 'batch%d' % b, 'results',
        'threads.npz'))['birth_floor']) for b in (1, 2)]
    assert all(np.isfinite(floors))
    # no bundle without resume=True
    assert not os.path.exists(os.path.join(d.logs['checkpoint'],
                                           'dynamic_state.pkl'))
    with pytest.raises(ValueError, match='append_run_num'):
        DynamicNestedSampler(2, LIKE, log_dir=None, resume=True,
                             device='cpu')


def test_dynamic_resume_between_batches(whole, tmp_path):
    """Stopped after batch 1 and resumed to 2 batches (any seed: the
    bundle holds the parts, the seed draws' RandomState and the shared
    trainer): the uninterrupted result exactly."""
    b = _dyn(tmp_path / 'resumed', resume=True)
    b.run(**dict(DYN_KW, num_batches=1))
    assert os.path.exists(os.path.join(b.logs['checkpoint'],
                                       'dynamic_state.pkl'))
    b2 = _dyn(tmp_path / 'resumed', resume=True)
    b2.run(**DYN_KW)
    assert _final(b2) == _final(whole)


def test_dynamic_exact_resume_mid_batch(whole, tmp_path, monkeypatch):
    """Batch 1 killed mid-run (cut at max_iters=20, which leaves a crash's
    checkpoint, then an exception before its ingest): the resumed run
    continues it from its own checkpoint, skips its seed refresh, replays
    its seed draw, and ends at the uninterrupted result exactly."""
    import nnest_torch.samplers.dynamic as dyn
    orig_run = dyn.NestedSampler.run
    calls = {'run': 0, 'refresh': 0}

    def crashing_run(self, *args, **kw):
        calls['run'] += 1
        if calls['run'] == 2:          # batch 1
            orig_run(self, *args, **dict(kw, max_iters=20))
            raise KeyboardInterrupt('emulated mid-batch kill')
        return orig_run(self, *args, **kw)

    with monkeypatch.context() as m:
        m.setattr(dyn.NestedSampler, 'run', crashing_run)
        with pytest.raises(KeyboardInterrupt):
            _dyn(tmp_path / 'killed', resume=True).run(**DYN_KW)

    orig_final = dyn.NestedSampler._mcmc_sample_final

    def counted(self, *args, **kw):
        calls['refresh'] += 1
        return orig_final(self, *args, **kw)

    monkeypatch.setattr(dyn.NestedSampler, '_mcmc_sample_final', counted)
    res = _dyn(tmp_path / 'killed', resume=True)
    res.run(**DYN_KW)
    assert calls['refresh'] == 1      # batch 2's only
    assert _final(res) == _final(whole)


@pytest.mark.slow
def test_dynamic_vs_static_10d(tmp_path):
    """On a 10-D Gaussian in a wide box, batches aimed at the posterior
    bulk (G = 1) give the same evidence with more posterior ESS per
    likelihood call, and the live count peaks above the static one."""
    d_, lim = 10, 10
    like = Gaussian(d_, 0.0, lim=lim)
    s = NestedSampler(d_, like, transform=lambda u: lim * u,
                      num_live_points=100, log_dir=str(tmp_path / 'static'),
                      seed=3, device='cpu')
    s.run(dlogz=0.3, train_iters=50, mcmc_num_chains=16)
    w = s.weights
    ess_static = float(np.sum(w) ** 2 / np.sum(w ** 2))
    d = DynamicNestedSampler(d_, like, transform=lambda u: lim * u,
                             num_live_init=100, log_dir=str(tmp_path / 'dyn'),
                             seed=3, device='cpu')
    d.run(G=1.0, num_batches=4, num_live_batch=50, dlogz=0.3,
          train_iters=50, mcmc_num_chains=16)
    analytic = like.analytic_logz([-lim] * d_, [lim] * d_)
    assert abs(d.logz - analytic) < 5 * d.logzerr + 0.3
    assert abs(d.logz - s.logz) < 5 * (d.logzerr + s.logzerr)
    assert int(np.max(d.n_live)) > 100
    assert (d.posterior_ess / d.total_calls
            > ess_static / s.total_calls)
