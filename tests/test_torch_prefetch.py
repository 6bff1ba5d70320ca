"""Multi-generation prefetch and speculation of nnest_torch on the CPU.

The consumption replay (``LatentKernels._consume_pool``), the trial
ladder's window replica (``_ladder_window_update``) and the compact
rejection generation (``NestedSampler._compact_rejection_gen``) equal
``nnest_tpu``'s exactly on the same numpy inputs, ties included. The
batch runners run the generations the one-generation route would, from the same
generator. End to end, a run at ``mcmc_gen_batch`` / ``rejection_gen_batch``
8 gives the run at 1 bit for bit ((logz, logzerr, h, total_calls, niter),
samples and derived columns) on every strategy, with speculation won and
lost, and a run killed inside a buffer resumes to the uninterrupted run's
numbers; these mirror nnest_tpu's own tests (tests/test_nested.py,
test_slice.py, test_mcmc_adapt.py, test_kernels.py).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnest_tpu.samplers import kernels as jk
from nnest_tpu.samplers.nested import NestedSampler as JaxNestedSampler
from nnest_torch import DynamicNestedSampler, NestedSampler, Trainer
from nnest_torch.flows import build_flow
from nnest_torch.likelihoods import Gaussian
from nnest_torch.priors import UniformPrior
from nnest_torch.samplers import kernels as tk
from nnest_torch.samplers.nested import EXACT_STATE

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

LIKE = Gaussian(2, 0.0, lim=3)
# 2-D runs: 50 live points, short training and chains
NLIVE = 50
RUN = dict(train_iters=5, dlogz=0.5, mcmc_num_chains=6, mcmc_steps=4)


def _sampler(seed=7, log_dir=None, like=LIKE, **kw):
    kw.setdefault('resume', False)
    if log_dir is not None:
        # a trainer without files: TensorBoard's import alone would take
        # most of this file's time
        kw.setdefault('trainer', _trainer())
    return NestedSampler(2, like, transform=lambda u: 3.0 * u,
                         num_live_points=NLIVE, log_dir=log_dir, seed=seed,
                         device='cpu', log_level=30, **kw)


def _trainer():
    return Trainer(2, hidden_dim=16, seed=8, device='cpu', log_level=30)


def _final(s):
    return (s.logz, s.logzerr, s.h, s.total_calls, s.niter)


# ------------------------------------------------------ consumption replay

def _consume_case(name):
    rs = np.random.RandomState(3)
    if name == 'ties':
        # two live points tie at the minimum (the first wins); candidates
        # equal to the minimum fail, unflagged ones do nothing, and the
        # fourth accept lands on a multiple of update_interval
        al = np.array([1.0, -2.0, 3.0, -2.0, 5.0, -2.0], np.float32)
        cl = np.array([-2.0, 10.0, 0.5, -2.0, -1.0, 7.0, -2.0, 0.25, 4.0],
                      np.float32)
        flags = np.array([1, 0, 1, 1, 1, 1, 1, 1, 1], bool)
        k, it, ui = 2, 9, 4
    elif name == 'random':
        al = np.round(rs.normal(size=50), 1).astype(np.float32)
        cl = np.round(rs.normal(0.5, 1.0, size=200), 1).astype(np.float32)
        flags = rs.uniform(size=200) < 0.7
        k, it, ui = 0, 100, 25
    else:   # nothing passes
        al = rs.normal(size=8).astype(np.float32)
        cl = np.full(5, al.min(), np.float32)
        flags = np.array([1, 1, 0, 1, 1], bool)
        cl[2] = 9.0
        k, it, ui = 1, 3, 1
    n, m, d = al.shape[0], cl.shape[0], 3
    au = rs.normal(size=(n, d)).astype(np.float32)
    ad = rs.normal(size=(n, k)).astype(np.float32)
    cx = rs.normal(size=(m, d)).astype(np.float32)
    cd = rs.normal(size=(m, k)).astype(np.float32)
    return au, al, ad, it, flags, cl, cx, cd, ui


@pytest.mark.parametrize('case', ['ties', 'random', 'none_pass'])
def test_consume_pool_matches_jax(case):
    au, al, ad, it, flags, cl, cx, cd, ui = _consume_case(case)
    want = jk.LatentKernels._consume_pool(
        None, jnp.asarray(au), jnp.asarray(al), jnp.asarray(ad),
        jnp.int32(it), jnp.asarray(flags), jnp.asarray(cl), jnp.asarray(cx),
        jnp.asarray(cd), update_interval=ui)
    k = ad.shape[1]
    t = (lambda a: torch.from_numpy(a.copy()))
    got = tk.LatentKernels._consume_pool(
        t(au), t(al), t(ad) if k else None,
        torch.tensor(it, dtype=torch.int32), t(flags), t(cl), t(cx),
        t(cd) if k else None, update_interval=ui)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if k:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3])
    assert bool(got[4]) == bool(want[4])
    if case == 'ties':
        assert int(want[3]) == it + 5 and bool(want[4])
    if case == 'none_pass':
        assert int(want[3]) == it and not bool(want[4])


_JAX_LADDER = jax.jit(jk.LatentKernels._ladder_window_update,
                      static_argnums=(6, 7, 8))


@pytest.mark.parametrize('flags', [(True, True, False), (True, False, True),
                                   (False, True, True)])
def test_ladder_window_update_matches_jax(flags):
    """A run of generations through both replicas (the JAX one as its
    batch runners run it, under jit): a doubling (n_ok under target / 2), a
    halving (over 2 x target), the 20-slot ring's wrap and the expiry
    proxy crossing its threshold."""
    adapt, can_double, can_halve = flags
    target, trials, thr = 16, 512, np.float32(30.0)
    wj = wt = np.zeros(20, np.float32)
    cj = ct = 0
    stops = []
    for n_ok in (40, 3, 0, 37, 5, 19, 7, 2, 33, 11, 1, 29, 6, 4):
        nc = (np.float32(trials) / np.float32(max(n_ok, 1)) if n_ok > 0
              else np.float32(trials))
        sj, wj, cj = _JAX_LADDER(jnp.int32(n_ok), jnp.float32(nc),
                                 jnp.asarray(wj), jnp.int32(cj), thr,
                                 jnp.int32(target), adapt, can_double,
                                 can_halve)
        st, wt, ct = tk.LatentKernels._ladder_window_update(
            n_ok, nc, wt, ct, thr, target, adapt, can_double, can_halve)
        wj, cj = np.asarray(wj), int(cj)
        assert bool(sj) == st
        np.testing.assert_array_equal(wt, wj)
        assert ct == cj
        stops.append(st)
    assert ct > 40 and any(stops) and not all(stops)


@pytest.mark.parametrize('kind', ['prior', 'flow'])
def test_compact_rejection_gen_matches_jax(kind):
    rs = np.random.RandomState(4)
    m = 64
    x = rs.normal(size=(m, 2)).astype(np.float32)
    ll = rs.normal(size=m).astype(np.float32)
    ds = rs.normal(size=(m, 2)).astype(np.float32)
    ok = rs.uniform(size=m) < 0.3
    extra = ((None, None, None) if kind == 'prior'
             else (41, np.float32(1.5), np.float32(2.25)))
    args = (x, ll, ds, ok) + extra + (np.float32(-1.75), 17, m)
    want = JaxNestedSampler._compact_rejection_gen(*args)
    got = NestedSampler._compact_rejection_gen(*args)
    assert set(got) == set(want)
    for key, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[key], v, err_msg=key)
            assert got[key].dtype == v.dtype, key
        else:
            assert got[key] == v and type(got[key]) is type(v), key


# ---------------------------------------------------------- batch runners

def _port_like(u):
    return -0.5 * torch.sum(u ** 2, dim=-1)


def _port_prior(u):
    return torch.where(torch.all(u.abs() <= 1.0, dim=-1),
                       torch.zeros_like(u[:, 0]),
                       torch.full_like(u[:, 0], -np.inf))


@pytest.fixture(scope='module')
def port_kernels():
    torch.manual_seed(0)
    return tk.LatentKernels(build_flow(2, hidden_dim=16, device='cpu'),
                            _port_like, _port_prior)


def _live(n, seed):
    au = np.random.RandomState(seed).uniform(-0.7, 0.7, (n, 2)).astype(
        np.float32)
    return torch.from_numpy(au), _port_like(torch.from_numpy(au))


@pytest.mark.parametrize('kind', ['mcmc', 'rejection_prior'])
def test_batch_runs_the_one_generation_route(port_kernels, kind):
    """A batch runner's generations are those of one generation a call on the
    live set its consumption left, from the same generator, and it stops
    exactly where the route's stop rule fires (an update_interval
    crossing; a ladder change)."""
    kern = port_kernels
    au, al = _live(40, 11)
    g_batch = torch.Generator().manual_seed(5)
    g_seq = torch.Generator().manual_seed(5)
    prior = UniformPrior(2, -1.0, 1.0)
    target = 16
    if kind == 'mcmc':
        kw = dict(num_chains=8, mcmc_steps=6, step_size=0.5)
        bufs, meta, n_gens = kern.mcmc_pool_generations(
            g_batch, au.clone(), al.clone(), None, 3, 0.5, 7,
            num_chains=8, mcmc_steps=6, max_gens=4)
    else:
        bufs, meta, n_gens = kern.rejection_prior_generations(
            prior, g_batch, au.clone(), al.clone(), None, 2, 2 ** 30,
            np.zeros(20, np.float32), 0, np.float32(1e30), target,
            num_trials=64, max_gens=5, adapt_trials=True, can_double=True,
            can_halve=False)
    cau, cal, stop = au.clone(), al.clone(), False
    it = 3 if kind == 'mcmc' else 2
    for g in range(n_gens):
        assert not stop
        assert float(meta['start_loglstar'][g]) == float(cal.min())
        assert int(meta['start_it'][g]) == it
        if kind == 'mcmc':
            out = kern.mcmc_from_live(g_seq, cau, cal,
                                      loglstar=float(cal.min()), **kw)
            flags, logl, x = out['moved'], out['final_logl'], out['final_x']
        else:
            x, logl, _, flags = kern.rejection_prior(
                prior, g_seq, float(cal.min()), 64)
            out = {'x': x, 'logl': logl, 'ok': flags}
        for key, v in out.items():
            np.testing.assert_array_equal(bufs[key][g].numpy(),
                                          torch.as_tensor(v).numpy(), key)
        for i in range(flags.shape[0]):
            if flags[i] and logl[i] > cal.min():
                w = int(torch.argmin(cal))
                cau[w], cal[w] = x[i], logl[i]
                it += 1
                stop = stop or (kind == 'mcmc' and it % 7 == 0)
        if kind != 'mcmc':
            stop = int(flags.sum()) < target // 2
    assert stop or n_gens == (4 if kind == 'mcmc' else 5)
    assert torch.equal(g_batch.get_state(), g_seq.get_state())


# ---------------------------------------------------- end to end, 1 vs 8

def _derived_like(x):
    return (-0.5 * torch.sum(x ** 2, dim=-1),
            torch.stack([torch.sum(x, dim=-1),
                         torch.linalg.norm(x, dim=-1)], dim=-1))


SWITCH = dict(volume_switch=0.5)
CASES = {
    # name: (run options, strategy stem whose dispatches at least halve)
    'mcmc_cov': (dict(SWITCH, mcmc_adapt='cov'), 'mcmc'),
    'mcmc_iso': (dict(SWITCH, mcmc_adapt='iso'), None),
    'derived': (dict(SWITCH), None),
    'prior_ladder': (dict(rejection_batch_size=16), 'rejection'),
    'prior_volume_switch': (dict(volume_switch=0.4, rejection_batch_size=16),
                            None),
    'flow': (dict(SWITCH, strategy=['rejection_prior', 'rejection_flow',
                                    'mcmc'], rejection_batch_size=64), None),
    'slice': (dict(SWITCH, strategy=['rejection_prior', 'slice'],
                   slice_steps=2), 'slice'),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_gen_batch_bit_identical(case):
    kw, halves = CASES[case]
    runs = {}
    for batch in (1, 8):
        if case == 'derived':
            s = _sampler(seed=11, like=_derived_like, num_derived=2)
        else:
            s = _sampler(seed=5 if 'prior' in case else 7)
        s.run(**dict(RUN, **kw), mcmc_gen_batch=batch,
              rejection_gen_batch=batch)
        runs[batch] = s
    one, eight = runs[1], runs[8]
    assert _final(one) == _final(eight)
    np.testing.assert_array_equal(one.samples, eight.samples)
    np.testing.assert_array_equal(one.loglikes, eight.loglikes)
    if case == 'derived':
        assert one.samples.shape[1] == 4
    for stem in ('rejection', 'rejection_flow', 'mcmc', 'slice'):
        gens = one.run_stats[stem + '_generations']
        assert eight.run_stats[stem + '_generations'] == gens
        assert one.run_stats[stem + '_dispatches'] == gens
        if stem.startswith('rejection'):
            # the same generations and passes by trial count on both routes
            by = one.run_stats[stem + '_by_trials']
            assert eight.run_stats[stem + '_by_trials'] == by
            assert sum(g for g, _ in by.values()) == gens
    if case == 'flow':
        assert eight.run_stats['rejection_flow_generations'] >= 2
    if halves is not None:
        d1 = one.run_stats[halves + '_dispatches']
        d8 = eight.run_stats[halves + '_dispatches']
        assert 2 * d8 <= d1, (d1, d8)


@pytest.mark.parametrize('outcome', ['won', 'lost'])
def test_speculation(outcome):
    """Won (the NLL gate skips every retrain): equal to the run without
    speculation, in fewer Metropolis dispatches, nothing lost. Lost (every
    boundary retrains): the generator set back to the dropped generations'
    start regenerates them, equal to one generation a dispatch."""
    threshold = 1e9 if outcome == 'won' else -1e9
    runs = {}
    for spec in (False, True):
        s = _sampler()
        s.run(**RUN, **SWITCH, retrain_nll_threshold=threshold,
              mcmc_speculate=spec, mcmc_gen_batch=8 if spec or
              outcome == 'won' else 1)
        runs[spec] = s
    assert _final(runs[False]) == _final(runs[True])
    np.testing.assert_array_equal(runs[False].samples, runs[True].samples)
    if outcome == 'won':
        assert runs[True].run_stats['speculation_losses'] == 0
        assert runs[True]._spec_losses == 0
        assert (runs[True].run_stats['mcmc_dispatches']
                < runs[False].run_stats['mcmc_dispatches'])
    else:
        assert runs[True]._spec_losses > 0
        assert runs[True].run_stats['speculation_losses'] > 0


def test_desync_raises():
    """A buffered generation that did not start where the host's replay
    stands stops the run."""
    s = _sampler()
    batch = s._mcmc_generations_batch

    def shifted(*args, **kwargs):
        gens = batch(*args, **kwargs)
        return [(out, lstar, it + 1, state) for out, lstar, it, state in gens]

    s._mcmc_generations_batch = shifted
    with pytest.raises(RuntimeError, match='prefetch desync'):
        s.run(**RUN, **SWITCH)


def test_one_rank_mesh_dispatches_one_generation_at_a_time():
    from nnest_torch.parallel import get_mesh
    runs = []
    for mesh in (None, get_mesh()):
        s = _sampler(mesh=mesh)
        s.run(**RUN, **SWITCH)
        runs.append(s)
    assert _final(runs[0]) == _final(runs[1])
    meshed = runs[1].run_stats
    for stem in ('rejection', 'mcmc'):
        assert meshed[stem + '_dispatches'] == meshed[stem + '_generations']
    assert runs[0].run_stats['mcmc_dispatches'] < meshed['mcmc_dispatches']


def test_dynamic_batch_takes_the_prefetch_path(monkeypatch):
    calls = []
    batch = NestedSampler._mcmc_generations_batch

    def counted(self, *args, **kwargs):
        calls.append(kwargs.get('speculate'))
        return batch(self, *args, **kwargs)

    monkeypatch.setattr(NestedSampler, '_mcmc_generations_batch', counted)
    s = DynamicNestedSampler(2, LIKE, transform=lambda u: 3.0 * u,
                             num_live_init=40, log_dir=None, device='cpu',
                             log_level=30)
    s.run(G=0.5, num_batches=1, num_live_batch=20, dlogz=0.5, train_iters=5,
          mcmc_num_chains=6, mcmc_steps=4, volume_switch=0.5)
    assert calls and np.isfinite(s.logz)


# ------------------------------------------------------------------ resume

@functools.lru_cache(maxsize=None)
def _uninterrupted(speculate):
    """(logz, h, total_calls, niter) of the resume tests' run, whole."""
    s = _sampler(trainer=_trainer())
    s.run(**RESUME_RUN, mcmc_speculate=speculate)
    return s.logz, s.h, s.total_calls, s.niter


RESUME_RUN = dict(RUN, **SWITCH, log_interval=10, rejection_batch_size=32)


@pytest.mark.parametrize('case', ['buffered', 'speculating', 'no_buffers'])
def test_resume_inside_a_buffer_is_bit_exact(tmp_path, case):
    """Killed at max_iters with Metropolis generations still buffered,
    resumed by a sampler with another seed: the uninterrupted run's
    numbers, with speculation off and on. 'no_buffers': a run at one
    generation a dispatch, its checkpoint stripped of the buffer keys (as
    checkpoints written before the prefetch are), resumes at the defaults
    to the same numbers."""
    kw = dict(RESUME_RUN, mcmc_speculate=case == 'speculating')
    killed = str(tmp_path / 'killed')
    one = (dict(mcmc_gen_batch=1, rejection_gen_batch=1)
           if case == 'no_buffers' else {})
    s_b = _sampler(log_dir=killed, append_run_num=False, resume=True)
    s_b.run(max_iters=80, **kw, **one)
    s_b._drain_io()
    path = os.path.join(killed, 'checkpoint', EXACT_STATE)
    es = torch.load(path, weights_only=True)
    assert es['it'] == 80
    if case == 'no_buffers':
        for key in ('mcmc_buf', 'prior_buf', 'flow_buf'):
            assert es['pool'].pop(key) == []
        torch.save(es, path)
    else:
        assert es['pool']['mcmc_buf']
    s_c = _sampler(seed=99, log_dir=killed, append_run_num=False,
                   resume=True)
    s_c.run(**kw)
    assert (s_c.logz, s_c.h, s_c.total_calls, s_c.niter) == \
        _uninterrupted(case == 'speculating')
