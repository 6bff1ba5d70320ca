"""Derived parameters in nnest_torch against nnest_tpu.

A likelihood may return ``(logl, derived)`` with ``num_derived`` columns.
The host wrapper ``Sampler.loglike`` is held to nnest_tpu's on the same
numpy likelihoods (lists, single points, non-finite clamping, its two
``ValueError``s, float64 derived values equal to 1e-12); the probe sorts a
tuple by its first element. The kernels carry the derived values of the
point they keep: the Metropolis kernel (full MH and constrained, endpoint
and collect-chains modes), the slice body and the ensemble's stretch body
on JAX's own draws (the draw helpers of the port's kernel tests) give
nnest_tpu's derived values within 1e-4 absolute at 2-D, beside x and logl
at those tests' tolerances, and a decision within 1e-4 of its threshold is
counted (none occurs at these seeds). The rejection and flow-density
bodies return their candidates' derived values. End to end on the 2-D
Gaussian, with a torch and with a numpy likelihood returning (sum x, prod
x): samples with 4 columns whose derived columns are the function of the
parameter columns to 1e-4, ``chain.txt`` under the ``param_names`` header,
and a killed run resumed to the uninterrupted (logz, h, total_calls, niter,
samples) exactly. The dynamic sampler's seed draw takes its derived values
from the parts as nnest_tpu's does; the posterior samplers' samples have
x_dim + num_derived columns."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnest_tpu.priors import UniformPrior as JaxUniformPrior
from nnest_tpu.samplers import kernels as jk
from nnest_tpu.samplers.base import Sampler as JaxSampler
from nnest_tpu.samplers.dynamic import DynamicNestedSampler as JaxDynamic
from nnest_torch import (DynamicNestedSampler, EnsembleSampler, MCMCSampler,
                         NestedSampler)
from nnest_torch.priors import UniformPrior
from nnest_torch.samplers import kernels as tk
from nnest_torch.samplers.base import Sampler, _returns_tensor
from nnest_torch.utils.evaluation import merge_runs
from tests.test_torch_dynamic import _parts, _Refresh
from tests.test_torch_ensemble import MIX
from tests.test_torch_ensemble import _jax_draws as stretch_draws
from tests.test_torch_flows import flow_pair
from tests.test_torch_kernels import _jax_prior, _port_prior
from tests.test_torch_mcmc_sampler import _jax_draws as mcmc_draws
from tests.test_torch_slice import MAX_EXPAND, MAX_SHRINK, _near_chains
from tests.test_torch_slice import _jax_draws as slice_draws

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

D, ND = 2, 2
TOL_DERIVED = 1e-4
NEAR = 1e-4
NAMES = ['x0', 'x1', 'd_sum', 'd_prod']
RUN = dict(train_iters=30, mcmc_num_chains=10, mcmc_steps=10,
           rejection_batch_size=32, dlogz=0.5, volume_switch=0.5)


def _derived_np(x):
    x = np.asarray(x, dtype=np.float64)
    return np.stack([np.sum(x, axis=-1), np.prod(x, axis=-1)], axis=-1)


def _jax_like(u):
    return (-0.5 * jnp.sum(u ** 2, axis=-1),
            jnp.stack([jnp.sum(u, axis=-1), jnp.prod(u, axis=-1)], axis=-1))


def torch_like(x):
    return (-0.5 * torch.sum(x ** 2, dim=-1),
            torch.stack([torch.sum(x, dim=-1), torch.prod(x, dim=-1)],
                        dim=-1))


def numpy_like(x):
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    return -0.5 * np.sum(x ** 2, axis=1), _derived_np(x)


@pytest.fixture(scope='module')
def derived_pair():
    jm, params, tm = flow_pair(D)
    return (jk.LatentKernels(jm, _jax_like, _jax_prior, num_derived=ND),
            params,
            tk.LatentKernels(tm, torch_like, _port_prior, num_derived=ND), tm)


# --------------------------------------------------------------- wrappers

def _pair(loglike, num_derived):
    ref = JaxSampler(D, loglike, prior=JaxUniformPrior(D, -5, 5),
                     num_derived=num_derived, log_dir=None, seed=0)
    port = Sampler(D, loglike, prior=UniformPrior(D, -5, 5),
                   num_derived=num_derived, log_dir=None, device='cpu')
    return ref, port


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def test_wrapper_lists_single_points_and_derived_match_jax():
    ref, port = _pair(numpy_like, ND)
    assert port._host_loglike and port.num_params == D + ND
    for u in ([[1.0, 2.0], [0.0, 0.0]], np.array([1.0, 2.0]),
              np.array([[1e-3, -7.5], [3.0, 1e-12], [-2.0, 0.25]])):
        got, want = port.loglike(u), ref.loglike(u)
        assert got[1].shape == (np.atleast_2d(u).shape[0], ND)
        _same(got, want)
    assert port.total_calls == ref.total_calls == 6


def test_wrapper_clamps_nonfinite_logl_and_keeps_derived():
    def like(x):
        logl, derived = numpy_like(x)
        logl[0], logl[1] = np.nan, np.inf
        return logl, derived

    ref, port = _pair(like, ND)
    u = np.array([[0.5, 0.5], [1.0, -1.0], [0.1, 0.2]])
    got = port.loglike(u)
    _same(got, ref.loglike(u))
    assert got[0][0] == got[0][1] == -1e100
    np.testing.assert_array_equal(got[1], _derived_np(u))


@pytest.mark.parametrize('make', [lambda n: np.zeros(n),
                                  lambda n: np.zeros((n, 3))],
                         ids=['one_dimensional', 'wrong_count'])
def test_wrapper_derived_shape_errors_match_jax(make):
    def like(x):
        x = np.asarray(x)
        return -np.sum(x ** 2, axis=1), make(x.shape[0])

    ref, port = _pair(like, 1)
    with pytest.raises(ValueError) as want:
        ref.loglike(np.zeros((2, 2)))
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        port.loglike(np.zeros((2, 2)))

    # a tensor likelihood's derived shape is checked once, when built
    def tensor_like(x):
        return -torch.sum(x ** 2, dim=1), torch.as_tensor(make(x.shape[0]))

    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        Sampler(D, tensor_like, num_derived=1, log_dir=None, device='cpu')


def test_logl_alone_gets_zero_derived_columns():
    def like(x):
        return numpy_like(x)[0]

    ref, port = _pair(like, ND)
    u = np.array([[0.1, 0.2], [0.3, -0.4]])
    _same(port.loglike(u), ref.loglike(u))
    assert np.all(port.loglike(u)[1] == 0.0)
    alone = Sampler(D, lambda x: torch_like(x)[0], num_derived=ND,
                    log_dir=None, device='cpu')
    logl, derived = alone.loglike(u)
    assert not alone._host_loglike and derived.shape == (2, ND)
    assert np.all(derived == 0.0)


def test_probe_sorts_tuples_by_their_logl():
    cpu = torch.device('cpu')
    assert _returns_tensor(torch_like, D, cpu)
    assert not _returns_tensor(numpy_like, D, cpu)
    u = np.array([[0.1, -0.7], [0.6, 0.3], [-0.2, 0.9]])
    device = Sampler(D, torch_like, num_derived=ND, log_dir=None,
                     device='cpu')
    host = Sampler(D, numpy_like, num_derived=ND, log_dir=None, device='cpu')
    assert not device._host_loglike and host._host_loglike
    assert device.total_calls == host.total_calls == 0
    for s in (device, host):
        logl, derived = s.loglike(u)
        assert derived.dtype == np.float64
        np.testing.assert_allclose(derived, _derived_np(u), rtol=1e-6,
                                   atol=1e-7)
    # inside the kernels: float32 on the device, a host likelihood's
    # derived values through float32 once
    for s in (device, host):
        logl, derived = s.kernels.like_fn(torch.tensor(u, dtype=torch.float32))
        assert derived.dtype == torch.float32 and derived.shape == (3, ND)
    np.testing.assert_array_equal(
        host.kernels.like_fn(torch.tensor(u, dtype=torch.float32))[1].numpy(),
        _derived_np(u.astype(np.float32)).astype(np.float32))


# ---------------------------------------------------------------- kernels

def _starts(tm, n, seed):
    rs = np.random.RandomState(seed)
    x0 = np.clip(0.5 * rs.normal(size=(n, D)), -1.0, 1.0).astype(np.float32)
    with torch.no_grad():
        z0 = tm(torch.from_numpy(x0))[0].numpy()
    logl0 = (-0.5 * np.sum(x0 ** 2, axis=1)).astype(np.float32)
    return x0, z0, logl0, _derived_np(x0).astype(np.float32)


def _record(monkeypatch, tkern):
    """Record the accept margins and log likelihoods of a kernel call."""
    margins, logls = [], []
    real_mask, real_like = tk._accept_mask, tkern.like_fn

    def mask(u, log_ratio):
        margins.append(torch.abs(
            u - torch.exp(torch.clamp(log_ratio, max=0.0))).min())
        return real_mask(u, log_ratio)

    def like(u):
        out = real_like(u)
        logls.append(out[0])
        return out

    monkeypatch.setattr(tk, '_accept_mask', mask)
    monkeypatch.setattr(tkern, 'like_fn', like)
    return margins, logls


def _near(margins, logls, loglstar):
    near = sum(float(m) < NEAR for m in margins)
    if loglstar is not None:
        near += sum(int((torch.abs(ll - loglstar) < NEAR).sum())
                    for ll in logls)
    return near


def _numpy(out):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


@pytest.mark.parametrize('loglstar,proposals', [(None, 1), (-1.5, 2)],
                         ids=['full_mh', 'constrained'])
def test_mcmc_carries_derived_as_jax(derived_pair, monkeypatch, loglstar,
                                     proposals):
    """The collect-chains trajectory against JAX's, then the endpoint mode
    on the same draws, which must end where the trajectory ends."""
    jkern, params, tkern, tm = derived_pair
    chains, steps = 32, 20
    _, z0, logl0, d0 = _starts(tm, chains, 4)
    lp0 = np.zeros(chains, np.float32)
    key = jax.random.PRNGKey(8)
    ref = _numpy({k: np.asarray(v) for k, v in jkern.mcmc(
        params, key, z0, logl0, d0, lp0, loglstar=loglstar, step_size=0.6,
        mcmc_steps=steps, dynamic_step_size=True,
        prior_volume_steps=proposals, collect_chains=True).items()})
    margins, logls = _record(monkeypatch, tkern)

    def run(collect):
        return _numpy(tkern.mcmc(
            None, torch.from_numpy(z0), torch.from_numpy(logl0),
            torch.from_numpy(lp0), derived0=torch.from_numpy(d0),
            loglstar=loglstar, step_size=0.6, mcmc_steps=steps,
            dynamic_step_size=True, prior_volume_steps=proposals,
            collect_chains=collect,
            draws=mcmc_draws(key, loglstar is not None, proposals,
                             chains=chains, steps=steps, dim=D)))

    got = run(True)
    assert _near(margins, logls, loglstar) == 0
    assert set(got) == set(ref)
    assert got['derived'].shape == (chains, steps + 1, ND)
    for k, tol in (('samples', 1e-5), ('latent', 1e-5), ('loglikes', 1e-4),
                   ('derived', TOL_DERIVED)):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=tol,
                                   err_msg=k)
    for k in ('accepted', 'rejected', 'ncall'):
        assert int(got[k]) == int(ref[k]), k
    assert 0 < int(got['accepted']) < steps * chains
    # each kept point keeps its own derived values (the starts' are of x0,
    # which the flow's round trip moves by ~1e-6)
    np.testing.assert_allclose(got['derived'], _derived_np(got['samples']),
                               rtol=0, atol=1e-5)
    end = run(False)
    assert 'derived' not in end and end['final_derived'].shape == (chains,
                                                                    ND)
    np.testing.assert_array_equal(end['final_derived'],
                                  got['derived'][:, -1])
    np.testing.assert_array_equal(end['final_x'], got['samples'][:, -1])


def test_slice_carries_derived_as_jax(derived_pair):
    jkern, params, tkern, tm = derived_pair
    chains, steps = 16, 3
    rs = np.random.RandomState(2)
    live = rs.uniform(-0.9, 0.9, size=(60, D)).astype(np.float32)
    logl_live = -0.5 * np.sum(live ** 2, axis=1)
    loglstar = np.float32(-0.4)
    x0 = live[logl_live > loglstar][:chains]
    with torch.no_grad():
        z0 = tm(torch.from_numpy(x0))[0].numpy()
    logl0 = (-0.5 * np.sum(x0 ** 2, axis=1)).astype(np.float32)
    d0 = _derived_np(x0).astype(np.float32)
    cov = dict(cov_from=live, cov_mask=rs.permutation(60) < 30)
    key = jax.random.PRNGKey(21)
    ref = {k: np.asarray(v) for k, v in jkern.slice_(
        params, key, z0, logl0, d0, loglstar=loglstar, width=1.0,
        slice_steps=steps, max_expand=MAX_EXPAND, max_shrink=MAX_SHRINK,
        **cov).items()}

    calls = []
    real = tkern._in_slice

    def recording(inverse, zc, logy, ll_star):
        out = real(inverse, zc, logy, ll_star)
        calls.append({'logy': logy.numpy().copy(),
                      'full': out[1].numpy().copy(), 'x': out[2].numpy(),
                      'ldj': out[3].numpy(), 'logl': out[4].numpy()})
        return out

    draws = slice_draws(key, D, chains=chains, steps=steps)
    tkern._in_slice = recording
    try:
        got = _numpy(tkern.slice_body(
            draws, torch.from_numpy(z0), torch.from_numpy(logl0),
            loglstar=float(loglstar), width=1.0, max_expand=MAX_EXPAND,
            derived0=torch.from_numpy(d0),
            **{k: torch.from_numpy(v) for k, v in cov.items()}))
    finally:
        del tkern._in_slice
    near, _ = _near_chains(calls, draws, float(loglstar))
    assert not near.any(), near
    for k, tol in (('final_z', 1e-5), ('final_x', 1e-5),
                   ('final_logl', 1e-5), ('final_derived', TOL_DERIVED)):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=tol,
                                   err_msg=k)
    assert int(got['ncall']) == int(ref['ncall'])
    assert got['moved'].all()
    np.testing.assert_allclose(got['final_derived'],
                               _derived_np(got['final_x']), rtol=0, atol=1e-6)


@pytest.mark.parametrize('moves,loglstar', [(MIX, None),
                                            ((('stretch', 1.0),), -1.5)],
                         ids=['mix', 'constrained'])
def test_stretch_carries_derived_as_jax(derived_pair, monkeypatch, moves,
                                        loglstar):
    jkern, params, tkern, tm = derived_pair
    walkers, steps = 16, 6
    _, z0, _, _ = _starts(tm, walkers, 11)
    key = jax.random.PRNGKey(17)
    ref = {k: np.asarray(v) for k, v in jkern.stretch(
        params, key, z0, mcmc_steps=steps, loglstar=loglstar,
        moves=moves).items()}
    margins, logls = _record(monkeypatch, tkern)
    got = _numpy(tkern.stretch_body(
        stretch_draws(key, moves, walkers=walkers, steps=steps, dim=D),
        torch.from_numpy(z0), loglstar=loglstar, moves=moves))
    assert _near(margins, logls, loglstar) == 0
    assert set(got) == set(ref)
    for k, tol in (('latent', 1e-5), ('samples', 1e-5), ('loglikes', 1e-4),
                   ('log_probs', 1e-4), ('derived', TOL_DERIVED)):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=tol,
                                   err_msg=k)
    for k in ('accepted', 'rejected', 'ncall'):
        assert int(got[k]) == int(ref[k]), k
    assert 0 < int(got['accepted']) < steps * walkers
    np.testing.assert_allclose(got['derived'], _derived_np(got['samples']),
                               rtol=0, atol=1e-5)


def test_rejection_and_density_return_their_candidates_derived(
        derived_pair):
    _, _, tkern, _ = derived_pair
    g = torch.Generator().manual_seed(3)
    x, logl, derived, ok = tkern.rejection_prior(
        UniformPrior(D, -1.0, 1.0), g, -0.3, 512)
    outs = [(x, derived, ok)]
    live = torch.rand(50, D, generator=g) * 1.6 - 0.8
    mld, mr = tkern.envelope(live, 1.1)
    draws = tkern.rejection_flow_draws(g, 512, D)
    x, logl, derived, ok, _ = tkern.rejection_flow_body(*draws, -0.5, mld,
                                                        mr, 1.1)
    outs.append((x, derived, ok))
    x, logl, derived, ok, _ = tkern.density_body(
        tkern.model.base_dist.sample(512, g), -0.5)
    outs.append((x, derived, ok))
    for x, derived, ok in outs:
        assert derived.shape == (512, ND) and 0 < int(ok.sum()) < 512
        np.testing.assert_allclose(derived.numpy(), _derived_np(x.numpy()),
                                   rtol=0, atol=1e-6)
    # the sampler keeps the passing trials' rows, in float64
    s = NestedSampler(D, torch_like, num_derived=ND, num_live_points=20,
                      log_dir=None, seed=1, device='cpu')
    u, logl, derived, _ = s._rejection_prior_sample(-0.3, num_trials=256)
    assert u.shape[0] == derived.shape[0] > 0 and derived.dtype == np.float64
    assert np.all(logl > -0.3)
    np.testing.assert_allclose(derived, _derived_np(u), rtol=0, atol=1e-6)


# ---------------------------------------------------------- nested sampler

def _nested(like, log_dir, seed, **kw):
    return NestedSampler(D, like, transform=lambda u: 3.0 * u,
                         num_derived=ND, num_live_points=100,
                         log_dir=str(log_dir), param_names=NAMES, seed=seed,
                         device='cpu', **kw)


@pytest.fixture(scope='module')
def whole_run(tmp_path_factory):
    """The uninterrupted 2-D run with the torch likelihood, resumable."""
    s = _nested(torch_like, tmp_path_factory.mktemp('whole'), 7,
                append_run_num=False, resume=True)
    s.run(**RUN)
    return s


@pytest.mark.parametrize('like', [torch_like, numpy_like],
                         ids=['torch', 'numpy'])
def test_nested_run_carries_derived(tmp_path, whole_run, like):
    if like is torch_like:
        s = whole_run
    else:
        s = _nested(like, tmp_path, 3)
        s.run(**RUN)
    assert s._host_loglike == (like is numpy_like)
    assert s.run_stats['mcmc_generations'] > 0
    assert s.samples.shape == (s.loglikes.size, D + ND)
    params = s.samples[:, :D]
    np.testing.assert_allclose(s.samples[:, D:], _derived_np(params),
                               rtol=1e-4, atol=1e-4)
    assert np.all(np.abs(params) <= 3.0)
    with open(os.path.join(s.logs['chains'], 'chain.txt')) as f:
        header = f.readline()
    assert header.lstrip('#').split() == ['weight', 'minusloglike'] + NAMES
    chain = np.loadtxt(os.path.join(s.logs['chains'], 'chain.txt'))
    assert chain.shape == (s.loglikes.size, 2 + D + ND)
    np.testing.assert_allclose(chain[:, 2:], s.samples, rtol=1e-5,
                               atol=1e-300)
    with open(os.path.join(s.logs['info'], 'params.txt')) as f:
        assert json.load(f)['num_derived'] == str(ND)
    with pytest.raises(ValueError, match='param_names'):
        NestedSampler(D, like, num_derived=ND, param_names=NAMES[:D],
                      log_dir=None, device='cpu')


def test_derived_run_resumes_bit_exact(tmp_path, whole_run):
    kw = dict(append_run_num=False, resume=True)
    whole = whole_run
    killed = _nested(torch_like, tmp_path / 'killed', 7, **kw)
    killed.run(max_iters=120, **RUN)
    assert killed.niter < whole.niter
    ck = os.path.join(killed.log_dir, 'checkpoint')
    np.testing.assert_allclose(
        np.load(os.path.join(ck, 'active_derived_120.npy')),
        _derived_np(np.load(os.path.join(ck, 'active_v_120.npy'))),
        rtol=1e-4, atol=1e-4)
    resumed = _nested(torch_like, tmp_path / 'killed', 99, **kw)
    resumed.run(**RUN)
    assert (resumed.logz, resumed.h, resumed.total_calls, resumed.niter) \
        == (whole.logz, whole.h, whole.total_calls, whole.niter)
    np.testing.assert_array_equal(resumed.samples, whole.samples)


# --------------------------------------------------------- dynamic sampler

class _DerivedRefresh(_Refresh):
    """The stand-in batch sampler with derived parameters: the refresh
    returns the starts' derived values unmoved too."""
    num_derived = ND

    def _mcmc_sample_final(self, mcmc_steps, **kw):
        out = super()._mcmc_sample_final(mcmc_steps, **kw)
        return out[:2] + (kw['init_derived'],) + out[3:]


def test_seed_batch_draw_with_derived_matches_jax():
    parts = _parts()
    for p in parts:
        p['samples'] = np.hstack([p['samples'], _derived_np(p['samples'])])
    port = DynamicNestedSampler(D, numpy_like, log_dir=None, seed=5,
                                device='cpu')
    ref = JaxDynamic(D, numpy_like, log_dir=None, seed=5)
    port._parts = ref._parts = parts
    deaths = np.sort(np.concatenate([p['logl'] for p in parts]))
    floors = [DynamicNestedSampler.batch_bounds(merge_runs(parts), parts,
                                                1.0)[0],
              float(deaths[700])]
    for floor in floors:
        got, want = _DerivedRefresh(), _DerivedRefresh()
        pts = port._seed_batch(got, floor, 50, 7)
        ref_pts = ref._seed_batch(want, floor, 50, 7)
        for k in ('init_samples', 'init_loglikes', 'init_derived',
                  'loglstar'):
            np.testing.assert_array_equal(got.kw[k], want.kw[k])
        np.testing.assert_array_equal(pts['derived'], ref_pts['derived'])
        np.testing.assert_array_equal(pts['derived'],
                                      _derived_np(3.0 * pts['u']))


def test_dynamic_run_keeps_derived_columns(tmp_path):
    dyn = DynamicNestedSampler(D, torch_like, transform=lambda u: 3.0 * u,
                               num_live_init=50, num_derived=ND,
                               log_dir=str(tmp_path), seed=8, device='cpu')
    dyn.run(G=1.0, num_batches=1, num_live_batch=25, **dict(
        RUN, train_iters=10, dlogz=1.0))
    assert dyn.samples.shape == (dyn.loglikes.size, D + ND)
    np.testing.assert_allclose(dyn.samples[:, D:],
                               _derived_np(dyn.samples[:, :D]), rtol=1e-4,
                               atol=1e-4)
    chain = np.loadtxt(os.path.join(dyn.logs['chains'], 'chain.txt'))
    assert chain.shape == (dyn.loglikes.size, 2 + D + ND)


# ------------------------------------------------------ posterior samplers

@pytest.mark.parametrize('cls', [MCMCSampler, EnsembleSampler])
def test_posterior_samples_carry_derived(tmp_path, cls):
    training = np.random.RandomState(0).normal(size=(200, D))
    s = cls(D, torch_like, prior=UniformPrior(D, -5.0, 5.0), num_derived=ND,
            param_names=NAMES, log_dir=str(tmp_path), seed=1, device='cpu')
    kw = {'output_interval': 1} if cls is MCMCSampler else {}
    out = s.run(20, 8, training, train_iters=2, **kw)
    assert out.shape == (8, 21, D + ND) and out is s.samples
    np.testing.assert_allclose(out[..., D:], _derived_np(out[..., :D]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s.loglikes, -0.5 * np.sum(out[..., :D] ** 2,
                                                         axis=-1),
                               rtol=1e-4, atol=1e-4)
    if cls is MCMCSampler:
        chain = np.loadtxt(os.path.join(s.logs['chains'], 'chain_2.txt'))
        assert chain.shape == (21, 2 + D + ND)
        np.testing.assert_allclose(chain[:, 2:], out[1], rtol=1e-5,
                                   atol=1e-300)
