"""nnest_torch's ensemble kernel and EnsembleSampler against nnest_tpu.

The kernel: the reference's draws are rebuilt with ``jax.random`` from the
key splits of ``nnest_tpu.samplers.kernels._stretch_impl`` (``split(key,
steps)``; ``k1, k2, km = split(k, 3)`` a step, the move from
``categorical(km, log_weights)``; ``kp, ku = split(k_half)`` a half-update;
then each move's own splits of ``kp``) and laid out as ``stretch_draws``
lays out the port's; ``stretch_body`` on them, with the same Cholesky flow
and walkers, must give nnest_tpu's trajectory: z and x within 1e-5, the
log probabilities and log likelihoods within 1e-4, the same accept flags
at every step. A decision within 1e-4 of its threshold is counted; none
occurs at the test's seeds. Each move is also held, statistically, to the
numpy oracle of tests/test_move_oracles.py (copied here) on the same latent
target.

The sampler: posterior moments on the 2-D Gaussian of tests/test_samplers.py,
the bootstrap's checkpoints, bit-exact resume and its fall-backs, the
re-thin and the ``emcee.h5`` seeding."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnest_tpu.samplers import kernels as jk
from nnest_torch import EnsembleSampler
from nnest_torch.flows import build_flow
from nnest_torch.likelihoods import Gaussian
from nnest_torch.priors import UniformPrior
from nnest_torch.samplers import kernels as tk
from nnest_torch.samplers.ensemble import real_space_stretch
from tests.test_torch_kernels import (_jax_like, _jax_prior, _port_like,
                                      _port_prior)
from tests.test_torch_other_flows import other_flow_pair

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

WALKERS, STEPS, DIM = 16, 6, 4
NEAR = 1e-4
MIX = (('stretch', 0.4), ('de', 0.2), ('snooker', 0.2), ('kde', 0.2))


@pytest.fixture(scope='module')
def cholesky_pair():
    jm, params, tm = other_flow_pair(DIM, 'cholesky', seed=3)
    return (jk.LatentKernels(jm, _jax_like, _jax_prior), params,
            tk.LatentKernels(tm, _port_like, _port_prior), tm)


def _jax_draws(key, moves, walkers=WALKERS, steps=STEPS, dim=DIM):
    """``_stretch_impl``'s draws on ``key`` in ``stretch_draws``' layout."""
    n = walkers // 2
    weights = jnp.asarray([w for _, w in moves], jnp.float32)
    log_weights = jnp.log(weights / jnp.sum(weights))
    out = {k: [] for k in ('move', 'idx', 'zeta', 'normal', 'accept')}
    for k in jax.random.split(key, steps):
        k1, k2, km = jax.random.split(k, 3)
        move = int(jax.random.categorical(km, log_weights))
        name = moves[move][0]
        halves = []
        for kh in (k1, k2):
            kp, ku = jax.random.split(kh)
            idx = np.zeros((3, n), np.int64)
            zeta = np.zeros(n, np.float32)
            normal = np.zeros((n, dim), np.float32)
            if name == 'stretch':
                kz, kc = jax.random.split(kp)
                zeta = jax.random.uniform(kz, (n,))
                idx[0] = jax.random.randint(kc, (n,), 0, n)
            elif name == 'snooker':
                for j, kj in enumerate(jax.random.split(kp, 3)):
                    idx[j] = jax.random.randint(kj, (n,), 0, n)
            else:   # de: ka, kb, ke; kde: kc, ke
                ks = jax.random.split(kp, 3 if name == 'de' else 2)
                for j, kj in enumerate(ks[:-1]):
                    idx[j] = jax.random.randint(kj, (n,), 0, n)
                normal = jax.random.normal(ks[-1], (n, dim))
            halves.append((idx, np.array(zeta), np.array(normal),
                           np.array(jax.random.uniform(ku, (n,)))))
        out['move'].append(move)
        for key_, part in zip(('idx', 'zeta', 'normal', 'accept'),
                              zip(*halves)):
            out[key_].append(np.stack(part))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize('moves,loglstar', [
    ((('stretch', 1.0),), None), ((('de', 1.0),), None),
    ((('snooker', 1.0),), None), ((('kde', 1.0),), None), (MIX, None),
    ((('stretch', 1.0),), -1.5)])
def test_stretch_body_matches_jax(cholesky_pair, monkeypatch, moves,
                                  loglstar):
    jkern, params, tkern, tm = cholesky_pair
    rs = np.random.RandomState(11)
    x0 = np.clip(0.4 * rs.normal(size=(WALKERS, DIM)), -1.0, 1.0).astype(
        np.float32)
    with torch.no_grad():
        z0 = tm(torch.from_numpy(x0))[0].numpy()
    key = jax.random.PRNGKey(17)
    ref = jkern.stretch(params, key, z0, mcmc_steps=STEPS, loglstar=loglstar,
                        moves=moves)
    ref = {k: np.asarray(v) for k, v in ref.items()}

    margins = []
    real_mask = tk._accept_mask

    def recording(u, log_ratio):
        margins.append(torch.abs(
            u - torch.exp(torch.clamp(log_ratio, max=0.0))).min())
        return real_mask(u, log_ratio)

    monkeypatch.setattr(tk, '_accept_mask', recording)
    logls = []
    real_like = tkern.like_fn

    def recording_like(u):
        out = real_like(u)
        logls.append(out[0])
        return out

    monkeypatch.setattr(tkern, 'like_fn', recording_like)
    draws = _jax_draws(key, moves)
    got = tkern.stretch_body(draws, torch.from_numpy(z0), loglstar=loglstar,
                             moves=moves)
    got = {k: v.numpy() if isinstance(v, torch.Tensor) else v
           for k, v in got.items()}
    near = sum(float(m) < NEAR for m in margins)
    if loglstar is not None:
        near += sum(int((torch.abs(ll - loglstar) < NEAR).sum())
                    for ll in logls)
    assert near == 0, near

    assert set(got) == set(ref) - {'derived'}
    for k, tol in (('latent', 1e-5), ('samples', 1e-5), ('log_probs', 1e-4),
                   ('loglikes', 1e-4)):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=tol,
                                   err_msg=k)

    def flags(latent):   # which walkers moved at each step
        return np.any(latent[:, 1:] != latent[:, :-1], axis=2)

    np.testing.assert_array_equal(flags(got['latent']), flags(ref['latent']))
    # (a snooker move whose two partners coincide proposes the walker's
    # own position: accepted, but not moved)
    for k in ('accepted', 'rejected', 'ncall'):
        assert int(got[k]) == int(ref[k]), k
    assert 0 < int(got['accepted']) < STEPS * WALKERS
    if len(moves) > 1:   # the steps take more than one move
        assert len(set(draws['move'].tolist())) > 1


def test_stretch_is_its_draws_then_its_body(cholesky_pair):
    _, _, tkern, _ = cholesky_pair
    z0 = 0.3 * torch.randn(WALKERS, DIM, generator=torch.Generator()
                           .manual_seed(2))
    out = tkern.stretch(torch.Generator().manual_seed(4), z0, mcmc_steps=5,
                        moves=MIX)
    g = torch.Generator().manual_seed(4)
    draws = tkern.stretch_draws(g, 5, WALKERS, DIM, MIX)
    assert draws['idx'].shape == (5, 2, 3, WALKERS // 2)
    assert draws['normal'].shape == (5, 2, WALKERS // 2, DIM)
    assert int(draws['idx'].max()) < WALKERS // 2
    body = tkern.stretch_body(draws, z0, moves=MIX)
    for k in out:
        assert torch.equal(torch.as_tensor(out[k]),
                           torch.as_tensor(body[k])), k
    with pytest.raises(ValueError, match='even number of walkers'):
        tkern.stretch_draws(g, 5, WALKERS + 1, DIM)
    with pytest.raises(ValueError, match='unknown ensemble move'):
        tkern.stretch_body(draws, z0, moves=(('walk', 1.0),))


# ------------------------------------------------------------- oracle ---
# tests/test_move_oracles.py's numpy oracle: the published proposal
# algorithms in a red-black half-ensemble update on the kernel's target.

ORACLE_WALKERS, ORACLE_STEPS, BURN = 64, 500, 150


def _oracle_propose(name, rng, s, c):
    """Published proposal algorithms; returns (proposal, log MH factor)."""
    n, dim = s.shape
    m = c.shape[0]
    if name == 'stretch':
        a = 2.0
        u = rng.uniform(size=n)
        zeta = ((a - 1.0) * u + 1.0) ** 2 / a
        partner = c[rng.randint(0, m, size=n)]
        prop = partner + zeta[:, None] * (s - partner)
        return prop, (dim - 1.0) * np.log(zeta)
    if name == 'de':
        g0 = 2.38 / np.sqrt(2.0 * dim)
        za = c[rng.randint(0, m, size=n)]
        zb = c[rng.randint(0, m, size=n)]
        prop = s + g0 * (za - zb) + 1e-5 * rng.normal(size=s.shape)
        return prop, np.zeros(n)
    if name == 'snooker':
        z = c[rng.randint(0, m, size=n)]
        z1 = c[rng.randint(0, m, size=n)]
        z2 = c[rng.randint(0, m, size=n)]
        d_vec = s - z
        norm = np.maximum(np.linalg.norm(d_vec, axis=1, keepdims=True),
                          1e-12)
        u = d_vec / norm
        proj = np.sum((z1 - z2) * u, axis=1, keepdims=True)
        prop = s + 1.7 * proj * u
        norm_new = np.maximum(np.linalg.norm(prop - z, axis=1), 1e-12)
        return prop, (dim - 1.0) * (np.log(norm_new) - np.log(norm[:, 0]))
    if name == 'kde':
        h = (np.std(c, axis=0) + 1e-6) * m ** (-1.0 / (dim + 4))
        center = c[rng.randint(0, m, size=n)]
        prop = center + h * rng.normal(size=s.shape)

        def logq(pts):
            d2 = np.sum(((pts[:, None, :] - c[None, :, :]) / h) ** 2,
                        axis=2)
            mx = -0.5 * np.min(d2, axis=1)
            lse = mx + np.log(np.sum(np.exp(-0.5 * d2 - mx[:, None]),
                                     axis=1))
            return (lse - np.log(m) - np.sum(np.log(h))
                    - 0.5 * dim * np.log(2.0 * np.pi))

        return prop, logq(s) - logq(prop)
    raise ValueError(name)


def _oracle_run(name, lp_fn, z0, steps, seed):
    rng = np.random.RandomState(seed)
    z = np.array(z0, dtype=np.float64)
    half = z.shape[0] // 2
    lp = lp_fn(z)
    chains = [z.copy()]
    n_acc = 0
    for _ in range(steps):
        for lo, hi, other in ((0, half, slice(half, None)),
                              (half, None, slice(0, half))):
            sl = slice(lo, hi)
            prop, extra = _oracle_propose(name, rng, z[sl], z[other])
            lp_prop = lp_fn(prop)
            acc = rng.uniform(size=prop.shape[0]) < np.exp(
                np.minimum(extra + lp_prop - lp[sl], 0.0))
            z[sl][acc] = prop[acc]
            lp[sl][acc] = lp_prop[acc]
            n_acc += int(acc.sum())
        chains.append(z.copy())
    return np.stack(chains, axis=1), n_acc / (steps * z.shape[0])


@pytest.fixture(scope='module')
def oracle_kernels():
    model = build_flow(DIM, flow='cholesky', seed=0, device='cpu')
    model.data_init(torch.from_numpy(
        np.random.RandomState(0).normal(size=(64, DIM)).astype(np.float32)))
    kern = tk.LatentKernels(model, lambda u: -0.5 * torch.sum(u ** 2, -1),
                            lambda u: torch.zeros(u.shape[0]))

    def lp_fn(z):
        with torch.no_grad():
            return kern.latent_log_prob(torch.as_tensor(
                z, dtype=torch.float32))[0].numpy().astype(np.float64)

    return kern, lp_fn


@pytest.mark.parametrize('move', ['stretch', 'de', 'snooker', 'kde'])
def test_move_matches_numpy_oracle(oracle_kernels, move):
    kern, lp_fn = oracle_kernels
    z0 = torch.randn(ORACLE_WALKERS, DIM,
                     generator=torch.Generator().manual_seed(5))
    out = kern.stretch(torch.Generator().manual_seed(6), z0,
                       mcmc_steps=ORACLE_STEPS, moves=((move, 1.0),))
    kern_acc = int(out['accepted']) / (ORACLE_STEPS * ORACLE_WALKERS)
    kern_z = out['latent'][:, BURN:, :].reshape(-1, DIM).numpy()
    orc_chains, orc_acc = _oracle_run(move, lp_fn, z0.numpy(), ORACLE_STEPS,
                                      seed=7)
    orc_z = orc_chains[:, BURN:, :].reshape(-1, DIM)
    assert abs(kern_acc - orc_acc) < 0.06, (move, kern_acc, orc_acc)
    assert np.allclose(kern_z.mean(0), orc_z.mean(0), atol=0.15), move
    assert np.allclose(kern_z.std(0), orc_z.std(0), atol=0.15), move


def test_real_space_stretch_targets_the_density():
    """Phase 0's real-space ensemble on a 2-D normal (mean 1, std 2)."""
    g = torch.Generator().manual_seed(0)
    x0 = 0.1 * torch.randn(64, 2, generator=g)
    chains, lps, n_acc = real_space_stretch(
        lambda x: -0.5 * torch.sum(((x - 1.0) / 2.0) ** 2, dim=-1), g, x0,
        400)
    assert chains.shape == (64, 401, 2) and lps.shape == (64, 401)
    x = chains[:, 100:].reshape(-1, 2).numpy()
    assert np.all(np.abs(x.mean(axis=0) - 1.0) < 0.25)
    assert np.all(np.abs(x.std(axis=0) - 2.0) < 0.25)
    assert 0.3 < int(n_acc) / (400 * 64) < 0.9
    with pytest.raises(ValueError, match='even number of walkers'):
        real_space_stretch(lambda x: x[:, 0], g, x0[:3], 2)


# ------------------------------------------------------------ sampler ---

@pytest.fixture(scope='module')
def training():
    return np.random.RandomState(0).normal(size=(800, 2))


def _prior():
    """A fresh, identically seeded prior: its host generator advances on
    phase 0's draws."""
    prior = UniformPrior(2, -5, 5)
    prior.seed(0)
    return prior


def _sampler(path, seed, **kw):
    return EnsembleSampler(2, Gaussian(2, 0.0, lim=5), prior=_prior(),
                           log_dir=str(path), append_run_num=False,
                           seed=seed, device='cpu', **kw)


def test_ensemble_sampler_run(tmp_path, training):
    s = _sampler(tmp_path, 2)
    out = s.run(300, 32, training, train_iters=5)
    assert out.shape == (32, 301, 2)
    samp = out[:, 100:, :].reshape(-1, 2)
    assert np.all(np.abs(samp.mean(axis=0)) < 0.2)
    assert np.all(np.abs(samp.std(axis=0) - 1.0) < 0.2)
    assert s.latent_samples.shape == (32, 301, 2)
    assert s.total_calls == 300 * 32
    assert s.total_accepted + s.total_rejected == 300 * 32


def test_bootstrap_resume_is_bit_exact(tmp_path):
    """The uninterrupted bootstrap (iters=2) against one killed after
    iters=1 and resumed to iters=2 by a sampler with another seed: the
    same training set and likelihood calls, bit for bit. The uninterrupted
    run's phases are checkpointed and its last training set has the
    posterior's moments."""
    kw = dict(thin=5, train_iters=3,
              moves={'stretch': 0.6, 'de': 0.2, 'snooker': 0.1, 'kde': 0.1})
    whole = _sampler(tmp_path / 'whole', 3)
    out = whole.bootstrap(100, 32, iters=2, **kw)
    assert out.shape[1] == 2 and out.shape[0] > 100
    assert np.all(np.abs(out.mean(axis=0)) < 0.35)
    assert np.all(np.abs(out.std(axis=0) - 1.0) < 0.35)
    assert sorted(os.listdir(whole.logs['checkpoint'])) == [
        'bootstrap_%d.pt' % p for p in (0, 1, 2)]
    assert whole.total_calls == 3 * 100 * 32

    _sampler(tmp_path / 'killed', 3).bootstrap(100, 32, iters=1, **kw)
    resumed = _sampler(tmp_path / 'killed', 99)
    again = resumed.bootstrap(100, 32, iters=2, resume=True, **kw)
    np.testing.assert_array_equal(again, out)
    assert resumed.total_calls == whole.total_calls
    assert resumed.total_accepted == whole.total_accepted
    # a completed bootstrap resumes to its last training set at once
    done = _sampler(tmp_path / 'killed', 5)
    np.testing.assert_array_equal(
        done.bootstrap(100, 32, iters=2, resume=True, **kw), out)
    assert done.total_calls == whole.total_calls


def test_corrupt_bootstrap_checkpoints(tmp_path):
    s = _sampler(tmp_path, 4)
    chains = np.random.RandomState(1).normal(size=(4, 10, 2))
    s.total_calls = 10
    s._bootstrap_save(0, chains, chains[:, 5:].reshape(-1, 2))
    state0 = s.generator.get_state()
    torch.rand(3, generator=s.generator)
    s.total_calls = 20
    s._bootstrap_save(1, chains, chains[:, ::2].reshape(-1, 2))
    ck = s.logs['checkpoint']
    # a corrupted newest phase falls back to the older one
    with open(os.path.join(ck, 'bootstrap_1.pt'), 'wb') as f:
        f.write(b'PK corrupt')
    fresh = _sampler(tmp_path, 8)
    phase, ts = fresh._bootstrap_load_latest(10)
    assert phase == 0
    np.testing.assert_array_equal(ts, chains[:, 5:].reshape(-1, 2))
    assert fresh.total_calls == 10
    assert torch.equal(fresh.generator.get_state(), state0)
    # a file that loads but lacks fields restores nothing
    for p in (0, 1):
        torch.save({'generator': torch.Generator().manual_seed(7)
                    .get_state(), 'total_calls': 99},
                   os.path.join(ck, 'bootstrap_%d.pt' % p))
    other = _sampler(tmp_path, 9)
    before = (other.generator.get_state(),
              other.trainer.snapshot_state()['model'])
    assert other._bootstrap_load_latest(10) is None
    assert torch.equal(other.generator.get_state(), before[0])
    assert other.total_calls == 0
    after = other.trainer.snapshot_state()['model']
    assert all(torch.equal(after[k], before[1][k]) for k in after)


def test_make_single_samples(tmp_path):
    """The re-thin keeps each row with probability 1/thin from the
    sampler's generator: the same generator state gives the same rows,
    every row is a row of the chains, about n/thin survive, consecutive
    draws differ, and an absurd thin falls back to the stride."""
    chains = np.random.RandomState(5).normal(size=(8, 100, 2))
    flat = chains.reshape(-1, 2)
    out = _sampler(tmp_path / 'a', 11)._make_single_samples(chains, 4)
    np.testing.assert_array_equal(
        out, _sampler(tmp_path / 'b', 11)._make_single_samples(chains, 4))
    rows = {tuple(r) for r in flat}
    assert all(tuple(r) in rows for r in out)
    assert 0.5 * flat.shape[0] / 4 <= out.shape[0] <= 2 * flat.shape[0] / 4
    s = _sampler(tmp_path / 'c', 12)
    a = s._make_single_samples(chains, 4)
    b = s._make_single_samples(chains, 4)
    assert a.shape != b.shape or not np.array_equal(a, b)
    np.testing.assert_array_equal(
        _sampler(tmp_path / 'd', 13)._make_single_samples(chains, 10 ** 6),
        chains[:, ::10 ** 6, :].reshape(-1, 2))


def test_emcee_h5_seeds_phase0(tmp_path):
    h5py = pytest.importorskip('h5py')
    s = _sampler(tmp_path / 'seed', 4)
    chain = np.random.RandomState(0).normal(size=(60, 16, 2))

    def write(path):
        with h5py.File(path, 'w') as f:
            g = f.create_group('mcmc')
            g.create_dataset('chain', data=chain)
            g.attrs['iteration'] = 60

    write(os.path.join(s.log_dir, 'emcee.h5'))
    out = s.bootstrap(40, 16, iters=1, thin=3, train_iters=2)
    # phase 0 came from the file: only phase 1's ensemble paid calls
    assert s.total_calls == 40 * 16
    assert out.shape[1] == 2
    seeded = torch.load(os.path.join(s.logs['checkpoint'], 'bootstrap_0.pt'),
                        weights_only=True)
    np.testing.assert_array_equal(seeded['chains'].numpy(),
                                  np.transpose(chain, (1, 0, 2)))
    bad = EnsembleSampler(3, Gaussian(3, 0.0, lim=5),
                          prior=UniformPrior(3, -5, 5), append_run_num=False,
                          log_dir=str(tmp_path / 'bad'), seed=4,
                          device='cpu')
    write(os.path.join(bad.log_dir, 'emcee.h5'))
    with pytest.raises(ValueError, match='does not match x_dim'):
        bad.bootstrap(40, 16, iters=1, thin=3)
