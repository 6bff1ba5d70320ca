"""nnest_torch.runtime (the port's native host runtime) against
nnest_tpu.runtime and the port's numpy twins, on the same arrays.

- The counterparts of tests/test_runtime.py: the ESS equal to nnest_tpu's
  native one and to the numpy twin within 1e-12 relative (and to the
  pure-Python estimator within 1e-10, as there); acceptance and jump equal
  to nnest_tpu's native ones exactly, acceptance to the numpy twin exactly
  and the jump within 1e-12 relative (numpy sums in another order); chain
  files byte-equal to nnest_tpu's native writer's and to ``np.savetxt``'s,
  with and without derived columns and a header.
- ``Sampler._save_samples``: the single file and the per-chain
  ``<outfile>_<i>.txt`` files, written natively and on the no-compiler
  path, byte-equal; the runtime's native calls and fallbacks counted.
- Four processes loading the runtime at once from an empty build directory
  all succeed, leaving one library and no temporary file.
- ``nnest_tpu.runtime`` is built for this module alone, into a private
  directory (the ``jax_runtime`` fixture): its loader builds straight onto
  one shared path in the package and gives up for the rest of a process
  that loads a half-written file, which parallel workers building it at
  once can do.
- With ``shutil.which`` patched to find no ``g++`` every entry is a counted
  fallback and the diagnostics are the numpy twins'; with ``g++`` present
  a failed build raises.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from nnest_torch import runtime
from nnest_torch.utils import evaluation as ev

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chains():
    """tests/test_runtime.py's chains: random walks with a run of repeated
    (rejected) steps."""
    rng = np.random.RandomState(0)
    x = np.cumsum(rng.normal(size=(4, 200, 3)), axis=1)
    x[:, 50:60, :] = x[:, 49:50, :]
    return x


def _counts():
    return runtime.native_calls, runtime.fallbacks


@pytest.fixture(scope='module')
def jax_runtime(tmp_path_factory):
    """``nnest_tpu.runtime`` with its library built by its own loader, from
    its own source and command, into a directory of this module's: the
    module's ``_SO`` and ``_STAMP`` point there and its load state is reset
    for this process, then all four are restored."""
    from nnest_tpu import runtime as ref
    saved = {k: getattr(ref, k) for k in ('_SO', '_STAMP', '_TRIED', '_LIB')}
    so = str(tmp_path_factory.mktemp('nnest_tpu_runtime')
             / 'libnnest_runtime.so')
    ref._SO, ref._STAMP, ref._TRIED, ref._LIB = so, so + '.sha256', False, None
    try:
        assert ref.available(), (
            'nnest_tpu.runtime did not build: g++ -O3 -shared -fPIC -o %s %s'
            % (so, ref._SRC))
        yield ref
    finally:
        for k, v in saved.items():
            setattr(ref, k, v)


def test_diagnostics_match_nnest_tpu_and_numpy(jax_runtime):
    x = _chains()
    mu = np.mean(x.reshape(-1, 3), axis=0)
    var = np.var(x.reshape(-1, 3), axis=0)
    native0, fallback0 = _counts()
    ess = ev.effective_sample_size(x, mu, var)
    np.testing.assert_array_equal(ess, jax_runtime.ess(x, mu, var))
    np.testing.assert_allclose(ess, ev.effective_sample_size_numpy(
        x, mu, var), rtol=1e-12, atol=0)
    # tests/test_runtime.py's pure-Python estimator
    b, t, d = x.shape
    acc, y = np.ones(d), x - mu
    for s in range(1, t):
        rho = np.mean(y[:, :-s, :] * y[:, s:, :], axis=(0, 1)) / var
        active = rho > 0.05
        if not np.any(active):
            break
        acc[active] += 2.0 * rho[active] * (1.0 - s / t)
    np.testing.assert_allclose(ess, t / acc, rtol=1e-10)

    acc_rate = ev.acceptance_rate(x)
    assert acc_rate == jax_runtime.acceptance_rate(x) \
        == ev.acceptance_rate_numpy(x)
    jump = ev.mean_jump_distance(x)
    assert jump == jax_runtime.mean_jump(x)
    assert jump == pytest.approx(ev.mean_jump_distance_numpy(x), rel=1e-12)
    assert _counts() == (native0 + 3, fallback0)


def _rows(n=50, d=3, nd=2, seed=1):
    rng = np.random.RandomState(seed)
    w = rng.uniform(size=n)
    w[:3] = [0.0, 1e-40, 2.5e-31]    # floored at min_weight
    return (w, rng.normal(size=n), rng.normal(size=(n, d)),
            rng.normal(size=(n, nd)) * 1e3)


def _savetxt(path, w, logl, s, derived, header, min_weight=1e-30):
    cols = [np.maximum(w, min_weight)[:, None], -logl[:, None], s]
    if derived is not None:
        cols.append(derived)
    np.savetxt(path, np.hstack(cols), fmt='%.5E', header=header,
               comments='#' if header else '')


@pytest.mark.parametrize('derived,header', [
    (True, 'weight minusloglike a b c d1 d2'), (True, ''),
    (False, 'weight minusloglike a b c'), (False, '')])
def test_write_chain_bytes(tmp_path, jax_runtime, derived, header):
    w, logl, s, der = _rows()
    der = der if derived else None
    paths = {k: str(tmp_path / (k + '.txt'))
             for k in ('port', 'nnest_tpu', 'numpy')}
    assert runtime.write_chain(paths['port'], w, logl, s, derived=der,
                               header=header)
    assert jax_runtime.write_chain(paths['nnest_tpu'], w, logl, s,
                                   derived=der, header=header)
    _savetxt(paths['numpy'], w, logl, s, der, header)
    data = {k: open(p, 'rb').read() for k, p in paths.items()}
    assert data['port'] == data['nnest_tpu'] == data['numpy']
    assert len(data['port'].splitlines()) == len(w) + bool(header)
    loaded = np.loadtxt(paths['port'])
    assert loaded.shape == (len(w), 2 + s.shape[1] + (2 if derived else 0))


def _save_all(save, root, samples, loglikes, derived):
    """The 2-D (one file) and 3-D (one file a chain) chains written by
    ``Sampler._save_samples`` under ``root``; their bytes by name."""
    from nnest_torch.samplers.base import Sampler
    os.makedirs(root)
    stub = types.SimpleNamespace(
        logs={'chains': root},
        param_names=['x0', 'x1', 'x2', 'd0', 'd1'])
    save(Sampler._save_samples, stub, samples, loglikes, derived)
    return {f: open(os.path.join(root, f), 'rb').read()
            for f in sorted(os.listdir(root))}


def _write_both(fn, stub, samples, loglikes, derived):
    w = np.random.RandomState(3).uniform(size=loglikes.shape)
    fn(stub, samples[0], loglikes[0], weights=w[0],
       derived_samples=derived[0])
    fn(stub, samples, loglikes, derived_samples=derived, outfile='walk')


def test_save_samples_native_and_fallback(tmp_path, monkeypatch):
    rng = np.random.RandomState(4)
    samples = rng.normal(size=(3, 40, 3))
    loglikes = rng.normal(size=(3, 40))
    derived = rng.normal(size=(3, 40, 2))
    native0, fallback0 = _counts()
    native = _save_all(_write_both, str(tmp_path / 'native'), samples,
                       loglikes, derived)
    assert _counts() == (native0 + 4, fallback0)
    assert sorted(native) == ['chain.txt', 'walk_1.txt', 'walk_2.txt',
                              'walk_3.txt']
    monkeypatch.setattr(runtime, '_lib', None)
    monkeypatch.setattr(runtime.shutil, 'which', lambda name: None)
    fallback = _save_all(_write_both, str(tmp_path / 'numpy'), samples,
                         loglikes, derived)
    assert _counts() == (native0 + 4, fallback0 + 4)
    assert fallback == native
    # each per-chain file is its chain's rows, derived columns last
    rows = np.loadtxt(str(tmp_path / 'native' / 'walk_2.txt'))
    np.testing.assert_allclose(rows[:, 2:5], samples[1], rtol=1e-5)
    np.testing.assert_allclose(rows[:, 5:], derived[1], rtol=1e-5)


def test_no_compiler_is_a_counted_fallback(tmp_path, monkeypatch):
    x = _chains()
    mu, var = x.mean(axis=(0, 1)), x.var(axis=(0, 1))
    monkeypatch.setattr(runtime, '_lib', None)
    monkeypatch.setattr(runtime.shutil, 'which', lambda name: None)
    native0, fallback0 = _counts()
    assert not runtime.available()
    assert runtime.ess(x, mu, var) is None
    np.testing.assert_array_equal(ev.effective_sample_size(x, mu, var),
                                  ev.effective_sample_size_numpy(x, mu, var))
    assert ev.acceptance_rate(x) == ev.acceptance_rate_numpy(x)
    assert ev.mean_jump_distance(x) == ev.mean_jump_distance_numpy(x)
    assert not runtime.write_chain(str(tmp_path / 'c.txt'), np.ones(2),
                                   np.zeros(2), np.zeros((2, 1)))
    assert not os.path.exists(str(tmp_path / 'c.txt'))
    assert _counts() == (native0, fallback0 + 5)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / 'bad.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(runtime, '_lib', None)
    monkeypatch.setattr(runtime, 'SOURCE', str(bad))
    monkeypatch.setattr(runtime, 'BUILD_DIR', str(tmp_path / 'build'))
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        runtime.ess(np.zeros((1, 3, 1)), np.zeros(1), np.ones(1))
    assert os.listdir(str(tmp_path / 'build')) == []


_LOAD = """
import sys
import numpy as np
from nnest_torch import runtime
runtime.BUILD_DIR = sys.argv[1]
x = np.cumsum(np.random.RandomState(0).normal(size=(2, 50, 2)), axis=1)
print(repr(runtime.ess(x, x.mean(axis=(0, 1)), x.var(axis=(0, 1))).tolist()))
"""


def test_four_processes_build_at_once(tmp_path):
    build = str(tmp_path / 'build')
    procs = [subprocess.Popen([sys.executable, '-c', _LOAD, build],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert len({o.strip() for o, _ in outs}) == 1
    files = os.listdir(build)
    assert len(files) == 1 and files[0].endswith('.so'), files
