"""nnest_torch across real processes: ranks of a gloo process group on the
CPU, each one OS process running the same nested or ensemble job in
lockstep, as tests/test_multiprocess.py runs nnest_tpu under
jax.distributed. The cases and their bounds are that file's: a 2-rank
nested run to the 2-D Gaussian's evidence with rank 0 alone writing, a
checkpoint resumed by fresh processes, the ensemble bootstrap resumed, a
numpy-only likelihood farmed over the ranks, and a 4-rank run. Then the
2-rank run against one process on the same seed: the first Metropolis
generation replayed in this process from rank 0's inputs (the same flow
and generator state) gives the same endpoints within 1e-5.

The ranks are this file run as a script (its ``__main__`` block), one
subprocess a rank, each with one intra-op thread; a rendezvous error is
retried on a fresh port.
"""

import argparse
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANALYTIC_LOGZ = -3.589   # the 2-D Gaussian in the [-3, 3]^2 box

# rendezvous failures worth a retry on a fresh port
_RENDEZVOUS_ERRS = ('Address already in use', 'EADDRINUSE',
                    'Connection refused', 'Connection reset',
                    'failed to connect', 'Connect timeout', 'Socket Timeout',
                    'DistNetworkError', 'connectFullMesh')


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def launch(script, nproc, args, timeout=300, retries=3):
    """Run ``script`` as ``nproc`` ranks (``--rank``, ``--world``,
    ``--port`` added to ``args``) and return each rank's ``RESULT`` JSON,
    in rank order. Every rank's ``communicate`` has its own timeout; a
    failed rank raises with every rank's tail."""
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH', ''))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, script, '--rank', str(r), '--world', str(nproc),
         '--port', str(port), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        cwd=ROOT) for r in range(nproc)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0] + '\n[timed out]')
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        if retries > 0 and any(e in o for o in outs for e in _RENDEZVOUS_ERRS):
            return launch(script, nproc, args, timeout, retries - 1)
        tails = '\n'.join('--- rank %d (rc %s) ---\n%s' % (
            r, procs[r].returncode, '\n'.join(o.splitlines()[-25:]))
            for r, o in enumerate(outs))
        raise AssertionError('rank(s) %s failed:\n%s' % (failed, tails))
    results = []
    for r, out in enumerate(outs):
        line = [ln for ln in out.splitlines() if ln.startswith('RESULT ')]
        assert line, 'rank %d printed no RESULT:\n%s' % (r, out[-3000:])
        results.append(json.loads(line[-1][len('RESULT '):]))
    return results


def _run(nproc, log_dir, *args, timeout=300):
    return launch(os.path.abspath(__file__), nproc,
                  ['--log_dir', str(log_dir), *args], timeout=timeout)


class NumpyOnlyGaussian:
    """The 2-D Gaussian of the nested runs as a numpy row loop: a host
    likelihood, farmed over the ranks inside the kernels."""
    x_dim = 2

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float64)
        out = np.empty(x.shape[0])
        for i in range(x.shape[0]):
            out[i] = -0.5 * np.dot(x[i], x[i]) - math.log(2 * math.pi)
        return out


# ------------------------------------------------------------------ tests

def _lockstep(results, *keys):
    for k in keys:
        assert len({r[k] for r in results}) == 1, (k, results)


def test_two_rank_nested_end_to_end(tmp_path):
    log_dir = tmp_path / 'mp'
    results = _run(2, log_dir)
    r0 = results[0]
    assert r0['world'] == 2 and r0['backend'] == 'gloo'
    _lockstep(results, 'logz', 'ncall', 'niter')
    assert abs(r0['logz'] - ANALYTIC_LOGZ) <= 0.5
    # the sharded Metropolis generations ran, and rank 0 alone writes
    assert r0['mcmc_generations'] > 0
    assert [r['has_logs'] for r in results] == [True, False]
    for sub, name in (('results', 'final.csv'), ('chains', 'chain.txt'),
                      ('info', 'params.txt')):
        assert os.path.exists(os.path.join(log_dir, sub, name)), name


def test_two_rank_checkpoint_resume(tmp_path):
    """A 2-rank run cut at 120 iterations, then resumed by two fresh
    processes: rank 0 loads and broadcasts, and the global ncall keeps
    growing from the saved, undivided count."""
    log_dir = tmp_path / 'mpresume'
    first = _run(2, log_dir, '--max_iters', '120')
    _lockstep(first, 'ncall', 'niter')
    assert first[0]['niter'] <= 122
    second = _run(2, log_dir)
    _lockstep(second, 'logz', 'ncall', 'niter')
    assert abs(second[0]['logz'] - ANALYTIC_LOGZ) <= 0.5
    assert second[0]['ncall'] > first[0]['ncall']
    assert second[0]['niter'] > 121


def test_two_rank_ensemble_bootstrap_resume(tmp_path):
    """The bootstrap with resume=True: phases 0 and 1, then phase 2 in
    fresh processes from rank 0's broadcast state, in lockstep."""
    log_dir = tmp_path / 'mpens'
    first = _run(2, log_dir, '--sampler', 'ensemble', '--bootstrap_iters',
                 '1')
    _lockstep(first, 'ts_sum', 'ncall')
    assert sum(r['has_logs'] for r in first) == 1
    second = _run(2, log_dir, '--sampler', 'ensemble', '--bootstrap_iters',
                  '2')
    _lockstep(second, 'ts_sum', 'ncall')
    assert second[0]['ts_shape'] == second[1]['ts_shape']
    assert second[0]['ncall'] > first[0]['ncall']


def test_two_rank_host_likelihood_farm(tmp_path):
    """A numpy-only likelihood: each rank evaluates its rows of every
    replicated batch, in lockstep, to the analytic evidence."""
    results = _run(2, tmp_path / 'mpfarm', '--likelihood', 'numpy')
    _lockstep(results, 'logz', 'ncall', 'niter')
    assert abs(results[0]['logz'] - ANALYTIC_LOGZ) <= 0.5
    # every rank evaluated the same rows' count: its share of each farmed
    # batch (tests/test_torch_parallel.py checks the split itself)
    _lockstep(results, 'farmed_rows')
    assert results[0]['farmed_rows'] > 0
    assert sum(r['has_logs'] for r in results) == 1


def test_four_rank_lockstep(tmp_path):
    results = _run(4, tmp_path / 'mp4', timeout=400)
    _lockstep(results, 'logz', 'ncall', 'niter')
    assert results[0]['world'] == 4
    assert abs(results[0]['logz'] - ANALYTIC_LOGZ) <= 0.5
    assert sum(r['has_logs'] for r in results) == 1


def test_two_ranks_against_one_process(tmp_path):
    """The first Metropolis generation of a 2-rank run, replayed here on
    one process by the one-process route from rank 0's inputs (flow,
    generator state, live set): the endpoints within 1e-5. Whether the
    whole 2-rank run equals a 1-process run on the same seed is measured
    and printed, not asserted: dp training sums its gradients in another
    order."""
    import torch
    from nnest_torch import NestedSampler
    from nnest_torch.likelihoods import Gaussian
    torch.set_num_threads(1)

    dump = tmp_path / 'first_generation.pt'
    two = _run(2, tmp_path / 'two', '--dump', str(dump))
    one = _run(1, tmp_path / 'one')
    print('2 ranks vs 1 process, (logz, ncall, niter): %s vs %s, equal: %s'
          % ([two[0][k] for k in ('logz', 'ncall', 'niter')],
             [one[0][k] for k in ('logz', 'ncall', 'niter')],
             all(two[0][k] == one[0][k] for k in ('logz', 'ncall',
                                                  'niter'))))

    rec = torch.load(dump, weights_only=False)
    s = NestedSampler(2, Gaussian(2, 0.0, lim=3), transform=lambda x: 3 * x,
                      num_live_points=100, log_dir=None, seed=7,
                      device='cpu', log_level=30)
    s.trainer.restore_state(rec['trainer'])
    s.generator.set_state(rec['generator'])
    got = s._mcmc_sample_live(*rec['args'], **rec['kwargs'])
    ref = rec['out']
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[3], ref[3])
    assert got[4] == ref[4] and got[6] == ref[6]


# ------------------------------------------------------------------ ranks

def _rank_main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--rank', type=int, required=True)
    p.add_argument('--world', type=int, required=True)
    p.add_argument('--port', type=int, required=True)
    p.add_argument('--log_dir', required=True)
    p.add_argument('--max_iters', type=int, default=1000000)
    p.add_argument('--seed', type=int, default=7)
    p.add_argument('--sampler', default='nested',
                   choices=('nested', 'ensemble'))
    p.add_argument('--likelihood', default='torch',
                   choices=('torch', 'numpy'))
    p.add_argument('--bootstrap_iters', type=int, default=1)
    p.add_argument('--dump', default=None)
    a = p.parse_args(argv)

    # TensorBoard imports TensorFlow where it is installed, which takes
    # several times as long as the run: the ranks write events without it
    sys.modules['tensorflow'] = None
    import torch
    torch.set_num_threads(1)
    from nnest_torch.likelihoods import Gaussian
    from nnest_torch.parallel import get_mesh, initialize_distributed

    backend, mesh = None, None
    if a.world > 1:
        backend = initialize_distributed(
            device='cpu', init_method='tcp://localhost:%d' % a.port,
            world_size=a.world, rank=a.rank, timeout_s=120)
        mesh = get_mesh()
    like = (NumpyOnlyGaussian() if a.likelihood == 'numpy'
            else Gaussian(2, 0.0, lim=3))
    farmed = [0]
    if a.likelihood == 'numpy':
        inner = like

        def like(x):   # noqa: F811  (counts the rows this rank evaluates)
            farmed[0] += len(x)
            return inner(x)

    out = {'rank': a.rank, 'world': a.world, 'backend': backend}
    if a.sampler == 'ensemble':
        from nnest_torch import EnsembleSampler
        from nnest_torch.priors import UniformPrior
        e = EnsembleSampler(2, like, prior=UniformPrior(2, -3, 3),
                            log_dir=a.log_dir, append_run_num=False,
                            mesh=mesh, seed=a.seed, device='cpu')
        ts = e.bootstrap(mcmc_steps=30, num_walkers=16,
                         iters=a.bootstrap_iters, resume=True, train_iters=20)
        out.update(ts_shape=list(ts.shape), ts_sum=float(np.sum(ts)),
                   ncall=int(e.total_calls), has_logs=e.logs is not None)
    else:
        from nnest_torch import NestedSampler
        s = NestedSampler(2, like, transform=lambda x: 3 * x,
                          num_live_points=100, log_dir=a.log_dir,
                          append_run_num=False, resume=True, mesh=mesh,
                          seed=a.seed, device='cpu')
        if a.dump and a.rank == 0:
            _record_first_generation(s, a.dump)
        s.run(train_iters=50, dlogz=0.1, max_iters=a.max_iters,
              log_interval=40, mcmc_num_chains=8)
        out.update(logz=float(s.logz), logzerr=float(s.logzerr),
                   niter=int(s.niter), ncall=int(s.total_calls),
                   has_logs=s.logs is not None,
                   mcmc_generations=s.run_stats['mcmc_generations'])
    out['farmed_rows'] = farmed[0]
    print('RESULT ' + json.dumps(out), flush=True)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _record_first_generation(s, path):
    """Save the inputs (flow, generator state, arguments) and output of
    the sampler's first Metropolis generation."""
    import torch
    real = s._mcmc_sample_live

    def recording(*args, **kw):
        first = not os.path.exists(path)
        if first:
            rec = {'trainer': s.trainer.snapshot_state(),
                   'generator': s.generator.get_state(),
                   'args': [np.array(a) if isinstance(a, np.ndarray) else a
                            for a in args],
                   'kwargs': {k: np.array(v) if isinstance(v, np.ndarray)
                              else v for k, v in kw.items()}}
        out = real(*args, **kw)
        if first:
            rec['out'] = out
            torch.save(rec, path)
        return out

    s._mcmc_sample_live = recording


if __name__ == '__main__':
    _rank_main()
