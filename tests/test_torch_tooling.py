"""The port's run tooling against nnest_tpu's: the background writer, the
sample buffer, the trainer's run directory (model file, training data,
plots, TensorBoard scalars), model files exchanged between the packages,
the progress bar, the generation-batch options that change nothing, and
the posterior samplers' chain statistics and trace plot."""

import glob
import os
import threading
import time

import numpy as np
import pytest
import torch

from nnest_torch import NestedSampler, Trainer
from nnest_torch.likelihoods import Gaussian
from nnest_torch.utils.buffer import SampleBuffer
from nnest_torch.utils.io_async import SerialWriter

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)


def _fail(exc):
    def job():
        raise exc
    return job


def _fifo(cls):
    w, out = cls(), []
    for i in range(50):
        w.submit(lambda i=i: out.append(i))
    w.drain()
    w.close()
    return out


def _first_failure(cls):
    w, ok = cls(), []
    w.submit(_fail(OSError('root cause')))
    w.submit(_fail(ValueError('secondary')))
    with pytest.raises(OSError, match='root cause') as info:
        w.drain()
    w.submit(lambda: ok.append(1))   # cleared: healthy jobs drain
    w.drain()
    w.close()
    return str(info.value), ok


def _close_stops_threads(cls):
    before = threading.active_count()
    writers = [cls() for _ in range(8)]
    done = []
    for w in writers:
        w.submit(lambda: done.append(1))
    started = threading.active_count() >= before + 8
    for w in writers:
        w.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    return started, done, threading.active_count() <= before


def _close_reraises(cls):
    w = cls()
    w.submit(_fail(RuntimeError('boom')))
    with pytest.raises(RuntimeError, match='boom') as info:
        w.close()
    return str(info.value)


@pytest.mark.parametrize('behaviour, expected', [
    (_fifo, list(range(50))),
    (_first_failure, ('root cause', [1])),
    (_close_stops_threads, (True, [1] * 8, True)),
    (_close_reraises, 'boom'),
], ids=['fifo_and_drain', 'first_failure', 'close_stops_threads',
        'close_reraises'])
def test_serial_writer_matches_jax(behaviour, expected):
    """tests/test_io_async.py's four behaviours, each run on the port's
    writer and on nnest_tpu's with the same outcome."""
    from nnest_tpu.utils.io_async import SerialWriter as JaxWriter
    assert behaviour(SerialWriter) == behaviour(JaxWriter) == expected


def test_sample_buffer_matches_jax():
    from nnest_tpu.utils.buffer import SampleBuffer as JaxBuffer
    rs = np.random.RandomState(0)
    port, ref = SampleBuffer(max_size=25), JaxBuffer(max_size=25)
    for buf in (port, ref):
        assert len(buf) == 0 and buf.get().shape == (0, 0)
    for n in (7, 1, 30, 4):
        rows = rs.normal(size=(n, 3)) if n > 1 else rs.normal(size=3)
        port.append(rows)
        ref.append(rows)
        assert len(port) == len(ref)
        np.testing.assert_array_equal(port.get(), ref.get())
    out = port.get()
    out[:] = 0.0   # a copy: the buffer keeps its rows
    np.testing.assert_array_equal(port.get(), ref.get())


def _scalars(log_dir, tag):
    """(steps, values) of a TensorBoard scalar under ``log_dir``, or None
    without tensorboard."""
    try:
        from tensorboard.backend.event_processing.event_accumulator import \
            EventAccumulator
    except ImportError:
        return None
    acc = EventAccumulator(log_dir, size_guidance={'scalars': 0})
    acc.Reload()
    events = acc.Scalars(tag)
    return ([e.step for e in events],
            np.array([e.value for e in events], dtype=np.float64))


def test_trainer_run_directory_and_model_files_match_jax(tmp_path):
    """Both trainers given a log_dir write the same files (models/netG.pkl,
    data/originals.npy, plots/plot_<epochs>.png) and one 'loss' scalar an
    epoch; a netG.pkl of either package loads in the other's
    Trainer(load_model=) and gives the same log_prob to 1e-5."""
    from nnest_tpu.training.trainer import Trainer as JaxTrainer
    x = np.random.RandomState(3).normal(size=(80, 2)).astype(np.float32)
    kw = dict(hidden_dim=16, batch_size=40, log=False)
    port = Trainer(2, log_dir=str(tmp_path / 'port'), seed=1, device='cpu',
                   **kw)
    ref = JaxTrainer(2, log_dir=str(tmp_path / 'jax'), seed=1, **kw)
    for t in (port, ref):
        t.train(x, max_iters=3)
        t.finish_plots()
    files = {}
    for name in ('port', 'jax'):
        root = str(tmp_path / name)
        files[name] = sorted(os.path.relpath(p, root) for p in glob.glob(
            os.path.join(root, '*', '*')))
    assert files['port'] == files['jax'] == [
        'data/originals.npy', 'models/netG.pkl', 'plots/plot_3.png']
    np.testing.assert_array_equal(
        np.load(str(tmp_path / 'port' / 'data' / 'originals.npy')), x)
    port.writer.flush()
    loss = _scalars(str(tmp_path / 'port'), 'loss')
    if loss is not None:   # tensorboard present
        assert loss[0] == [1, 2, 3]
        assert loss[1][-1] == pytest.approx(port.best_validation_loss,
                                            rel=1e-6)

    # cross-package model files
    port_in_jax = JaxTrainer(2, log_dir=str(tmp_path), load_model='port',
                             **kw)
    jax_in_port = Trainer(2, log_dir=str(tmp_path), load_model='jax',
                          device='cpu', **kw)
    z = np.random.RandomState(4).normal(size=(50, 2)).astype(np.float32)
    np.testing.assert_allclose(port_in_jax.log_probs(z, to_numpy=True),
                               port.log_probs(z, to_numpy=True), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(jax_in_port.log_probs(z, to_numpy=True),
                               ref.log_probs(z, to_numpy=True), rtol=1e-5,
                               atol=1e-5)
    assert jax_in_port.initialized and jax_in_port.optimizer is not None


def _tiny_run(log_dir=None, seed=2, **run_kw):
    sampler = NestedSampler(2, Gaussian(2, 0.0, lim=3),
                            transform=lambda u: 3.0 * u, num_live_points=40,
                            log_dir=log_dir, seed=seed, device='cpu',
                            log_level=30)
    sampler.run(**dict(dict(strategy=['rejection_prior', 'mcmc'],
                            volume_switch=0.5, train_iters=3,
                            mcmc_num_chains=5, mcmc_steps=4, dlogz=0.5,
                            rejection_batch_size=64), **run_kw))
    return sampler


def test_nested_run_logs_logz_and_loss_scalars(tmp_path):
    """A nested run writes its trainer's files into the run directory and
    one 'logz' scalar an iteration, equal to results.csv's logz where both
    have the step."""
    import csv
    s = _tiny_run(str(tmp_path / 'run'))
    run = s.log_dir
    for rel in ('models/netG.pkl', 'data/originals.npy'):
        assert os.path.exists(os.path.join(run, rel)), rel
    assert glob.glob(os.path.join(run, 'plots', 'plot_*.png'))
    logz = _scalars(run, 'logz')
    if logz is None:
        return   # no tensorboard: nothing more to read
    steps, values = logz
    assert steps == list(range(1, s.niter))
    with open(os.path.join(run, 'results', 'results.csv')) as f:
        rows = list(csv.DictReader(f))
    assert rows
    for row in rows:
        assert values[int(row['step']) - 1] == pytest.approx(
            float(row['logz']), rel=1e-6)
    loss_steps, _ = _scalars(run, 'loss')
    assert loss_steps == list(range(1, s.trainer.total_iters + 1))


class _Raising(Gaussian):
    """The 2-D Gaussian that raises once it has answered ``limit`` rows."""

    def __init__(self, limit):
        super().__init__(2, 0.0, lim=3)
        self.limit = limit

    def logpdf(self, x):
        if self.num_evaluations > self.limit:
            raise RuntimeError('likelihood failed')
        return super().logpdf(x)


def test_progress_bar_runs_and_closes_when_the_run_raises(monkeypatch):
    tqdm_mod = pytest.importorskip('tqdm')
    bars = []

    class Recording(tqdm_mod.tqdm):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            bars.append(self)

    monkeypatch.setattr(tqdm_mod, 'tqdm', Recording)
    s = _tiny_run(show_progress=True)
    assert len(bars) == 1
    assert bars[0].n == s.niter - 1 and s._run_pbar is None
    assert bars[0] not in Recording._instances   # closed

    sampler = NestedSampler(2, _Raising(500), transform=lambda u: 3.0 * u,
                            num_live_points=40, log_dir=None, device='cpu',
                            log_level=30)
    with pytest.raises(RuntimeError, match='likelihood failed'):
        sampler.run(strategy=['rejection_prior'], show_progress=True,
                    rejection_batch_size=16, dlogz=0.01)
    assert len(bars) == 2 and bars[1].n > 0
    assert sampler._run_pbar is None
    assert bars[1] not in Recording._instances


def test_generation_batch_options_change_nothing():
    """(logz, h, ncall, niter) are the same, bit for bit, at
    mcmc_gen_batch = rejection_gen_batch = 1 and 8, with speculation on
    and off; a batch below 1 or a non-bool speculation is refused."""
    def final(**kw):
        s = _tiny_run(**kw)
        assert s.run_stats['mcmc_generations'] > 0
        return (s.logz, s.h, s.total_calls, s.niter)

    want = final(mcmc_gen_batch=1, rejection_gen_batch=1,
                 mcmc_speculate=False)
    for gen_batch in (1, 8):
        for speculate in (False, True):
            assert final(mcmc_gen_batch=gen_batch,
                         rejection_gen_batch=gen_batch,
                         mcmc_speculate=speculate) == want
    s = NestedSampler(2, Gaussian(2, 0.0), log_dir=None, device='cpu',
                      log_level=30)
    for kw in (dict(mcmc_gen_batch=0), dict(rejection_gen_batch=2.5),
               dict(mcmc_speculate='yes')):
        with pytest.raises(ValueError):
            s.run(**kw)


@pytest.mark.parametrize('sampler', ['mcmc', 'ensemble'])
def test_chain_statistics_once_a_call_and_the_trace_plot(tmp_path, sampler):
    """A posterior sampler's ``run`` logs its chains' statistics once, and
    only from ``stats_interval`` steps on; the sampling helper called
    directly logs them at its own ``stats_interval`` and draws the first
    chain's trace with ``plot_trace``."""
    from nnest_torch import EnsembleSampler, MCMCSampler
    from nnest_torch.priors import UniformPrior
    prior = UniformPrior(2, -5.0, 5.0)
    prior.seed(0)
    cls = MCMCSampler if sampler == 'mcmc' else EnsembleSampler
    s = cls(2, Gaussian(2, 0.0, lim=5), prior=prior, log_dir=str(tmp_path),
            seed=1, device='cpu', log_level=30)
    logged = []
    s._chain_stats = lambda chains: logged.append(chains.shape)
    training = np.random.default_rng(0).normal(size=(200, 2))
    for steps, stats_interval, want in ((20, 10, 1), (5, 10, 0)):
        logged.clear()
        s.run(steps, 8, training, stats_interval=stats_interval,
              train_iters=2)
        assert logged == [(8, steps + 1, 2)] * want

    def helper(**kw):   # 4 chains (walkers) of 6 steps
        if sampler == 'mcmc':
            return s._mcmc_sample(6, num_chains=4, **kw)
        return s._ensemble_sample(6, 4, **kw)

    logged.clear()
    helper()
    assert logged == []
    trace = os.path.join(s.log_dir, 'plots', 'trace.png')
    if os.path.exists(trace):
        os.remove(trace)
    helper(stats_interval=5, plot_trace=True)
    assert logged == [(4, 7, 2)]
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return   # no matplotlib: no trace plot
    assert os.path.exists(trace)
