"""GPU-only tests of the CUDA spline-inverse kernel (``cuda`` marker).

They skip with a reason where CUDA is unavailable. On a machine with a
GPU and nvcc, run them with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest`` because tests/conftest.py
configures JAX, which this file never imports).
"""

import numpy as np
import pytest
import torch

from nnest_torch.flows import build_flow
from nnest_torch.ops import spline_inverse as si
from nnest_torch.ops.fused_spline import _inverse_body, pack_inverse_consts

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: the kernel has no CPU mode')


def _flow(d, seed=0):
    hidden = 16 if d < 16 else (32 if d < 32 else 64)
    model = build_flow(d, hidden_dim=hidden, seed=seed, device='cuda')
    model.data_init(0.7 * torch.randn(256, d, device='cuda') + 0.3)
    return model


@pytest.mark.parametrize('d,n', [(2, 1), (5, 1000), (16, 256), (50, 4096),
                                 (100, 256), (16, 4097), (100, 4097)])
def test_kernel_matches_twin(d, n):
    _needs_gpu()
    packed = pack_inverse_consts(_flow(d, seed=d))
    z = 2.0 * torch.randn(n, d, device='cuda')
    before = si.launches
    x_k, ld_k = si.spline_inverse(z, packed)
    x_p, ld_p = _inverse_body(z, packed)
    torch.cuda.synchronize()
    assert si.launches == before + 1
    assert float((x_k - x_p).abs().max()) <= 3e-5
    assert float((ld_k - ld_p).abs().max()) <= 3e-4


def test_block_range_chain_equals_whole_inverse():
    """The per-block wrapper (one launch per block, last to first, plus the
    constant logdet) equals the whole-chain launch: the entry point's
    block range."""
    _needs_gpu()
    packed = pack_inverse_consts(_flow(5))
    z = 2.0 * torch.randn(300, 5, device='cuda')
    before = si.launches_per_block
    x, ld = si.spline_inverse_per_block(z, packed)
    assert si.launches_per_block == before + len(packed['blocks'])
    x_all, ld_all = si.spline_inverse(z, packed)
    assert float((x - x_all).abs().max()) <= 1e-6
    assert float((ld - ld_all).abs().max()) <= 1e-5


@pytest.mark.parametrize('d,n', [(5, 70), (16, 4097)])
def test_per_block_matches_twin(d, n):
    _needs_gpu()
    packed = pack_inverse_consts(_flow(d, seed=d))
    z = 2.0 * torch.randn(n, d, device='cuda')
    x_k, ld_k = si.spline_inverse_per_block(z, packed)
    x_p, ld_p = _inverse_body(z, packed)
    torch.cuda.synchronize()
    assert float((x_k - x_p).abs().max()) <= 3e-5
    assert float((ld_k - ld_p).abs().max()) <= 3e-4


@pytest.mark.parametrize('d,hidden', [(7, 10), (16, 24)])
def test_runtime_width_matches_twin(d, hidden):
    """A width other than the compiled 16/32/64 runs the kernel's run-time
    width instantiation, never the twin."""
    _needs_gpu()
    model = build_flow(d, hidden_dim=hidden, seed=3, device='cuda')
    model.data_init(0.7 * torch.randn(256, d, device='cuda') + 0.3)
    packed = pack_inverse_consts(model)
    z = 2.0 * torch.randn(333, d, device='cuda')
    before = si.launches
    x_k, ld_k = si.spline_inverse(z, packed)
    x_p, ld_p = _inverse_body(z, packed)
    torch.cuda.synchronize()
    assert si.launches == before + 1
    assert float((x_k - x_p).abs().max()) <= 3e-5
    assert float((ld_k - ld_p).abs().max()) <= 3e-4


@pytest.mark.parametrize('rows,stages', [(1, None), (3, None), (8, None),
                                         (64, None), (2, 0), (16, 2)])
def test_any_rows_a_block_matches_twin(rows, stages):
    """The rows a block takes and the ring's stages (the plan's choice or
    a sweep's; 0 stages: weights read from global memory) change the
    tiling, never the result."""
    _needs_gpu()
    packed = pack_inverse_consts(_flow(16))
    z = 2.0 * torch.randn(1000, 16, device='cuda')
    x_k, ld_k = si._launch(z, packed, 0, 3, True, rows, stages)
    x_p, ld_p = _inverse_body(z, packed)
    torch.cuda.synchronize()
    assert float((x_k - x_p).abs().max()) <= 3e-5
    assert float((ld_k - ld_p).abs().max()) <= 3e-4


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _needs_gpu()
    packed = pack_inverse_consts(_flow(4))
    z = torch.randn(8, 4, device='cuda')
    for bad in (z.double(), z.t().contiguous().t(), z[:, :3].contiguous()):
        with pytest.raises(ValueError):
            si.spline_inverse(bad, packed)
    x, ld = si.spline_inverse(z[:0], packed)
    assert x.shape == (0, 4) and ld.shape == (0,)


def test_nested_sampler_launches_the_kernel(tmp_path):
    _needs_gpu()
    from nnest_torch import NestedSampler
    from nnest_torch.likelihoods import Gaussian
    like = Gaussian(2, 0.0, lim=3)
    sampler = NestedSampler(2, like, transform=lambda u: 3.0 * u,
                            num_live_points=100, log_dir=str(tmp_path),
                            seed=0, device='cuda')
    before = si.launches
    sampler.run(strategy=['mcmc'], train_iters=50, dlogz=0.5)
    generations = sampler.run_stats['mcmc_generations']
    assert generations > 0
    # one launch for the chain starts plus one per step of each generation
    assert si.launches - before == generations * (5 * 2 + 1)
    analytic = like.analytic_logz([-3.0, -3.0], [3.0, 3.0])
    assert abs(sampler.logz - analytic) <= max(3 * sampler.logzerr, 0.15)
    assert np.isfinite(sampler.logzerr)


@pytest.mark.parametrize('n', [16, 32, 501 * 64])
def test_kernel_at_the_posterior_samplers_shapes(n):
    """A full-MH step's 16 chains, an ensemble half-update's 32 walkers and
    a 64-walker, 500-step ensemble's trajectory inverse, at d = 16."""
    _needs_gpu()
    packed = pack_inverse_consts(_flow(16, seed=n))
    z = 2.0 * torch.randn(n, 16, device='cuda')
    x_k, ld_k = si.spline_inverse(z, packed)
    x_p, ld_p = _inverse_body(z, packed)
    torch.cuda.synchronize()
    assert float((x_k - x_p).abs().max()) <= 3e-5
    assert float((ld_k - ld_p).abs().max()) <= 3e-4


def test_posterior_samplers_launch_the_kernel(tmp_path):
    """MCMCSampler: one launch a step and one a call; EnsembleSampler.run:
    two a step (the half-updates) and two a call (the starts' target and
    the trajectory inverse); the plain twin is never called."""
    _needs_gpu()
    from nnest_torch import EnsembleSampler, MCMCSampler
    from nnest_torch.likelihoods import Gaussian
    from nnest_torch.ops import fused_spline
    from nnest_torch.priors import UniformPrior
    training = np.random.RandomState(0).normal(size=(500, 4))
    for cls, per_step, per_call in ((MCMCSampler, 1, 1),
                                    (EnsembleSampler, 2, 2)):
        s = cls(4, Gaussian(4, 0.0), prior=UniformPrior(4, -5, 5),
                log_dir=str(tmp_path / cls.__name__), seed=1)
        before, twin = si.launches, fused_spline.calls
        s.run(200, 16, training, train_iters=20)
        torch.cuda.synchronize()
        assert si.launches - before == 200 * per_step + per_call
        assert fused_spline.calls == twin
        samp = s.samples[:, 50:].reshape(-1, 4)
        assert np.all(np.abs(samp.mean(axis=0)) < 0.3)
        assert np.all(np.abs(samp.std(axis=0) - 1.0) < 0.3)


class _NumpyOnly:
    """-|x|^2 / 2 - log(2 pi) in numpy: ``np.asarray`` of a CUDA tensor
    raises, so the sampler calls it on the host with float64 numpy."""

    def __init__(self):
        self.dtypes = set()

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float64)
        self.dtypes.add(type(x).__name__)
        return -0.5 * np.sum(x ** 2, axis=1) - np.log(2.0 * np.pi)


def test_host_likelihood_runs_on_the_card(tmp_path):
    """A numpy-only likelihood through the whole nested loop on the card:
    the chains still run the kernel (the twin never), and the 2-D Gaussian
    reaches its analytic logz."""
    _needs_gpu()
    from nnest_torch import NestedSampler
    from nnest_torch.ops import fused_spline
    like = _NumpyOnly()
    s = NestedSampler(2, like, transform=lambda x: 3 * x,
                      num_live_points=100, log_dir=str(tmp_path), seed=42)
    assert s._host_loglike and s.total_calls == 0
    before, twin = si.launches, fused_spline.calls
    s.run(train_iters=50, dlogz=0.3, mcmc_num_chains=10, volume_switch=0.5)
    torch.cuda.synchronize()
    assert s.run_stats['mcmc_generations'] > 0
    assert si.launches > before and fused_spline.calls == twin
    assert like.dtypes == {'ndarray'}
    assert abs(s.logz + 3.589) <= 0.6


def test_dynamic_sampler_launches_the_kernel(tmp_path):
    """The 2-D dynamic run on the card: the seed refresh and the batches
    run the kernel, the twin never; the merged logz near the analytic."""
    _needs_gpu()
    from nnest_torch import DynamicNestedSampler
    from nnest_torch.likelihoods import Gaussian
    from nnest_torch.ops import fused_spline
    like = Gaussian(2, 0.0, lim=3)
    d = DynamicNestedSampler(2, like, transform=lambda x: 3 * x,
                             num_live_init=100, log_dir=str(tmp_path), seed=3)
    before, twin = si.launches, fused_spline.calls
    d.run(G=0.5, num_batches=2, num_live_batch=50, dlogz=0.3,
          train_iters=30)
    torch.cuda.synchronize()
    assert si.launches > before and fused_spline.calls == twin
    analytic = like.analytic_logz([-3.0, -3.0], [3.0, 3.0])
    assert abs(d.logz - analytic) < 5 * d.logzerr + 0.2


def test_derived_parameters_ride_on_the_card(tmp_path):
    """A torch likelihood returning (logl, derived) through the nested
    loop on the card: the kernel runs (the twin never), and every saved
    point's derived columns are the function of its parameters."""
    _needs_gpu()
    from nnest_torch import NestedSampler
    from nnest_torch.ops import fused_spline

    def like(x):
        return (-0.5 * torch.sum(x ** 2, dim=-1) - np.log(2.0 * np.pi),
                torch.stack([x.sum(-1), x.prod(-1)], dim=-1))

    s = NestedSampler(2, like, transform=lambda x: 3 * x, num_derived=2,
                      num_live_points=100, log_dir=str(tmp_path), seed=5)
    assert not s._host_loglike
    before, twin = si.launches, fused_spline.calls
    s.run(train_iters=30, dlogz=0.3, mcmc_num_chains=10, volume_switch=0.5)
    torch.cuda.synchronize()
    assert s.run_stats['mcmc_generations'] > 0
    assert si.launches > before and fused_spline.calls == twin
    params = s.samples[:, :2]
    np.testing.assert_allclose(
        s.samples[:, 2:], np.stack([params.sum(1), params.prod(1)], 1),
        rtol=1e-4, atol=1e-4)
    assert abs(s.logz + 3.589) <= 0.6


def test_command_lines_and_model_file_on_the_card(tmp_path):
    """The nested command line on the card (a tiny 2-D Gaussian that
    reaches MCMC) launches the kernel and never the twin; its netG.pkl
    reloads on the card to the same log_prob; the ensemble command line's
    MCMC sampler launches once a step and once for its starts."""
    _needs_gpu()
    import argparse
    from nnest_torch import Trainer
    from nnest_torch.cli import ensemble, nested
    from nnest_torch.ops import fused_spline
    args = nested.build_parser().parse_args(
        ['--likelihood', 'gaussian', '--corr', '0.0', '--num_live_points',
         '100', '--train_iters', '30', '--strategy', 'rejection_prior,mcmc',
         '--switch', '0.5', '--log_dir', str(tmp_path)])
    assert isinstance(args, argparse.Namespace) and args.device == 'cuda'
    before, twin = si.launches, fused_spline.calls
    s = nested.main(args)
    torch.cuda.synchronize()
    assert si.launches > before and fused_spline.calls == twin
    assert s.run_stats['mcmc_generations'] > 0
    loaded = Trainer(2, hidden_dim=16, log_dir=str(tmp_path / 'gaussian'),
                     load_model='run1', log=False)
    pts = np.asarray(s.saved_u[-100:], dtype=np.float32)
    np.testing.assert_allclose(loaded.log_probs(pts, to_numpy=True),
                               s.trainer.log_probs(pts, to_numpy=True),
                               rtol=0, atol=1e-6)
    eargs = ensemble.build_parser().parse_args(
        ['--sampler', 'mcmc', '--mcmc_steps', '50', '--num_training_samples',
         '200', '--log_dir', str(tmp_path / 'ens')])
    before = si.launches
    e = ensemble.main(eargs)
    torch.cuda.synchronize()
    assert si.launches - before == 51
    assert e.samples.shape == (16, 51, 2) and np.all(np.isfinite(e.samples))


def test_graphed_training_step_equals_the_eager_one():
    """On the card a training step replays a captured CUDA graph: two
    epochs (two captures: the optimizer replaced in between by a restored
    snapshot) give the parameters of the same epochs run eagerly, the
    capture's warm-up leaving no trace."""
    _needs_gpu()
    from nnest_torch import Trainer
    x = torch.randn(95, 2, generator=torch.Generator().manual_seed(1))
    trainers = []
    for graphs in (True, False):
        t = Trainer(2, hidden_dim=16, batch_size=20, log=False, seed=3)
        t._use_graphs = graphs
        t.ensure_init(x.numpy())
        trainers.append(t)
    g = torch.Generator(device='cuda').manual_seed(5)
    train, valid = x[10:].cuda(), x[:10].cuda()
    for epoch in range(2):
        order = torch.randperm(85, generator=g, device='cuda')
        noise = torch.randn(5, 20, 2, generator=g, device='cuda')
        out = [t._train_epoch(train, valid, order, noise, 0.05, 1e-3)
               for t in trainers]
        assert float(out[0][0]) == pytest.approx(float(out[1][0]), abs=1e-6)
        assert out[0][1] == pytest.approx(out[1][1], abs=1e-6)
        for t in trainers:   # a new optimizer: the graph is captured anew
            t.restore_state(t.snapshot_state())
    for a, b in zip(trainers[0].model.parameters(),
                    trainers[1].model.parameters()):
        assert float((a - b).abs().max()) <= 1e-6
    assert trainers[0].optimizer.state_dict()['state'][0]['step'] == 10
