"""nnest_torch stands alone: it imports neither jax nor nnest_tpu, and its
entry points run on CUDA unless asked for the CPU. It offers nnest_tpu's
import surface: every name of nnest_tpu's ``__all__`` lists (the profiling
helpers of ``nnest_tpu.utils`` included), ``Prior.__call__`` as
nnest_tpu's, ``FlowModel.sample``."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

# One intra-op thread a process: the suite runs in parallel workers that
# share the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_RUN = """
import sys
sys.modules['jax'] = None        # any import of jax now raises ImportError
sys.modules['nnest_tpu'] = None
import torch
import nnest_torch
from nnest_torch import NestedSampler, Trainer, build_flow
import nnest_torch.likelihoods, nnest_torch.priors
import nnest_torch.utils.evaluation, nnest_torch.samplers.nested
from nnest_torch.likelihoods import (DoubleGaussianShell, Eggbox,
                                     GaussianMix, GaussianShell, Himmelblau)
from nnest_torch.ops.fused_spline import pack_inverse_consts
from nnest_torch.ops.spline_inverse import spline_inverse
import nnest_torch.ops.consume_pool
from nnest_torch.samplers.kernels import LatentKernels
model = build_flow(3, device='cpu')
x, logdet = spline_inverse(torch.randn(5, 3), pack_inverse_consts(model))
assert x.shape == (5, 3) and bool(torch.isfinite(logdet).all())
kernels = LatentKernels(model, GaussianMix(3),
                        lambda u: torch.zeros(u.shape[0]))
g = torch.Generator().manual_seed(0)
out = kernels.rejection_flow_live(g, -50.0, torch.rand(8, 3), 0.0, 0.0,
                                  False, 1.1, 16)
out = kernels.density(g, -50.0, 16)
out = kernels.slice_from_live(g, torch.rand(8, 3), torch.zeros(8),
                              num_chains=4, loglstar=-50.0, width=1.0,
                              slice_steps=1, adapt_cov=True)
from nnest_torch.distributions import GeneralisedNormal
for kw in (dict(flow='nvp', scale='constant'), dict(flow='cholesky'),
           dict(flow='spline', num_slow=1),
           dict(flow='nvp', base_dist=GeneralisedNormal(3))):
    other = LatentKernels(build_flow(3, device='cpu', **kw), GaussianMix(3),
                          lambda u: torch.zeros(u.shape[0]), num_slow=1)
    out = other.rejection_flow_live(g, -50.0, torch.rand(8, 3), 0.0, 0.0,
                                    False, 1.1, 16)
    out = other.density(g, -50.0, 16)
trainer = Trainer(3, device='cpu', log=False)
trainer.restore_state(trainer.snapshot_state())
import nnest_torch.cli.analyse, nnest_torch.cli.ensemble, nnest_torch.cli.nested
import nnest_torch.cli.multihost
from nnest_torch.utils.profiling import StepTimer, device_trace
from nnest_torch.flows.testing import brute_force_logdet
assert brute_force_logdet(model, torch.randn(2, 3)).shape == (2,)
from nnest_torch.parallel import get_mesh, make_sharded_mcmc, shard_batch
mesh = get_mesh()
assert shard_batch(torch.zeros(3, 2), mesh)[0].shape == (3, 2)
assert nnest_torch.cli.multihost.build_parser().parse_args([]).device == 'cuda'
from nnest_torch.utils.buffer import SampleBuffer
from nnest_torch.utils.io_async import SerialWriter
writer, rows = SerialWriter(), SampleBuffer(4)
writer.submit(lambda: rows.append([[1.0], [2.0]]))
writer.close()
assert len(rows) == 2
assert nnest_torch.cli.nested.build_parser().parse_args([]).device == 'cuda'
from nnest_torch import DynamicNestedSampler, EnsembleSampler, MCMCSampler
import nnest_torch.samplers.dynamic, nnest_torch.samplers.ensemble
import nnest_torch.samplers.mcmc
from nnest_torch.likelihoods import Gaussian
from nnest_torch.priors import UniformPrior
dyn = DynamicNestedSampler(2, Gaussian(2, 0.0), transform=lambda u: 3 * u,
                           num_live_init=20, log_dir=None, device='cpu',
                           log_level=30)
dyn.run(num_batches=1, num_live_batch=10, dlogz=1.0, train_iters=1,
        mcmc_steps=2)
assert dyn.samples.shape[1] == 2 and dyn.insertion_p_value is not None
training = torch.randn(60, 2, generator=g).numpy()
for cls, kw in ((MCMCSampler, {}), (EnsembleSampler, {})):
    s = cls(2, Gaussian(2, 0.0), prior=UniformPrior(2, -5, 5), log_dir=None,
            device='cpu', log_level=30)
    assert s.run(3, 4, training, train_iters=1).shape == (4, 4, 2)
boot = EnsembleSampler(2, Gaussian(2, 0.0), prior=UniformPrior(2, -5, 5),
                       log_dir=None, device='cpu', log_level=30)
assert boot.bootstrap(3, 4, iters=1, thin=1, train_iters=1,
                      moves={'stretch': 1, 'kde': 1}).shape[1] == 2
from nnest_torch.samplers import (EnsembleSampler, LatentKernels, MCMCSampler,
                                  NestedSampler, Sampler)
from nnest_torch.utils import (SampleBuffer, create_logger,
                               effective_sample_size, get_or_create_run_dir)
from nnest_torch.ops import fused_inverse_fn, is_fusable_spline
from nnest_torch.distributions import BaseDistribution
from nnest_torch.priors import Prior
from nnest_torch.parallel import params_sharding_tree, unshard
from nnest_torch import runtime
assert runtime.available() and runtime.fallbacks == 0
chains = torch.randn(2, 20, 3, generator=g).double().numpy()
assert effective_sample_size(chains, chains.mean(axis=(0, 1)),
                             chains.var(axis=(0, 1))).shape == (3,)
assert runtime.native_calls > 0
assert fused_inverse_fn(model)(torch.randn(4, 3))[0].shape == (4, 3)
assert UniformPrior(2, -1, 1)([0.0, 0.0]) == 0.0
assert model.sample(5, g).shape == (5, 3)
loaded = [m for m in sys.modules
          if m.split('.')[0] in ('jax', 'jaxlib', 'nnest_tpu')
          and sys.modules[m] is not None]
assert not loaded, loaded
print('ok')
"""


def test_imports_and_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, '-c', _BLOCKED_RUN], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith('ok')


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r'^\s*(import|from)\s+(jax|jaxlib|nnest_tpu)\b',
                         re.MULTILINE)
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for dirpath, _, names in os.walk(os.path.join(ROOT, 'nnest_torch')):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith('.py')]
    offenders = []
    for path in files:
        with open(path) as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert len(files) > 10 and not offenders, offenders


def test_tf32_is_off():
    import nnest_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is usable')
    from nnest_torch import (DynamicNestedSampler, EnsembleSampler,
                             MCMCSampler, NestedSampler, Trainer, build_flow)
    from nnest_torch.likelihoods import Gaussian
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        build_flow(2)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Trainer(2)
    for cls in (NestedSampler, DynamicNestedSampler, MCMCSampler,
                EnsembleSampler):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            cls(2, Gaussian(2, 0.0), log_dir=None)


def test_trainer_has_the_transport_api():
    """The port's Trainer offers nnest_tpu's public transport names: every
    public method or property of nnest_tpu's Trainer that maps points or
    draws samples."""
    from nnest_torch import Trainer
    from nnest_tpu.training.trainer import Trainer as JaxTrainer
    names = ('forward', 'inverse', 'log_probs', 'get_prior_samples',
             'get_latent_samples', 'get_samples', 'get_synthetic_samples',
             'num_params', 'base_dist')
    for name in names:
        assert hasattr(JaxTrainer, name), name
        assert hasattr(Trainer, name), name
        assert isinstance(getattr(Trainer, name), property) == isinstance(
            getattr(JaxTrainer, name), property), name
    public = {n for n in vars(JaxTrainer) if n.startswith('get_')}
    assert public <= set(names), public - set(names)


@pytest.mark.parametrize('module', [
    'nnest_tpu', 'nnest_tpu.samplers', 'nnest_tpu.utils', 'nnest_tpu.ops',
    'nnest_tpu.distributions', 'nnest_tpu.parallel'])
def test_nnest_tpu_names_resolve_in_the_port(module):
    import importlib
    ref = importlib.import_module(module)
    port = importlib.import_module(module.replace('nnest_tpu',
                                                  'nnest_torch'))
    names = set(ref.__all__)
    assert names, module
    missing = {n for n in names if not hasattr(port, n)}
    assert not missing, missing
    assert names <= set(port.__all__)


def test_prior_call_matches_nnest_tpu():
    from nnest_torch.priors import Prior, UniformPrior
    from nnest_tpu.priors import UniformPrior as JaxUniformPrior
    port = UniformPrior(3, -1.0, [1.0, 2.0, 3.0])
    ref = JaxUniformPrior(3, -1.0, [1.0, 2.0, 3.0])
    assert isinstance(port, Prior)
    batch = np.random.RandomState(0).uniform(-2, 4, size=(20, 3))
    for x in ([0.0, 1.5, 2.5], [0.0, 2.5, 2.5], np.array([0.5, 0.5, -1.0]),
              np.array([1.5, 0.0, 0.0]), batch, batch.tolist()):
        got, want = port(x), ref(x)
        assert type(got) is type(want)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype == np.float64
            assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert {float(v) for v in port(batch)} == {0.0, -np.inf}
    with pytest.raises(NotImplementedError):
        Prior(2)([0.0, 0.0])


def test_flow_sample_is_the_inverse_of_base_draws():
    import jax
    import jax.numpy as jnp
    from nnest_torch.flows import build_flow, params_from_jax
    from nnest_tpu.flows import build_flow as jax_build_flow
    jm = jax_build_flow(3, flow='spline', hidden_dim=16)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(
        np.random.RandomState(0).normal(size=(16, 3)), jnp.float32))
    model = params_from_jax(build_flow(3, hidden_dim=16, device='cpu'),
                            jax.tree.map(np.asarray, params))
    got = model.sample(32, torch.Generator().manual_seed(5))
    z = model.sample_base(32, torch.Generator().manual_seed(5))
    want, _ = jm.inverse(params, jnp.asarray(z.numpy()))
    assert got.shape == (32, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
