"""nnest_torch stands alone: it imports neither jax nor nnest_tpu, and its
entry points run on CUDA unless asked for the CPU."""

import os
import re
import subprocess
import sys

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
