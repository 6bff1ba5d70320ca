"""Flow trainer: maximum-likelihood training of a normalizing flow.

Port of the training path of ``nnest_tpu/training/trainer.py``, for any
flow ``build_flow`` makes (spline, NVP, Cholesky, fast-slow):

- Adam with coupled L2 weight decay (decay added to the gradient before the
  Adam moments): ``torch.optim.Adam(weight_decay=...)`` over the flow's
  parameters. Frozen buffers (the 1x1-conv permutation ``_P``) are not
  parameters, so they are never updated. The optimizer state persists
  across ``train()`` calls, as the JAX trainer's does.
- A 10% validation split, patience early stopping, and restore of the
  best-validation parameters at the end of training.
- The padded, masked tail batch: when the batch size does not divide the
  training set, the last batch repeats rows with weight 0.
- Auto-jitter ``0.2 x`` the mean nearest-neighbour distance, divided by
  sqrt(d) above 16-D (the JAX package's law, copied as it is).
- ``save``/``load`` of the flow's ``state_dict``, and
  ``snapshot_state``/``restore_state`` of everything a later ``train()``
  reads (flow, Adam state, the trainer's generator, the early-stop
  bookkeeping), so a retrain after a restore is bit-identical on the CPU.
- The transport API of the JAX trainer: ``forward`` and ``inverse`` (each
  ``(out, logdet)``), ``log_probs``, ``get_prior_samples`` (base draws),
  ``get_latent_samples``, ``get_samples``, ``get_synthetic_samples`` (the
  inverse of base draws), ``num_params`` and ``base_dist``; each takes
  numpy, lists or tensors (a 1-D input is one row) and returns tensors on
  the trainer's device, or float32 numpy with ``to_numpy=True``.

Training is the flow's forward plus autograd in plain PyTorch, and the
transport API the flow's plain ``forward`` and ``inverse``; the JAX package
runs both in plain XLA too, with no hand-written kernel.
"""

from __future__ import annotations

import copy
import logging
import time

import numpy as np
import torch

from nnest_torch.flows import build_flow
from nnest_torch.utils.device import resolve_device
from nnest_torch.utils.logger import create_logger


def mean_nn_distance(x):
    """Mean distance to the nearest neighbour (auto-jitter scale)."""
    sq = torch.sum(x ** 2, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    d2 = d2 + torch.diag(torch.full_like(sq, 1e30))
    return torch.mean(torch.sqrt(torch.clamp(torch.min(d2, dim=1).values,
                                             min=0.0)))


class Trainer:
    best_validation_epoch = None
    best_validation_loss = None

    def __init__(self,
                 x_dim,
                 hidden_dim=16,
                 num_slow=0,
                 batch_size=100,
                 flow='spline',
                 scale='',
                 num_blocks=3,
                 num_layers=1,
                 base_dist=None,
                 learning_rate=0.0001,
                 weight_decay=1e-6,
                 log=True,
                 log_level=logging.INFO,
                 seed=0,
                 num_bins=8,
                 tail_bound=3.0,
                 device='cuda'):
        self.device = resolve_device(device)
        self.x_dim = x_dim
        self.batch_size = batch_size
        self.total_iters = 0
        self.model = build_flow(x_dim, flow=flow, hidden_dim=hidden_dim,
                                num_slow=num_slow, num_blocks=num_blocks,
                                num_layers=num_layers, scale=scale,
                                base_dist=base_dist, num_bins=num_bins,
                                tail_bound=tail_bound, seed=seed,
                                device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.initialized = False
        self.optimizer = None
        self.last_training_jitter = None
        self.logger = create_logger(__name__, level=log_level)
        self.log = log
        self.logger.info('Flow [%s] x_dim [%d]' % (flow, x_dim))

    def _tensor(self, a):
        """float32 rows on the trainer's device from numpy, a list or a
        tensor; a 1-D input is one row."""
        if isinstance(a, torch.Tensor):
            a = a.to(device=self.device, dtype=torch.float32)
        else:
            a = torch.as_tensor(np.asarray(a, dtype=np.float32),
                                device=self.device)
        return a[None, :] if a.dim() == 1 else a

    def ensure_init(self, samples=None):
        """Data-dependent init (ActNorm statistics) from ``samples``, or
        from 64 base draws when there is no data, then the optimizer."""
        if self.initialized:
            return
        x = (self._tensor(samples) if samples is not None
             else self.model.sample_base(64, self.generator))
        self.model.data_init(x)
        self._new_optimizer()
        self.initialized = True

    def _new_optimizer(self):
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=self.learning_rate,
            weight_decay=self.weight_decay)

    def _validation_loss(self, valid):
        with torch.no_grad():
            return -torch.mean(self.model.log_prob(valid))

    def train(self, samples, max_iters=10000, jitter=0.0,
              validation_fraction=0.1, patience=50, log_interval=100):
        """Maximum-likelihood training with early stopping."""
        start = time.time()
        samples = np.asarray(samples, dtype=np.float32)
        self.ensure_init(samples)
        data = self._tensor(samples)
        if jitter < 0:
            training_jitter = 0.2 * float(mean_nn_distance(data))
            if self.x_dim > 16:
                training_jitter /= float(self.x_dim) ** 0.5
        else:
            training_jitter = float(jitter)
        self.last_training_jitter = training_jitter
        if self.log:
            self.logger.info('Number of training samples [%d]' % len(data))
            self.logger.info('Training jitter [%5.4f]' % training_jitter)

        n = data.shape[0]
        n_valid = max(1, int(round(n * validation_fraction)))
        perm = torch.randperm(n, generator=self.generator, device=self.device)
        valid, train = data[perm[:n_valid]], data[perm[n_valid:]]
        n_train = train.shape[0]
        bs = min(self.batch_size, n_train)
        nb = (n_train + bs - 1) // bs
        pad = nb * bs - n_train
        weights = torch.ones(nb, bs, device=self.device)
        if pad:
            weights[-1, bs - pad:] = 0.0

        model, opt = self.model, self.optimizer
        best_params = copy.deepcopy(model.state_dict())
        best_val, best_i, counter, i = 1e30, -1, 0, 0
        while i < max_iters and counter <= patience:
            order = torch.randperm(n_train, generator=self.generator,
                                   device=self.device)
            epoch = train[order]
            if pad:
                # masked duplicate rows: their values never reach the loss
                epoch = torch.cat([epoch, epoch[:pad]], dim=0)
            epoch = epoch.reshape(nb, bs, -1)
            noise = torch.randn(epoch.shape, generator=self.generator,
                                device=self.device)
            train_loss = 0.0
            for b in range(nb):
                batch = epoch[b] + training_jitter * noise[b]
                w = weights[b]
                nll = -torch.sum(model.log_prob(batch) * w) / torch.sum(w)
                opt.zero_grad(set_to_none=True)
                nll.backward()
                opt.step()
                train_loss = train_loss + nll.detach()
            val_loss = float(self._validation_loss(valid))
            if val_loss < best_val:
                best_val, best_i, counter = val_loss, i, 0
                best_params = copy.deepcopy(model.state_dict())
            else:
                counter += 1
            if self.log and (i == 0 or (i + 1) % max(1, log_interval) == 0):
                self.logger.info(
                    'Epoch [%i] train loss [%5.4f] validation loss [%5.4f]'
                    % (i + 1, float(train_loss) / nb, val_loss))
            i += 1
        if self.log and i < max_iters:
            self.logger.info('Epoch [%i] ran out of patience' % i)

        self.total_iters += i
        model.load_state_dict(best_params)
        self.best_validation_epoch = best_i + 1 if best_i >= 0 else 0
        self.best_validation_loss = float(best_val)
        if self.log:
            self.logger.info(
                'Best epoch [%i] validation loss [%5.4f] train time (s) '
                '[%5.4f]' % (self.best_validation_epoch,
                             self.best_validation_loss, time.time() - start))

    # --------------------------------------------------------- persistence

    def save(self, path):
        """The flow's parameters and buffers (``state_dict``) to ``path``."""
        torch.save(self.model.state_dict(), path)

    def load(self, path):
        self.load_params(torch.load(path, map_location='cpu',
                                    weights_only=True))

    def load_params(self, state):
        """Rebind the flow's parameters and buffers from a ``state_dict``;
        the optimizer starts afresh, as after a data-dependent init."""
        self.model.load_state_dict(state)
        self._new_optimizer()
        self.initialized = True

    def snapshot_state(self):
        """Everything a later ``train()`` reads, as CPU copies: the flow's
        ``state_dict``, the Adam state, the generator state, the iteration
        count, the best validation loss and epoch and the last jitter."""
        def cpu(tree):
            if isinstance(tree, torch.Tensor):
                return tree.detach().to('cpu', copy=True)
            if isinstance(tree, dict):
                return {k: cpu(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(cpu(v) for v in tree)
            return copy.deepcopy(tree)

        return {
            'initialized': self.initialized,
            'model': cpu(self.model.state_dict()),
            'optimizer': (None if self.optimizer is None
                          else cpu(self.optimizer.state_dict())),
            'generator': self.generator.get_state(),
            'total_iters': self.total_iters,
            'best_validation_loss': self.best_validation_loss,
            'best_validation_epoch': self.best_validation_epoch,
            'last_training_jitter': self.last_training_jitter,
        }

    def restore_state(self, snap):
        """Inverse of :meth:`snapshot_state`; ``snap`` is left unchanged."""
        self.load_params(snap['model'])
        if snap['optimizer'] is None:
            self.optimizer = None
        else:
            self.optimizer.load_state_dict(copy.deepcopy(snap['optimizer']))
        self.initialized = bool(snap['initialized'])
        self.generator.set_state(snap['generator'].cpu())
        self.total_iters = int(snap['total_iters'])
        self.best_validation_loss = snap['best_validation_loss']
        self.best_validation_epoch = snap['best_validation_epoch']
        self.last_training_jitter = snap['last_training_jitter']

    # ------------------------------------------------------------ transport

    def num_params(self):
        """The flow's parameter and buffer count (its ``state_dict``)."""
        self.ensure_init()
        return sum(int(v.numel()) for v in self.model.state_dict().values())

    @property
    def base_dist(self):
        return self.model.base_dist

    def forward(self, x, to_numpy=False):
        """x → (z, log|det dz/dx|)."""
        self.ensure_init()
        with torch.no_grad():
            return _out(self.model(self._tensor(x)), to_numpy)

    def inverse(self, z, to_numpy=False):
        """z → (x, log|det dx/dz|)."""
        self.ensure_init()
        with torch.no_grad():
            return _out(self.model.inverse(self._tensor(z)), to_numpy)

    def get_prior_samples(self, num_samples, to_numpy=False):
        """``num_samples`` draws of the base distribution (latent space),
        from the trainer's generator."""
        self.ensure_init()
        return _out(self.model.sample_base(num_samples, self.generator),
                    to_numpy)

    def get_latent_samples(self, x, to_numpy=False):
        return self.forward(x, to_numpy=to_numpy)[0]

    def get_samples(self, z, to_numpy=False):
        return self.inverse(z, to_numpy=to_numpy)[0]

    def get_synthetic_samples(self, num_samples, to_numpy=False):
        """``num_samples`` draws of the flow: base draws from the trainer's
        generator through the inverse."""
        return self.get_samples(self.get_prior_samples(num_samples),
                                to_numpy=to_numpy)

    def log_probs(self, x, to_numpy=False):
        self.ensure_init()
        with torch.no_grad():
            return _out(self.model.log_prob(self._tensor(x)), to_numpy)


def _out(tree, to_numpy):
    """A tensor, or a tuple of them, as is or as numpy on the host."""
    if not to_numpy:
        return tree
    if isinstance(tree, tuple):
        return tuple(t.cpu().numpy() for t in tree)
    return tree.cpu().numpy()
