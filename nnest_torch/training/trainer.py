"""Flow trainer: maximum-likelihood training of a normalizing flow.

Port of ``nnest_tpu/training/trainer.py``, for any flow ``build_flow``
makes (spline, NVP, Cholesky, fast-slow):

- Adam with coupled L2 weight decay (decay added to the gradient before the
  Adam moments): ``torch.optim.Adam(weight_decay=...)`` over the flow's
  parameters. Frozen buffers (the 1x1-conv permutation ``_P``) are not
  parameters, so they are never updated. The optimizer state persists
  across ``train()`` calls, as the JAX trainer's does. ``train(l2_norm=)``
  adds ``l2_norm`` times the sum of squares of every tensor of the JAX
  package's parameter tree (``flows/convert.param_tensors``, frozen buffers
  included, as ``nnest_tpu`` sums ``tree_leaves(params)``) to the loss.
- A 10% validation split, patience early stopping, and restore of the
  best-validation parameters at the end of training. One epoch is
  :meth:`Trainer._train_epoch`, given the epoch's row order and noise;
  ``train`` draws both from the trainer's generator.
- The padded, masked tail batch: when the batch size does not divide the
  training set, the last batch repeats rows with weight 0.
- Auto-jitter ``0.2 x`` the mean nearest-neighbour distance, divided by
  sqrt(d) above 16-D (the JAX package's law, copied as it is).
- ``save``/``load`` in ``nnest_tpu``'s ``netG.pkl`` format: a pickle of the
  parameter tree in the JAX layout with numpy leaves
  (``flows/convert.params_to_jax``/``params_from_jax``), so a model file of
  either package loads in the other; ``snapshot_state``/``restore_state``
  of everything a later ``train()`` reads (flow, Adam state, the trainer's
  generator, the early-stop bookkeeping), so a retrain after a restore is
  bit-identical on the CPU.
- The run directory: with ``log_dir`` the trainer makes ``models/``,
  ``data/``, ``chains/`` and ``plots/`` there, and each ``train()`` writes
  ``data/originals.npy``, ``models/netG.pkl``, one ``loss`` scalar an epoch
  (the validation loss) to TensorBoard, all of a training's in one write of
  the run directory's scalar event file (:meth:`log_scalars`,
  ``utils/events.py``; the ``SummaryWriter``'s file takes the images), and
  the real/latent/synthetic triptych ``plots/plot_<total_iters>.png``,
  rendered on a worker thread (:meth:`finish_plots` joins it).
  ``load_model`` loads ``<log_dir>/<load_model>/models/netG.pkl``. matplotlib and
  ``torch.utils.tensorboard`` are imported only when used; without them
  there is no plot and the writer is a null writer, as in ``nnest_tpu``.
- The transport API of the JAX trainer: ``forward`` and ``inverse`` (each
  ``(out, logdet)``), ``log_probs``, ``get_prior_samples`` (base draws),
  ``get_latent_samples``, ``get_samples``, ``get_synthetic_samples`` (the
  inverse of base draws), ``num_params`` and ``base_dist``; each takes
  numpy, lists or tensors (a 1-D input is one row) and returns tensors on
  the trainer's device, or float32 numpy with ``to_numpy=True``.

- Data parallelism (``mesh=``, a :class:`nnest_torch.parallel.Mesh` with a
  process group): every rank draws the same epoch order and noise; when the
  training rows' count divides dp each batch is dp-sharded (its rows padded
  to a multiple of dp with weight 0), each rank backpropagates its rows'
  share of the batch's weighted mean NLL, and the gradients and the NLL are
  summed over the ranks in one collective before Adam, whose update is then
  the same on every rank; the L2 term is added on rank 0 (the step is
  ``parallel.make_sharded_train_step``). The validation loss is sharded and
  summed the same way when the validation rows' count divides dp. On a GPU
  the sharded step is two CUDA graphs, the forward and backward, then Adam,
  with the collective eager between them (gloo cannot be captured); a
  one-rank mesh without a process group trains as ``mesh=None`` does.
- Tensor parallelism (a mesh with tp > 1): the flow is sharded at
  construction (``parallel.shard_params``), its wide conditioner layers
  column-parallel over the tp group; the batches are dp-sharded as above
  over the dp shards, and the step is eager (a collective inside the
  forward cannot be captured). Every rank calls ``train`` and the
  transport API; the model file and the plots are made from the whole
  flow, gathered on every rank (``parallel.unshard``), by rank 0.

Training is the flow's forward plus autograd in PyTorch, and the transport
API the flow's ``forward`` and plain ``inverse``; the JAX package runs both
in plain XLA, with no hand-written kernel. On a card a spline chain's
forward (every block's ActNorm, conv product, both halves' conditioner
MLPs and RQS) is one hand-written CUDA launch and its backward one more
plus a reduction of the weight gradients (``ops/spline_chain.py``); a
spline chain outside that kernel's limits takes each coupling half's
transform pair (``ops/spline_coupling.py``); both are recorded into the
step's graph like the rest, and the CPU runs the plain code. The
recorder's counter ``train_step`` {``fused``, ``plain``} counts each step
by the path its forward took: ``fused`` where it launched either.
``epoch_chunk`` and ``use_gpu`` are accepted and change nothing, as in
``nnest_tpu``; ``device`` decides placement. Unlike ``nnest_tpu``, whose
default ``log_dir`` is ``'logs/test'``, a trainer built without a
``log_dir`` writes nothing.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import pickle
import threading
import time

import numpy as np
import torch

from nnest_torch.flows import build_flow
from nnest_torch.flows.convert import (param_tensors, params_from_jax,
                                       params_to_jax)
from nnest_torch.ops import spline_chain, spline_coupling
from nnest_torch.parallel.mesh import (all_reduce_sum, shard_batch,
                                       shard_params, unshard)
from nnest_torch.parallel.sharded import (dp_backward, dp_rows, l2_term,
                                          make_sharded_train_step)
from nnest_torch.utils.device import resolve_device
from nnest_torch.utils.events import ScalarEventFile
from nnest_torch.utils.logger import create_logger
from nnest_torch.utils.profiling import count


def _launches():
    """Launches of the training kernels so far: the spline chain's pair
    (``ops/spline_chain.py``) and the spline coupling's
    (``ops/spline_coupling.py``)."""
    return spline_chain.launches + spline_coupling.launches


def _path(launches_before):
    """'fused' where a training kernel launched since ``launches_before``
    (a :func:`_launches` reading), else 'plain'."""
    return 'fused' if _launches() != launches_before else 'plain'


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
                 load_model='',
                 log_dir=None,
                 use_gpu=False,
                 log=True,
                 learning_rate=0.0001,
                 weight_decay=1e-6,
                 log_level=logging.INFO,
                 seed=0,
                 num_bins=8,
                 tail_bound=3.0,
                 epoch_chunk=25,
                 device='cuda',
                 mesh=None):
        del use_gpu   # placement follows ``device``
        self.device = resolve_device(device)
        self.mesh = mesh
        # data parallelism needs a process group to sum over
        self._dp = mesh is not None and mesh.group is not None
        self.x_dim = x_dim
        self.batch_size = batch_size
        self.epoch_chunk = max(1, int(epoch_chunk))   # no effect
        self.total_iters = 0
        self.model = build_flow(x_dim, flow=flow, hidden_dim=hidden_dim,
                                num_slow=num_slow, num_blocks=num_blocks,
                                num_layers=num_layers, scale=scale,
                                base_dist=base_dist, num_bins=num_bins,
                                tail_bound=tail_bound, seed=seed,
                                device=self.device)
        if mesh is not None:
            shard_params(self.model, mesh)
        # the tensors of nnest_tpu's parameter tree, which l2_norm sums over
        self._l2_tensors = param_tensors(self.model)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.initialized = False
        self.optimizer = None
        # on a GPU a training step runs as a CUDA graph (_graphed_step),
        # but for a collective inside the forward (tp); the tests turn it
        # off to compare with the eager step
        self._use_graphs = self.device.type == 'cuda' and (
            mesh is None or mesh.tp == 1)
        self._graphs, self._graphs_for = {}, None
        # the Metropolis step loop's CUDA graphs (samplers/kernels.py),
        # kept here so that the samplers sharing this trainer capture once
        self.mcmc_graphs = {}
        self.last_training_jitter = None
        self.plot_seconds = 0.0
        self.logger = create_logger(__name__, level=log_level)
        self.log = log
        self.writer = None
        # the scalar event file beside the writer's, made at the first
        # scalar (log_scalars)
        self._scalars = None
        # one writer, two threads (the triptych render and the caller)
        self._writer_lock = threading.Lock()
        self._plot_thread = None
        self._plot_error = None

        if load_model:
            self.path = os.path.join(log_dir, load_model)
            self.load(os.path.join(self.path, 'models', 'netG.pkl'))
        elif log_dir is not None:
            self.path = log_dir
            for sub in ('models', 'data', 'chains', 'plots'):
                os.makedirs(os.path.join(self.path, sub), exist_ok=True)
        else:
            self.path = None
        if self.path is not None:
            self.writer = _make_writer(self.path)
        self.logger.info('Flow [%s] x_dim [%d]' % (flow, x_dim))

    @property
    def writes_events(self):
        """Whether the trainer writes TensorBoard events (a run directory
        and the package there)."""
        return self.writer is not None and not isinstance(self.writer,
                                                          _NullWriter)

    def log_scalars(self, tag, steps, values, wall_times):
        """TensorBoard scalars, one a row, appended to the run directory's
        scalar event file in one write (``utils/events.py``) under the
        writer's lock (the samplers log through this, from their IO thread
        too); nothing where the trainer writes no events."""
        if not self.writes_events:
            return
        with self._writer_lock:
            if self._scalars is None:
                self._scalars = ScalarEventFile(self.path)
            self._scalars.write(tag, steps, values, wall_times)

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
        # capturable: Adam's step count lives on the device, so a CUDA
        # graph can replay the update
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=self.learning_rate,
            weight_decay=self.weight_decay,
            capturable=self.device.type == 'cuda')

    def _validation_loss(self, valid, shard=False):
        """The mean NLL of ``valid``; with ``shard`` each rank sums its
        rows' share and the shares are summed over the ranks."""
        with torch.no_grad():
            if not shard:
                return -torch.mean(self.model.log_prob(valid))
            rows, _ = shard_batch(valid, self.mesh)
            part = torch.sum(self.model.log_prob(rows)) / valid.shape[0]
            return -all_reduce_sum(part.reshape(1), self.mesh)[0]

    def train(self,
              samples,
              max_iters=10000,
              log_interval=100,
              save_interval=100,
              jitter=0.0,
              validation_fraction=0.1,
              patience=50,
              l2_norm=0.0):
        """Maximum-likelihood training with early stopping. The model is
        saved once, at the end (``save_interval`` is accepted, as in
        ``nnest_tpu``, whose whole training is one device program)."""
        del save_interval
        start = time.time()
        samples = np.asarray(samples, dtype=np.float32)
        self.ensure_init(samples)
        data = self._tensor(samples)
        if self.path:
            np.save(os.path.join(self.path, 'data', 'originals.npy'), samples)
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

        # dp-shard the batches and the validation set when their row counts
        # divide dp (nnest_tpu's rule); otherwise every rank computes all
        shard = (self._dp and n_train % self.mesh.dp == 0,
                 self._dp and n_valid % self.mesh.dp == 0)
        best_params = copy.deepcopy(self.model.state_dict())
        best_val, best_i, counter, i = 1e30, -1, 0, 0
        val_trace, val_times = [], []
        while i < max_iters and counter <= patience:
            order = torch.randperm(n_train, generator=self.generator,
                                   device=self.device)
            noise = torch.randn((nb, bs, self.x_dim), generator=self.generator,
                                device=self.device)
            train_loss, val_loss = self._train_epoch(
                train, valid, order, noise, training_jitter, l2_norm, *shard)
            val_trace.append(val_loss)
            val_times.append(time.time())
            if val_loss < best_val:
                best_val, best_i, counter = val_loss, i, 0
                best_params = copy.deepcopy(self.model.state_dict())
            else:
                counter += 1
            if self.log and (i == 0 or (i + 1) % max(1, log_interval) == 0):
                self.logger.info(
                    'Epoch [%i] train loss [%5.4f] validation loss [%5.4f]'
                    % (i + 1, float(train_loss), val_loss))
            i += 1
        if self.log and i < max_iters:
            self.logger.info('Epoch [%i] ran out of patience' % i)
        self.log_scalars('loss', range(self.total_iters + 1,
                                       self.total_iters + i + 1),
                         val_trace, val_times)

        self.total_iters += i
        self.model.load_state_dict(best_params)
        self.best_validation_epoch = best_i + 1 if best_i >= 0 else 0
        self.best_validation_loss = float(best_val)
        with self._unsharded():
            if self.path:
                self.save(os.path.join(self.path, 'models', 'netG.pkl'))
                if self.x_dim >= 2:
                    self.plot_samples(samples, outfile=os.path.join(
                        self.path, 'plots',
                        'plot_%s.png' % self.total_iters), asynchronous=True)
        if self.log:
            self.logger.info(
                'Best epoch [%i] validation loss [%5.4f] train time (s) '
                '[%5.4f]' % (self.best_validation_epoch,
                             self.best_validation_loss, time.time() - start))

    @contextlib.contextmanager
    def _unsharded(self):
        """``self.model`` whole inside the block: under tensor parallelism
        a copy gathered over the tp group (every rank enters), else the
        model itself."""
        model = self.model
        self.model = unshard(model)
        try:
            yield
        finally:
            self.model = model

    def _train_epoch(self, train, valid, order, noise, jitter, l2_norm=0.0,
                     shard_train=False, shard_valid=False):
        """One epoch: the training rows in ``order`` (a permutation of
        ``len(train)``), padded to ``noise.shape[:2]`` = (batches, batch
        size) with repeated rows of weight 0, each batch plus ``jitter``
        times its ``noise`` rows, one Adam step a batch on the weighted mean
        NLL (plus ``l2_norm`` times the sum of squares of the parameter
        tree); ``shard_train`` and ``shard_valid`` dp-shard the steps and
        the validation loss (module docstring). Returns (the batches' mean
        NLL as a 0-dim tensor, the validation loss after the epoch as a
        float)."""
        nb, bs = noise.shape[:2]
        pad = nb * bs - train.shape[0]
        epoch = train[order]
        if pad:
            # masked duplicate rows: their values never reach the loss
            epoch = torch.cat([epoch, epoch[:pad]], dim=0)
        epoch = epoch.reshape(nb, bs, -1)
        weights = torch.ones(nb, bs, device=train.device)
        if pad:
            weights[-1, bs - pad:] = 0.0
        if shard_train:
            step = (self._graphed_dp_step(bs, l2_norm) if self._use_graphs
                    else make_sharded_train_step(self.model, self.optimizer,
                                                 self.mesh, l2_norm))
        else:
            step = (self._graphed_step(bs, l2_norm) if self._use_graphs
                    else lambda x, w: self._step(x, w, l2_norm))
        # the path a step's forward took: fixed at capture for a graph,
        # seen step by step for an eager one
        path = getattr(step, 'path', None)
        train_loss = 0.0
        for b in range(nb):
            before = _launches()
            train_loss = train_loss + step(epoch[b] + jitter * noise[b],
                                           weights[b])
            count('train_step', key=path or _path(before))
        return train_loss / nb, float(self._validation_loss(valid,
                                                            shard_valid))

    def _step(self, batch, w, l2_norm):
        """One Adam step on the weighted mean NLL of ``batch`` (plus the
        L2 term); returns the NLL."""
        with torch.enable_grad():
            nll = -torch.sum(self.model.log_prob(batch) * w) / torch.sum(w)
            loss = nll
            if l2_norm > 0:
                loss = nll + l2_norm * l2_term(self._l2_tensors, self.mesh)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        self.optimizer.step()
        return nll.detach()

    def _graphed_step(self, bs, l2_norm):
        """:meth:`_step` for (bs, d) batches as a CUDA graph: the forward,
        backward and Adam kernels of one step (several thousand small
        launches eagerly) replayed by one call. Captured once for each
        batch size and L2 weight, anew after the optimizer is replaced
        (``load_params``, ``restore_state``); the parameters and Adam's
        state are the same tensors throughout, updated in place."""
        if self._graphs_for is not self.optimizer:
            self._graphs, self._graphs_for = {}, self.optimizer
        key = (int(bs), float(l2_norm))
        if key not in self._graphs:
            self._graphs[key] = self._capture(int(bs), float(l2_norm))
        static_x, static_w, static_nll, graph, path = self._graphs[key]

        def step(batch, w):
            static_x.copy_(batch)
            static_w.copy_(w)
            graph.replay()
            return static_nll.clone()

        step.path = path
        return step

    def _capture(self, bs, l2_norm):
        """Warm up and capture one training step (:meth:`_warmed_up`), with
        the path its forward took: 'fused' where the capture launched a
        training kernel (:func:`_launches`), else 'plain'."""
        static_x = torch.zeros(bs, self.x_dim, device=self.device)
        static_w = torch.ones(bs, device=self.device)
        graph = torch.cuda.CUDAGraph()
        with self._warmed_up(lambda: self._step(static_x, static_w,
                                                l2_norm)):
            before = _launches()
            with torch.cuda.graph(graph, capture_error_mode='thread_local'):
                static_nll = self._step(static_x, static_w, l2_norm)
        return static_x, static_w, static_nll, graph, _path(before)

    @contextlib.contextmanager
    def _warmed_up(self, step):
        """Run ``step`` three times on a side stream (the warm-up a CUDA
        graph capture needs), then the block (the captures). The warm-up
        moves the parameters and Adam's state: on exit both are put back
        as they were (a state not made yet as Adam makes it: zeros, step
        0)."""
        opt = self.optimizer
        params = list(self.model.parameters())
        saved_params = [p.detach().clone() for p in params]
        saved_state = {p: {k: v.clone() for k, v in opt.state[p].items()}
                       for p in params if opt.state[p]}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                step()
        torch.cuda.current_stream().wait_stream(side)
        opt.zero_grad(set_to_none=True)
        yield
        with torch.no_grad():
            for p, saved in zip(params, saved_params):
                p.copy_(saved)
            for p in params:
                for k, v in opt.state[p].items():
                    if p in saved_state:
                        v.copy_(saved_state[p][k])
                    else:
                        v.zero_()

    def _graphed_dp_step(self, bs, l2_norm):
        """The dp step (``parallel.make_sharded_train_step``) for (bs, d)
        batches as two CUDA graphs: the forward and backward with the
        gradients and NLL packed into one flat tensor, then (after the
        eager collective sums it over the ranks) the unpacking into the
        gradients and Adam. Captured as :meth:`_graphed_step` is."""
        if self._graphs_for is not self.optimizer:
            self._graphs, self._graphs_for = {}, self.optimizer
        key = ('dp', int(bs), float(l2_norm))
        if key not in self._graphs:
            self._graphs[key] = self._capture_dp(int(bs), float(l2_norm))
        static_x, static_w, static_wt, flat, reduced, graph_a, graph_b, \
            path = self._graphs[key]

        def step(batch, w):
            rows, w_rows = dp_rows(self.mesh, batch, w)
            static_x.copy_(rows)
            static_w.copy_(w_rows)
            static_wt.copy_(torch.sum(w))
            graph_a.replay()
            reduced.copy_(all_reduce_sum(flat, self.mesh))
            graph_b.replay()
            return reduced[-1].clone()

        step.path = path
        return step

    def _capture_dp(self, bs, l2_norm):
        """Warm up and capture the two graphs of :meth:`_graphed_dp_step`
        (:meth:`_warmed_up`). The warm-up sums nothing over the ranks:
        every rank runs it on the same zeros, and its result is
        discarded."""
        params = list(self.model.parameters())
        m = shard_batch(torch.zeros(bs, 1), self.mesh)[0].shape[0]
        static_x = torch.zeros(m, self.x_dim, device=self.device)
        static_w = torch.ones(m, device=self.device)
        static_wt = torch.full((), float(bs), device=self.device)

        def backward():
            nll = dp_backward(self.model, self.optimizer, self.mesh,
                              static_x, static_w, static_wt, l2_norm,
                              self._l2_tensors)
            return torch.cat([p.grad.reshape(-1) for p in params]
                             + [nll.reshape(1)])

        def update(packed):
            offset = 0
            for p in params:
                n = p.numel()
                p.grad.copy_(packed[offset:offset + n].view_as(p))
                offset += n
            self.optimizer.step()

        graph_a, graph_b = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with self._warmed_up(lambda: update(backward())):
            before = _launches()
            with torch.cuda.graph(graph_a, capture_error_mode='thread_local'):
                flat = backward()
            path = _path(before)
            reduced = torch.zeros_like(flat)
            with torch.cuda.graph(graph_b, capture_error_mode='thread_local'):
                update(reduced)
        return (static_x, static_w, static_wt, flat, reduced, graph_a,
                graph_b, path)

    # --------------------------------------------------------- persistence

    def save(self, path):
        """The flow's parameter tree to ``path`` in ``nnest_tpu``'s
        ``netG.pkl`` format (a pickle of the JAX layout, numpy leaves)."""
        with open(path, 'wb') as f:
            pickle.dump(params_to_jax(self.model), f)

    def load(self, path):
        """A ``netG.pkl`` of either package."""
        with open(path, 'rb') as f:
            self.load_params(pickle.load(f))

    def load_params(self, tree):
        """Rebind the flow from a parameter tree in the JAX layout (numpy
        leaves); the optimizer starts afresh, as after a data-dependent
        init."""
        params_from_jax(self.model, tree)
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
        self.model.load_state_dict(snap['model'])
        self._new_optimizer()
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

    # --------------------------------------------------------------- plots

    def plot_samples(self, samples, outfile=None, plot_synthetic=True,
                     asynchronous=False):
        """The real/latent/synthetic triptych of ``samples``, with the
        warped grid at 2-D, to ``outfile`` and (with a writer) TensorBoard.

        The generator's state is restored after the synthetic draw, so a
        plot changes no later result. With ``asynchronous`` the flow's work
        runs here and the matplotlib render on a worker thread;
        :meth:`finish_plots` joins it and raises what the render raised."""
        state = self.generator.get_state()
        try:
            data = self._plot_samples_data(samples, plot_synthetic)
        finally:
            self.generator.set_state(state)
        if data is None:
            return
        if asynchronous:
            self.finish_plots()
            # not a daemon: interpreter exit waits for the file
            self._plot_thread = threading.Thread(
                target=self._render_worker, args=(data, outfile))
            self._plot_thread.start()
        else:
            self._render_triptych(data, outfile)

    def _render_worker(self, data, outfile):
        """The asynchronous render; its seconds add to ``plot_seconds``
        and, while the program records, to the ``plot`` background
        counters."""
        t0 = time.time_ns()
        try:
            self._render_triptych(data, outfile)
        except BaseException as e:  # raised again by finish_plots()
            self._plot_error = e
        finally:
            ns = time.time_ns() - t0
            self.plot_seconds += ns * 1e-9
            count('background_ns', ns, 'plot')
            count('background_jobs', 1, 'plot')

    def finish_plots(self):
        """Join an asynchronous render, re-raise its failure, and flush the
        TensorBoard writer."""
        if self._plot_thread is not None:
            self._plot_thread.join()
            self._plot_thread = None
        if self._plot_error is not None:
            e, self._plot_error = self._plot_error, None
            raise e
        if self.writer is not None:
            with self._writer_lock:
                self.writer.flush()

    def _plot_samples_data(self, samples, plot_synthetic):
        """The flow's part of a plot, as host numpy; None without
        matplotlib."""
        try:
            import matplotlib  # noqa: F401  (the probe only)
        except ImportError:
            return None
        samples = np.asarray(samples)

        def warp_grid(pts_fn, xr, yr, ng=30):
            xv, yv = np.meshgrid(np.linspace(*xr, ng), np.linspace(*yr, ng))
            xy = np.stack([xv, yv], -1).reshape(ng * ng, 2).astype(np.float32)
            return np.asarray(pts_fn(xy)).reshape(ng, ng, 2)

        data = {
            'samples': samples,
            'z': self.get_latent_samples(samples, to_numpy=True),
            'synthetic': (self.get_synthetic_samples(samples.shape[0],
                                                     to_numpy=True)
                          if plot_synthetic else None),
            'grids': None,
            'total_iters': self.total_iters,
        }
        if self.x_dim == 2:
            data['grids'] = (
                warp_grid(lambda g: self.get_samples(g, to_numpy=True),
                          (-3, 3), (-3, 3)),
                warp_grid(
                    lambda g: self.get_latent_samples(g, to_numpy=True),
                    (samples[:, 0].min() - .1, samples[:, 0].max() + .1),
                    (samples[:, 1].min() - .1, samples[:, 1].max() + .1)))
        return data

    def _render_triptych(self, data, outfile):
        """The render: numpy and matplotlib's object-oriented API (no
        pyplot state), safe on a worker thread."""
        from matplotlib import collections as mc
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure
        samples, z = data['samples'], data['z']
        ncols = 3 if data['synthetic'] is not None else 2
        fig = Figure(figsize=(4 * ncols + 1, 5))
        FigureCanvasAgg(fig)
        ax = fig.subplots(1, ncols)
        ax[0].scatter(samples[:, 0], samples[:, 1], c='r', s=5, alpha=0.5)
        ax[0].set_title('Real data')

        def add_grid(axis, xs):
            # the warped grid's lines along both mesh directions
            for p1, p2 in ((xs[1:, :, :], xs[:-1, :, :]),
                           (xs[:, 1:, :], xs[:, :-1, :])):
                axis.add_collection(mc.LineCollection(
                    list(zip(p1.reshape(-1, 2), p2.reshape(-1, 2))),
                    linewidths=1, alpha=0.2, color='k'))

        if data['grids'] is not None:
            add_grid(ax[0], data['grids'][0])
            add_grid(ax[1], data['grids'][1])
        ax[1].scatter(z[:, 0], z[:, 1], c='r', s=5, alpha=0.5)
        ax[1].set_title('Latent data')
        if data['synthetic'] is not None:
            xs = data['synthetic']
            ax[2].scatter(xs[:, 0], xs[:, 1], c='r', s=5, alpha=0.5)
            ax[2].set_title('Synthetic data')
        fig.tight_layout()
        if outfile is not None:
            fig.savefig(outfile)   # draws on the figure's Agg canvas
        else:
            fig.canvas.draw()
        if self.writes_events:
            # the triptych (as drawn, not drawn again) and the training
            # data's scatter, the images nnest_tpu sends
            image = np.asarray(fig.canvas.buffer_rgba())[..., :3]
            fig0 = Figure(figsize=(5, 5))
            FigureCanvasAgg(fig0)
            ax0 = fig0.subplots(1, 1)
            ax0.scatter(samples[:, 0], samples[:, 1], c='r', s=5, alpha=0.5)
            ax0.set_title('Originals')
            with self._writer_lock:
                self.writer.add_image('latent', image, data['total_iters'],
                                      dataformats='HWC')
                self.writer.add_figure('originals', fig0,
                                       data['total_iters'])


def _out(tree, to_numpy):
    """A tensor, or a tuple of them, as is or as numpy on the host."""
    if not to_numpy:
        return tree
    if isinstance(tree, tuple):
        return tuple(t.cpu().numpy() for t in tree)
    return tree.cpu().numpy()


class _NullWriter:
    """The writer without TensorBoard: every call does nothing."""

    def add_figure(self, *args, **kwargs):
        pass

    def add_image(self, *args, **kwargs):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def _make_writer(path):
    """A TensorBoard ``SummaryWriter`` on ``path``, or a null writer when
    ``torch.utils.tensorboard`` cannot be imported."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return _NullWriter()
    return SummaryWriter(path)
