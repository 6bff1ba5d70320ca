"""The ``nvp`` flow's reference: the plain inverse of a single-speed RealNVP
flow, read from a state dict, and its operation and byte counts.

The flow is upstream nnest's ``SingleSpeedNVP`` (adammoss/nnest v0.4.2,
``nnest/networks.py:248-347``; ``examples/nested/run.py --flow nvp``), the
affine coupling flow of Dinh et al. (arXiv:1605.08803). This file is
written from those equations and the conventions the state dict encodes,
and imports nothing of the program:

- ``num_blocks`` couplings; coupling k has the checkerboard mask
  m_i = (i + k) mod 2 (upstream's ``arange(d) % 2``, flipped after each
  block), 1 on the dims it passes through;
- forward z = x exp(log_s) + t, with t = t_net(x m) (1 - m) and
  log_s = s_net(x m) (1 - m); each net is x @ w + b over
  ``num_layers + 2`` layers (d -> h -> ... -> h -> d), ReLU (t_net) or
  tanh (s_net) between them. So x = (z - t) exp(-log_s), t and log_s from
  z m (= x m), and the logdet is -sum(log_s);
- ``scale`` 'translate': no s_net (the NICE coupling), x = z - t, logdet
  0; 'constant': translation-only couplings, each followed by a
  ``ScaleLayer``, z = x exp(s) with one scalar s, so x = z exp(-s);
- the inverse takes the couplings (and scale layers) last first.

Departures from upstream, each kept as the program builds the flow: a
``ScaleLayer``'s logdet is d s, where upstream returns s whatever d is
(right only at d 1; the JAX package's correction); each weight is stored
as JAX's (n_in, n_out) and the layer computes x @ w + b; the masks are not
in the state dict (a buffer the program does not save), so they are
rebuilt here from the couplings' order.

TF32: a float64 call (the reference) runs with
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` set to False, and restores them after;
a float32 call computes as the caller set them, so the tf32 control's call
keeps TF32 on.

``inverse(state, z)`` computes in ``z``'s dtype and device: in float64 the
benchmark's reference for the hot inverse, in float32 with TF32 matmuls
the control. Operations are counted as ``harness/costs.py`` counts them
(each exp, tanh, ReLU, product and sum one operation, a multiply-add two):
``inverse_cost`` is the NVP inverse kernel's yardstick, ``inverse_ops`` and
``forward_ops`` count the flow for ``mfu``.
"""

from __future__ import annotations

import contextlib
import re

import torch

from harness import costs

_BIJECTOR = re.compile(r'chain\.bijectors\.(\d+)\.')


@contextlib.contextmanager
def _tf32_off():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _mlp(x, ws, bs, act):
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w + b
        if i < len(ws) - 1:
            x = act(x)
    return x


def _net(state, prefix, dev, dt):
    """The (weights, biases) of the MLP under ``prefix``, or None."""
    n = sum(1 for key in state if key.startswith(prefix + 'w.'))
    if not n:
        return None
    return ([state['%sw.%d' % (prefix, i)].to(dev, dt) for i in range(n)],
            [state['%sb.%d' % (prefix, i)].to(dev, dt) for i in range(n)])


def inverse(state, z):
    """(x, logdet) of the NVP flow in ``state`` (a state dict of tensors)
    at latent points ``z`` (n, d), computed in ``z``'s dtype."""
    dt, dev = z.dtype, z.device
    with (_tf32_off() if dt == torch.float64
          else contextlib.nullcontext()):
        n, d = z.shape
        order = sorted({int(m.group(1)) for m in map(_BIJECTOR.match, state)
                        if m})
        # the couplings in chain order, each with its index among them
        layers, k = [], 0
        for i in order:
            pre = 'chain.bijectors.%d.' % i
            if pre + 't_net.w.0' in state:
                layers.append(('coupling', pre, k))
                k += 1
            else:
                layers.append(('scale', pre, None))
        logdet = torch.zeros(n, dtype=dt, device=dev)
        for kind, pre, k in reversed(layers):
            if kind == 'scale':
                s = state[pre + 's'].to(dev, dt)
                z = z * torch.exp(-s)
                logdet = logdet - d * s
                continue
            mask = torch.tensor([float((i + k) % 2) for i in range(d)],
                                dtype=dt, device=dev)
            masked, keep = z * mask, 1.0 - mask
            t = _mlp(masked, *_net(state, pre + 't_net.', dev, dt),
                     torch.relu) * keep
            s_net = _net(state, pre + 's_net.', dev, dt)
            if s_net is None:
                z = z - t
                continue
            log_s = _mlp(masked, *s_net, torch.tanh) * keep
            z = (z - t) * torch.exp(-log_s)
            logdet = logdet - torch.sum(log_s, dim=-1)
        return z, logdet


def shape(config):
    """(d, hidden, blocks, nets, scale layers) of the configuration's flow,
    which has to be a single-speed NVP flow with one hidden-to-hidden layer
    a net (upstream's ``--num_layers 1``): the counts below are that
    flow's. ``nets`` is 2, or 1 for translation-only couplings."""
    args = config.get('flow_args', {})
    if (args.get('flow') != 'nvp' or args.get('num_slow', 0)
            or args.get('num_layers', 1) != 1):
        raise ValueError('the nvp reference is the single-speed NVP flow\'s '
                         'at num_layers 1, not that of %r' % args)
    scale = args.get('scale', '')
    return (config['likelihood']['x_dim'], config['hidden_dim'],
            args.get('num_blocks', costs.NUM_BLOCKS),
            1 if scale in ('translate', 'constant') else 2,
            scale == 'constant')


def _net_ops(d, h):
    """One row through a net and its mask: the three layers' multiply-adds
    2 (d h + h^2 + h d), their biases 2h + d, the two activations 2h, and
    the product by 1 - m d."""
    return 2 * (2 * d * h + h * h) + 4 * h + 2 * d


def _params(d, h, nets, scale):
    """Floats one coupling reads: its mask d, each net's weights and
    biases, and a scale layer's s."""
    return d + nets * (2 * d * h + h * h + 2 * h + d) + int(scale)


def inverse_cost(n, d, hidden, blocks, nets=2, scale=False):
    """(operations, bytes) the chain inverse needs for n rows. Operations a
    row and coupling: z m d, the nets (``_net_ops`` each), then z - t d,
    and with an s_net -log_s, its exp and the product 3d and the logdet's
    sum d; the running logdet's add 1; a scale layer's product d and add
    1. Once a call and coupling: 1 - m d, and a scale layer's e^-s and
    -d s 3. Bytes: z read once, each coupling's mask and parameters read
    once, x and logdet written once."""
    affine = d + (4 * d if nets == 2 else 0)
    per_row = blocks * (d + nets * _net_ops(d, hidden) + affine + 1
                        + (d + 1 if scale else 0))
    ops = n * per_row + blocks * (d + (3 if scale else 0))
    nbytes = 4 * (2 * n * d + n + blocks * _params(d, hidden, nets, scale))
    return ops, nbytes


def inverse_ops(config, rows, calls):
    """``inverse_cost`` at ``rows`` rows, and its per-call part for each
    further call."""
    if not calls:
        return 0
    d, h, blocks, nets, scale = shape(config)
    return (inverse_cost(rows, d, h, blocks, nets, scale)[0]
            + (calls - 1) * inverse_cost(0, d, h, blocks, nets, scale)[0])


def forward_ops(config):
    """One row through the flow's forward and its log density: per
    coupling x m d, the nets, with an s_net exp(log_s), the product and
    the add 3d and the logdet's sum d (else the add d), the running
    logdet's add 1, a scale layer's product d and add 1; then the base
    density 3d + 1."""
    d, h, blocks, nets, scale = shape(config)
    affine = 4 * d if nets == 2 else d
    per_block = (d + nets * _net_ops(d, h) + affine + 1
                 + (d + 1 if scale else 0))
    return blocks * per_block + 3 * d + 1
