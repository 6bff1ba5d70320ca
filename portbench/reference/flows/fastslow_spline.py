"""The ``fastslow_spline`` flow's reference: the plain inverse of a fast-slow
spline flow, read from a state dict, and its operation counts.

The flow is upstream nnest's fast-slow flow with spline chains (adammoss/
nnest v0.4.2, ``examples/nested/scripts/run_mog4_fast.sh``: ``--flow spline
--num_slow k``): the slow dims [0, k) go through a chain of their own, the
fast dims [k, d) through another, and one affine coupling ("combine") then
mixes the slow dims into the fast ones. This file is written from those
equations and the conventions the state dict encodes, and imports nothing
of the program:

- each chain is the single-speed spline flow of ``reference/flows/
  spline.py`` (state keys ``slow.*`` and ``fast.*`` in place of
  ``chain.*``), whose inverse this file calls;
- the combine coupling, a RealNVP affine coupling whose mask m is 1 on the
  slow dims: forward z = h * exp(log_s) + t, with t = t_net(h m) (1 - m)
  and log_s = s_net(h m) (1 - m); each net is x @ w + b over three layers
  (d -> 64 -> 64 -> d), ReLU (t_net) or tanh (s_net) between them. So
  h = (z - t) * exp(-log_s), t and log_s from z m (= h m), and the logdet
  is -sum(log_s);
- x = [slow chain^-1(h_slow), fast chain^-1(h_fast)], logdet the sum of
  the combine's and both chains'.

Departures from the published description, each kept as the program
builds the flow: the fast chain has hidden width 16 whatever the slow
chain's (``hidden_dim``) is, as upstream's own flow factory does; the
combine's mask is not in the state dict (a buffer the program does not
save), so it is rebuilt here from the slow chain's width; K = 8 bins and
tail bound 3 in both chains, the program's defaults.

TF32: a float64 call (the reference) runs with
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` set to False, and restores them after;
a float32 call computes as the caller set them, so the tf32 control's call
keeps TF32 on.

``inverse(state, z)`` computes in ``z``'s dtype and device: in float64 the
benchmark's reference for the hot inverse, in float32 with TF32 matmuls
the control. The operations are counted as ``harness/costs.py`` counts
them: each chain's ``inverse_cost`` and ``flow_forward_ops`` at its own d
and width, the combine coupling's two MLPs, masks and affine.
"""

from __future__ import annotations

import contextlib

import torch

from harness import costs
from reference.flows import spline

# The combine coupling's hidden width and its layers (the program's
# factory: AffineCoupling(..., 64, mask, num_layers=1): d -> 64 -> 64 -> d).
COMBINE_HIDDEN = 64
# The fast chain's hidden width, whatever hidden_dim is (upstream's quirk).
FAST_HIDDEN = 16


def _mlp(x, ws, bs, act):
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w + b
        if i < len(ws) - 1:
            x = act(x)
    return x


def _sub_state(state, prefix):
    """The chain under ``prefix`` as ``reference/flows/spline.py`` reads a
    single-speed flow: its keys under ``chain.``."""
    return {'chain.' + k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def num_slow(state):
    """The slow chain's width: its first ActNorm's."""
    return state['slow.bijectors.0.s'].shape[0]


def combine_inverse(state, z):
    """(h, logdet) of the combine coupling's inverse at ``z``."""
    dt, dev = z.dtype, z.device
    k = num_slow(state)
    mask = torch.zeros(z.shape[1], dtype=dt, device=dev)
    mask[:k] = 1.0
    keep = 1.0 - mask

    def net(name):
        n = sum(1 for key in state if key.startswith('combine.%s.w.' % name))
        return ([state['combine.%s.w.%d' % (name, i)].to(dev, dt)
                 for i in range(n)],
                [state['combine.%s.b.%d' % (name, i)].to(dev, dt)
                 for i in range(n)])

    masked = z * mask
    t = _mlp(masked, *net('t_net'), torch.relu) * keep
    log_s = _mlp(masked, *net('s_net'), torch.tanh) * keep
    return (z - t) * torch.exp(-log_s), -torch.sum(log_s, dim=-1)


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


def inverse(state, z):
    """(x, logdet) of the fast-slow flow in ``state`` (a state dict of
    tensors) at latent points ``z`` (n, d), computed in ``z``'s dtype."""
    with (_tf32_off() if z.dtype == torch.float64
          else contextlib.nullcontext()):
        k = num_slow(state)
        h, ld_c = combine_inverse(state, z)
        x_s, ld_s = spline.inverse(_sub_state(state, 'slow.'), h[:, :k])
        x_f, ld_f = spline.inverse(_sub_state(state, 'fast.'), h[:, k:])
        return torch.cat([x_s, x_f], dim=1), ld_s + ld_f + ld_c


def shape(config):
    """(d, slow dims, slow hidden, fast hidden, blocks) of the
    configuration's flow, which has to be a fast-slow spline flow."""
    args = config.get('flow_args', {})
    if args.get('flow', 'spline') != 'spline' or not args.get('num_slow', 0):
        raise ValueError('the fastslow_spline reference is the fast-slow '
                         'spline flow\'s, not that of %r' % args)
    return (config['likelihood']['x_dim'], args['num_slow'],
            config['hidden_dim'], FAST_HIDDEN,
            args.get('num_blocks', costs.NUM_BLOCKS))


def combine_ops(d):
    """One row through the combine coupling, either way: each net's three
    layers 2 (d h + h^2 + h d), their biases 2h + d and two activations
    2h; then z m d, the two products by 1 - m 2d, z - t d, -log_s and its
    exp 2d, the product d and the logdet's sum d (1 - m, once a call, is
    left out)."""
    h = COMBINE_HIDDEN
    net = 2 * (2 * d * h + h * h) + 2 * h + d + 2 * h
    return 2 * net + 8 * d


def inverse_ops(config, rows, calls):
    """Each chain's ``inverse_cost`` at ``rows`` rows (and its per-call
    part for each further call), the combine coupling's ``combine_ops`` a
    row, and the two logdet sums and the concatenation's nothing."""
    if not calls:
        return 0
    d, k, h_slow, h_fast, blocks = shape(config)
    ops = rows * (combine_ops(d) + 2)
    for dim, h in ((k, h_slow), (d - k, h_fast)):
        ops += (costs.inverse_cost(rows, dim, h, num_blocks=blocks)[0]
                + (calls - 1) * costs.inverse_cost(0, dim, h,
                                                   num_blocks=blocks)[0])
    return ops


def forward_ops(config):
    """One row through the flow's forward and its log density: each
    chain's forward (``flow_forward_ops`` less its base density 3 dim + 1),
    the combine coupling, the three logdets' sum 2 and the base density
    3d + 1."""
    d, k, h_slow, h_fast, blocks = shape(config)
    chains = sum(costs.flow_forward_ops(dim, h, num_blocks=blocks)
                 - (3 * dim + 1) for dim, h in ((k, h_slow), (d - k, h_fast)))
    return chains + combine_ops(d) + 2 + 3 * d + 1
