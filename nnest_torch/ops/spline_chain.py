"""A spline chain's forward in training: the CUDA kernel pair, its autograd
binding, its plain versions and the predicate that chooses it.

A spline-layout chain ([ActNorm, Invertible1x1Conv, SplineCoupling] x
blocks, ``fused_spline.is_spline_chain``) runs ``Chain.forward`` through
:func:`path`: ``'kernel'`` for a chain the kernels take (:func:`takes`: a
float32 CUDA batch, K, d, hidden and blocks within the kernels' limits,
no tensor-parallel shard), else ``'plain'``, the module-by-module forward
(for a CUDA batch with the coupling's own pair, ``ops/spline_coupling.py``).
The recorder's counter ``spline_chain`` {``kernel``, ``plain``} counts one
a spline-layout ``Chain.forward`` by its path.

On the kernel path (:func:`chain_forward`) the whole chain is one launch of
``csrc/spline_chain.cu``: every block's ActNorm, the conv's product with
its assembled W, both halves' conditioner MLPs and RQS, and the RQS row
logdet. What stays plain PyTorch around it: each conv's assembly ``W = P L
(U + diag S)`` and the parameter-only logdet ``sum(s) + sum(log|S|)``,
whose gradients autograd takes. Where a gradient is wanted the launch is
one :class:`_ChainFn`: the forward also saves each row's record of each
block (the block's input and every activation its backward reads), and
the backward is one launch (last block to first, from the records) plus
one launch that sums the thread blocks' partial weight gradients in a
fixed order, so two replays are bit-equal.
The kernels read every parameter where it lives (a table of pointers a
launch; nothing is repacked), allocate nothing (the wrapper allocates with
``torch.empty``), launch on the current stream and never synchronise, so a
training step's CUDA graph records them like any other launch. There is
no fallback: a CUDA batch :func:`takes` accepts launches the kernels or
raises.

:func:`chain_backward_plain` is the backward derived by hand in PyTorch,
line for line as the kernel derives it, so the CPU tests hold that
derivation to autograd through the plain chain.

The pair replaces no TPU kernel: the JAX package trains in plain XLA. It
is added for launch count (a captured training step of the cells' flows
was ~690 kernels, each bound by launch latency); what bounds it is the
chain's ~36 (forward) and ~40 (backward) dependent stages, each ending in
a barrier (the source's header). The source is compiled at first use with
``nvcc`` for ``sm_90a`` into ``csrc/build/``, one library a bin count, and
bound with ``ctypes``, as ``ops/spline_inverse.py`` builds its kernel.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from nnest_torch.bijectors.mlp import leaky_relu
from nnest_torch.ops.fused_spline import is_spline_chain
from nnest_torch.ops.spline_coupling import (coupling_rqs_backward_plain,
                                             coupling_rqs_plain)
from nnest_torch.ops.spline_inverse import BUILD_DIR, build

SOURCE = os.path.join(os.path.dirname(BUILD_DIR), 'spline_chain.cu')
# The kernels' limits (csrc/spline_chain.cu's constants of the same names).
MIN_BINS, MAX_BINS = 2, 16
MAX_BLOCKS = 8
MAX_DIM = 128
MAX_HIDDEN = 128
MAX_SHARED_BYTES = 230400
# Thread blocks a launch aims to keep in flight (the H100 has 132 SMs); a
# backward one writes a full set of partial gradients each, which the
# reduction reads back.
TARGET_BLOCKS = 132
# A flow block's tensors in the kernels' table order.
TENSORS = 19

# Kernel launches since import (or since a caller reset it): forward,
# backward and reduction each count one. A training step's graph capture
# moves it, its replays do not.
launches = 0
# nvcc's output for the library loaded last, -Xptxas -v report included.
build_log = None

_libs = {}
_lock = threading.Lock()


def load_library(num_bins=8):
    """Build (once per source hash and bin count) and load the kernels'
    library for ``num_bins`` bins (the factory's default 8 unless given):
    one library a bin count, so a build compiles the one instantiation a
    flow needs (all fifteen take nvcc ~2 minutes)."""
    global build_log
    if not MIN_BINS <= num_bins <= MAX_BINS:
        raise ValueError('spline chain kernel takes %d to %d bins, got %d'
                         % (MIN_BINS, MAX_BINS, num_bins))
    with _lock:
        lib = _libs.get(num_bins)
        if lib is not None:
            return lib
        so, build_log = build(SOURCE, 'spline_chain_k%d' % num_bins,
                              ('-DNNEST_CHAIN_BINS=%d' % num_bins,))
        lib = ctypes.CDLL(so)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nnest_chain_record_floats.argtypes = [ci, ci, ci]
        lib.nnest_chain_record_floats.restype = ci
        lib.nnest_chain_forward.argtypes = (
            [vp, ci, vp, vp, vp, vp, ci, ci, ci, ci, cf, ci, vp])
        lib.nnest_chain_forward.restype = ci
        lib.nnest_chain_backward.argtypes = (
            [vp, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cf, ci, vp])
        lib.nnest_chain_backward.restype = ci
        lib.nnest_chain_reduce.argtypes = [vp, ci, ci, vp, vp]
        lib.nnest_chain_reduce.restype = ci
        _libs[num_bins] = lib
        return lib


# ------------------------------------------------------------ the layout

def _blocks(chain):
    bijs = list(chain.bijectors)
    return [bijs[i:i + 3] for i in range(0, len(bijs), 3)]


def _shape(chain):
    """(d, hidden, bins, tail bound) of a spline-layout chain whose blocks
    all share them and whose conditioners are the factory's 4-layer
    LeakyReLU MLPs; None for any other."""
    shapes = set()
    for act, conv, sc in _blocks(chain):
        for net in (sc.f1, sc.f2):
            if len(net.w) != 4 or net.act != 'leaky_relu':
                return None
        shapes.add((act.dim, conv.dim, sc.dim, sc.hidden, sc.num_bins,
                    sc.tail_bound))
    if len(shapes) != 1:
        return None
    d, dc, ds, hidden, num_bins, tail_bound = shapes.pop()
    if not d == dc == ds:
        return None
    return d, hidden, num_bins, tail_bound


def tensor_shapes(d, hidden, num_bins):
    """The shapes of a flow block's tensors in the kernels' table order: s,
    t, W, then f1's and f2's (w, b) for layers 0-3."""
    per = 3 * num_bins - 1
    cut = d - d // 2
    up = d - cut
    shapes = [(d,), (d,), (d, d)]
    for n_in, n_out in ((cut, up * per), (up, cut * per)):
        sizes = (n_in, hidden, hidden, hidden, n_out)
        for i in range(4):
            shapes += [(sizes[i], sizes[i + 1]), (sizes[i + 1],)]
    return shapes


def block_tensors(act, conv, sc):
    """A flow block's tensors in table order; W assembled here (plain,
    differentiable)."""
    out = [act.s, act.t, conv.assemble()]
    for net in (sc.f1, sc.f2):
        for w, b in zip(net.w, net.b):
            out += [w, b]
    return out


def const_logdet(chain):
    """The chain's parameter-only logdet, sum(s) + sum(log|S|) a block
    (plain, differentiable)."""
    out = 0.0
    for act, conv, _ in _blocks(chain):
        out = out + torch.sum(act.s) + torch.sum(torch.log(torch.abs(conv.S)))
    return out


def record_floats(d, hidden, num_bins):
    """Floats of a row's record of one flow block, which the forward saves
    for the backward (the kernel's ``record_floats``): x, a, c, u, f1's and
    f2's three pre-activations, both raw outputs."""
    cut = d - d // 2
    return 3 * d + (d - cut) + 6 * hidden + d * (3 * num_bins - 1)


def row_floats(d, hidden, num_bins, backward):
    """Shared floats of one row's state in a thread block (the kernel's
    ``row_floats``)."""
    per = 3 * num_bins - 1
    cut = d - d // 2
    up = d - cut
    f = 3 * d + up + 6 * hidden + d * per + cut + 1
    if backward:
        f += cut * per + 2 * hidden + 3 * d + up + 1
    return f


def launch_plan(n, d, hidden, num_bins, backward):
    """Rows a thread block, grid and dynamic shared bytes for ``n`` rows:
    the fewest rows that keep at most ``TARGET_BLOCKS`` thread blocks,
    halved while a block's rows overfill its shared memory. Raises where
    one row does."""
    per_row = 4 * row_floats(d, hidden, num_bins, backward)
    rows = max(1, -(-n // TARGET_BLOCKS))
    while rows > 1 and rows * per_row > MAX_SHARED_BYTES:
        rows = -(-rows // 2)
    if rows * per_row > MAX_SHARED_BYTES:
        raise ValueError('spline chain kernel: one row of d %d, hidden %d, '
                         '%d bins needs %d bytes of shared memory, more than '
                         'a block has' % (d, hidden, num_bins, per_row))
    return {'rows': rows, 'grid': -(-n // rows), 'smem_bytes': rows * per_row}


# ------------------------------------------------------------ the predicate

def chain_fits(chain, device):
    """True where the kernels take a spline-layout ``chain`` on ``device``:
    its blocks alike (:func:`_shape`), bins, d, hidden and blocks within
    the kernels' limits, one row's backward state within a thread block's
    shared memory, every tensor float32 on ``device`` and none
    tensor-parallel sharded."""
    shape = _shape(chain)
    if shape is None:
        return False
    d, hidden, num_bins, _ = shape
    if not (MIN_BINS <= num_bins <= MAX_BINS and 2 <= d <= MAX_DIM
            and 1 <= hidden <= MAX_HIDDEN
            and 1 <= len(chain.bijectors) // 3 <= MAX_BLOCKS
            and 4 * row_floats(d, hidden, num_bins, True)
            <= MAX_SHARED_BYTES):
        return False
    return all(t.dtype == torch.float32 and t.device == device
               and getattr(t, 'tp_shard', None) is None
               for t in list(chain.parameters()) + list(chain.buffers()))


def takes(chain, x):
    """True where a spline-layout ``chain`` runs its forward on ``x``
    through the kernels: ``x`` a float32 CUDA (rows, d) batch and the chain
    fit for the kernels on its device (:func:`chain_fits`)."""
    return (x.device.type == 'cuda' and x.dtype == torch.float32
            and x.dim() == 2 and x.shape[1] == chain.bijectors[0].dim
            and chain_fits(chain, x.device))


def path(chain, x):
    """``Chain.forward``'s path for a batch ``x``: None for a chain without
    the spline layout, else ``'kernel'`` where :func:`takes` and
    ``'plain'`` otherwise."""
    if not is_spline_chain(chain):
        return None
    return 'kernel' if takes(chain, x) else 'plain'


# ----------------------------------------------------------------- kernels

def _check(x, tensors, d, hidden, num_bins):
    """Raise on what the kernels do not take: the table, x's type and
    shape, each tensor's, then the devices, so that every refusal but the
    last shows on the CPU too."""
    shapes = tensor_shapes(d, hidden, num_bins)
    if len(tensors) % TENSORS or not 1 <= len(tensors) // TENSORS <= \
            MAX_BLOCKS:
        raise ValueError('spline chain kernel takes %d tensors a block for '
                         '1 to %d blocks, got %d tensors'
                         % (TENSORS, MAX_BLOCKS, len(tensors)))
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != d or \
            not x.is_contiguous():
        raise ValueError('spline chain kernel takes x float32 contiguous '
                         '(rows, %d), got %s %s' % (d, x.dtype,
                                                     tuple(x.shape)))
    for i, t in enumerate(tensors):
        if tuple(t.shape) != shapes[i % TENSORS] or \
                t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError('spline chain kernel: tensor %d of block %d is '
                             '%s %s, it takes %s float32 contiguous'
                             % (i % TENSORS, i // TENSORS, t.dtype,
                                tuple(t.shape), shapes[i % TENSORS]))
    for t in [x] + list(tensors):
        if t.device.type != 'cuda' or t.device != x.device:
            raise ValueError('spline chain kernel needs its tensors on one '
                             'card, got %s beside x on %s'
                             % (t.device, x.device))


def _table(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _call(fn, device, *args):
    global launches
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError('spline chain kernel launch failed: cudaError %d'
                           % err)
    launches += 1


def forward_kernel(x, tensors, meta, save=False):
    """One launch of the forward kernel: ``(z, RQS row logdet, saved)``,
    ``saved`` each row's record of each block (blocks, rows,
    :func:`record_floats`) where ``save``, else None. ``meta``: (d,
    hidden, bins, tail bound)."""
    d, hidden, num_bins, tail_bound = meta
    _check(x, tensors, d, hidden, num_bins)
    n = x.shape[0]
    blocks = len(tensors) // TENSORS
    z = torch.empty_like(x)
    logdet = torch.empty(n, dtype=torch.float32, device=x.device)
    saved = (torch.empty(blocks, n, record_floats(d, hidden, num_bins),
                         dtype=torch.float32, device=x.device)
             if save else None)
    if n:
        lib = load_library(num_bins)
        if save and saved.shape[2] != lib.nnest_chain_record_floats(
                d, hidden, num_bins):
            raise ValueError('spline chain kernel: a record of %d floats, '
                             'the library counts %d' % (
                                 saved.shape[2],
                                 lib.nnest_chain_record_floats(
                                     d, hidden, num_bins)))
        plan = launch_plan(n, d, hidden, num_bins, False)
        _call(lib.nnest_chain_forward, x.device,
              _table(tensors),
              blocks, x.data_ptr(), z.data_ptr(), logdet.data_ptr(),
              saved.data_ptr() if save else None, n, d, hidden, num_bins,
              float(tail_bound), plan['rows'])
    return z, logdet, saved


def backward_kernel(saved, tensors, gz, gl, meta, need_x=True):
    """One launch of the backward kernel and one of the reduction:
    ``(d x or None, [the gradient of each tensor, table order])``, the
    gradients views of one buffer. ``gz`` (rows, d) and ``gl`` (rows,):
    dL/dz and dL/d row logdet."""
    d, hidden, num_bins, tail_bound = meta
    blocks, n, rf = saved.shape
    _check(gz, tensors, d, hidden, num_bins)
    if rf != record_floats(d, hidden, num_bins) or \
            blocks * TENSORS != len(tensors) or saved.device != gz.device:
        raise ValueError('spline chain kernel takes saved (%d, rows, %d) '
                         'on %s, got %s on %s' % (
                             len(tensors) // TENSORS,
                             record_floats(d, hidden, num_bins), gz.device,
                             tuple(saved.shape), saved.device))
    if gl.dtype != torch.float32 or gl.shape != (n,) or \
            gl.device != gz.device or tuple(gz.shape) != (n, d):
        raise ValueError('spline chain kernel takes gz (%d, %d) and gl '
                         '(%d,) float32 beside saved %s, got %s and %s %s'
                         % (n, d, n, tuple(saved.shape), tuple(gz.shape),
                            gl.dtype, tuple(gl.shape)))
    gl = gl.contiguous()
    shapes = tensor_shapes(d, hidden, num_bins) * blocks
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    total = sum(sizes)
    flat = torch.empty(total, dtype=torch.float32, device=gz.device)
    gx = torch.empty(n, d, dtype=torch.float32, device=gz.device) \
        if need_x else None
    if n:
        lib = load_library(num_bins)
        plan = launch_plan(n, d, hidden, num_bins, True)
        partial = torch.empty(plan['grid'], total, dtype=torch.float32,
                              device=gz.device)
        _call(lib.nnest_chain_backward, gz.device, _table(tensors), blocks,
              saved.data_ptr(), gz.data_ptr(), gl.data_ptr(),
              gx.data_ptr() if need_x else None, partial.data_ptr(), total,
              n, d, hidden, num_bins, float(tail_bound), plan['rows'])
        _call(lib.nnest_chain_reduce, gz.device, partial.data_ptr(),
              plan['grid'], total, flat.data_ptr())
    else:
        flat.zero_()
        if need_x:
            gx.zero_()
    grads, pos = [], 0
    for s, k in zip(shapes, sizes):
        grads.append(flat[pos:pos + k].view(s))
        pos += k
    return gx, grads


class _ChainFn(torch.autograd.Function):
    """The kernel pair under autograd. ``forward`` takes ``ctx`` (the old
    form), so ``torch.func`` transforms refuse it with an error rather
    than batching a backward that reads raw pointers."""

    @staticmethod
    def forward(ctx, x, meta, *tensors):
        z, logdet, saved = forward_kernel(x, tensors, meta, save=True)
        ctx.save_for_backward(saved, *tensors)
        ctx.meta = meta
        return z, logdet

    @staticmethod
    def backward(ctx, gz, gl):
        saved, *tensors = ctx.saved_tensors
        n, d = saved.shape[1:]
        gz = saved.new_zeros(n, d) if gz is None else gz.contiguous()
        gl = saved.new_zeros(n) if gl is None else gl
        gx, grads = backward_kernel(saved, tensors, gz, gl, ctx.meta,
                                    need_x=ctx.needs_input_grad[0])
        return (gx, None, *grads)


def chain_forward(chain, x):
    """A spline-layout chain's forward ``(z, logdet)`` through the kernels,
    for a batch :func:`takes` accepts: one launch, plus the plain conv
    assemblies and constant logdet around it; under autograd the pair."""
    meta = _shape(chain)
    tensors = chain_tensors(chain)
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in tensors)):
        z, logdet = _ChainFn.apply(x, meta, *tensors)
    else:
        z, logdet, _ = forward_kernel(x, tensors, meta)
    return z, logdet + const_logdet(chain)


# ------------------------------------------------------------ plain versions

def _mlp_forward(wb, v):
    """A conditioner's pre-activations (three hidden, then the raw
    output) from its (w, b) pairs and input ``v``."""
    pre, h = [], v
    for i, (w, b) in enumerate(wb):
        a = h @ w + b
        pre.append(a)
        if i < len(wb) - 1:
            h = leaky_relu(a)
    return pre


def _mlp_backward(wb, v, pre, g):
    """The kernel's ``mlp_backward``: from dL/d raw ``g``, d/d ``v`` and
    the (dw, db) of each layer."""
    grads = [None] * len(wb)
    for i in reversed(range(len(wb))):
        w = wb[i][0]
        inp = v if i == 0 else leaky_relu(pre[i - 1])
        grads[i] = (inp.T @ g, torch.sum(g, dim=0))
        g_in = g @ w.T
        if i > 0:
            g_in = torch.where(pre[i - 1] >= 0, g_in, 0.2 * g_in)
        g = g_in
    return g, grads


def _block_forward_plain(tensors, x, meta):
    """One flow block forward as the kernel computes it: every activation
    its backward reads, the block's output and its RQS row logdet."""
    d, _, num_bins, tail_bound = meta
    cut = d - d // 2
    s, t, W = tensors[:3]
    f1 = list(zip(tensors[3:11:2], tensors[4:11:2]))
    f2 = list(zip(tensors[11::2], tensors[12::2]))
    a = x * torch.exp(s) + t
    c = a @ W
    lower, upper = c[:, :cut], c[:, cut:]
    pre1 = _mlp_forward(f1, lower)
    u, ld1 = coupling_rqs_plain(pre1[-1], upper, num_bins, tail_bound)
    pre2 = _mlp_forward(f2, u)
    y, ld2 = coupling_rqs_plain(pre2[-1], lower, num_bins, tail_bound)
    acts = {'a': a, 'c': c, 'u': u, 'pre1': pre1, 'pre2': pre2, 'f1': f1,
            'f2': f2}
    return torch.cat([y, u], dim=1), ld1 + ld2, acts


def chain_forward_plain(tensors, x, meta):
    """The forward kernel's computation in plain PyTorch on the kernels'
    table of tensors: ``(z, RQS row logdet, each block's input)``."""
    inputs, logdet = [], 0.0
    for b in range(0, len(tensors), TENSORS):
        inputs.append(x)
        x, ld, _ = _block_forward_plain(tensors[b:b + TENSORS], x, meta)
        logdet = logdet + ld
    return x, logdet, inputs


def backward_plain(tensors, x, gz, gl, meta):
    """The backward kernel's derivation in plain PyTorch on the kernels'
    table of tensors (:func:`chain_backward_plain`)."""
    d, _, num_bins, tail_bound = meta
    cut = d - d // 2
    inputs = chain_forward_plain(tensors, x, meta)[2]
    grads = []
    for b in reversed(range(len(inputs))):
        block, xb = tensors[b * TENSORS:(b + 1) * TENSORS], inputs[b]
        s, _, W = block[:3]
        _, _, acts = _block_forward_plain(block, xb, meta)
        c = acts['c']
        lower, upper = c[:, :cut], c[:, cut:]
        # the lower half's RQS, then f2 (which read u)
        g_raw2, g_lower = coupling_rqs_backward_plain(
            acts['pre2'][-1], lower, gz[:, :cut], gl, num_bins, tail_bound)
        g_u, g_f2 = _mlp_backward(acts['f2'], acts['u'], acts['pre2'],
                                  g_raw2)
        g_u = gz[:, cut:] + g_u
        # the upper half's RQS, then f1 (which read c's lower half)
        g_raw1, g_upper = coupling_rqs_backward_plain(
            acts['pre1'][-1], upper, g_u, gl, num_bins, tail_bound)
        g_l, g_f1 = _mlp_backward(acts['f1'], lower, acts['pre1'], g_raw1)
        g_c = torch.cat([g_lower + g_l, g_upper], dim=1)
        # the conv, then ActNorm
        g_W = acts['a'].T @ g_c
        g_a = g_c @ W.T
        g_s = torch.sum(g_a * xb, dim=0) * torch.exp(s)
        g_t = torch.sum(g_a, dim=0)
        gz = g_a * torch.exp(s)
        out = [g_s, g_t, g_W]
        for g_net in (g_f1, g_f2):
            for gw, gb in g_net:
                out += [gw, gb]
        grads = out + grads
    return gz, grads


def chain_tensors(chain):
    """A spline-layout chain's tensors in the kernels' table order, block
    after block, each W assembled (plain, differentiable)."""
    out = []
    for blk in _blocks(chain):
        out += block_tensors(*blk)
    return out


def chain_backward_plain(chain, x, gz, gl):
    """The backward kernel's derivation in plain PyTorch: from the chain's
    input ``x``, dL/dz ``gz`` (rows, d) and dL/d(RQS row logdet) ``gl``
    (rows,), ``(d x, [the gradient of each tensor, table order])`` as
    autograd gives them through the plain chain with each block's
    assembled W a tensor of its own (the constant logdet left out: its
    gradients are autograd's, outside the kernels)."""
    return backward_plain(chain_tensors(chain), x, gz, gl, _shape(chain))
