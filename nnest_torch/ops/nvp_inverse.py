"""The single-speed NVP flow's inverse: packing, launch plan, build, bind,
launch, and its plain twin.

``nvp_inverse(z, packed)`` is the hot inverse every Metropolis step runs
through a single-speed RealNVP flow (``flows/factory.py::_nvp_chain``:
alternating-mask affine couplings, ``scale`` '', ``'translate'`` or
``'constant'``; ``samplers/kernels.LatentKernels._hot_inverse``). For a
CUDA tensor it launches the hand-written kernel in ``csrc/nvp_inverse.cu``,
one launch for the whole chain; for a CPU tensor it runs the plain PyTorch
twin :func:`nvp_inverse_twin`, which reads the same packed buffer with the
same offsets. There is no fallback between the two: a CUDA tensor launches
the kernel or raises.

The kernel replaces no TPU kernel: the JAX package runs the NVP flow's
inverse as plain XLA inside its chain steps. It is added for launch count.
PyTorch runs the chain's inverse as ~80 small launches a call (each
coupling's two 3-layer MLPs, the masks, the affine and the logdet's sum), on
the host's path between a Metropolis step's graphs; at the example's widths
(d 50, hidden 16, 3 couplings, 256 rows) the call is ~5.7 MFLOP and
~150 KB, so latency bounds it, not the operations or the bytes (the
source's header has the design).

Each coupling's parameters are packed once a generation
(:func:`pack_nvp_consts`, one ``torch.cat``) into one segment in the order
the kernel consumes them, last coupling first: the mask, ``t_net`` and
``s_net`` ((n_in, n_out) weights then bias, three layers each), the
``ScaleLayer``'s s (0 without one), padded to a multiple of 4 floats
(:func:`segment_layout`). The source is compiled at first use with ``nvcc``
for ``sm_90a`` into ``csrc/build/`` (``ops/spline_inverse.build``) and
bound with ``ctypes``; a process that never runs an NVP flow on a card
never builds or loads it.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from nnest_torch.bijectors import AffineCoupling, ScaleLayer
from nnest_torch.flows.model import FastSlowFlowModel
from nnest_torch.ops.spline_inverse import BUILD_DIR, build
from nnest_torch.parallel.mesh import unshard

SOURCE = os.path.join(os.path.dirname(BUILD_DIR), 'nvp_inverse.cu')
# The kernel's limits (csrc/nvp_inverse.cu's kMaxDim, kMaxHidden and
# kMaxStages): the dims and the conditioners' width it takes, the weight
# stages it keeps.
MAX_DIM = 64
MAX_HIDDEN = 64
MAX_STAGES = 4
# Shared memory one thread block may use on Hopper (bytes).
MAX_SHARED_BYTES = 232448
# Blocks the plan aims to keep in flight (the H100 has 132 SMs) and the
# most rows one block takes.
TARGET_BLOCKS = 132
MAX_ROWS = 32

# Kernel launches since import (or since a caller reset them), and the
# plain twin's calls: chip_smoke.py sets both to 0, drives a sampler and
# checks that the card's path never ran the twin.
launches = 0
calls = 0
# nvcc's output for the loaded library, -Xptxas -v report included.
build_log = None

_lib = None
_lock = threading.Lock()
# launch arguments by (n, d, hidden, nets, couplings, rows): the plan
# depends on the shape alone, so it is worked out and checked against the
# library's layout once, not a call
_plans = {}


def _ceil4(v):
    return -(-v // 4) * 4


def segment_layout(d, hidden, nets):
    """One coupling's packed segment: ``(offsets, floats)``. ``offsets``
    maps ``mask``, ``scale`` and, for net n (0 ``t_net``, 1 ``s_net``;
    ``nets`` of them) and layer i, ``w{n}{i}`` (an (n_in, n_out) matrix,
    row-major) and ``b{n}{i}`` to float offsets; ``floats`` is the segment's
    length, a multiple of 4 (every segment a whole number of 16-byte
    copies). csrc/nvp_inverse.cu's ``Layout`` computes the same."""
    off, pos = {'mask': 0}, d
    for n in range(nets):
        for i, (n_in, n_out) in enumerate(((d, hidden), (hidden, hidden),
                                           (hidden, d))):
            off['w%d%d' % (n, i)] = pos
            pos += n_in * n_out
            off['b%d%d' % (n, i)] = pos
            pos += n_out
    off['scale'] = pos
    return off, _ceil4(pos + 1)


def _layout(chain):
    """(couplings, scale layers or None, hidden) of a chain in the
    factory's single-speed NVP layout, else None."""
    bijs = list(chain.bijectors) if chain is not None else []
    couplings = [b for b in bijs if isinstance(b, AffineCoupling)]
    if not couplings:
        return None
    if len(bijs) == 2 * len(couplings):
        scales = bijs[1::2]
        if not (all(isinstance(b, AffineCoupling) for b in bijs[0::2])
                and all(type(s) is ScaleLayer for s in scales)):
            return None
    elif len(bijs) == len(couplings):
        scales = None
    else:
        return None
    c0 = couplings[0]
    d, sizes = c0.dim, c0.t_net.sizes
    if len(sizes) != 4 or sizes[0] != d or sizes[3] != d \
            or sizes[1] != sizes[2]:
        return None
    for c in couplings:
        if (type(c) is not AffineCoupling or c.dim != d
                or c.translate_only != c0.translate_only
                or c.t_net.sizes != sizes or c.t_net.act != 'relu'
                or (c.s_net is not None and (c.s_net.sizes != sizes
                                             or c.s_net.act != 'tanh'))):
            return None
    return couplings, scales, sizes[1]


def is_fusable_nvp(model) -> bool:
    """True for a single-speed NVP flow in the factory's layout that the
    kernel takes: AffineCouplings with [d, h, h, d] conditioners (ReLU
    ``t_net``, tanh ``s_net`` or none), all translation-only or none, each
    followed by a ScaleLayer or none of them, 2 <= d <= ``MAX_DIM`` and
    h <= ``MAX_HIDDEN``. A fast-slow flow is not one."""
    if isinstance(model, FastSlowFlowModel):
        return False
    found = _layout(getattr(model, 'chain', None))
    if found is None:
        return False
    couplings, _, hidden = found
    return 2 <= couplings[0].dim <= MAX_DIM and 1 <= hidden <= MAX_HIDDEN


@torch.no_grad()
def pack_nvp_consts(model):
    """The flow's packing for :func:`nvp_inverse`: ``flat``, every
    coupling's segment (:func:`segment_layout`) last coupling first, in the
    parameters' dtype on their device, made by one ``torch.cat``; and the
    shape (``d``, ``hidden``, ``nets``, ``couplings``, ``scale``). Under
    tensor parallelism the weights are gathered over the tp group once a
    packing (``parallel.unshard``), so the inverse needs no collective."""
    model = unshard(model)
    couplings, scales, hidden = _layout(model.chain)
    c0 = couplings[0]
    d, nets = c0.dim, 1 if c0.translate_only else 2
    _, seg = segment_layout(d, hidden, nets)
    ref = c0.t_net.w[0]
    used = d + nets * (2 * d * hidden + hidden * hidden + 2 * hidden + d)
    pad = torch.zeros(seg - used, dtype=ref.dtype, device=ref.device)
    pieces = []
    for b in reversed(range(len(couplings))):
        c = couplings[b]
        pieces.append(c.mask.to(ref.dtype))
        for net in (c.t_net, c.s_net)[:nets]:
            for w, bias in zip(net.w, net.b):
                pieces += [w.detach().reshape(-1), bias.detach()]
        # the scale layer's s, then the padding (its first float the
        # scale's place where there is no scale layer)
        if scales is not None:
            pieces += [scales[b].s.detach().reshape(1), pad[1:]]
        else:
            pieces.append(pad)
    return {'flat': torch.cat(pieces), 'd': d, 'hidden': hidden,
            'nets': nets, 'couplings': len(couplings),
            'scale': scales is not None}


@torch.no_grad()
def nvp_inverse_twin(z, packed):
    """The kernel's function in plain PyTorch, read from ``packed['flat']``
    with :func:`segment_layout`'s offsets: for each segment (the chain's
    last coupling first) the ScaleLayer's inverse where there is one, then
    the coupling's: t = t_net(z m)(1 - m), log_s = s_net(z m)(1 - m) (none
    when translation-only), z = (z - t) exp(-log_s), logdet - sum(log_s).
    The operations and their order are those of ``model.inverse``."""
    global calls
    calls += 1
    d, h, nets = packed['d'], packed['hidden'], packed['nets']
    off, seg = segment_layout(d, h, nets)
    flat = packed['flat']
    acts = (torch.relu, torch.tanh)
    logdet = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    for c in range(packed['couplings']):
        p = flat[c * seg:(c + 1) * seg]
        if packed['scale']:
            s = p[off['scale']]
            z = z * torch.exp(-s)
            logdet = logdet + -d * s
        mask = p[:d]
        vm = z * mask
        keep = 1.0 - mask
        out = []
        for n in range(nets):
            v = vm
            for i, (n_in, n_out) in enumerate(((d, h), (h, h), (h, d))):
                w = off['w%d%d' % (n, i)]
                b = off['b%d%d' % (n, i)]
                v = v @ p[w:w + n_in * n_out].view(n_in, n_out) \
                    + p[b:b + n_out]
                if i < 2:
                    v = acts[n](v)
            out.append(v * keep)
        if nets == 1:
            z = z - out[0]
        else:
            z = (z - out[0]) * torch.exp(-out[1])
            logdet = logdet + -torch.sum(out[1], dim=-1)
    return z, logdet


def row_floats(d, hidden):
    """Shared floats of one row's state: z, the masked input, the two
    nets' two hidden activations, their two outputs, the running logdet
    (csrc/nvp_inverse.cu's ``row_floats``)."""
    return 4 * d + 4 * hidden + 1


def launch_plan(n, d, hidden, nets, couplings, rows=None):
    """How the kernel covers ``n`` rows: rows a thread block, the grid, the
    weight stages in shared memory and the shared bytes a block needs (the
    C entry checks the last against its own sum).

    By default a block takes the power of two of rows that keeps about
    ``TARGET_BLOCKS`` blocks in flight (at most ``MAX_ROWS``), halved until
    one stage fits beside the rows' state. The stages hold whole
    couplings: every coupling where they fit (all the weights loaded once,
    up front), else as many as fit, up to ``MAX_STAGES``, the next
    couplings' loads in flight while one is computed. ``rows`` overrides
    the choice (a sweep)."""
    _, seg = segment_layout(d, hidden, nets)
    per_row = 4 * row_floats(d, hidden)

    def room(r):
        return MAX_SHARED_BYTES - r * per_row

    if rows is None:
        want = -(-n // TARGET_BLOCKS)
        rows = 1
        while rows < min(want, MAX_ROWS):
            rows *= 2
        while rows > 1 and room(rows) < 4 * seg:
            rows //= 2
    rows = int(rows)
    stages = min(couplings, MAX_STAGES, room(rows) // (4 * seg))
    if stages < 1:
        raise ValueError('nvp inverse kernel: %d rows at d %d, hidden %d '
                         'need more shared memory than a block has'
                         % (rows, d, hidden))
    return {'rows': rows, 'grid': -(-n // rows), 'stages': stages,
            'segment_floats': seg,
            'smem_bytes': 4 * stages * seg + rows * per_row}


def load_library():
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so, build_log = build(SOURCE, 'nvp_inverse')
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nnest_nvp_inverse.argtypes = [vp] * 4 + [ci] * 9 + [vp]
        lib.nnest_nvp_inverse.restype = ci
        lib.nnest_nvp_segment_floats.argtypes = [ci, ci, ci]
        lib.nnest_nvp_segment_floats.restype = ci
        _lib = lib
        return lib


def _launch(z, packed, rows=None):
    """One launch of the kernel over every row of ``z``. ``rows``
    overrides the launch plan's rows a block (a sweep)."""
    if z.dtype != torch.float32 or packed['flat'].dtype != torch.float32:
        raise ValueError('nvp inverse kernel takes float32, got z %s and '
                         'parameters %s' % (z.dtype, packed['flat'].dtype))
    d, h, nets = packed['d'], packed['hidden'], packed['nets']
    if z.dim() != 2 or z.shape[1] != d:
        raise ValueError('z must be (n, %d), got %s' % (d, tuple(z.shape)))
    if not z.is_contiguous():
        raise ValueError('z must be contiguous')
    flat = packed['flat']
    if flat.device != z.device:
        raise ValueError('z is on %s, the flow on %s' % (z.device,
                                                         flat.device))
    lib = load_library()
    n, couplings = z.shape[0], packed['couplings']
    key = (n, d, h, nets, couplings, rows)
    plan = _plans.get(key)
    if plan is None:
        p = launch_plan(n, d, h, nets, couplings, rows)
        seg = lib.nnest_nvp_segment_floats(d, h, nets)
        if seg != p['segment_floats']:
            raise ValueError('the kernel\'s segment is %d floats, the '
                             'packing\'s %d' % (seg, p['segment_floats']))
        plan = _plans[key] = (seg, p['rows'], p['stages'], p['smem_bytes'])
    seg, *plan_args = plan
    if flat.numel() != couplings * seg:
        raise ValueError('packed nvp params hold %d floats, expected %d'
                         % (flat.numel(), couplings * seg))
    x = torch.empty_like(z)
    logdet = torch.empty(n, dtype=torch.float32, device=z.device)
    if n == 0:
        return x, logdet
    args = (z.data_ptr(), flat.data_ptr(), x.data_ptr(), logdet.data_ptr(),
            n, d, h, nets, couplings, int(packed['scale']), *plan_args,
            torch.cuda.current_stream(z.device).cuda_stream)
    if z.device.index == torch.cuda.current_device():
        err = lib.nnest_nvp_inverse(*args)
    else:
        with torch.cuda.device(z.device):
            err = lib.nnest_nvp_inverse(*args)
    if err != 0:
        raise RuntimeError('nvp inverse kernel launch failed: cudaError %d'
                           % err)
    return x, logdet


def nvp_inverse(z, packed):
    """Whole-chain inverse ``z -> (x, logdet)`` with the packing of
    :func:`pack_nvp_consts`: one kernel launch for a CUDA tensor, the plain
    twin for a CPU tensor."""
    global launches
    if z.device.type == 'cpu':
        return nvp_inverse_twin(z, packed)
    out = _launch(z, packed)
    launches += 1
    return out


def nvp_inverse_fn(model):
    """The single-speed NVP flow's inverse ``z -> (x, logdet)`` through
    :func:`nvp_inverse`, its parameters packed once, now."""
    packed = pack_nvp_consts(model)
    return lambda z: nvp_inverse(z, packed)
