"""The spline coupling's RQS forward in training: the CUDA kernel pair, its
autograd binding and its plain versions.

``coupling_rqs(raw, x, num_bins, tail_bound)`` is one half of
``SplineCoupling.forward``: from the conditioner MLP's raw output ``raw``
(rows, n * (3K - 1)) and the half ``x`` (rows, n) it returns the RQS
forward ``y`` (rows, n) and each row's logdet summed over its dims (rows,).
For a CPU tensor it runs :func:`coupling_rqs_plain`, the coupling's plain
code (``bijectors/rqs.py``'s knots and ``rqs(inverse=False)``, then the
row sum), unchanged. For a CUDA tensor it runs the hand-written kernel pair
in ``csrc/spline_coupling.cu`` as one ``torch.autograd.Function``: the
forward kernel, and the backward kernel that recomputes the forward from
the saved ``raw`` and ``x`` and gives d/d raw and d/dx. There is no
fallback between the two: a CUDA tensor launches the kernels or raises.

The pair replaces no TPU kernel: the JAX package trains in plain XLA. It
is added for launch count. PyTorch runs a coupling half's transform as
~200 small kernels forward and ~260 backward over 100 x 1 to 100 x 25
lanes in a training step, each bound by launch latency (the source's
header); the pair is one launch each way, every intermediate in
registers, the row sums in a fixed order and no atomics, so a launch is
deterministic and is recorded into the trainer's CUDA graphs like any
other (the wrappers allocate with ``torch.empty``, launch on the current
stream and never synchronise).

:func:`coupling_rqs_backward_plain` is the hand-derived backward written
in PyTorch, line for line the backward kernel's derivation, so the CPU
tests hold that derivation to autograd through :func:`coupling_rqs_plain`.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into
``csrc/build/`` and bound with ``ctypes``, as ``ops/spline_inverse.py``
builds its kernel.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading

import torch
import torch.nn.functional as F

from nnest_torch.bijectors.rqs import (DEFAULT_MIN_BIN_HEIGHT,
                                       DEFAULT_MIN_BIN_WIDTH,
                                       DEFAULT_MIN_DERIVATIVE,
                                       conditioner_knots, rqs, softplus)
from nnest_torch.ops.spline_inverse import BUILD_DIR, build

SOURCE = os.path.join(os.path.dirname(BUILD_DIR), 'spline_coupling.cu')
# The kernels' limits (csrc/spline_coupling.cu's kMinBins, kMaxBins and
# kMaxDims): bins, and dims a half.
MIN_BINS, MAX_BINS = 2, 16
MAX_DIMS = 12288

# Kernel launches since import (or since a caller reset it), forward and
# backward: a training step's graph capture moves it, its replays do not.
launches = 0
# nvcc's output for the loaded library, -Xptxas -v report included.
build_log = None

_lib = None
_lock = threading.Lock()


def load_library():
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so, build_log = build(SOURCE, 'spline_coupling')
        lib = ctypes.CDLL(so)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nnest_coupling_forward.argtypes = (
            [vp, vp, ci, vp, vp, ci, ci, ci, cf, vp])
        lib.nnest_coupling_forward.restype = ci
        lib.nnest_coupling_backward.argtypes = (
            [vp, vp, ci, vp, ci, vp, vp, vp, ci, ci, ci, cf, vp])
        lib.nnest_coupling_backward.restype = ci
        _lib = lib
        return lib


# ------------------------------------------------------------ plain versions

def coupling_rqs_plain(raw, x, num_bins, tail_bound):
    """``SplineCoupling``'s transform of one half in plain PyTorch: the
    knots from ``raw`` (rows, n * (3K - 1)), the RQS forward of ``x``
    (rows, n), and the per-dim logdets summed over each row."""
    W, H, D = conditioner_knots(
        raw.reshape(x.shape[0], x.shape[1], 3 * num_bins - 1), num_bins,
        tail_bound)
    y, ld = rqs(x, W, H, D, inverse=False, tail_bound=tail_bound)
    return y, torch.sum(ld, dim=-1)


def _softplus_grad(v):
    """What autograd gives through ``rqs.softplus``: -sgn(v) e / (1 + e) +
    [v >= 0], e = exp(-|v|) (1 at v == 0)."""
    e = torch.exp(-torch.abs(v))
    return (v >= 0).to(v.dtype) - torch.sign(v) * (e / (1.0 + e))


def _softmax_grad(p, g):
    return p * (g - torch.sum(g * p, dim=-1, keepdim=True))


def _side(raw, min_size, B):
    """One side of the knots as the kernel makes it: p = softmax(raw),
    s = softmax(2B p), the K + 1 edges with the ends pinned."""
    K = raw.shape[-1]
    p = F.softmax(raw, dim=-1)
    s = F.softmax(2.0 * B * p, dim=-1)
    cum = 2.0 * B * torch.cumsum(min_size + (1.0 - min_size * K) * s,
                                 dim=-1) - B
    e = torch.cat([torch.full_like(cum[..., :1], -B), cum[..., :-1],
                   torch.full_like(cum[..., :1], B)], dim=-1)
    return p, s, e


def _side_grad(p, s, ge, min_size, B):
    """d/d raw of one side from d/d edges (the pinned ends take none)."""
    K = p.shape[-1]
    # reverse cumsum of 2B dL/de over the sizes feeding each edge
    g_cs = torch.cat([2.0 * B * ge[..., 1:K], torch.zeros_like(ge[..., :1])],
                     dim=-1)
    g = (1.0 - min_size * K) * torch.flip(
        torch.cumsum(torch.flip(g_cs, [-1]), dim=-1), [-1])
    g = 2.0 * B * _softmax_grad(s, g)
    return _softmax_grad(p, g)


def coupling_rqs_backward_plain(raw, x, gy, gl, num_bins, tail_bound):
    """The backward kernel's derivation in plain PyTorch: from ``raw`` and
    ``x`` (recomputed, as the kernel recomputes them), dL/dy ``gy``
    (rows, n) and dL/d(row logdet) ``gl`` (rows,), the gradients
    (d raw (rows, n * (3K - 1)), d x (rows, n)) that autograd gives through
    :func:`coupling_rqs_plain`."""
    K, B = num_bins, tail_bound
    rows, n = x.shape
    o = raw.reshape(rows, n, 3 * K - 1)
    pw, sw, ew = _side(o[..., :K], DEFAULT_MIN_BIN_WIDTH, B)
    ph, sh, eh = _side(o[..., K:2 * K], DEFAULT_MIN_BIN_HEIGHT, B)
    r = o[..., 2 * K:]
    pin = torch.full_like(o[..., :1], math.log(
        math.exp(1.0 - DEFAULT_MIN_DERIVATIVE) - 1.0))
    d = DEFAULT_MIN_DERIVATIVE + softplus(torch.cat([pin, softplus(r), pin],
                                                    dim=-1))
    inside = (x >= -B) & (x <= B)
    xc = torch.clamp(x, -B, B)
    cmp = torch.cat([ew[..., 1:K], ew[..., K:] + 1e-6], dim=-1)
    bin_ = torch.clamp(torch.sum((xc[..., None] >= cmp).long(), dim=-1),
                       max=K - 1)[..., None]

    def at(a, shift=0):
        return torch.gather(a, -1, bin_ + shift)[..., 0]

    icw, ich, id_, id1 = at(ew), at(eh), at(d), at(d, 1)
    ibw, ih = at(ew, 1) - icw, at(eh, 1) - ich
    delta = ih / ibw
    d_sum = id_ + id1 - 2.0 * delta
    theta_raw = (xc - icw) / ibw
    theta = torch.clamp(theta_raw, 0.0, 1.0)
    t1mt = theta * (1.0 - theta)
    omt = 1.0 - theta
    num = ih * (delta * theta * theta + id_ * t1mt)
    den = delta + d_sum * t1mt
    poly = id1 * theta * theta + 2.0 * delta * t1mt + id_ * omt * omt
    dnum = delta * delta * poly

    # y = ich + num / den, logdet = log(dnum) - 2 log(den); the tails are
    # the identity and take nothing else
    gy_in = torch.where(inside, gy, torch.zeros_like(gy))
    gl_in = torch.where(inside, gl[:, None].expand_as(x),
                        torch.zeros_like(x))
    g_num = gy_in / den
    g_den = -gy_in * num / (den * den) - 2.0 * gl_in / den
    g_dnum = gl_in / dnum
    # dnum = delta^2 poly, poly = id1 th^2 + 2 delta t1mt + id (1-th)^2
    g_poly = g_dnum * delta * delta
    g_delta = g_dnum * poly * 2.0 * delta
    g_id1 = g_poly * theta * theta
    g_theta = g_poly * id1 * 2.0 * theta
    g_delta = g_delta + g_poly * 2.0 * t1mt
    g_t1mt = g_poly * 2.0 * delta
    g_id = g_poly * omt * omt
    g_theta = g_theta - g_poly * id_ * 2.0 * omt
    # den = delta + d_sum t1mt
    g_delta = g_delta + g_den
    g_dsum = g_den * t1mt
    g_t1mt = g_t1mt + g_den * d_sum
    # num = ih (delta th^2 + id t1mt)
    g_ih = g_num * (delta * theta * theta + id_ * t1mt)
    g_in = g_num * ih
    g_delta = g_delta + g_in * theta * theta
    g_theta = g_theta + g_in * delta * 2.0 * theta
    g_id = g_id + g_in * t1mt
    g_t1mt = g_t1mt + g_in * id_
    # t1mt = th (1 - th)
    g_theta = g_theta + g_t1mt * (1.0 - 2.0 * theta)
    # d_sum = id + id1 - 2 delta
    g_id = g_id + g_dsum
    g_id1 = g_id1 + g_dsum
    g_delta = g_delta - 2.0 * g_dsum
    # theta = clamp(theta_raw, 0, 1), theta_raw = (xc - icw) / ibw
    g_raw_t = torch.where((theta_raw >= 0.0) & (theta_raw <= 1.0), g_theta,
                          torch.zeros_like(g_theta))
    g_xc = g_raw_t / ibw
    g_ibw = -g_raw_t * (xc - icw) / (ibw * ibw)
    # delta = ih / ibw
    g_ih = g_ih + g_delta / ibw
    g_ibw = g_ibw - g_delta * ih / (ibw * ibw)

    # onto the edges: icw = e[bin], ibw = e[bin+1] - e[bin], the same for
    # the heights with ich's gradient gy
    def onto(lo, hi):
        g = torch.zeros(rows, n, K + 1, dtype=x.dtype, device=x.device)
        g.scatter_(-1, bin_, lo[..., None])
        return g.scatter_add_(-1, bin_ + 1, hi[..., None])

    gw = onto(-g_raw_t / ibw - g_ibw, g_ibw)
    gh = onto(gy_in - g_ih, g_ih)
    g_w = _side_grad(pw, sw, gw, DEFAULT_MIN_BIN_WIDTH, B)
    g_h = _side_grad(ph, sh, gh, DEFAULT_MIN_BIN_HEIGHT, B)
    # the interior derivatives: d[k] = min + softplus(softplus(raw))
    g_d = onto(g_id, g_id1)[..., 1:K]
    g_r = g_d * _softplus_grad(softplus(r)) * _softplus_grad(r)
    graw = torch.cat([g_w, g_h, g_r], dim=-1).reshape(raw.shape)
    gx = torch.where(inside, g_xc, gy)
    return graw, gx


# ----------------------------------------------------------------- kernels

def _check(raw, num_bins, **halves):
    """Raise on what the kernels do not take: bins, dtypes, shapes (each
    half (rows, n) beside raw (rows, n * (3K - 1))), layouts, then
    devices, so that every refusal but the last shows on the CPU too."""
    if not MIN_BINS <= num_bins <= MAX_BINS:
        raise ValueError('spline coupling kernel takes %d to %d bins, got %d'
                         % (MIN_BINS, MAX_BINS, num_bins))
    tensors = dict(raw=raw, **halves)
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError('spline coupling kernel takes float32, %s is %s'
                             % (name, t.dtype))
    for name, t in halves.items():
        if t.dim() != 2 or raw.dim() != 2 or raw.shape[0] != t.shape[0] or \
                raw.shape[1] != t.shape[1] * (3 * num_bins - 1):
            raise ValueError('spline coupling kernel takes raw (rows, n * %d) '
                             'and %s (rows, n), got %s and %s'
                             % (3 * num_bins - 1, name, tuple(raw.shape),
                                tuple(t.shape)))
        if t.shape[1] > MAX_DIMS:
            raise ValueError('spline coupling kernel takes at most %d dims a '
                             'half, got %d' % (MAX_DIMS, t.shape[1]))
    if not raw.is_contiguous():
        raise ValueError('spline coupling kernel: raw must be contiguous')
    for name, t in halves.items():
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError('spline coupling kernel: the rows of %s must be '
                             'contiguous' % name)
    for name, t in tensors.items():
        if t.device.type != 'cuda' or t.device != raw.device:
            raise ValueError('spline coupling kernel needs CUDA tensors on '
                             'one device, %s is on %s' % (name, t.device))


def _row_stride(t):
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _rows(t):
    """``t`` (rows, n) itself where its rows are contiguous and apart (a
    column slice of a batch), else a contiguous copy (an expanded
    gradient)."""
    n = t.shape[1]
    if (n == 1 or t.stride(1) == 1) and (t.shape[0] < 2 or t.stride(0) >= n):
        return t
    return t.contiguous()


def _call(fn, device, *args):
    global launches
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError('spline coupling kernel launch failed: '
                           'cudaError %d' % err)
    launches += 1


def forward_kernel(raw, x, num_bins, tail_bound):
    """One launch of the forward kernel: ``(y, row logdet)``."""
    _check(raw, num_bins, x=x)
    rows, n = x.shape
    y = torch.empty(rows, n, dtype=torch.float32, device=x.device)
    logdet = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        _call(load_library().nnest_coupling_forward, x.device,
              raw.data_ptr(), x.data_ptr(), _row_stride(x), y.data_ptr(),
              logdet.data_ptr(), rows, n, num_bins, float(tail_bound))
    return y, logdet


def backward_kernel(raw, x, gy, gl, num_bins, tail_bound):
    """One launch of the backward kernel: ``(d raw, d x)``."""
    if gl.dtype != torch.float32 or gl.dim() != 1 or \
            gl.shape[0] != raw.shape[0]:
        raise ValueError('spline coupling kernel takes gl float32 (rows,) '
                         'beside raw %s, got %s %s' % (
                             tuple(raw.shape), gl.dtype, tuple(gl.shape)))
    _check(raw, num_bins, x=x, gy=gy)
    if gl.device != raw.device:
        raise ValueError('spline coupling kernel: gl is on %s, raw on %s'
                         % (gl.device, raw.device))
    gl = gl.contiguous()
    rows, n = x.shape
    graw = torch.empty_like(raw)
    gx = torch.empty(rows, n, dtype=torch.float32, device=x.device)
    if rows:
        _call(load_library().nnest_coupling_backward, x.device,
              raw.data_ptr(), x.data_ptr(), _row_stride(x), gy.data_ptr(),
              _row_stride(gy), gl.data_ptr(), graw.data_ptr(), gx.data_ptr(),
              rows, n, num_bins, float(tail_bound))
    return graw, gx


class _CouplingRQS(torch.autograd.Function):
    """The kernel pair under autograd. ``forward`` takes ``ctx`` (the old
    form), so ``torch.func`` transforms refuse it with an error rather
    than batching a backward that reads raw pointers."""

    @staticmethod
    def forward(ctx, raw, x, num_bins, tail_bound):
        ctx.save_for_backward(raw, x)
        ctx.num_bins, ctx.tail_bound = num_bins, tail_bound
        return forward_kernel(raw, x, num_bins, tail_bound)

    @staticmethod
    def backward(ctx, gy, gl):
        raw, x = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(x)
        if gl is None:
            gl = x.new_zeros(x.shape[0])
        graw, gx = backward_kernel(raw, x, _rows(gy), gl, ctx.num_bins,
                                   ctx.tail_bound)
        return graw, gx, None, None


def coupling_rqs(raw, x, num_bins, tail_bound):
    """One coupling half's transform ``(y, row logdet)``: the plain code for
    a CPU tensor, the kernel pair for a CUDA tensor."""
    if raw.device.type == 'cpu' and x.device.type == 'cpu':
        return coupling_rqs_plain(raw, x, num_bins, tail_bound)
    return _CouplingRQS.apply(raw.contiguous(), _rows(x), int(num_bins),
                              float(tail_bound))
