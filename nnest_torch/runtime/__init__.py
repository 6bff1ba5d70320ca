"""Native (C++) host runtime: the chain writer, chain diagnostics and the
TensorBoard scalar event writer.

Port of ``nnest_tpu/runtime``, built from the port's own copy of the
source, ``nnest_torch/csrc/nnest_runtime.cpp``. The source is compiled at
first use with ``g++ -O3 -shared -fPIC`` into ``nnest_torch/csrc/build/``
(one library per hash of the source and flags, written to a temporary file
and moved into place with ``os.replace``, so processes that build at once
each load a whole library) and bound with ``ctypes``.

Surface (``nnest_tpu.runtime``'s):

- ``available() -> bool``;
- ``write_chain(path, weights, logl, samples, derived=None,
  min_weight=1e-30, header='') -> bool``: the getdist/CosmoMC text chain,
  byte for byte what ``np.savetxt(fmt='%.5E')`` writes;
- ``ess(x, mu, var)``, ``acceptance_rate(x)``, ``mean_jump(x)``: the
  diagnostics of ``utils/evaluation.py`` on chains (chains, steps, dim);
- ``write_scalar_events(path, tag, steps, values, wall_times) -> bool``
  (the port's own): appends one TensorBoard scalar event a row, the bytes
  of ``utils/events.encode_scalar_events``, in one call that holds no GIL.

Where the machine has no ``g++`` every entry returns ``None`` (``False``
for the writers) and the caller takes its Python path; that is the only
fallback. With ``g++`` present a failed build, load or write raises.
:data:`native_calls` and :data:`fallbacks` count the entries that ran
natively and those that returned for the numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'csrc', 'nnest_runtime.cpp')
BUILD_DIR = os.path.join(os.path.dirname(SOURCE), 'build')
GXX_FLAGS = ('-O3', '-shared', '-fPIC')

# Entries that ran natively, and entries that returned for the numpy path
# (no g++), since import or since a caller reset them.
native_calls = 0
fallbacks = 0
# How the loaded library came to be: built (the g++ command line, its
# seconds and output) or found already built.
build_log = None

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()


def _bind(lib):
    dptr = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    lib.write_chain.restype = ctypes.c_int
    lib.write_chain.argtypes = [ctypes.c_char_p, dptr, dptr, dptr, dptr,
                                i64, i64, i64, ctypes.c_double,
                                ctypes.c_char_p]
    lib.ess_autocorr.restype = None
    lib.ess_autocorr.argtypes = [dptr, i64, i64, i64, dptr, dptr, dptr]
    lib.acceptance_rate.restype = ctypes.c_double
    lib.acceptance_rate.argtypes = [dptr, i64, i64, i64]
    lib.mean_jump.restype = ctypes.c_double
    lib.mean_jump.argtypes = [dptr, i64, i64, i64]
    lib.write_scalar_events.restype = ctypes.c_int
    lib.write_scalar_events.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.POINTER(i64), dptr, dptr, i64]
    return lib


def load_library():
    """The runtime library, built once per source hash, or None where the
    machine has no ``g++``. A failed build or load raises."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        gxx = shutil.which('g++')
        if gxx is None:
            return None
        with open(SOURCE, 'rb') as f:
            tag = hashlib.sha256(
                f.read() + ' '.join(GXX_FLAGS).encode()).hexdigest()[:16]
        so = os.path.join(BUILD_DIR, 'libnnest_runtime_%s.so' % tag)
        if os.path.exists(so):
            log = 'g++ library %s already built' % so
        else:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = '%s.%d.tmp' % (so, os.getpid())
            cmd = [gxx, *GXX_FLAGS, '-o', tmp, SOURCE]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError('g++ failed (exit %d): %s\n%s%s' % (
                        proc.returncode, ' '.join(cmd), proc.stdout,
                        proc.stderr))
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            log = 'g++ built %s in %.3f s: %s%s' % (
                so, time.perf_counter() - t0, ' '.join(cmd),
                ('\n' + proc.stdout + proc.stderr).rstrip())
        _lib = _bind(ctypes.CDLL(so))
        build_log = log
        return _lib


def _entry():
    """The library for one entry, counted as a native call, or None (no
    ``g++``), counted as a fallback."""
    global native_calls, fallbacks
    lib = load_library()
    with _count_lock:
        if lib is None:
            fallbacks += 1
        else:
            native_calls += 1
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _c(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def available() -> bool:
    return load_library() is not None


def write_chain(path, weights, logl, samples, derived=None,
                min_weight=1e-30, header='') -> bool:
    """Rows of ``max(weight, min_weight) -logl samples [derived]`` in
    ``%.5E`` to ``path``, under ``#header`` when ``header`` is not empty.
    False where there is no ``g++`` (nothing written); an I/O error
    raises."""
    lib = _entry()
    if lib is None:
        return False
    weights, logl, samples = _c(weights), _c(logl), _c(samples)
    n, d = samples.shape
    if weights.shape != (n,) or logl.shape != (n,):
        raise ValueError('weights and logl must be (%d,), got %s and %s'
                         % (n, weights.shape, logl.shape))
    if derived is not None and np.size(derived) > 0:
        derived = _c(derived)
        if derived.ndim != 2 or derived.shape[0] != n:
            raise ValueError('derived must be (%d, k), got %s'
                             % (n, derived.shape))
        nd, dptr = derived.shape[1], _ptr(derived)
    else:
        nd, dptr = 0, None
    rc = lib.write_chain(os.fsencode(path), _ptr(weights), _ptr(logl),
                         _ptr(samples), dptr, n, d, nd, float(min_weight),
                         header.encode())
    if rc != 0:
        raise OSError('native chain writer could not write %s' % path)
    return True


def write_scalar_events(path, tag, steps, values, wall_times) -> bool:
    """Append one TensorBoard scalar event a row (``steps[i]``,
    ``values[i]`` as float32, ``wall_times[i]``) under ``tag`` to the event
    file ``path``, after the file-version event where the file is new.
    False where there is no ``g++`` (nothing written); an I/O error
    raises."""
    lib = _entry()
    if lib is None:
        return False
    steps = np.ascontiguousarray(np.asarray(steps, dtype=np.int64))
    values, wall_times = _c(values), _c(wall_times)
    n = steps.size
    if steps.shape != (n,) or values.shape != (n,) or \
            wall_times.shape != (n,):
        raise ValueError('steps, values and wall_times must be one row each, '
                         'got %s, %s and %s' % (steps.shape, values.shape,
                                                wall_times.shape))
    rc = lib.write_scalar_events(
        os.fsencode(path), tag.encode(),
        steps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _ptr(values),
        _ptr(wall_times), n)
    if rc != 0:
        raise OSError('native event writer could not write %s' % path)
    return True


def _chains(x):
    x = _c(x)
    if x.ndim != 3 or x.shape[1] < 2:
        raise ValueError('chains must be (chains, steps >= 2, dim), got %s'
                         % (x.shape,))
    return x


def ess(x, mu, var):
    """Per-dim truncated-autocorrelation ESS of chains (b, t, d), or
    None."""
    lib = _entry()
    if lib is None:
        return None
    x = _chains(x)
    b, t, d = x.shape
    mu, var = _c(mu).reshape(-1), _c(var).reshape(-1)
    if mu.shape != (d,) or var.shape != (d,):
        raise ValueError('mu and var must be (%d,)' % d)
    out = np.empty(d, dtype=np.float64)
    lib.ess_autocorr(_ptr(x), b, t, d, _ptr(mu), _ptr(var), _ptr(out))
    return out


def acceptance_rate(x):
    """Fraction of steps in which a chain moved, or None."""
    lib = _entry()
    if lib is None:
        return None
    x = _chains(x)
    return float(lib.acceptance_rate(_ptr(x), *x.shape))


def mean_jump(x):
    """Mean Euclidean step length, or None."""
    lib = _entry()
    if lib is None:
        return None
    x = _chains(x)
    return float(lib.mean_jump(_ptr(x), *x.shape))
