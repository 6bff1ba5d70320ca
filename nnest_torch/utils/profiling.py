"""Profiling hooks: named regions, a device trace, named step timers, and
the recorder of the program's spans and counters.

Port of ``nnest_tpu/utils/profiling.py`` on ``torch.profiler``, with the
recorder added.

Usage::

    with trace_annotation('flow_train'):
        trainer.train(...)

    timer = StepTimer()
    with timer.time('mcmc'):
        ...
    timer.summary()  # {'mcmc': {'count': n, 'total_s': t, 'mean_s': m}}

To capture a trace viewable in TensorBoard's profiler view or Perfetto::

    with device_trace('/tmp/torch-trace'):
        run(...)

``device_trace`` records the host and, when the process has a GPU, its
CUDA kernels; on a machine without one it traces the host, which is all
there is to trace. ``StepTimer`` reads the host's clock: around work
queued on the GPU it times the dispatch, not the device (the samplers'
phases that end in a copy to the host cover the device work as well).

The recorder::

    with recording() as rec:
        sampler.run(...)
    rec.spans      # Span objects in the order they opened
    rec.counters   # {'host_syncs': {innermost span: n}, ...}

The program's counters: ``host_syncs`` (below); ``background_ns`` and
``background_jobs`` {key: n} (:func:`background`); ``mcmc_graph``
{``graph_steps``, ``eager_steps``, ``captures``: n}, the Metropolis steps
that replayed the step loop's CUDA graphs, the steps run eagerly, and the
graphs captured (``samplers/kernels.py``); ``hot_inverse`` {``spline``,
``fast_slow``, ``plain``: n}, the calls of the flow inverse that chain
steps run (``LatentKernels._hot_inverse``) by the path each took: the
spline kernel, the kernel once per chain of a fast-slow flow, or the
flow's own plain ``inverse``; ``train_step`` {``fused``, ``plain``: n}, the
trainer's steps by the path their forward took: a training kernel pair
(the spline chain's, ``ops/spline_chain.py``, or the spline coupling's,
``ops/spline_coupling.py``; a graph's path fixed at its capture) or the
plain code (``training/trainer.py``); ``spline_chain`` {``kernel``,
``plain``: n}, each forward of a spline-layout chain by its path: the
chain's kernel or module by module (``bijectors/base.py``); ``evidence_side``
{``dead``, ``transform_calls``, ``scalar_jobs``: n}, the points that die in
the nested sampler's evidence loop, its calls of the sampler transform and
the ``logz`` scalar batches it hands to the writer (``samplers/nested.py``).

Recording is off by default. Off, :func:`span` returns one shared no-op
context and :func:`count` returns at once: no clock is read and nothing is
allocated, and no draw, order or result depends on it. On, a span records
its start and end on ``time.time_ns()``, the clock ``torch.profiler``
stamps the device's events with, so the spans lie on the device trace's
timeline; a ``StepTimer`` phase is also recorded as a span under its name;
every synchronizing CUDA call counts under ``host_syncs``, keyed by the
innermost open span (``torch.cuda.set_sync_debug_mode('warn')``, set for
the block on a machine with CUDA and restored after). Spans nest like the
call stack of the thread that opened the recording; spans opened on other
threads are not recorded, their counters are. Inside a ``device_trace``
block each recorded span is also a ``trace_annotation`` of its name.

``NestedSampler.run`` records itself while a ``torch.profiler`` profile is
collecting (``device_trace`` among them); :func:`last_record` hands its
record to the profile's reader afterwards."""

from __future__ import annotations

import contextlib
import threading
import time
import warnings
from collections import defaultdict

import torch

_record = None     # the Record being written; None while recording is off
_last = None       # the Record of the last recording() block that ended
_annotating = 0    # open device_trace blocks

_SYNC_WARNING = 'called a synchronizing CUDA operation'


def trace_annotation(name: str):
    """Named region in the profiler timeline."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block and write one trace file into ``log_dir``
    (``torch.profiler.tensorboard_trace_handler``'s ``*.pt.trace.json``).
    The program's recorded spans show in it as annotations."""
    global _annotating
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        _annotating += 1
        try:
            yield
        finally:
            _annotating -= 1


def profiler_collecting():
    """Whether a ``torch.profiler`` profile is collecting on this
    process."""
    return torch._C._autograd._profiler_enabled()


class Span:
    """A named region: ``start_ns`` and ``end_ns`` on ``time.time_ns()``,
    ``attrs`` (a dict the region may add to before it closes), and, once
    recorded, ``parent`` (the index in ``Record.spans`` of the span that
    held it, -1 for none) and ``syncs`` (host syncs made while it was the
    innermost open span)."""

    __slots__ = ('name', 'attrs', 'start_ns', 'end_ns', 'parent', 'syncs',
                 '_timer', '_record', '_annotation')

    def __init__(self, name, attrs, timer=None):
        self.name, self.attrs, self._timer = name, attrs, timer
        self.start_ns = self.end_ns = None
        self.parent, self.syncs = -1, 0
        self._record = self._annotation = None

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self):
        rec = _record
        if rec is not None and rec._push(self):
            self._record = rec
            if _annotating:
                self._annotation = trace_annotation(self.name)
                self._annotation.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        if self._record is not None:
            self._record._pop(self)
        if self._timer is not None:
            self._timer._add(self.name, self.seconds)
        return False


class _Off:
    """The shared no-op context :func:`span` returns while recording is
    off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Record:
    """The spans and counters of one :func:`recording` block.

    - ``spans``: :class:`Span` objects of the recording's thread, in the
      order they opened;
    - ``counters``: {name: n} or {name: {key: n}} (:func:`count`);
    - ``syncs_counted``: whether host syncs were counted (a machine with
      CUDA)."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self.syncs_counted = False
        self._stack = []
        self._thread = threading.get_ident()
        self._lock = threading.Lock()

    def _push(self, span):
        if threading.get_ident() != self._thread:
            return False
        span.parent = self._stack[-1] if self._stack else -1
        self._stack.append(len(self.spans))
        self.spans.append(span)
        return True

    def _pop(self, span):
        # a span left open by an exception closes with the one that held it
        while self._stack:
            inner = self.spans[self._stack.pop()]
            if inner is span:
                break
            inner.end_ns = span.end_ns

    def _add(self, name, n, key):
        with self._lock:
            if key is None:
                self.counters[name] = self.counters.get(name, 0) + n
            else:
                keyed = self.counters.setdefault(name, {})
                keyed[key] = keyed.get(key, 0) + n

    def _sync(self):
        if threading.get_ident() != self._thread:
            key = 'thread ' + threading.current_thread().name
        elif self._stack:
            inner = self.spans[self._stack[-1]]
            inner.syncs += 1
            key = inner.name
        else:
            key = 'outside spans'
        self._add('host_syncs', 1, key)


def span(name, **attrs):
    """A recorded region ``name`` with ``attrs``, or, while recording is
    off, one shared no-op context."""
    if _record is None:
        return _OFF
    return Span(name, attrs)


def timed(name, **attrs):
    """A region whose ``seconds`` are read whether or not recording is on;
    it is recorded as a span while it is."""
    return Span(name, attrs)


def count(name, n=1, key=None):
    """Add ``n`` to counter ``name`` (under ``key`` when given) while
    recording is on; nothing otherwise."""
    rec = _record
    if rec is not None:
        rec._add(name, n, key)


class _Background:
    __slots__ = ('key', '_t0')

    def __init__(self, key):
        self.key = key

    def __enter__(self):
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        count('background_ns', time.time_ns() - self._t0, self.key)
        count('background_jobs', 1, self.key)
        return False


def background(key):
    """A context that times its block, run on a background thread, into
    the counters ``background_ns`` and ``background_jobs`` under ``key``
    while recording is on; the shared no-op context otherwise."""
    if _record is None:
        return _OFF
    return _Background(key)


@contextlib.contextmanager
def _sync_counting(rec):
    """Count the synchronizing CUDA calls of the block into ``rec``."""
    if not torch.cuda.is_available():
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.filterwarnings('always', message='.*' + _SYNC_WARNING)
        show = warnings.showwarning

        def counted(message, category, filename, lineno, file=None,
                    line=None):
            if _SYNC_WARNING in str(message):
                rec._sync()
            else:
                show(message, category, filename, lineno, file, line)
        warnings.showwarning = counted
        torch.cuda.set_sync_debug_mode('warn')
        rec.syncs_counted = True
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(previous)


@contextlib.contextmanager
def recording():
    """Record the block's spans and counters; yields the :class:`Record`.
    Inside an open recording the block adds to that one."""
    global _record, _last
    if _record is not None:
        yield _record
        return
    rec = Record()
    _record = rec
    try:
        with _sync_counting(rec):
            yield rec
    finally:
        _record = None
        _last = rec


def last_record():
    """The :class:`Record` of the last :func:`recording` block that ended
    (None before the first)."""
    return _last


class StepTimer:
    def __init__(self):
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)

    def time(self, name: str, **attrs):
        """A :class:`Span` that adds its seconds to phase ``name`` (and is
        recorded while recording is on)."""
        return Span(name, attrs, timer=self)

    def _add(self, name, seconds):
        self._totals[name] += seconds
        self._counts[name] += 1

    def summary(self):
        return {
            k: {'count': self._counts[k], 'total_s': self._totals[k],
                'mean_s': self._totals[k] / self._counts[k]}
            for k in self._totals
        }
