"""Serial background writer for artifact IO.

A copy of ``nnest_tpu/utils/io_async.py`` (the port imports nothing from
the JAX package). The nested sampler snapshots its state on the main thread
and hands the pure file IO (checkpoints, the ``chain.txt`` rewrite, a
pool's ``logz`` scalars at a time) to this one daemon thread.

One thread, FIFO order: a checkpoint's files keep their order (data files
first, the ``checkpoint_<it>.txt`` marker last) and successive checkpoints
never interleave. ``drain()`` blocks until everything queued so far is on
disk; callers drain before reading checkpoints back and before declaring a
run complete. While the program records (``utils/profiling.py``) each job's
time counts under ``background_ns['io_writer']``.
"""

from __future__ import annotations

import queue
import threading

from nnest_torch.utils.profiling import background


class SerialWriter:
    """FIFO background executor for file-IO closures."""

    _STOP = object()

    def __init__(self, name='nnest-io'):
        self._q = queue.Queue()
        self._exc = None
        self._t = threading.Thread(target=self._run, daemon=True, name=name)
        self._t.start()

    def _run(self):
        while True:
            job = self._q.get()
            try:
                if job is self._STOP:
                    return
                if job is not None:
                    with background('io_writer'):
                        job()
            except BaseException as e:  # surfaced by the next drain()
                # keep the first failure: later jobs often fail as side
                # effects of it (a full disk, a removed directory)
                if self._exc is None:
                    self._exc = e
            finally:
                self._q.task_done()

    def submit(self, job):
        self._q.put(job)

    def close(self):
        """Drain, stop the worker thread, and re-raise any failure. The
        thread stops even when the drain raises."""
        try:
            self.drain()
        finally:
            self._q.put(self._STOP)
            self._t.join()

    def drain(self):
        """Block until every queued job has run; re-raise the first
        failure (a lost checkpoint must not pass silently)."""
        self._q.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
