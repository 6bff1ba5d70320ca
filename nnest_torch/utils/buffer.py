"""Bounded sample buffer: a copy of ``nnest_tpu/utils/buffer.py``, for
users who accumulate training samples across sampler rounds."""

from __future__ import annotations

import numpy as np


class SampleBuffer:
    """The last ``max_size`` rows appended, as one numpy array."""

    def __init__(self, max_size: int = 10000):
        self.max_size = max_size
        self._data = None

    def append(self, samples):
        samples = np.atleast_2d(np.asarray(samples))
        if self._data is None:
            self._data = samples[-self.max_size:]
        else:
            self._data = np.concatenate(
                [self._data, samples], axis=0)[-self.max_size:]

    def get(self):
        return (np.empty((0, 0)) if self._data is None
                else np.array(self._data, copy=True))

    def __len__(self):
        return 0 if self._data is None else self._data.shape[0]
