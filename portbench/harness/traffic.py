"""The general generator of the bands: every job's seed. A band that does
not start from the prior starts each job from a live set that the
configuration's likelihood kind draws (``harness/likelihoods/<kind>.py``
``init_set``); ``ellipsoid_draw`` and ``init_set`` here are the
``gaussian`` kind's ellipsoid. The same seed gives the same jobs."""

from __future__ import annotations

import numpy as np

from harness.likelihoods.gaussian import ellipsoid_draw
from harness.likelihoods.gaussian import ellipsoid_set as init_set

__all__ = ['MASK62', 'ellipsoid_draw', 'init_set', 'job_seed']

MASK62 = (1 << 62) - 1


def job_seed(seed, index):
    """The seed of job ``index`` (an int, or a name such as 'warmup') of
    the run seeded ``seed``."""
    if isinstance(index, str):
        index = int.from_bytes(index.encode(), 'little')
    words = np.random.SeedSequence([int(seed) % (1 << 64), int(index)]
                                   ).generate_state(2, np.uint32)
    return (int(words[0]) << 32 | int(words[1])) & MASK62
