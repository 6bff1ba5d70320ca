"""The pool consumption, frozen plainly (NumPy), for the counts its
roofline needs: candidates in order against the current worst live point
(the first index on a tie); the first flagged candidate strictly above it
replaces it, and the walk goes on from the next candidate."""

from __future__ import annotations

import numpy as np


def consumption_counts(live_logl, flags, cand_logl):
    """(flagged, sectors, accepts, slots): the flagged candidates, the
    32-byte sectors of the candidates' float32 logl that hold a flagged
    one, the accepts, and the distinct live slots replaced."""
    al = np.asarray(live_logl, dtype=np.float32).copy()
    flags = np.asarray(flags, dtype=bool)
    cl = np.asarray(cand_logl, dtype=np.float32)
    m = flags.shape[0]
    padded = np.zeros(m + (-m) % 8, dtype=bool)
    padded[:m] = flags
    sectors = int(padded.reshape(-1, 8).any(axis=1).sum())
    accepts, replaced = 0, set()
    worst = int(np.argmin(al))
    for i in np.flatnonzero(flags):
        if cl[i] > al[worst]:
            al[worst] = cl[i]
            replaced.add(worst)
            accepts += 1
            worst = int(np.argmin(al))
    return int(flags.sum()), sectors, accepts, len(replaced)
