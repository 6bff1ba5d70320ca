"""The evidence loop's order statistics, checked from its record.

A run's record is every dead point in order of death, then the final live
points, each with its u, logl and the live-set slot it held. Replaying it
from the initial live set, the i-th dead point must be the point then
holding its slot and the lowest logl of the live set, and the point that
next holds that slot (its next death, or its final point) is its
replacement, born strictly above the dead point's logl and inside the box
|u| <= 1."""

from __future__ import annotations

import numpy as np


def replay(u, logl, slots, n_live, init_u=None, init_logl=None):
    """(order_violations, contour_violations) of one run's record. Without
    an initial live set it is taken from the record: each slot's first
    point."""
    u = np.asarray(u, dtype=np.float64)
    logl = np.asarray(logl, dtype=np.float64)
    slots = np.asarray(slots, dtype=np.int64)
    total = logl.shape[0]
    dead = total - n_live
    if dead < 0 or slots.shape[0] != total or u.shape[0] != total:
        return total + 1, 0
    if not np.array_equal(np.sort(slots[dead:]), np.arange(n_live)):
        return total + 1, 0
    # the record's next point in each slot
    nxt = np.full(total, -1, dtype=np.int64)
    last = {}
    for i in range(total - 1, -1, -1):
        nxt[i] = last.get(int(slots[i]), -1)
        last[int(slots[i])] = i
    if init_u is None:
        first = np.array([last[s] for s in range(n_live)])
        live_u, live_l = u[first].copy(), logl[first].copy()
    else:
        live_u = np.asarray(init_u, dtype=np.float64).copy()
        live_l = np.asarray(init_logl, dtype=np.float64).copy()
    order = contour = 0
    contour += int(np.sum(np.any(np.abs(live_u) > 1.0, axis=1)))
    for i in range(dead):
        s = int(slots[i])
        if not (np.array_equal(live_u[s], u[i]) and live_l[s] == logl[i]
                and logl[i] == np.min(live_l)):
            order += 1
        j = nxt[i]
        if j < 0:
            order += 1
            continue
        if not (logl[j] > logl[i] and np.all(np.abs(u[j]) <= 1.0)):
            contour += 1
        live_u[s], live_l[s] = u[j], logl[j]
    final = np.argsort(slots[dead:]) + dead
    order += int(np.sum(~np.all(live_u == u[final], axis=1)))
    order += int(np.sum(live_l != logl[final]))
    return order, contour
