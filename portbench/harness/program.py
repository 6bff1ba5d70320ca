"""The program's own spans and counters (``nnest_torch.utils.profiling``),
as the traced job recorded them, for the per-layer readers; and a segment
timeline that names any time by the innermost of many spans.

``NestedSampler.run`` records itself while a ``torch.profiler`` profile is
collecting, which in a traced run is the window's first job alone; the
recorder's ``last_record()`` then holds that job's record. A program
without the recorder gives None here, and so does every reader built on
it."""

from __future__ import annotations

import bisect


def traced_record(ctx):
    """The traced job's record, or None: the program has no recorder, the
    traced job failed (the window's first job is not among ``ctx['jobs']``),
    or the last record is not one whole run."""
    try:
        from nnest_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, 'last_record', None)
    rec = last() if last is not None else None
    jobs = ctx['jobs']
    if rec is None or not jobs or jobs[0]['index'] != 0:
        return None
    if [s.name for s in rec.spans if s.parent < 0] != ['run']:
        return None
    return rec


def traced_stats(ctx):
    """The traced job's ``run_stats``."""
    return ctx['jobs'][0]['run_stats']


def duration_ns(span):
    return span.end_ns - span.start_ns


def under(rec, span, names):
    """Whether ``span`` is, or is nested in, a span named in ``names``."""
    while True:
        if span.name in names:
            return True
        if span.parent < 0:
            return False
        span = rec.spans[span.parent]


def total_ns(rec, name, outside=()):
    """Σ the time of the spans named ``name`` that lie in no span named in
    ``outside``; None when there is none."""
    spans = [s for s in rec.spans if s.name == name
             and not (s.parent >= 0 and under(rec, rec.spans[s.parent],
                                               outside))]
    return sum(duration_ns(s) for s in spans) if spans else None


def self_ns(rec, name):
    """Σ over the spans named ``name`` of their time outside every span
    nested in them; None when there is none."""
    own = {i: duration_ns(s) for i, s in enumerate(rec.spans)
           if s.name == name}
    if not own:
        return None
    for s in rec.spans:
        if s.parent in own:
            own[s.parent] -= duration_ns(s)
    return sum(own.values())


def span_tuples(rec):
    """The record's spans as the harness's (start ns, end ns, name)."""
    return [(s.start_ns, s.end_ns, s.name) for s in rec.spans]


class Timeline:
    """The innermost of ``spans`` ((start ns, end ns, name), each closed
    [start, end]) at any time, named as ``harness/trace.py``'s
    ``_innermost`` names it (the shortest span holding the time, the first
    of equal ones, ``outside`` for none): one sweep over the spans' edges,
    which keeps the spans open there, into a name at each edge and one
    between each edge and the next; then a bisection a query."""

    def __init__(self, spans, outside='outside pb spans'):
        order = sorted(range(len(spans)), key=lambda i: spans[i][0])
        self.edges = sorted({t for s in spans for t in s[:2]})
        self.at = []       # the name at each edge
        self.after = []    # the name between each edge and the next
        self.outside = outside

        def shortest(open_):
            if not open_:
                return outside
            i = min(open_, key=lambda i: (spans[i][1] - spans[i][0], i))
            return spans[i][2]
        open_, k = [], 0
        for t in self.edges:
            while k < len(order) and spans[order[k]][0] <= t:
                open_.append(order[k])
                k += 1
            open_ = [i for i in open_ if spans[i][1] >= t]
            self.at.append(shortest(open_))
            open_ = [i for i in open_ if spans[i][1] > t]
            self.after.append(shortest(open_))

    def name(self, t):
        k = bisect.bisect_right(self.edges, t) - 1
        if k < 0:
            return self.outside
        return self.at[k] if self.edges[k] == t else self.after[k]
