"""The traced job's device timeline, read from ``torch.profiler``'s events:
every operation that ran on the card (kernels, copies, sets), the
harness's ``pb.*`` spans on the host, and what follows from them."""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch


def _union(intervals):
    """Merged [start, end] intervals of ``intervals``, sorted."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def _innermost(spans, t):
    """The name of the shortest span holding time ``t``."""
    best, width = 'outside pb spans', None
    for start, end, name in spans:
        if start <= t <= end and (width is None or end - start < width):
            best, width = name, end - start
    return best


def _overlap(merged, a, b):
    """The time of the merged intervals ``merged`` inside [a, b]."""
    i = max(0, bisect.bisect_right([s for s, _ in merged], a) - 1)
    total = 0
    while i < len(merged) and merged[i][0] < b:
        total += max(0, min(merged[i][1], b) - max(merged[i][0], a))
        i += 1
    return total


def _untraced_busy(busy, spans, untraced, epochs):
    """[(start ns, end ns, device ns)] for each stretch of ``untraced``
    ((start ns, end ns, epochs run)): the epochs it ran times the median
    device time of the same training's traced epochs (``epochs``, (start
    ns, end ns)) after its first, which captures the step's graph. Every
    epoch of a training runs the same kernels on the same shapes."""
    trains = [(s, e) for s, e, n in spans if n == 'pb.train']
    out = []
    for a, b, n in untraced:
        t0, t1 = next(((s, e) for s, e in trains if s <= a <= e), (a, a))
        own = sorted((s, e) for s, e in epochs if t0 <= s and e <= a)
        per = sorted(_overlap(busy, s, e) for s, e in own[1:] or own)
        median = per[len(per) // 2] if per else 0
        out.append((a, b, min(b - a, n * median)))
    return out


def summarize(results, spans, untraced=(), epochs=()):
    """The traced window's numbers from the profiler's device events
    (``results``, its ``kineto_results``), the host spans ``spans``
    ((start ns, end ns, name), ``pb.job`` the traced job), the stretches
    ``untraced`` ((start ns, end ns, epochs run)) of each training in which
    the device trace was off, and the traced epochs ``epochs`` ((start ns,
    end ns)); times in seconds:

    - ``window_s``: the traced job's span;
    - ``busy_s``: the union of every device operation's interval in it,
      plus each untraced stretch's device time (``_untraced_busy``);
    - ``traced_window_s``, ``traced_busy_s``: the same with the untraced
      stretches left out;
    - ``ops``: {name: [count, seconds]} of the traced device operations;
    - ``mcmc_kernels``: kernels that started inside ``pb.mcmc_dispatch``;
    - ``idle``: {host span: [gaps, seconds]} of the device's idle gaps,
      each named by the innermost span the host was in at its middle; an
      untraced stretch's idle time (its length less its device time) is
      one entry under ``pb.train, untraced epochs``."""
    gpu = []
    cuda = torch.autograd.DeviceType.CUDA
    for e in results.events():
        if e.device_type() == cuda and not e.is_user_annotation():
            gpu.append((e.start_ns(), e.end_ns(), e.name()))
    jobs = [s for s in spans if s[2] == 'pb.job']
    if not jobs:
        return None
    w0, w1 = min(s[0] for s in jobs), max(s[1] for s in jobs)
    stretches = [(max(a, w0), min(b, w1), n) for a, b, n in untraced
                 if b > w0 and a < w1]
    off = _union([[a, b] for a, b, _ in stretches])
    off_ns = sum(b - a for a, b in off)
    inside = [g for g in gpu if g[1] > w0 and g[0] < w1]
    ops = defaultdict(lambda: [0, 0.0])
    for start, end, name in inside:
        ops[name][0] += 1
        ops[name][1] += (end - start) * 1e-9
    busy = _union([[max(s, w0), min(e, w1)] for s, e, _ in inside])
    busy_ns = sum(e - s for s, e in busy)
    estimated = _untraced_busy(busy, spans, stretches, epochs)
    est_ns = sum(d for _, _, d in estimated)
    dispatch = sorted((s, e) for s, e, n in spans
                      if n == 'pb.mcmc_dispatch')
    mcmc_kernels = 0
    if dispatch:
        starts = [s for s, _ in dispatch]
        for start, _, name in inside:
            if name.startswith('Memcpy') or name.startswith('Memset'):
                continue
            i = bisect.bisect_right(starts, start) - 1
            if i >= 0 and start <= dispatch[i][1]:
                mcmc_kernels += 1
    inner = [s for s in spans if s[2] != 'pb.job']
    idle = defaultdict(lambda: [0, 0.0])
    covered = _union([list(iv) for iv in busy] + [list(iv) for iv in off])
    edges = [w0] + [t for iv in covered for t in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            name = _innermost(inner, (a + b) // 2)
            if name == 'outside pb spans':
                name = 'evidence loop (host)'
            idle[name][0] += 1
            idle[name][1] += (b - a) * 1e-9
    for a, b, d in estimated:
        idle['pb.train, untraced epochs'][0] += 1
        idle['pb.train, untraced epochs'][1] += (b - a - d) * 1e-9
    return {'window_s': (w1 - w0) * 1e-9,
            'busy_s': (busy_ns + est_ns) * 1e-9,
            'traced_window_s': (w1 - w0 - off_ns) * 1e-9,
            'traced_busy_s': busy_ns * 1e-9,
            'untraced_s': off_ns * 1e-9,
            'untraced_epochs': sum(n for _, _, n in stretches),
            'untraced_busy_s': est_ns * 1e-9,
            'device_events': len(gpu),
            'in_window': len(inside), 'ops': dict(ops),
            'mcmc_kernels': mcmc_kernels, 'idle': dict(idle)}


def breakdown(summary, top=10):
    """The ``breakdown`` of a traced run's line: the device operations that
    took most time and the idle time by what the host was doing, each
    [name, seconds]."""
    ops = sorted(summary['ops'].items(), key=lambda kv: -kv[1][1])[:top]
    idle = sorted(summary['idle'].items(), key=lambda kv: -kv[1][1])[:top]
    return {'device_ops': [[name[:160], v[1]] for name, v in ops],
            'idle_gaps': [['%s (%d gaps)' % (name, v[0]), v[1]]
                          for name, v in idle]}


def kernel_time(summary, symbol):
    """(launches, seconds) of the device operations whose name holds
    ``symbol``."""
    count, secs = 0, 0.0
    for name, (n, s) in summary['ops'].items():
        if symbol in name:
            count += n
            secs += s
    return count, secs
