"""Share of the traced job's hot-inverse calls (the flow inverse that
Metropolis steps run, ``LatentKernels._hot_inverse``) that took a kernel
path: the program's counter ``hot_inverse``, (``spline`` + ``fast_slow``)
over all its calls (``plain`` among them), in %. None where the program
counts no such calls (a checkout without the counter)."""

from harness import program

KERNEL_PATHS = ('spline', 'fast_slow')


def read(ctx):
    rec = program.traced_record(ctx)
    if rec is None:
        return None
    calls = rec.counters.get('hot_inverse') or {}
    total = sum(calls.values())
    if not total:
        return None
    return 100.0 * sum(calls.get(k, 0) for k in KERNEL_PATHS) / total
