"""Share of the traced job's spline-chain forwards that ran the chain's
kernel: the program's counter ``spline_chain``, ``kernel`` over all its
forwards (``plain`` among them), in %. None where the program counts no
such forward (a checkout without the counter)."""

from harness import program


def read(ctx):
    rec = program.traced_record(ctx)
    if rec is None:
        return None
    forwards = rec.counters.get('spline_chain') or {}
    total = sum(forwards.values())
    if not total:
        return None
    return 100.0 * forwards.get('kernel', 0) / total
