"""Share of the traced job's training steps whose forward ran the spline
coupling's kernel pair: the program's counter ``train_step``, ``fused``
over all its steps (``plain`` among them), in %. None where the program
counts no such steps (a checkout without the counter)."""

from harness import program


def read(ctx):
    rec = program.traced_record(ctx)
    if rec is None:
        return None
    steps = rec.counters.get('train_step') or {}
    total = sum(steps.values())
    if not total:
        return None
    return 100.0 * steps.get('fused', 0) / total
