"""The evidence loop's side work a dead point in the traced job: the
program's counter ``evidence_side``, (``transform_calls`` +
``scalar_jobs``) over ``dead`` (the sampler transform's calls from the loop
and the ``logz`` scalar batches handed to the writer, over the points that
died in the loop). None where the program counts no dead point (a checkout
without the counter)."""

from harness import program


def read(ctx):
    rec = program.traced_record(ctx)
    if rec is None:
        return None
    side = rec.counters.get('evidence_side') or {}
    if not side.get('dead'):
        return None
    return (side.get('transform_calls', 0) + side.get('scalar_jobs', 0)) / \
        side['dead']
