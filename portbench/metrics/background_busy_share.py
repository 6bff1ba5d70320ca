"""The background threads' busy time in the traced job over its ``run``
span: the program's ``background_ns`` counters of the writer thread's jobs
(``io_writer``: checkpoints, the chain file, TensorBoard's ``logz``
scalars) and the trainer's plot renders (``plot``), summed."""

from harness import program


def read(ctx):
    rec = program.traced_record(ctx)
    if rec is None or 'background_ns' not in rec.counters:
        return None
    run = rec.spans[0]
    return 100.0 * sum(rec.counters['background_ns'].values()) / \
        program.duration_ns(run)
