"""Host milliseconds the sampler's thread stood in checkpoint I/O in the
traced job: the program's ``checkpoint_io`` phases (each checkpoint's
snapshot and hand-off, and the final drain of the background writer) and
its ``io.drain`` waits outside them, summed."""

from harness import program


def read(ctx):
    rec = program.traced_record(ctx)
    if rec is None:
        return None
    phases = program.total_ns(rec, 'checkpoint_io')
    if phases is None:
        return None
    drains = program.total_ns(rec, 'io.drain', outside=('checkpoint_io',))
    return 1e-6 * (phases + (drains or 0))
