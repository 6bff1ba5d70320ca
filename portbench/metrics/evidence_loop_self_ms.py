"""Host milliseconds a dead point of the evidence loop's own work in the
traced job: the program's ``loop`` span less every span nested in it (pool
refills, training, the NLL gate, checkpoints, the chain file), over the
traced job's dead points."""

from harness import program


def read(ctx):
    rec = program.traced_record(ctx)
    if rec is None:
        return None
    own = program.self_ns(rec, 'loop')
    dead = ctx['jobs'][0]['dead']
    if own is None or not dead:
        return None
    return 1e-6 * own / dead
