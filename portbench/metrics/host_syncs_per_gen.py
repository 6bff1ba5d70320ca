"""Synchronizing CUDA calls a Metropolis pool generation in the traced job:
the program's ``host_syncs`` made inside its dispatches (``mcmc_kernel``)
and its serving of buffered generations (``gen.serve``), counted by
``torch.cuda.set_sync_debug_mode('warn')`` while the job recorded, over
the traced job's ``mcmc_generations``."""

from harness import program


def read(ctx):
    rec = program.traced_record(ctx)
    if rec is None or not rec.syncs_counted:
        return None
    gens = program.traced_stats(ctx).get('mcmc_generations', 0)
    if not gens:
        return None
    syncs = sum(s.syncs for s in rec.spans
                if program.under(rec, s, ('mcmc_kernel', 'gen.serve')))
    return syncs / gens
