"""Host milliseconds a Metropolis pool generation of eager work before its
step loop in the traced job: the program's ``gen.prep`` spans inside its
dispatches (``mcmc_kernel``: the chain starts' draw and re-projection, the
hot inverse's repacking, the covariance factor, the starts' inverse),
summed, over the traced job's ``mcmc_generations``."""

from harness import program


def read(ctx):
    rec = program.traced_record(ctx)
    if rec is None:
        return None
    prep = [s for s in rec.spans if s.name == 'gen.prep'
            and program.under(rec, s, ('mcmc_kernel',))]
    gens = program.traced_stats(ctx).get('mcmc_generations', 0)
    if not prep or not gens:
        return None
    return 1e-6 * sum(program.duration_ns(s) for s in prep) / gens
