"""Host milliseconds a Metropolis pool generation served: run_stats'
mcmc_s over mcmc_generations (a dispatch's time falls on the generations
it buffered)."""


def read(ctx):
    n = ctx['stats'].get('mcmc_generations', 0)
    return 1e3 * ctx['stats']['mcmc_s'] / n if n else None
