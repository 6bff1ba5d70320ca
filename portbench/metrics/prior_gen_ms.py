"""Host milliseconds a prior-rejection pool generation served: run_stats'
rejection_s over rejection_generations."""


def read(ctx):
    n = ctx['stats'].get('rejection_generations', 0)
    return 1e3 * ctx['stats']['rejection_s'] / n if n else None
