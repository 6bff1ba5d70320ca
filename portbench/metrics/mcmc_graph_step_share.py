"""Share of the traced job's Metropolis steps that ran by replaying the
step loop's captured CUDA graphs: the program's counter ``mcmc_graph``,
``graph_steps`` over ``graph_steps`` + ``eager_steps``, in %. None where
the program counts no such steps (a checkout without the counter)."""

from harness import program


def read(ctx):
    rec = program.traced_record(ctx)
    if rec is None:
        return None
    steps = rec.counters.get('mcmc_graph') or {}
    graphed = steps.get('graph_steps', 0)
    total = graphed + steps.get('eager_steps', 0)
    if not total:
        return None
    return 100.0 * graphed / total
