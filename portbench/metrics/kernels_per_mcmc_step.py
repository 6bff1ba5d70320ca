"""Device kernels that started inside the traced job's Metropolis
dispatches, over the Metropolis steps those dispatches ran."""


def read(ctx):
    trace = ctx['trace']
    if trace is None or not ctx['traced_steps'] or not trace['mcmc_kernels']:
        return None
    return trace['mcmc_kernels'] / ctx['traced_steps']
