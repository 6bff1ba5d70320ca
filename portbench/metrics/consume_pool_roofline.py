"""The consumption kernel's share of its roofline in the traced job: the
least time each call's inputs need (``pool_cost`` with the flagged
candidates, their logl sectors, the accepts and the replaced slots, worked
out by the frozen plain consumption from the recorded inputs) summed, over
the device time of the kernel's symbol."""

SYMBOL = 'consume_pool_kernel'


def read(ctx):
    trace = ctx['trace']
    if trace is None:
        return None
    from harness.trace import kernel_time
    count, secs = kernel_time(trace, SYMBOL)
    pools = ctx['traced_pools']
    if not count or count != len(pools):
        return None
    c = ctx['costs']
    least = sum(c.bound_s(*c.pool_cost(*p))[0] for p in pools)
    return 100.0 * least / secs
