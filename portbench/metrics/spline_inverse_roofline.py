"""The spline inverse kernel's share of its roofline in the traced job:
the least time the chip could take for each call (``inverse_cost`` at the
call's rows, the flow's d and hidden width, K = 8, 3 blocks, against the
float32 and HBM peaks; operations bound it at every shape the cells run)
summed, over the device time of the kernel's symbol."""

SYMBOL = 'spline_inverse_kernel'


def read(ctx):
    trace = ctx['trace']
    if trace is None:
        return None
    from harness.trace import kernel_time
    count, secs = kernel_time(trace, SYMBOL)
    rows = ctx['traced_inverse_rows']
    if not count or count != len(rows):
        return None
    c, cfg = ctx['costs'], ctx['config']
    d, h = cfg['likelihood']['x_dim'], cfg['hidden_dim']
    least = sum(c.bound_s(*c.inverse_cost(n, d, h))[0] for n in rows)
    return 100.0 * least / secs
