"""The spline inverse kernel's share of its roofline under a fast-slow
flow's hot inverse in the traced job: for each traced call the least time
the chip could take for its two launches (``inverse_cost`` at the call's
rows for the slow chain and for the fast chain, at each chain's d and
hidden width as the flow reference ``fastslow_spline`` gives them, K = 8,
the configuration's blocks, against the float32 and HBM peaks), summed,
over the device time of the kernel's symbol. The combine coupling's plain
operations, which run beside the kernel in every call, are outside both
the numerator and the denominator. None unless the kernel launched exactly
twice a traced call (a program that runs the flow's plain inverse
launches it never)."""

from reference.flows import fastslow_spline

SYMBOL = 'spline_inverse_kernel'


def read(ctx):
    trace = ctx['trace']
    if trace is None:
        return None
    from harness.trace import kernel_time
    count, secs = kernel_time(trace, SYMBOL)
    rows = ctx['traced_inverse_rows']
    if not count or count != 2 * len(rows):
        return None
    c = ctx['costs']
    d, k, h_slow, h_fast, blocks = fastslow_spline.shape(ctx['config'])
    least = sum(c.bound_s(*c.inverse_cost(n, dim, h, num_blocks=blocks))[0]
                for n in rows for dim, h in ((k, h_slow), (d - k, h_fast)))
    return 100.0 * least / secs
