"""The NVP inverse kernel's share of its roofline in the traced job: for
each traced hot-inverse call the least time the chip could take for it
(the flow reference ``nvp``'s ``inverse_cost`` at the call's rows and the
configuration's d, hidden width, blocks and scale, against the float32 and
HBM peaks), summed, over the device time of the kernel's symbol. None
unless the kernel launched exactly once a traced call: a program whose hot
inverse of the flow is its plain ``inverse`` launches it never, and the
benchmark counts no other launches of it."""

from reference.flows import nvp

SYMBOL = 'nvp_inverse_kernel'


def read(ctx):
    trace = ctx['trace']
    if trace is None:
        return None
    from harness.trace import kernel_time
    count, secs = kernel_time(trace, SYMBOL)
    rows = ctx['traced_inverse_rows']
    if not count or count != len(rows):
        return None
    c = ctx['costs']
    d, h, blocks, nets, scale = nvp.shape(ctx['config'])
    least = sum(c.bound_s(*nvp.inverse_cost(n, d, h, blocks, nets, scale))[0]
                for n in rows)
    return 100.0 * least / secs
