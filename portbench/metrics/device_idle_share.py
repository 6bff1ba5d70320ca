"""1 - the device's busy time over the traced job's whole span: the union
of the device operations' intervals from ``torch.profiler``, plus, for
each training's epochs after its tenth (run with the trace off), those
epochs times the median device time of its traced epochs after the first
(``harness/trace.py``)."""


def read(ctx):
    trace = ctx['trace']
    if trace is None or trace['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - trace['busy_s'] / trace['window_s'])
