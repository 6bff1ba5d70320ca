"""The window's model FLOPs over the window times the float32 peak: the
flow inverse at every counted hot-inverse call and row (the flow
reference's ``inverse_ops``), the training epochs (three flow forwards a
training row and one a validation row, at the flow reference's
``forward_ops``), and every likelihood row evaluated (the kind's
``ops_per_row``)."""

from harness import cells


def read(ctx):
    c, cfg = ctx['costs'], ctx['config']
    flow = cells.flow_reference(cfg)
    flops = 0.0
    flops += flow.inverse_ops(cfg, ctx['inverse_rows'], ctx['inverse_calls'])
    flops += ctx['epochs'] * c.epoch_ops(cfg['num_live_points'],
                                         flow.forward_ops(cfg))
    flops += ctx['rows'] * cells.kind(cfg['likelihood']['kind']).ops_per_row(
        cfg['likelihood'])
    return 100.0 * flops / (ctx['window_s'] * c.PEAK_F32_FLOPS)
