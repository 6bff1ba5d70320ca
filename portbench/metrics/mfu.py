"""The window's model FLOPs over the window times the float32 peak: the
flow inverse of every spline-kernel call (``inverse_cost``), the training
epochs (three flow forwards a training row and one a validation row), and
every likelihood row evaluated (2d^2 + 2d)."""


def read(ctx):
    c, cfg = ctx['costs'], ctx['config']
    d, h = cfg['likelihood']['x_dim'], cfg['hidden_dim']
    calls = ctx['inverse_calls']
    flops = 0.0
    if calls:
        flops += (c.inverse_cost(ctx['inverse_rows'], d, h)[0]
                  + (calls - 1) * c.inverse_cost(0, d, h)[0])
    flops += ctx['epochs'] * c.training_epoch_ops(cfg['num_live_points'], d,
                                                  h)
    flops += ctx['rows'] * c.likelihood_ops(d)
    return 100.0 * flops / (ctx['window_s'] * c.PEAK_F32_FLOPS)
