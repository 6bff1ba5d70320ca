"""The share of the window outside training, pool generations and
checkpoint I/O (run_stats' host clocks): the evidence loop's own work on
the host, the sampler's set-up and its end-of-run diagnostics."""


def read(ctx):
    s, w = ctx['stats'], ctx['window_s']
    gen = sum(v for k, v in s.items() if k.endswith('_s')
              and k not in ('train_s', 'checkpoint_s'))
    return 100.0 * (w - s.get('train_s', 0.0) - gen
                    - s.get('checkpoint_s', 0.0)) / w
