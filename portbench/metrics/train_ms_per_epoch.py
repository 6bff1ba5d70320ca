"""Host milliseconds of training an epoch: run_stats' train_s over the
trainer's epochs in the window."""


def read(ctx):
    if not ctx['epochs']:
        return None
    return 1e3 * ctx['stats']['train_s'] / ctx['epochs']
