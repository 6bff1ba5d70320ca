"""The share of the window spent training the flow (run_stats' train_s)."""


def read(ctx):
    if not ctx['stats'].get('trainings'):
        return None
    return 100.0 * ctx['stats']['train_s'] / ctx['window_s']
