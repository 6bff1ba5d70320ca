"""Flow-training epochs a dead point over the window's jobs: the program's
``run_stats['train_epochs']`` (each training's epochs, early stopping
included) summed, over the dead points."""


def read(ctx):
    epochs = ctx['stats'].get('train_epochs')
    if epochs is None or not ctx['dead']:
        return None
    return epochs / ctx['dead']
