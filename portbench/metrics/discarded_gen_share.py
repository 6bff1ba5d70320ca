"""Prefetched generations left unserved when a job ended, over all the
generations made (served and discarded)."""


def read(ctx):
    s = ctx['stats']
    served = sum(v for k, v in s.items() if k.endswith('_generations'))
    made = served + s.get('generations_discarded', 0)
    return 100.0 * s.get('generations_discarded', 0) / made if made else None
