"""Likelihood kinds, one module a kind, found by the name a configuration's
``likelihood.kind`` gives (``harness/cells.py`` ``kind``). A kind's module
has:

- ``build(like_cfg, device)``: (the float32 likelihood on ``device``, a
  callable that counts the rows it evaluated in ``.rows``; the transform
  from the sampler's cube [-1, 1]^d to the likelihood's space);
- ``init_set(like, config, band, n, seed, device)``: (u float64 numpy
  (n, d) of float32 values, their float32 logl as float64 numpy, the birth
  floor) for a band that does not start from the prior: ``n`` points
  exactly uniform within {logL > floor} and the box, the start's shape
  named by ``band['start']`` and read from the band's own keys;
- ``ops_per_row(like_cfg)``: the operations of one likelihood row, counted
  as ``harness/costs.py`` counts them.

Its plain float64 reference is ``reference/likelihoods/<kind>.py``."""
