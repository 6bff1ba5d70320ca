"""The plain float64 likelihoods, one module a kind, found by the kind's
name (``harness/cells.py`` ``reference_kind``). A kind's module has
``loglike(like_cfg)``: the float64 NumPy log likelihood of cube points
(rows of u in [-1, 1]^d, the sampler's coordinates), its transform to the
likelihood's space included. It imports nothing of the program."""
