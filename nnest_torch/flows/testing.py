"""Testing oracles for flows.

Port of ``nnest_tpu/flows/testing.py``: ``brute_force_logdet`` computes
log|det ∂f⁻¹(z)/∂z| from the full Jacobian of each row, so tests can hold
every bijector's analytic logdet to it.

Each row's Jacobian is taken with ``torch.func.jacrev`` on its own, in a
loop over the rows (testing only, so the rows are few). The literal
counterpart of the JAX oracle, ``torch.func.vmap(torch.func.jacfwd(f))``,
is not used: through the spline flow it returns a wrong Jacobian without
an error (its log|det| ~9 nats off the analytic logdet at d = 3), while
``vmap`` alone, ``jacfwd`` alone, ``jacrev`` and
``torch.autograd.functional.jacobian`` agree with it to rounding.
"""

from __future__ import annotations

import torch


def _row_logdets(fn, points):
    """log|det| of the Jacobian of ``fn`` (a (1, d) -> ((1, d), ...) map
    of the flow) at each row of ``points``."""
    def one(p):
        return fn(p[None, :])[0][0]

    jacobians = torch.stack([torch.func.jacrev(one)(p) for p in points])
    return torch.linalg.slogdet(jacobians)[1]


def brute_force_logdet(model, z):
    """log|det dx/dz| of the flow inverse at each row of z, via full
    Jacobians (O(d³) a row; testing only)."""
    return _row_logdets(model.inverse, z)


def brute_force_forward_logdet(model, x):
    """log|det dz/dx| of the flow forward at each row of x."""
    return _row_logdets(model.forward, x)
