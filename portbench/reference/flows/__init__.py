"""Plain references of the flows, one module a flow, found by the name a
configuration's ``flow_reference`` gives (``spline`` without it;
``harness/cells.py`` ``flow_reference``). A flow reference's module has:

- ``inverse(state, z)``: (x, logdet) of the flow in the state dict
  ``state`` at latent points ``z`` (n, d), computed in ``z``'s dtype and
  device: in float64 the reference for the run's hot inverse, in float32
  under TF32 the control;
- ``inverse_ops(config, rows, calls)``: the operations of ``calls`` calls
  of the inverse over ``rows`` rows in all;
- ``forward_ops(config)``: the operations of one row through the flow's
  forward and its log density.

Operations are counted as ``harness/costs.py`` counts them. It imports
nothing of the program."""
