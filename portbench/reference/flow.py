"""The ``spline`` flow's reference (``reference/flows/spline.py``), under
the name it had before flow references were found by name."""

from reference.flows.spline import inverse

__all__ = ['inverse']
