"""The port's benchmark harness: cell discovery, traffic, hooks, trace
reading, the comparison that decides ``correct`` and the metric context."""
