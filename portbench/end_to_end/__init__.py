"""One reader per end-to-end metric, found by the metric's name. Each
reads the merged result of a run's ranks (``run.merge``)."""
