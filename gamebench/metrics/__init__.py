"""One module a per-layer metric, named as the metric (dots become
underscores): ``read(ctx)`` returns the value, or None where the run has
nothing to read."""
