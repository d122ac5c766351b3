"""Per-layer metric readers, one file each, named as the metric: ``read(run)`` returns
the value, or ``None`` where the run holds nothing to read."""
