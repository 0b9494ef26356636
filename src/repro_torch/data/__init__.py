"""The synthetic token pipeline with background prefetch (``pipeline``)."""
