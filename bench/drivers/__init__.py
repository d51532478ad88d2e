"""One driver per kind of traffic: ``run(cell, seed, seconds, traced,
device)`` -> (``harness.Outcome``, the perf_counter time set-up ended)."""
