"""The port's benchmark: ``python3 bench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``; cells, configurations, traffic and
metrics are files found by name (``bench/harness.py``)."""
