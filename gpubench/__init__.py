"""The benchmark of ``repro_torch``: full-graph GCN inference on one card.

``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Configurations, traffic mixes, cells and metrics are files under
this directory, found by the names ``BENCHMARK.json`` gives them.
"""
