"""Readers of the per-layer metrics, one file a metric, named as in
``BENCHMARK.json``."""
