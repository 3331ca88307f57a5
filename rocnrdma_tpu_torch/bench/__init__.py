"""Benchmark CLIs of the port: ``bench_allreduce`` and ``bench_local``."""
