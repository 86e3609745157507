"""Benchmark of blim_tpu_torch: see benchmark/run.py."""
