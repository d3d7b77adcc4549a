"""Benchmarks of the port (``kernels_bench``)."""
