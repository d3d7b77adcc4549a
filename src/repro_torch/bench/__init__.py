"""Benchmarks of the port: ``kernels_bench``, ``ssd_ab``, the Fig-13 study
(``fig13_vcp``), Table 2 (``table2_zoo``) and their runner (``run``)."""
