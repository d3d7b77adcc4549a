"""Benchmarks of the port: the paper's studies (``table1_designs``,
``fig9_memory_traffic``, ``fig10_performance``, ``fig11_energy``, the
Fig-13 study ``fig13_vcp``, Table 2 ``table2_zoo``), the simulator's
throughput (``backend_throughput``), the kernel and seam-rate bench
(``kernels_bench``), ``ssd_ab``, ``dse_sweep``, the regression gate
(``compare``) and their runner (``run``)."""
