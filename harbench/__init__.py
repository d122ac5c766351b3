"""The benchmark of ``tpuhar_torch`` on one H100: ``python3 -m harbench.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``. Cells, configurations, drivers and
per-layer metric readers are files found by the names in ``BENCHMARK.json``."""
