"""The benchmark of ``repro_torch``: one cell a run, driven by
``BENCHMARK.json`` and the data files beside this package
(``configs/``, ``traffic/``, ``metrics/``). Run ``python3 bench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` from the
repository root."""
