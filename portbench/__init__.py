"""portbench: the benchmark of rub_mimo_tpu_torch on one NVIDIA H100.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name: its configuration
in ``configs/``, its traffic in ``traffic/``, its per-layer readers in
``metrics/``, the layers' kernel-name patterns in ``layers/`` and the
kernels' bounds in ``rooflines/``.  ``reference/`` holds the plain
generator and receiver that the program's answers are judged against;
it imports nothing of the program.
"""
