"""The benchmark of ``pixie_tpu_torch``, the port on an NVIDIA card.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; ``run.py`` says
how the files of a cell are found by name.
"""
