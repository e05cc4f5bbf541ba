"""The benchmark of ``ctc_pytorch_tpu_torch`` on one NVIDIA H100.

``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line last.  Everything that belongs to one configuration, traffic mix, cell
kind, per-layer metric or kernel table is a file of its own that the harness
finds by name (``registry.py``).
"""
