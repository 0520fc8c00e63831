"""The benchmark of ``stereo_rcnn_tpu_torch`` on NVIDIA H100 cards.

``python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything the harness needs of a cell is found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``driver``
names a module of ``drivers/``), ``limits/<cell>.json`` and, for each
per-layer metric, ``metrics/<metric>.py``.
"""
