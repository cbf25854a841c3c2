"""The benchmark of the PyTorch and CUDA port (``ruart_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one CUDA card
and prints one JSON line. What belongs to one configuration, traffic mix,
per-layer metric or cell lives in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``
and ``limits/<cell>.json``. ``drivers/<kind>.py`` drives one path of the
port (``train``, ``offline``); a mix names its kind.
"""
