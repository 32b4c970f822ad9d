"""The benchmark of the PyTorch/CUDA port of the CF engine (``repro_torch``).

``python3 cfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Configurations,
traffic mixes, jobs and per-layer metric readers are files found by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``jobs/<job>.py`` and
``metrics/<metric>.py``.  ``reference/`` holds the plain implementation
that decides ``correct``; it imports nothing of the port.
"""
