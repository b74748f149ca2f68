"""The benchmark of the port (``fastecc_tpu_torch``) on one NVIDIA H100.

``python3 -m ecbench.run`` runs one cell of ``BENCHMARK.json`` once;
``configs/``, ``traffic/``, ``ops/`` and ``metrics/`` hold what belongs
to one deployment, traffic mix, operation or metric, found by name;
``reference/`` is the plain reference that judges the outputs;
``control.py`` and ``sets.py`` measure the control and the spreads;
``tests/`` runs on the CPU (``python -m pytest ecbench/tests -q``).
"""
