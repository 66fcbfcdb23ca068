"""The benchmark of naf_tpu_torch: ``run.py`` runs one cell of
``BENCHMARK.json`` once (see ``harness.py``)."""
