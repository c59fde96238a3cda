"""The benchmark of the PyTorch/CUDA port (``kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch``)
on one H100: ``run.py`` runs one cell of ``BENCHMARK.json`` once."""
