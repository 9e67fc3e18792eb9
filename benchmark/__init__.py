"""The benchmark of ``dream_tpu_torch`` on NVIDIA GPUs: cells, traffic, metric readers
and the plain reference that decides ``correct`` (see ``benchmark/README.md``)."""
