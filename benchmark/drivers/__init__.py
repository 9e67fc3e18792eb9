"""Workload drivers, one module a traffic ``kind``: ``set_up``, ``window`` and ``check``."""
