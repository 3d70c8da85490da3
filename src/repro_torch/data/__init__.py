"""Scenario-building data helpers (``repro.data`` in NumPy): arrival-time
samplers for the streamed workloads of ``core/workloads.py``."""
