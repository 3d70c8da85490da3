"""Data helpers (``repro.data``): the synthetic LM token batches of
training, and arrival-time samplers for the streamed workloads of
``core/workloads.py``."""
