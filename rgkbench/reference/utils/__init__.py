"""Logging, formatting and LRU helpers (copies of rgk_tpu/utils/)."""
