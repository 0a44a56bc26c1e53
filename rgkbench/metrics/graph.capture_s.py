"""Seconds of CUDA graph capture in set-up:
`integrator.graph.read_stats()["capture_ms"]` / 1000."""


def read(rec):
    ms = rec.get("capture_ms")
    return None if ms is None else ms / 1e3
