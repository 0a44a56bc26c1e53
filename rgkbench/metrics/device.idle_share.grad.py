"""1 - (CUDA-event time around each window step and its SGD update,
summed) / the window's wall time."""


def read(rec):
    if "step_event_ms" not in rec or not rec.get("window_s"):
        return None
    return 1.0 - sum(rec["step_event_ms"]) / 1e3 / rec["window_s"]
