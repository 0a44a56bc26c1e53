"""1 - (CUDA-event time from before each round's block launch to after
its fetch, summed) / the window's wall time."""


def read(rec):
    if "round_event_ms" not in rec or not rec.get("window_s"):
        return None
    return 1.0 - sum(rec["round_event_ms"]) / 1e3 / rec["window_s"]
