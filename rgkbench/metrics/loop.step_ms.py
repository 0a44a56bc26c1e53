"""Round ms by CUDA events (block launch to fetch), summed over the
window, per queued-loop iteration."""


def read(rec):
    if not rec.get("iterations") or "round_event_ms" not in rec:
        return None
    return sum(rec["round_event_ms"]) / rec["iterations"]
