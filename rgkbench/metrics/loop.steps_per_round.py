"""Queued-loop iterations a round over the window's rounds (the graph
counters' `iterations`)."""


def read(rec):
    if not rec.get("rounds") or rec.get("iterations") is None:
        return None
    return rec["iterations"] / rec["rounds"]
