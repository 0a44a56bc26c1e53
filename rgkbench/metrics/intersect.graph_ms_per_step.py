"""Device ms a queued step spends inside the intersector on the graph
route: the phase stamps' `intersect_ns` over the queued iterations
(`read_stats()`), every block since the WHILE graph was built."""

from rgkbench.metrics import _program


def read(rec):
    st = _program.stats(rec, "intersect_ns", "iterations")
    return None if st is None else st["intersect_ns"] / st["iterations"] / 1e6
