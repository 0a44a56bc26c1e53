"""Share of the intersection layer's roofline on the graph route: the
least bytes of the queries the graph ran (`_intersect.least_bytes` of
the program's counters `closest_queries`, `live_lanes`, `any_queries`,
`any_live_rays` and the scene's triangles) at the card's bandwidth over
the stamps' `intersect_ns`, in %.  The count of `intersect_roofline`."""

from rgkbench.metrics import _intersect as ix
from rgkbench.metrics import _program


def read(rec):
    st = _program.stats(rec, "intersect_ns", "closest_queries",
                        "live_lanes")
    if st is None or "triangles" not in rec:
        return None
    nbytes = ix.least_bytes(st["closest_queries"], st["live_lanes"],
                            st.get("any_queries", 0),
                            st.get("any_live_rays", 0), rec["triangles"])
    return 100.0 * nbytes / ix.PEAK_BYTES_PER_S / (st["intersect_ns"] / 1e9)
