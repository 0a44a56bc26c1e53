"""Share of the light phase's queries' roofline on the graph route: the
least bytes (`_intersect.least_bytes`) of its closest queries over the
light extension rays (`light_live_rays` less the splat query's
`light_any_rays`), its any-hit splat queries over `light_any_rays`, and
the scene's triangles once a query, at the card's bandwidth, over the
stamps' `light_intersect_ns`, in the window; in %."""

from rgkbench.metrics import _bdpt
from rgkbench.metrics import _intersect as ix


def read(rec):
    st = _bdpt.window(rec, "light_intersect_ns", "light_live_rays",
                      "light_closest_queries")
    if st is None or "triangles" not in rec:
        return None
    any_rays = st.get("light_any_rays", 0)
    nbytes = ix.least_bytes(st["light_closest_queries"],
                            st["light_live_rays"] - any_rays,
                            st.get("light_any_queries", 0), any_rays,
                            rec["triangles"])
    return (100.0 * nbytes / ix.PEAK_BYTES_PER_S
            / (st["light_intersect_ns"] / 1e9))
