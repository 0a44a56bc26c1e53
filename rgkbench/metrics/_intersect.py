"""The least work of the intersection layer's queries, shared by its
readers.

A query's least traffic, whatever algorithm answers it: each live ray's
inputs read once (origin and direction, 3 float32 each, and its t
interval, 2 float32), its record written once (closest: t, triangle id
and two barycentrics, 4 x 4 bytes; any: one int32 witness), and the
scene's triangles read once (3 vertices of 3 float32 each).  Over the
bytes at the card's published bandwidth that is the least time; no
implementation can beat it, so the share stays under 1.
"""

RAY_IN_BYTES = 8 * 4
CLOSEST_OUT_BYTES = 4 * 4
ANY_OUT_BYTES = 4
TRIANGLE_BYTES = 9 * 4
# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
# Substrings of the intersection kernels' names: K1, K2 and the binned
# pipeline's K3 and K4.
KERNELS = ("flat_sweep", "cluster_walk", "binned_walk", "binned_sweep")


def least_bytes(closest_queries, closest_rays, any_queries, any_rays,
                triangles):
    """Bytes that the queries of a block need at least."""
    return (closest_rays * (RAY_IN_BYTES + CLOSEST_OUT_BYTES)
            + any_rays * (RAY_IN_BYTES + ANY_OUT_BYTES)
            + (closest_queries + any_queries) * triangles * TRIANGLE_BYTES)


def is_intersection(name: str) -> bool:
    return any(k in name for k in KERNELS)


def kernel_ms(kernels: dict, intersection: bool) -> float:
    """Device ms of the profiled block's intersection kernels, or of
    every other kernel."""
    return sum(ms for name, (_, ms) in kernels.items()
               if is_intersection(name) == intersection)
