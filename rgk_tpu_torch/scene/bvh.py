"""Host-side BVH construction: binned SAH + skip-link flattening (port
of rgk_tpu/scene/bvh.py).

A 2-wide BVH is built with binned SAH (16 bins) and flattened
depth-first with skip links, so the traversal (ops/intersect.py
`intersect_bvh`) needs no per-lane stack.  Node i of the flat layout:

    node_min[i], node_max[i] : AABB
    meta[i] = (first, count, skip)
      leaf:  first = offset into prim_idx, count = #prims (> 0)
      inner: first = left child (== i + 1), count = 0
      skip:  next node in DFS order once this subtree is done or culled;
             the root's rightmost path ends at skip == n_nodes.

The port's copy of the reference's native C++ builder
(`rgk_tpu_torch/native/bvh_native.py`, numpy + ctypes only, compiled
with `c++` at first use into `rgk_tpu_torch/build/`) runs when it
loads; `_build_numpy` is the same algorithm, line for line the
reference's, and the fallback.  Which one ran is logged at level 3:
the numpy build takes minutes at a million triangles.
"""

from __future__ import annotations

import numpy as np

from ..utils import log as out
from .arrays import BVHArrays, f32, i32

N_BINS = 16


def _build_numpy(centroids, prim_min, prim_max, leaf_size):
    """Iterative binned-SAH build.  Returns (node_min, node_max, first,
    count, skip, order) with nodes in DFS pre-order."""
    n = centroids.shape[0]
    order = np.arange(n)

    nodes_min, nodes_max, nodes_first, nodes_count = [], [], [], []
    # Stack of (start, end, parent_row, is_right); the left child pops
    # first, so it lands at parent_row + 1.
    stack = [(0, n, -1, False)]
    parent_right_child = {}

    while stack:
        start, end, parent_row, is_right = stack.pop()
        row = len(nodes_min)
        if parent_row >= 0 and is_right:
            parent_right_child[parent_row] = row

        bbmin = prim_min[order[start:end]].min(axis=0)
        bbmax = prim_max[order[start:end]].max(axis=0)
        count = end - start

        if count <= leaf_size:
            nodes_min.append(bbmin)
            nodes_max.append(bbmax)
            nodes_first.append(start)
            nodes_count.append(count)
            continue

        # Binned SAH over the centroid extent, best of 3 axes.
        cmin = centroids[order[start:end]].min(axis=0)
        cmax = centroids[order[start:end]].max(axis=0)
        extent = cmax - cmin
        best = None
        for axis in range(3):
            if extent[axis] <= 1e-12:
                continue
            c = centroids[order[start:end], axis]
            bins = np.minimum(
                ((c - cmin[axis]) / extent[axis] * N_BINS).astype(np.int32),
                N_BINS - 1)
            counts = np.bincount(bins, minlength=N_BINS)
            bmin = np.full((N_BINS, 3), np.inf)
            bmax = np.full((N_BINS, 3), -np.inf)
            pm = prim_min[order[start:end]]
            px = prim_max[order[start:end]]
            for b in range(N_BINS):
                sel = bins == b
                if counts[b]:
                    bmin[b] = pm[sel].min(axis=0)
                    bmax[b] = px[sel].max(axis=0)
            lmin = np.minimum.accumulate(bmin, axis=0)
            lmax = np.maximum.accumulate(bmax, axis=0)
            rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
            lcount = np.cumsum(counts)
            rcount = np.cumsum(counts[::-1])[::-1]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] \
                    + d[..., 2] * d[..., 0]

            cost = (area(lmin[:-1], lmax[:-1]) * lcount[:-1]
                    + area(rmin[1:], rmax[1:]) * rcount[1:])
            cost = np.where((lcount[:-1] == 0) | (rcount[1:] == 0),
                            np.inf, cost)
            k = int(np.argmin(cost))
            if np.isfinite(cost[k]) and (best is None or cost[k] < best[0]):
                best = (cost[k], axis, k, bins)

        if best is None:
            # Degenerate: all centroids coincide — median split.
            mid = start + count // 2
        else:
            _, axis, k, bins = best
            sel = bins <= k
            seg = order[start:end]
            order[start:end] = np.concatenate([seg[sel], seg[~sel]])
            mid = start + int(sel.sum())
            if mid == start or mid == end:
                mid = start + count // 2

        nodes_min.append(bbmin)
        nodes_max.append(bbmax)
        nodes_first.append(-1)  # patched to the left child (row + 1)
        nodes_count.append(0)
        stack.append((mid, end, row, True))
        stack.append((start, mid, row, False))

    n_nodes = len(nodes_min)
    first = np.asarray(nodes_first, np.int64)
    count = np.asarray(nodes_count, np.int64)
    right = np.full(n_nodes, -1, np.int64)
    for parent, rc in parent_right_child.items():
        right[parent] = rc
    inner = count == 0
    first[inner] = np.nonzero(inner)[0] + 1

    # Skip links: skip(root) = n_nodes; skip(left) = right sibling;
    # skip(right) = skip(parent).
    skip = np.full(n_nodes, n_nodes, np.int64)
    stack2 = [(0, n_nodes)]
    while stack2:
        row, s = stack2.pop()
        skip[row] = s
        if count[row] == 0:
            left, rc = first[row], right[row]
            stack2.append((left, rc))
            stack2.append((rc, s))

    return (np.asarray(nodes_min, np.float32),
            np.asarray(nodes_max, np.float32),
            first, count, skip, order)


def native_builder():
    """The port's copy of the reference's C++ binned-SAH builder, or None
    when its library cannot be built or loaded here."""
    from ..native import bvh_native

    return bvh_native.build_binned_sah if bvh_native._load() else None


def builder_name() -> str:
    """Which SAH builder `sah_build` runs here: "native" or "numpy"."""
    return "numpy" if native_builder() is None else "native"


def sah_build(centroids, prim_min, prim_max, leaf_size):
    """Binned SAH through the native builder when it loads, else numpy.
    Returns (node_min, node_max, first, count, skip, order)."""
    build = native_builder() or _build_numpy
    return build(centroids, prim_min, prim_max, leaf_size)


def prim_bounds(vertices: np.ndarray, tri_vidx: np.ndarray):
    """Per-triangle (centroid, min, max) boxes."""
    a = vertices[tri_vidx[:, 0]]
    b = vertices[tri_vidx[:, 1]]
    c = vertices[tri_vidx[:, 2]]
    prim_min = np.minimum(np.minimum(a, b), c)
    prim_max = np.maximum(np.maximum(a, b), c)
    return (prim_min + prim_max) * 0.5, prim_min, prim_max


def build_bvh(vertices: np.ndarray, tri_vidx: np.ndarray,
              leaf_size: int = 4, device="cpu") -> BVHArrays:
    """Build the flattened BVH of a committed triangle soup on
    `device`."""
    centroids, prim_min, prim_max = prim_bounds(vertices, tri_vidx)
    node_min, node_max, first, count, skip, order = sah_build(
        centroids, prim_min, prim_max, leaf_size)
    out.log(3, f"BVH ({builder_name()} SAH builder): {len(first)} nodes over "
               f"{len(order)} triangles (leaf size {leaf_size})")
    meta = np.stack([first, count, skip], axis=1).astype(np.int32)
    return BVHArrays(
        node_min=f32(node_min, device),
        node_max=f32(node_max, device),
        node_meta=i32(meta, device),
        prim_idx=i32(order, device),
    )


def placeholder_bvh(n_triangles: int, device="cpu") -> BVHArrays:
    """The one-node BVH a flat scene carries (as the reference's)."""
    return BVHArrays(
        node_min=f32(np.zeros((1, 3)), device),
        node_max=f32(np.zeros((1, 3)), device),
        node_meta=i32(np.zeros((1, 3)), device),
        prim_idx=i32(np.arange(n_triangles), device),
    )
