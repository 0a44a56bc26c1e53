"""Two-level cluster structure for the cluster kernel K2 (port of
rgk_tpu/scene/clusters.py; the arrays are bitwise the reference's).

* Triangles are ordered by a binned-SAH DFS sweep (scene/bvh.py) and
  chopped into fixed-size chunks of consecutive triangles.
* A small skip-link BVH is built over the chunk AABBs, one chunk per
  leaf, with u16 fixed-point node boxes (3 words a node), one leaf bit
  per node and eight per-direction-octant link tables.
* The chunk size auto-scales: 64 triangles (half a 128-slot tile) at
  the finest, doubling until the tree has at most CHUNK_CAP leaves, so
  node ids always fit the 16-bit link fields.

Cluster pack layout [T*16, 128] float32, coefficient-major (tile k =
rows k*16 .. k*16+15; row j = coefficient j of the tile's 128 slots;
slot s is column s & 127 of tile s >> 7):
  0:12  Badouel coefficients (builder.build_tri_pack); thin-glass and
        padding slots are FOLDED to never-hit rows (n = 0, d = 1, so
        t = -1/0 = -inf fails every interval test)
  12    thin-glass flag (diagnostic; the kernel never reads it)
  13    original triangle id, int32 bit pattern inside the float row
        (-1 for padding); read by bit cast, never by value
  14:16 zero
The kernel reads this pack as it is; no triangle-major copy is made.
"""

from __future__ import annotations

import numpy as np

from ..utils import log as out
from .arrays import ClusterArrays, f32, i32
from .bvh import prim_bounds, sah_build

HALF = 64          # finest chunk: half a 128-slot tile
CHUNK_CAP = 20000  # most tree leaves (the reference's SMEM budget)


def build_octant_links(first, count, skip, node_min, node_max):
    """Per-direction-octant front-to-back links over one node set.

        hit(o, n)  = near child (inner) / chunk id (leaf, every octant)
        miss(o, n) = the octant-DFS successor

    Octant bit a set means the ray direction is negative along axis a.
    The near child of an inner node is chosen by box-centre order along
    the axis where the two children are most separated.  Returns int32
    [8, N] = (hit << 16) | miss, both UNSIGNED 16-bit fields."""
    n_nodes = len(count)
    if n_nodes >= 65536:
        raise ValueError("node ids must fit unsigned 16-bit links")
    centers = (np.asarray(node_min) + np.asarray(node_max)) * 0.5
    first = np.asarray(first, np.int64)
    count = np.asarray(count, np.int64)
    skip = np.asarray(skip, np.int64)

    inner = count == 0
    left = np.where(inner, first, 0)
    right = np.where(inner, skip[np.clip(left, 0, n_nodes - 1)], 0)
    d = centers[np.clip(right, 0, n_nodes - 1)] \
        - centers[np.clip(left, 0, n_nodes - 1)]
    split_axis = np.argmax(np.abs(d), axis=1)
    left_is_lower = d[np.arange(n_nodes), split_axis] >= 0.0

    links = np.empty((8, n_nodes), np.uint32)
    # Ascending inner ids are DFS pre-order: parents come before their
    # children, so one linear pass propagates the successors:
    #   miss(near(n)) = far(n);  miss(far(n)) = miss(n)
    inner_idx = np.nonzero(inner)[0]
    for o in range(8):
        neg = np.array([(o >> a) & 1 for a in range(3)], bool)
        near_is_left = left_is_lower ^ neg[split_axis]
        near = np.where(near_is_left, left, right)
        far = np.where(near_is_left, right, left)
        hit = np.where(inner, near, first).astype(np.uint32)
        miss = np.empty(n_nodes, np.uint32)
        miss[0] = n_nodes
        for n in inner_idx:
            miss[near[n]] = far[n]
            miss[far[n]] = miss[n]
        links[o] = (hit << np.uint32(16)) | miss
    return links.view(np.int32)


def _quantize_boxes(node_min, node_max, lo, step):
    """Conservative u16 fixed-point node boxes, 3 words per node:
    w0 = (qmin_x << 16) | qmin_y, w1 = (qmin_z << 16) | qmax_x,
    w2 = (qmax_y << 16) | qmax_z.  Min floors and max ceils, so the
    dequantized box contains the true one."""
    inv = 1.0 / step
    qmin = np.floor((np.asarray(node_min, np.float64) - lo) * inv)
    qmax = np.ceil((np.asarray(node_max, np.float64) - lo) * inv)
    qmin = np.clip(qmin, 0, 65535).astype(np.uint32)
    qmax = np.clip(qmax, 0, 65535).astype(np.uint32)
    w = np.empty((len(qmin), 3), np.uint32)
    w[:, 0] = (qmin[:, 0] << 16) | qmin[:, 1]
    w[:, 1] = (qmin[:, 2] << 16) | qmax[:, 0]
    w[:, 2] = (qmax[:, 1] << 16) | qmax[:, 2]
    return w.reshape(-1).view(np.int32)


def _pack_leaf_bits(count):
    """count > 0 -> leaf; one bit per node, 32 per int32 word."""
    n = len(count)
    bits = np.zeros(((n + 31) // 32,), np.uint32)
    leaf = np.nonzero(np.asarray(count) > 0)[0]
    np.bitwise_or.at(bits, leaf // 32,
                     np.uint32(1) << (leaf % 32).astype(np.uint32))
    return bits.view(np.int32)


def chunk_halves_for(m: int) -> int:
    """Chunk size, in 64-triangle halves, for m triangles."""
    halves_raw = -(-m // HALF)
    chunk_halves = 1
    while -(-halves_raw // chunk_halves) > CHUNK_CAP:
        chunk_halves *= 2
    return chunk_halves


def build_clusters(vertices: np.ndarray, tri_vidx: np.ndarray,
                   tri_pack: np.ndarray, order=None,
                   device="cpu") -> ClusterArrays:
    """Build the two-level chunk structure on `device`.

    tri_pack: [M, 12|13] Badouel pack (col 12 = thin-glass flag).
    `order`: a precomputed SAH DFS triangle order; the commit passes the
    leaf-4 BVH's, so one SAH sweep feeds both structures."""
    m = tri_vidx.shape[0]
    centroids, prim_min, prim_max = prim_bounds(vertices, tri_vidx)
    if order is None:
        order = sah_build(centroids, prim_min, prim_max, 8)[5]
    order = np.asarray(order, np.int64)

    chunk_halves = chunk_halves_for(m)
    # Pad to whole chunks (for chunk_halves == 1 still whole tiles: two
    # sibling halves share one tile).
    grain = max(chunk_halves, 2) * HALF
    k = -(-m // grain) * grain
    pad = k - m
    n_tiles = k // 128
    n_chunks = k // (chunk_halves * HALF)

    pmin = prim_min[order]
    pmax = prim_max[order]
    if pad:
        # Padding prims: empty boxes inside the last real box.
        pmin = np.concatenate([pmin, np.repeat(pmin[-1:], pad, axis=0)])
        pmax = np.concatenate([pmax, np.repeat(pmin[-1:], pad, axis=0)])

    csz = chunk_halves * HALF
    ch_min = pmin.reshape(n_chunks, csz, 3).min(axis=1)
    ch_max = pmax.reshape(n_chunks, csz, 3).max(axis=1)
    ch_cent = (ch_min + ch_max) * 0.5

    # The chunk tree, one chunk per leaf.
    node_min, node_max, first, count, skip, corder = sah_build(
        ch_cent, ch_min, ch_max, 1)
    first = np.asarray(first, np.int64).copy()
    count = np.asarray(count, np.int64)
    corder = np.asarray(corder, np.int64)
    # Leaves name their chunk directly.
    leaf = count > 0
    first[leaf] = corder[first[leaf]]
    n_nodes = len(count)
    if n_nodes >= 65536 or n_chunks >= 65536:
        raise ValueError(f"{n_nodes} nodes / {n_chunks} chunks overflow "
                         "the 16-bit links")

    pack = np.asarray(tri_pack, np.float32)
    glass = (pack[:, 12] > 0.5) if pack.shape[1] > 12 else \
        np.zeros((m,), bool)
    rows = np.zeros((k, 16), np.float32)
    rows[:m, :12] = pack[order, :12]
    rows[:m, 12] = glass[order].astype(np.float32)
    ids = np.full((k,), -1, np.int32)
    ids[:m] = order.astype(np.int32)
    rows[:, 13] = ids.view(np.float32)
    # Thin glass (never blocks) and padding fold to never-hit rows.
    dead = np.zeros((k,), bool)
    dead[:m] = glass[order]
    dead[m:] = True
    rows[dead, :12] = 0.0
    rows[dead, 3] = 1.0
    rows = rows.reshape(n_tiles, 128, 16).transpose(
        0, 2, 1).reshape(n_tiles * 16, 128)

    links = build_octant_links(first, count, skip, node_min, node_max)
    # Rows per octant padded to a multiple of 8 (the reference's DMA
    # alignment; kept so the arrays compare one to one).
    n_sub = -(-(-(-n_nodes // 128)) // 8) * 8
    links_pad = np.zeros((8, n_sub * 128), np.int32)
    links_pad[:, :n_nodes] = links
    links_pad = links_pad.reshape(8 * n_sub, 128)

    # u16 quantization frame: the root's box, one step per axis.
    lo = np.asarray(node_min[0], np.float64)
    hi = np.asarray(node_max[0], np.float64)
    step = np.maximum((hi - lo) / 65535.0, 1e-30)
    boxes_q = _quantize_boxes(node_min, node_max, lo, step)

    out.log(3, f"Clusters: {n_chunks} x {csz} triangles "
               f"({n_tiles} tiles, chunk_halves={chunk_halves}), "
               f"{n_nodes} tree nodes")
    return ClusterArrays(
        boxes_q=i32(boxes_q, device),
        leaf_bits=i32(_pack_leaf_bits(count), device),
        links=i32(links_pad, device),
        pack=f32(rows, device),
        scene_lo=f32(lo, device),
        scene_step=f32(step, device),
        half_meta=i32(np.zeros((chunk_halves,)), device),
        chunk_halves=chunk_halves,
    )


def empty_clusters(device="cpu") -> ClusterArrays:
    """The placeholder a flat scene carries (as the reference's): a
    root LEAF whose miss link ends the walk, over one all-padding
    tile."""
    pack = np.zeros((16, 128), np.float32)
    pack[3, :] = 1.0                        # d = 1: never hits
    pack[13, :] = np.full((128,), -1, np.int32).view(np.float32)
    links = np.full((8 * 8, 128), (0 << 16) | 1, np.int32)
    return ClusterArrays(
        boxes_q=i32(np.zeros((3,)), device),
        leaf_bits=i32(np.ones((1,)), device),
        links=i32(links, device),
        pack=f32(pack, device),
        scene_lo=f32(np.zeros((3,)), device),
        scene_step=f32(np.full((3,), 1e-30), device),
        half_meta=i32(np.zeros((2,)), device),
        chunk_halves=2,
    )
