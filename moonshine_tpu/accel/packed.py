"""Node and triangle records for the per-thread traversal kernel.

The CUDA kernel (kernels/traverse.cu) walks the same binary BVH as
accel/traverse.py, in the same stackless escape-link order, but reads it
as fixed-size records so one node visit is two 16-byte loads and one
triangle test three:

  node  [M, 8] int32:  min.x min.y min.z link | max.x max.y max.z escape
        (coordinates are float32 bit patterns). `link` is the left child
        of an internal node, or -1 - (offset << 4 | count) for a leaf
        covering sorted triangles [offset, offset + count).
  tri   [T, 12] float32: v0, 0 | v1 - v0, 0 | v2 - v0, 0 in the BVH's
        sorted order. The edges are the same float32 differences
        traverse.py computes per test, so both intersect identically.

Packing is plain numpy at scene build time. `closest_hit_np` and
`any_hit_np` are numpy twins of the kernel's loop over these buffers: they
are what the CPU tests check the packing and the walk with.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

LEAF_COUNT_BITS = 4
_MAX_LEAF_COUNT = (1 << LEAF_COUNT_BITS) - 1
_MAX_LEAF_OFFSET = (1 << (31 - LEAF_COUNT_BITS)) - 1


class PackedBVH(NamedTuple):
    nodes: np.ndarray  # [M, 8] int32
    tris: np.ndarray  # [T, 12] float32


def pack_nodes(aabb_min, aabb_max, left, count, escape) -> np.ndarray:
    """[M, 8] int32 node records from the flattened BVH arrays."""
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    left = np.asarray(left, np.int64)
    count = np.asarray(count, np.int64)
    leaf = count > 0
    if (count > _MAX_LEAF_COUNT).any():
        raise ValueError(f"leaf holds more than {_MAX_LEAF_COUNT} triangles")
    if (left[leaf] > _MAX_LEAF_OFFSET).any():
        raise ValueError("leaf triangle offset does not fit a node record")
    link = np.where(leaf, -1 - ((left << LEAF_COUNT_BITS) | count), left)
    out = np.empty((len(left), 8), np.int32)
    out[:, 0:3] = aabb_min.view(np.int32)
    out[:, 3] = link
    out[:, 4:7] = aabb_max.view(np.int32)
    out[:, 7] = np.asarray(escape, np.int32)
    return out


def pack_tris(sorted_tri_verts) -> np.ndarray:
    """[T, 12] float32 triangle records (vertex 0 and two edges)."""
    v = np.asarray(sorted_tri_verts, np.float32)
    out = np.zeros((len(v), 12), np.float32)
    out[:, 0:3] = v[:, 0]
    out[:, 4:7] = v[:, 1] - v[:, 0]
    out[:, 8:11] = v[:, 2] - v[:, 0]
    return out


def pack(bvh, sorted_tri_verts) -> PackedBVH:
    """Records for a host (numpy) BVH and its sorted triangle vertices."""
    return PackedBVH(
        nodes=pack_nodes(bvh.aabb_min, bvh.aabb_max, bvh.left, bvh.count,
                         bvh.escape),
        tris=pack_tris(sorted_tri_verts),
    )


def unpack_node(record):
    """(min [3], max [3], is_leaf, link or offset, count, escape)."""
    rec = np.asarray(record, np.int32)
    lo = rec[0:3].view(np.float32)
    hi = rec[4:7].view(np.float32)
    link = int(rec[3])
    if link >= 0:
        return lo, hi, False, link, 0, int(rec[7])
    code = -1 - link
    return (lo, hi, True, code >> LEAF_COUNT_BITS,
            code & _MAX_LEAF_COUNT, int(rec[7]))


# --- numpy twins of the kernel (one ray at a time, float32 throughout) ---

_F = np.float32


def _safe_inv(d):
    mag = np.abs(d)
    sgn = np.where(d >= 0, _F(1), _F(-1)).astype(np.float32)
    return (_F(1) / np.where(mag < _F(1e-12), sgn * _F(1e-12), d)).astype(
        np.float32)


def _box_hit(lo, hi, o, inv, t_best):
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tnear = np.minimum(t0, t1).max()
    tfar = np.maximum(t0, t1).min()
    return tnear <= tfar and tfar >= 0 and tnear <= t_best


def _tri_hit(rec, o, d, t_best):
    v0, e1, e2 = rec[0:3], rec[4:7], rec[8:11]
    pvec = np.cross(d, e2)
    det = _F(np.dot(e1, pvec))
    inv_det = _F(1) / (_F(1e-12) if abs(det) < _F(1e-12) else det)
    tvec = o - v0
    u = _F(np.dot(tvec, pvec)) * inv_det
    qvec = np.cross(tvec, e1)
    v = _F(np.dot(d, qvec)) * inv_det
    t = _F(np.dot(e2, qvec)) * inv_det
    hit = (abs(det) > _F(1e-12) and u >= 0 and v >= 0 and u + v <= 1
           and t > 0 and t < t_best)
    return hit, t, u, v


def _walk(packed, o, d, t_max, any_hit):
    nodes, tris = packed.nodes, packed.tris
    inv = _safe_inv(d)
    t_best = _F(t_max)
    best = (-1, _F(0), _F(0))
    cur = 0
    while cur >= 0:
        lo, hi, leaf, link, count, nxt = unpack_node(nodes[cur])
        if _box_hit(lo, hi, o, inv, t_best):
            if not leaf:
                nxt = link
            for s in range(link, link + count) if leaf else ():
                s = min(s, len(tris) - 1)
                hit, t, u, v = _tri_hit(tris[s], o, d, t_best)
                if hit and any_hit:
                    return True
                if hit:
                    t_best, best = t, (s, u, v)
        cur = nxt
    return False if any_hit else (t_best,) + best


def closest_hit_np(packed, tri_order, ray_o, ray_d, t_max, active=None):
    """Kernel twin: (t, tri, u, v) arrays; tri is the original id, -1 on
    miss, and an inactive lane returns (t_max, -1, 0, 0)."""
    o = np.asarray(ray_o, np.float32)
    d = np.asarray(ray_d, np.float32)
    n = len(o)
    t_max = np.broadcast_to(np.asarray(t_max, np.float32), (n,))
    active = np.ones(n, bool) if active is None else np.asarray(active)
    t = t_max.copy()
    tri = np.full(n, -1, np.int32)
    u = np.zeros(n, np.float32)
    v = np.zeros(n, np.float32)
    order = np.asarray(tri_order)
    for i in np.flatnonzero(active):
        t[i], s, u[i], v[i] = _walk(packed, o[i], d[i], t_max[i], False)
        tri[i] = order[s] if s >= 0 else -1
    return t, tri, u, v


def any_hit_np(packed, ray_o, ray_d, t_max, active=None):
    """Kernel twin of the any-hit walk: bool [N]."""
    o = np.asarray(ray_o, np.float32)
    d = np.asarray(ray_d, np.float32)
    n = len(o)
    t_max = np.broadcast_to(np.asarray(t_max, np.float32), (n,))
    active = np.ones(n, bool) if active is None else np.asarray(active)
    out = np.zeros(n, bool)
    for i in np.flatnonzero(active):
        out[i] = _walk(packed, o[i], d[i], t_max[i], True)
    return out
