"""LBVH construction over world-space triangles.

Software replacement for the reference's Vulkan KHR BLAS/TLAS
(engine/hrtsystem/Accel.zig:94-563). The driver hardware there builds an
opaque acceleration structure; here we build a Karras radix tree over
Morton-sorted triangle centroids (Karras 2012, "Maximally Parallel
Construction of BVHs") entirely with vectorized numpy — no Python-level
recursion — then flatten it into fixed-size arrays with *skip links* so
device-side traversal is a single stackless while loop.

Key properties:
  * 64-bit sort keys (30-bit Morton << 32 | index) are strictly increasing,
    so the radix tree depth is bounded by the key width — every bottom-up /
    top-down pass loop below converges in <= 64 iterations even for
    degenerate (all-coincident) geometry.
  * Each internal node covers a contiguous range of the Morton-sorted
    triangle array, so leaves collapse to (offset, count) pairs over the
    sorted order; traversal needs only `left` + `escape` per node.
  * Arrays are padded to a power of two by default so scenes of similar
    size share XLA executables.

Refit (the reference's TLAS update path, Accel.zig:567-679) is
`refit(bvh, tri_verts)`: topology is kept, AABBs are recomputed bottom-up
in jnp — cheap enough to run per-frame for animated scenes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


SENTINEL = np.int32(-1)  # escape target meaning "traversal done"


class BVH(NamedTuple):
    """Flattened BVH. Node 0 is the root. count[i] == 0 marks an internal
    node whose left child is left[i] (the right child is reached through the
    left subtree's escape link); count[i] > 0 marks a leaf covering
    tri_order[left[i] : left[i]+count[i]].
    """

    aabb_min: jnp.ndarray  # [M, 3] f32
    aabb_max: jnp.ndarray  # [M, 3] f32
    left: jnp.ndarray  # [M] i32: left child (internal) or tri offset (leaf)
    count: jnp.ndarray  # [M] i32: 0 internal, >0 leaf triangle count
    escape: jnp.ndarray  # [M] i32: next node when skipping this subtree
    tri_order: jnp.ndarray  # [T] i32: Morton-sorted triangle permutation
    num_nodes: int
    num_tris: int
    # parity bookkeeping: parent links enable jnp refit (Accel.zig refit path)
    parent: jnp.ndarray  # [M] i32, -1 for root



def _to_bvh(aabb_min, aabb_max, left, count, escape, order,
            num_nodes, num_tris, parent, as_numpy):
    """as_numpy=True keeps host arrays (no device upload): used by World so
    the build's topology can be cached for host-side refits and converted
    to device arrays exactly once via `device_bvh`."""
    conv = (lambda a, dt: np.asarray(a, dt)) if as_numpy else \
           (lambda a, dt: jnp.asarray(a, dt))
    return BVH(
        aabb_min=conv(aabb_min, np.float32),
        aabb_max=conv(aabb_max, np.float32),
        left=conv(left, np.int32),
        count=conv(count, np.int32),
        escape=conv(escape, np.int32),
        tri_order=conv(order, np.int32),
        num_nodes=num_nodes,
        num_tris=num_tris,
        parent=conv(parent, np.int32),
    )


def device_bvh(bvh: BVH) -> BVH:
    """Upload a host (numpy) BVH's arrays to the device."""
    return bvh._replace(
        aabb_min=jnp.asarray(bvh.aabb_min),
        aabb_max=jnp.asarray(bvh.aabb_max),
        left=jnp.asarray(bvh.left),
        count=jnp.asarray(bvh.count),
        escape=jnp.asarray(bvh.escape),
        tri_order=jnp.asarray(bvh.tri_order),
        parent=jnp.asarray(bvh.parent),
    )


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v to every third bit (Morton helper)."""
    v = v.astype(np.uint64)
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def morton3d(points01: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points in [0,1]^3. [N,3] -> [N] uint64."""
    q = np.clip(points01 * 1024.0, 0.0, 1023.0).astype(np.uint64)
    return (
        (_expand_bits(q[:, 0]) << np.uint64(2))
        | (_expand_bits(q[:, 1]) << np.uint64(1))
        | _expand_bits(q[:, 2])
    )


def _clz64(x: np.ndarray) -> np.ndarray:
    """Count leading zeros of uint64 array (64 for x == 0)."""
    # via float64 exponent trick is lossy for >53 bits; do it in two 32-bit halves
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    clz_hi = 32 - _bit_length_u32(hi)
    clz_lo = 32 - _bit_length_u32(lo)
    return np.where(hi != 0, clz_hi, 32 + clz_lo).astype(np.int64)


def _bit_length_u32(x: np.ndarray) -> np.ndarray:
    """Position of highest set bit (0 for x == 0)."""
    out = np.zeros(x.shape, np.int64)
    v = x.astype(np.uint32).copy()
    for shift in (16, 8, 4, 2, 1):
        mask = v >= (np.uint32(1) << np.uint32(shift))
        out = np.where(mask, out + shift, out)
        v = np.where(mask, v >> np.uint32(shift), v)
    return out + (v > 0)


def _karras_topology(keys: np.ndarray):
    """Radix-tree topology over strictly-increasing uint64 keys.

    Returns (left, right, leaf_range_lo, leaf_range_hi) where internal node
    i in [0, n-2] has children indices encoded as: child >= 0 -> internal
    node id, child < 0 -> leaf id ~child (bitwise complement).
    """
    n = len(keys)
    assert n >= 2
    idx = np.arange(n - 1, dtype=np.int64)

    def delta(i, j):
        """Common-prefix length of keys i, j; -1 out of range. i, j arrays."""
        ok = (j >= 0) & (j < n)
        jc = np.clip(j, 0, n - 1)
        d = _clz64(keys[i] ^ keys[jc])
        return np.where(ok, d, -1)

    # direction of the range containing i
    d = np.sign(delta(idx, idx + 1) - delta(idx, idx - 1)).astype(np.int64)
    delta_min = delta(idx, idx - d)

    # exponential search for an upper bound on range length
    lmax = np.full(n - 1, 2, np.int64)
    while True:
        probe = delta(idx, idx + lmax * d) > delta_min
        if not probe.any():
            break
        lmax = np.where(probe, lmax * 2, lmax)
        if (lmax > 4 * n).all():
            break

    # binary search for the exact other end j
    length = np.zeros(n - 1, np.int64)
    t = lmax // 2
    while (t >= 1).any():
        probe = delta(idx, idx + (length + t) * d) > delta_min
        length = np.where((t >= 1) & probe, length + t, length)
        t = t // 2
    j = idx + length * d

    # binary search for the split position
    delta_node = delta(idx, j)
    s = np.zeros(n - 1, np.int64)
    t = (length + 1) // 2  # ceil(length / 2)
    while True:
        probe = delta(idx, idx + (s + t) * d) > delta_node
        s = np.where((t >= 1) & probe, s + t, s)
        if (t <= 1).all():
            break
        t = (t + 1) // 2
    gamma = idx + s * d + np.minimum(d, 0)

    lo = np.minimum(idx, j)
    hi = np.maximum(idx, j)
    left = np.where(lo == gamma, ~gamma, gamma)  # ~x marks a leaf
    right = np.where(hi == gamma + 1, ~(gamma + 1), gamma + 1)
    return left.astype(np.int64), right.astype(np.int64), lo, hi


def _next_pow2(x: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


def build(
    tri_verts: np.ndarray,
    leaf_size: int = 4,
    pad_nodes_to_pow2: bool = True,
    as_numpy: bool = False,
) -> BVH:
    """Build a flattened BVH over [T, 3, 3] world-space triangle vertices."""
    tri_verts = np.asarray(tri_verts, np.float32)
    T = len(tri_verts)
    if T == 0:
        raise ValueError("cannot build a BVH over zero triangles")

    centroids = tri_verts.mean(axis=1)
    lo, hi = centroids.min(axis=0), centroids.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    codes = morton3d((centroids - lo) / extent)
    order = np.argsort(codes, kind="stable").astype(np.int64)
    keys = (codes[order] << np.uint64(32)) | np.arange(T, dtype=np.uint64)

    if T == 1:
        return _single_leaf_bvh(tri_verts, order, pad_nodes_to_pow2,
                                as_numpy=as_numpy)

    left_c, right_c, range_lo, range_hi = _karras_topology(keys)
    n_internal = T - 1
    range_size = range_hi - range_lo + 1

    # --- collapse: an internal node whose range fits in a leaf becomes one.
    # A node is a kept internal node iff its range is larger than leaf_size.
    keep_internal = range_size > leaf_size
    # the root must exist even if T <= leaf_size
    keep_internal[0] = keep_internal[0] or T > leaf_size
    if T <= leaf_size:
        return _single_leaf_bvh(tri_verts, order, pad_nodes_to_pow2, T,
                                as_numpy=as_numpy)

    # a child pointer becomes a leaf if it points at (a) a Karras leaf or
    # (b) an internal node with range_size <= leaf_size
    def resolve_child(child):
        is_karras_leaf = child < 0
        ci = np.where(is_karras_leaf, ~child, child)
        child_lo = np.where(is_karras_leaf, ci, range_lo[np.clip(ci, 0, n_internal - 1)])
        child_hi = np.where(is_karras_leaf, ci, range_hi[np.clip(ci, 0, n_internal - 1)])
        child_is_leaf = is_karras_leaf | ~keep_internal[np.clip(ci, 0, n_internal - 1)]
        return ci, child_lo, child_hi, child_is_leaf

    li, llo, lhi, lleaf = resolve_child(left_c)
    ri, rlo, rhi, rleaf = resolve_child(right_c)

    kept_ids = np.nonzero(keep_internal)[0]
    n_kept = len(kept_ids)
    new_id = np.full(n_internal, -1, np.int64)
    new_id[kept_ids] = np.arange(n_kept)

    # output node array: kept internal nodes first, then leaves
    n_leaves = int(lleaf[kept_ids].sum() + rleaf[kept_ids].sum())
    M = n_kept + n_leaves
    node_left = np.zeros(M, np.int64)
    node_count = np.zeros(M, np.int64)
    node_lo = np.zeros(M, np.int64)  # triangle range, for AABB + escape calc
    node_hi = np.zeros(M, np.int64)
    child_left = np.full(M, -1, np.int64)  # in new ids
    child_right = np.full(M, -1, np.int64)
    parent = np.full(M, -1, np.int64)

    node_lo[:n_kept] = range_lo[kept_ids]
    node_hi[:n_kept] = range_hi[kept_ids]

    # assign leaf slots
    leaf_cursor = n_kept
    # left children that are leaves
    l_is_leaf_k = lleaf[kept_ids]
    n_left_leaves = int(l_is_leaf_k.sum())
    left_leaf_slots = np.arange(leaf_cursor, leaf_cursor + n_left_leaves)
    leaf_cursor += n_left_leaves
    r_is_leaf_k = rleaf[kept_ids]
    n_right_leaves = int(r_is_leaf_k.sum())
    right_leaf_slots = np.arange(leaf_cursor, leaf_cursor + n_right_leaves)

    cl = np.where(l_is_leaf_k, -1, new_id[np.clip(li[kept_ids], 0, n_internal - 1)])
    cl[l_is_leaf_k] = left_leaf_slots
    cr = np.where(r_is_leaf_k, -1, new_id[np.clip(ri[kept_ids], 0, n_internal - 1)])
    cr[r_is_leaf_k] = right_leaf_slots
    child_left[:n_kept] = cl
    child_right[:n_kept] = cr
    parent[cl] = np.arange(n_kept)
    parent[cr] = np.arange(n_kept)

    node_lo[left_leaf_slots] = llo[kept_ids][l_is_leaf_k]
    node_hi[left_leaf_slots] = lhi[kept_ids][l_is_leaf_k]
    node_count[left_leaf_slots] = node_hi[left_leaf_slots] - node_lo[left_leaf_slots] + 1
    node_lo[right_leaf_slots] = rlo[kept_ids][r_is_leaf_k]
    node_hi[right_leaf_slots] = rhi[kept_ids][r_is_leaf_k]
    node_count[right_leaf_slots] = node_hi[right_leaf_slots] - node_lo[right_leaf_slots] + 1

    node_left[:n_kept] = child_left[:n_kept]
    node_left[n_kept:] = node_lo[n_kept:]  # leaves: triangle offset

    # --- escape links: escape(left child) = right sibling;
    # escape(right child) = escape(parent); escape(root) = SENTINEL.
    escape = np.full(M, -2, np.int64)
    escape[0] = -1
    for _ in range(70):  # depth bound: 64-bit keys
        unresolved = escape == -2
        if not unresolved.any():
            break
        p = parent
        is_left = np.zeros(M, bool)
        valid_p = p >= 0
        is_left[valid_p] = (
            child_left[np.clip(p, 0, M - 1)][valid_p] == np.arange(M)[valid_p]
        )
        cand = np.where(
            is_left,
            child_right[np.clip(p, 0, M - 1)],
            escape[np.clip(p, 0, M - 1)],
        )
        ready = valid_p & (np.where(is_left, True, cand != -2))
        escape = np.where(unresolved & ready, cand, escape)

    assert not (escape == -2).any(), "escape link propagation did not converge"

    # --- AABBs bottom-up over sorted triangle ranges.
    sorted_verts = tri_verts[order]  # [T, 3, 3]
    # prefix min/max over sorted triangle AABBs lets us compute any
    # contiguous-range AABB in O(1)... but prefix min is monotone, ranges
    # need segment trees. Ranges here are node ranges; do it directly:
    tri_min = sorted_verts.min(axis=1)  # [T, 3]
    tri_max = sorted_verts.max(axis=1)
    aabb_min = np.empty((M, 3), np.float32)
    aabb_max = np.empty((M, 3), np.float32)
    # leaves: reduce over their (small) ranges
    for k in range(1, leaf_size + 1):
        sel = node_count == k
        if not sel.any():
            continue
        base = node_lo[sel]
        mins = tri_min[base]
        maxs = tri_max[base]
        for j in range(1, k):
            mins = np.minimum(mins, tri_min[base + j])
            maxs = np.maximum(maxs, tri_max[base + j])
        aabb_min[sel] = mins
        aabb_max[sel] = maxs
    # internal: union of children, bottom-up passes
    done = node_count > 0
    for _ in range(70):
        if done.all():
            break
        can = ~done & done[np.clip(child_left, 0, M - 1)] & done[np.clip(child_right, 0, M - 1)]
        if not can.any():
            break
        aabb_min[can] = np.minimum(
            aabb_min[child_left[can]], aabb_min[child_right[can]]
        )
        aabb_max[can] = np.maximum(
            aabb_max[child_left[can]], aabb_max[child_right[can]]
        )
        done |= can
    assert done.all(), "AABB propagation did not converge"

    escape = np.where(escape == -1, SENTINEL, escape)

    if pad_nodes_to_pow2:
        Mp = _next_pow2(M)
        pad = Mp - M
        if pad:
            aabb_min = np.pad(aabb_min, ((0, pad), (0, 0)), constant_values=np.inf)
            aabb_max = np.pad(aabb_max, ((0, pad), (0, 0)), constant_values=-np.inf)
            node_left = np.pad(node_left, (0, pad))
            node_count = np.pad(node_count, (0, pad), constant_values=1)
            escape = np.pad(escape, (0, pad), constant_values=SENTINEL)
            parent = np.pad(parent, (0, pad), constant_values=-1)

    return _to_bvh(aabb_min, aabb_max, node_left, node_count, escape,
                   order, M, T, parent, as_numpy)


def _ranges_to_members(lo: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate [lo[i], lo[i]+lens[i]) index ranges without Python loops."""
    total = int(lens.sum())
    out = np.ones(total, np.int64)
    out[0] = lo[0]
    cl = np.cumsum(lens)[:-1]
    out[cl] = lo[1:] - (lo[:-1] + lens[:-1]) + 1
    return np.cumsum(out)


def _half_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Half surface area of boxes [..., 3]; 0 for empty (inverted) boxes."""
    e = hi - lo
    a = e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]
    return np.where((e >= 0).all(axis=-1), a, 0.0)


def _clip_tri_aabb(v, axis, p, left):
    """AABB of each triangle clipped to the half-space (coord <= p[k] when
    left else >= p[k]) along `axis`. v: [K, 3, 3], p: [K]. Returns
    (lo, hi) [K, 3]; inverted boxes mean the triangle misses that side."""
    K = len(v)
    d = v[:, :, axis] - p[:, None]  # [K, 3] signed vertex/plane distance
    inside = (d <= 0) if left else (d >= 0)
    # candidate points: the vertices on the kept side + the three
    # edge/plane crossings (computed unconditionally, masked by validity)
    pts = np.empty((K, 6, 3), np.float64)
    ok = np.empty((K, 6), bool)
    pts[:, 0:3] = v
    ok[:, 0:3] = inside
    for e, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
        di, dj = d[:, i], d[:, j]
        cross = (di * dj) < 0
        t = np.where(cross, di / np.where(di == dj, 1.0, di - dj), 0.0)
        pts[:, 3 + e] = v[:, i] + t[:, None] * (v[:, j] - v[:, i])
        ok[:, 3 + e] = cross
    okk = ok[:, :, None]
    lo = np.where(okk, pts, np.inf).min(axis=1)
    hi = np.where(okk, pts, -np.inf).max(axis=1)
    return lo, hi


def presplit_refs(tri_verts: np.ndarray, max_refs_factor: float = 1.35,
                  area_factor: float = 8.0, rounds: int = 16):
    """SBVH-style pre-splitting: triangles whose AABB half-area is far
    above the median are split into multiple *references* — (tri id,
    clipped sub-box) pairs — so the builder can carve tight boxes around
    large wall/floor triangles instead of leaves that span the scene.
    The traversal still intersects the FULL triangle at every reference
    (exact t/u/v; a hit found from a sibling reference's leaf is a valid
    hit), so duplicated references affect performance only, never results
    — the classic spatial-split correctness argument (Stich et al., SBVH).

    Returns (ref_tri [R] i64, ref_lo [R,3] f32, ref_hi [R,3] f32); R is
    bounded by T * max_refs_factor. Reference bar: the driver-quality AS
    builds behind /root/reference/engine/hrtsystem/Accel.zig:94-184.
    """
    tri_verts = np.asarray(tri_verts, np.float32)
    T = len(tri_verts)
    ref_tri = np.arange(T, dtype=np.int64)
    ref_lo = tri_verts.min(axis=1).astype(np.float64)
    ref_hi = tri_verts.max(axis=1).astype(np.float64)
    budget = int(T * max_refs_factor)
    for _ in range(rounds):
        free = budget - len(ref_tri)
        if free <= 0:
            break
        area = _half_area(ref_lo, ref_hi)
        thresh = max(float(np.median(area)) * area_factor, 1e-30)
        cand = np.flatnonzero(area > thresh)
        if len(cand) == 0:
            break
        if len(cand) > free:
            cand = cand[np.argsort(area[cand])[::-1][:free]]
        v = tri_verts[ref_tri[cand]].astype(np.float64)
        ext = ref_hi[cand] - ref_lo[cand]
        axis = ext.argmax(axis=1)
        p = (ref_lo[cand] + ref_hi[cand])[np.arange(len(cand)), axis] * 0.5
        # per-axis groups, vectorized clips with per-ref planes
        l_lo = np.empty_like(ref_lo[cand])
        l_hi = np.empty_like(l_lo)
        r_lo = np.empty_like(l_lo)
        r_hi = np.empty_like(l_lo)
        for a in range(3):
            g = np.flatnonzero(axis == a)
            if not len(g):
                continue
            l_lo[g], l_hi[g] = _clip_tri_aabb(v[g], a, p[g], True)
            r_lo[g], r_hi[g] = _clip_tri_aabb(v[g], a, p[g], False)
        # intersect with the parent reference box (second-generation
        # splits must stay inside their region) and cap at the plane
        sel = np.arange(len(cand))
        l_lo = np.maximum(l_lo, ref_lo[cand])
        l_hi = np.minimum(l_hi, ref_hi[cand])
        l_hi[sel, axis] = np.minimum(l_hi[sel, axis], p)
        r_lo = np.maximum(r_lo, ref_lo[cand])
        r_hi = np.minimum(r_hi, ref_hi[cand])
        r_lo[sel, axis] = np.maximum(r_lo[sel, axis], p)
        ok_l = (l_lo <= l_hi).all(axis=1)
        ok_r = (r_lo <= r_hi).all(axis=1)
        both = ok_l & ok_r
        if not both.any():
            break
        c2 = cand[both]
        # parent slot becomes the left child; right child appended
        ref_lo[c2] = l_lo[both]
        ref_hi[c2] = l_hi[both]
        ref_tri = np.concatenate([ref_tri, ref_tri[c2]])
        ref_lo = np.concatenate([ref_lo, r_lo[both]])
        ref_hi = np.concatenate([ref_hi, r_hi[both]])
    # narrow f64 -> f32 rounding OUTWARD: round-to-nearest could move a lo
    # up (or hi down) past the true clipped extent by half an ulp, and a
    # ray grazing exactly at that boundary would miss a hit the
    # non-presplit build finds (the SBVH correctness argument needs
    # conservative reference boxes). Standard SBVH practice.
    lo32 = ref_lo.astype(np.float32)
    hi32 = ref_hi.astype(np.float32)
    lo32 = np.where(lo32.astype(np.float64) > ref_lo,
                    np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32.astype(np.float64) < ref_hi,
                    np.nextafter(hi32, np.float32(np.inf)), hi32)
    return (ref_tri, lo32, hi32)


def build_sah(
    tri_verts: np.ndarray,
    leaf_size: int = 4,
    n_bins: int = 16,
    pad_nodes_to_pow2: bool = True,
    as_numpy: bool = False,
    refs=None,
) -> BVH:
    """Top-down binned-SAH BVH (same flattened layout as `build`).

    Replaces Morton/Karras splits with surface-area-heuristic splits: each
    level bins every frontier node's triangles along its dominant centroid
    axis, sweeps the bins for the min-SAH partition, and partitions the
    triangle order in place — all as segment operations vectorized across
    the whole frontier (bincount / argsort / reduceat), so a 1M-triangle
    build is a few seconds of numpy. Tree quality is the classic 1.5-3x
    traversal win over LBVH on incoherent rays; the driver hardware the
    reference delegates to (Accel.zig:94-184) builds SAH-quality trees too.

    refs: optional (ref_tri, ref_lo, ref_hi) from presplit_refs — the
    build then partitions spatial-split REFERENCES (tight clipped boxes,
    possibly several per triangle). The returned BVH's tri_order maps
    sorted positions to original triangle ids (duplicates allowed; leaf
    code intersects full triangles, so results are identical).
    """
    tri_verts = np.asarray(tri_verts, np.float32)
    if refs is not None:
        ref_tri, ref_lo, ref_hi = refs
        cent = ((ref_lo + ref_hi) * 0.5).astype(np.float64)
        tmin = ref_lo.astype(np.float64)
        tmax = ref_hi.astype(np.float64)
        T = len(ref_tri)
    else:
        T = len(tri_verts)
        if T:
            cent = tri_verts.mean(axis=1).astype(np.float64)
            tmin = tri_verts.min(axis=1).astype(np.float64)
            tmax = tri_verts.max(axis=1).astype(np.float64)
    if T == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    if T <= leaf_size:
        assert refs is None, "presplit scenes are never this small"
        return _single_leaf_bvh(tri_verts, np.arange(T, dtype=np.int64),
                                pad_nodes_to_pow2, T, as_numpy=as_numpy)

    order = np.arange(T, dtype=np.int64)

    # emitted nodes (root = 0): ranges + children; leaves resolved at the end
    node_lo = [np.asarray([0], np.int64)]
    node_len = [np.asarray([T], np.int64)]
    link_parent = []  # per level: node ids that got children
    link_left = []
    link_right = []
    n_nodes = 1

    # frontier: output node ids + their [lo, len) ranges over `order`
    f_node = np.asarray([0], np.int64)
    f_lo = np.asarray([0], np.int64)
    f_len = np.asarray([T], np.int64)
    n_levels = 0

    while len(f_node):
        n_levels += 1
        F = len(f_node)
        starts = np.concatenate([[0], np.cumsum(f_len)[:-1]])
        member = _ranges_to_members(f_lo, f_len)  # positions in `order`
        tri = order[member]
        seg = np.repeat(np.arange(F, dtype=np.int64), f_len)
        c = cent[tri]

        cb_min = np.minimum.reduceat(c, starts, axis=0)
        cb_max = np.maximum.reduceat(c, starts, axis=0)
        ext = cb_max - cb_min
        axis = ext.argmax(axis=1)  # [F]

        ax_c = c[np.arange(len(c)), axis[seg]]
        ax_lo = cb_min[seg, axis[seg]]
        ax_ext = np.maximum(ext[seg, axis[seg]], 1e-30)
        b = np.minimum(
            ((ax_c - ax_lo) / ax_ext * n_bins).astype(np.int64), n_bins - 1
        )

        # per-(seg, bin) triangle counts and AABB unions
        key = seg * n_bins + b
        cnt = np.bincount(key, minlength=F * n_bins).reshape(F, n_bins)
        ord2 = np.argsort(key, kind="stable")
        ks = key[ord2]
        gstart = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        gkey = ks[gstart]
        bmin = np.full((F * n_bins, 3), np.inf)
        bmax = np.full((F * n_bins, 3), -np.inf)
        bmin[gkey] = np.minimum.reduceat(tmin[tri][ord2], gstart, axis=0)
        bmax[gkey] = np.maximum.reduceat(tmax[tri][ord2], gstart, axis=0)
        bmin = bmin.reshape(F, n_bins, 3)
        bmax = bmax.reshape(F, n_bins, 3)

        # SAH sweep: split after bin k (left = bins <= k)
        lmin = np.minimum.accumulate(bmin, axis=1)
        lmax = np.maximum.accumulate(bmax, axis=1)
        rmin = np.minimum.accumulate(bmin[:, ::-1], axis=1)[:, ::-1]
        rmax = np.maximum.accumulate(bmax[:, ::-1], axis=1)[:, ::-1]
        lcnt = np.cumsum(cnt, axis=1)
        rcnt = f_len[:, None] - lcnt  # count of bins > k at column k
        cost = (
            _half_area(lmin, lmax)[:, :-1] * lcnt[:, :-1]
            + _half_area(rmin, rmax)[:, 1:] * rcnt[:, :-1]
        )
        cost = np.where((lcnt[:, :-1] == 0) | (rcnt[:, :-1] == 0), np.inf,
                        cost)
        best = cost.argmin(axis=1)  # [F] split-after bin
        degenerate = ~np.isfinite(cost[np.arange(F), best])
        if n_levels > 48:
            # depth guard: adversarial centroid distributions can make SAH
            # carve 1|n-1 splits indefinitely; median splits from here keep
            # the depth within the bottom-up passes' bounds
            degenerate[:] = True

        # left flag per member; degenerate segments split at the median index
        go_left = b <= best[seg]
        local = np.arange(len(member)) - starts[seg]
        go_left = np.where(degenerate[seg], local < (f_len[seg] + 1) // 2,
                           go_left)

        # stable partition of each segment: left block then right block
        part = np.argsort(seg * 2 + (~go_left).astype(np.int64),
                          kind="stable")
        order[member] = tri[part]

        n_left = np.bincount(seg, weights=go_left.astype(np.float64),
                             minlength=F).astype(np.int64)
        l_lo, l_len = f_lo, n_left
        r_lo, r_len = f_lo + n_left, f_len - n_left

        # emit children; those still above leaf_size join the next frontier
        ids_l = n_nodes + np.arange(F, dtype=np.int64)
        ids_r = n_nodes + F + np.arange(F, dtype=np.int64)
        n_nodes += 2 * F
        node_lo.extend([l_lo, r_lo])
        node_len.extend([l_len, r_len])
        link_parent.append(f_node)
        link_left.append(ids_l)
        link_right.append(ids_r)

        split_l = l_len > leaf_size
        split_r = r_len > leaf_size
        f_node = np.concatenate([ids_l[split_l], ids_r[split_r]])
        f_lo = np.concatenate([l_lo[split_l], r_lo[split_r]])
        f_len = np.concatenate([l_len[split_l], r_len[split_r]])
        if len(f_node):
            srt = np.argsort(f_lo, kind="stable")  # keep ranges sorted
            f_node, f_lo, f_len = f_node[srt], f_lo[srt], f_len[srt]

    node_lo = np.concatenate(node_lo)
    node_len = np.concatenate(node_len)
    child_left = np.full(n_nodes, -1, np.int64)
    child_right = np.full(n_nodes, -1, np.int64)
    child_left[np.concatenate(link_parent)] = np.concatenate(link_left)
    child_right[np.concatenate(link_parent)] = np.concatenate(link_right)
    if refs is not None:
        return _finalize_topdown(
            tri_verts, ref_tri[order], node_lo, node_len, child_left,
            child_right, 2 * n_levels + 6, pad_nodes_to_pow2, as_numpy,
            item_min=tmin[order].astype(np.float32),
            item_max=tmax[order].astype(np.float32),
        )
    return _finalize_topdown(
        tri_verts, order, node_lo, node_len, child_left, child_right,
        2 * n_levels + 6, pad_nodes_to_pow2, as_numpy,
    )


def _finalize_topdown(tri_verts, order, node_lo, node_len, child_left,
                      child_right, depth_bound, pad_nodes_to_pow2,
                      as_numpy=False, item_min=None, item_max=None):
    """Escape links, parent links, AABBs, and array compaction for a
    top-down tree over contiguous ranges of `order`.

    Refit requires escape(left child) == its right sibling (see refit);
    node ids here are emit-ordered, so the
    final arrays are renumbered with each left child preceding its sibling.
    """
    M0 = len(node_lo)
    is_leaf0 = child_left < 0

    parent = np.full(M0, -1, np.int64)
    valid = child_left >= 0
    parent[child_left[valid]] = np.flatnonzero(valid)
    parent[child_right[valid]] = np.flatnonzero(valid)

    escape = np.full(M0, -2, np.int64)
    escape[0] = -1
    for _ in range(depth_bound):
        unresolved = escape == -2
        if not unresolved.any():
            break
        p = np.clip(parent, 0, M0 - 1)
        is_left = child_left[p] == np.arange(M0)
        cand = np.where(is_left, child_right[p], escape[p])
        ready = (parent >= 0) & (is_left | (cand != -2))
        escape = np.where(unresolved & ready, cand, escape)
    assert not (escape == -2).any(), "escape propagation did not converge"

    # AABBs straight from ranges (every node covers order[lo:lo+len)),
    # chunked so the member scratch stays bounded. item_min/item_max
    # (already in sorted order) override per-item boxes — the spatial-split
    # path carves node boxes from clipped reference boxes, not full
    # triangles.
    if item_min is not None:
        tri_min, tri_max = item_min, item_max
    else:
        sorted_verts = tri_verts[order]
        tri_min = sorted_verts.min(axis=1)
        tri_max = sorted_verts.max(axis=1)
    aabb_min = np.empty((M0, 3), np.float32)
    aabb_max = np.empty((M0, 3), np.float32)
    for i_grp in range(0, M0, 1 << 16):
        sl = slice(i_grp, min(i_grp + (1 << 16), M0))
        los = node_lo[sl]
        lens = node_len[sl]
        mem = _ranges_to_members(los, lens)
        st = np.concatenate([[0], np.cumsum(lens)[:-1]])
        aabb_min[sl] = np.minimum.reduceat(tri_min[mem], st, axis=0)
        aabb_max[sl] = np.maximum.reduceat(tri_max[mem], st, axis=0)

    # renumber so arrays stay compact (ids already 0..M0-1, emit order)
    node_left = np.where(is_leaf0, node_lo, child_left)
    node_count = np.where(is_leaf0, node_len, 0)
    escape = np.where(escape == -1, SENTINEL, escape)

    M = M0
    if pad_nodes_to_pow2:
        Mp = _next_pow2(M)
        pad = Mp - M
        if pad:
            aabb_min = np.pad(aabb_min, ((0, pad), (0, 0)),
                              constant_values=np.inf)
            aabb_max = np.pad(aabb_max, ((0, pad), (0, 0)),
                              constant_values=-np.inf)
            node_left = np.pad(node_left, (0, pad))
            node_count = np.pad(node_count, (0, pad), constant_values=1)
            escape = np.pad(escape, (0, pad), constant_values=SENTINEL)
            parent = np.pad(parent, (0, pad), constant_values=-1)

    # num_tris is the SORTED length (spatial splits duplicate references,
    # so it can exceed the original triangle count): traversal clips
    # sorted positions against it (traverse.py), never original ids
    return _to_bvh(aabb_min, aabb_max, node_left, node_count, escape,
                   order, M, len(order), parent, as_numpy)


def _single_leaf_bvh(tri_verts, order, pad, count=None, as_numpy=False):
    """Degenerate tree: the root is the only (leaf) node."""
    T = count if count is not None else 1
    sorted_verts = tri_verts[order]
    amin = sorted_verts.min(axis=(0, 1))[None]
    amax = sorted_verts.max(axis=(0, 1))[None]
    return _to_bvh(amin, amax, np.zeros(1, np.int32),
                   np.full(1, T, np.int32), np.full(1, SENTINEL, np.int32),
                   order, 1, len(tri_verts), np.full(1, -1, np.int32),
                   as_numpy)


def refit(bvh: BVH, tri_verts: jnp.ndarray, max_leaf_size: int = 4, depth_bound: int = 70) -> BVH:
    """Recompute AABBs for new vertex positions, keeping topology.

    jnp analogue of the reference's TLAS update-mode rebuild
    (Accel.zig:567-679 recordRebuild). Runs fixed bottom-up passes (depth is
    bounded by the 64-bit build keys), so it jits to a static program.
    """
    sorted_verts = tri_verts[bvh.tri_order]
    tri_min = sorted_verts.min(axis=1)
    tri_max = sorted_verts.max(axis=1)

    M = bvh.left.shape[0]
    is_leaf = bvh.count > 0
    offs = bvh.left
    lo = jnp.where(is_leaf[:, None], jnp.full((M, 3), jnp.inf), jnp.full((M, 3), jnp.inf))
    hi = -lo
    for j in range(max_leaf_size):
        take = is_leaf & (j < bvh.count)
        idx = jnp.clip(offs + j, 0, bvh.num_tris - 1)
        lo = jnp.where(take[:, None], jnp.minimum(lo, tri_min[idx]), lo)
        hi = jnp.where(take[:, None], jnp.maximum(hi, tri_max[idx]), hi)

    # bottom-up: child boxes into parents, fixed passes
    left_child = jnp.clip(bvh.left, 0, M - 1)
    # right child = escape of left child (construction invariant)
    right_child = jnp.clip(bvh.escape[left_child], 0, M - 1)
    internal = ~is_leaf

    def body(_, lohi):
        lo, hi = lohi
        nlo = jnp.minimum(lo[left_child], lo[right_child])
        nhi = jnp.maximum(hi[left_child], hi[right_child])
        lo = jnp.where(internal[:, None], nlo, lo)
        hi = jnp.where(internal[:, None], nhi, hi)
        return lo, hi

    import jax

    lo, hi = jax.lax.fori_loop(0, depth_bound, body, (lo, hi))
    return bvh._replace(aabb_min=lo, aabb_max=hi)


def refit_host(left: np.ndarray, count: np.ndarray, escape: np.ndarray,
               tri_order: np.ndarray, tri_verts: np.ndarray,
               depth_bound: int = 70) -> tuple[np.ndarray, np.ndarray]:
    """Numpy refit: recompute node AABBs for moved vertices, topology fixed.

    Host-side twin of `refit` (the jnp version) for the interactive-edit
    path (World refit, Accel.zig:567-679 recordRebuild semantics): the whole
    rebuild stays on the host and uploads once, instead of paying a device
    round-trip per edit. Returns (aabb_min, aabb_max) as [M, 3] float32.
    """
    tri_verts = np.asarray(tri_verts, np.float32)
    sorted_verts = tri_verts[np.asarray(tri_order)]
    tri_min = sorted_verts.min(axis=1)
    tri_max = sorted_verts.max(axis=1)

    left = np.asarray(left)
    count = np.asarray(count)
    escape = np.asarray(escape)
    M = len(left)
    T = len(sorted_verts)  # sorted references (spatial splits duplicate)
    is_leaf = count > 0
    lo = np.full((M, 3), np.inf, np.float32)
    hi = np.full((M, 3), -np.inf, np.float32)
    for j in range(int(count.max(initial=0))):
        take = is_leaf & (j < count)
        idx = np.clip(left + j, 0, T - 1)
        lo[take] = np.minimum(lo[take], tri_min[idx[take]])
        hi[take] = np.maximum(hi[take], tri_max[idx[take]])

    left_child = np.clip(left, 0, M - 1)
    right_child = np.clip(escape[left_child], 0, M - 1)
    internal = ~is_leaf
    for _ in range(depth_bound):
        nlo = np.where(internal[:, None],
                       np.minimum(lo[left_child], lo[right_child]), lo)
        nhi = np.where(internal[:, None],
                       np.maximum(hi[left_child], hi[right_child]), hi)
        if np.array_equal(nlo, lo) and np.array_equal(nhi, hi):
            break
        lo, hi = nlo, nhi
    return lo, hi
