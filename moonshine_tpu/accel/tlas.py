"""Two-level acceleration structure (TLAS over instance AABBs + shared
per-geometry BLASes) — the reference's BLAS dedup, where 4096 instances of
one mesh share a single acceleration structure
(engine/hrtsystem/Accel.zig:313-343), rebuilt for batched lanes.

The flatten path (scene/world.py) trades memory for locality by expanding
every instance to world-space rows; past the flatten cap that trade stops
making sense (a 1k-instance x 50k-tri scene would materialize 50M rows).
This module keeps ONE object-space BLAS per unique geometry group and a
top-level BVH over per-instance world AABBs. Traversal is a single
lockstep `lax.while_loop` state machine per ray batch:

  * lanes outside any BLAS step the TLAS (stackless skip links); hitting
    an instance leaf transforms the ray into object space (direction NOT
    renormalized, so object-space t == world-space t) and jumps to the
    instance's BLAS root,
  * lanes inside a BLAS step it exactly like accel/traverse.py; walking
    off the BLAS (escape -1) resumes the TLAS at the saved skip link
    (folded into the TLAS cursor at entry, so no extra state).

Both arms run every iteration with lane masks — the batched shape of
"divergent" two-level traversal (no per-lane recursion, static shapes,
one while_loop). Hits return the OBJECT triangle id plus the instance id;
shading gathers object-space rows and applies the instance transform per
lane (integrator/path._decode_hit).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.mathutil import mat_vec
from . import lbvh
from .traverse import Hit, _aabb_hit, _safe_inv, _tri_intersect

BLAS_LEAF = 4  # triangle bundle per BLAS leaf (matches traverse.py)


class TLAS(NamedTuple):
    """Device arrays for two-level traversal. BLAS node/tri arrays are the
    per-unique-geometry trees concatenated, child/escape links rewritten to
    absolute indices (-1 keeps meaning "exit this BLAS")."""

    # top level, one leaf per instance
    top_min: jnp.ndarray  # [Mt, 3]
    top_max: jnp.ndarray  # [Mt, 3]
    top_left: jnp.ndarray  # [Mt] i32
    top_count: jnp.ndarray  # [Mt] i32 (0 internal, 1 leaf)
    top_escape: jnp.ndarray  # [Mt] i32 (-1 = done)
    top_inst: jnp.ndarray  # [I] i32: leaf order -> instance id
    # concatenated BLASes
    blas_min: jnp.ndarray  # [Mb, 3]
    blas_max: jnp.ndarray  # [Mb, 3]
    blas_left: jnp.ndarray  # [Mb] i32 (abs node idx / abs tri offset)
    blas_count: jnp.ndarray  # [Mb] i32
    blas_escape: jnp.ndarray  # [Mb] i32 (-1 = exit BLAS)
    blas_tris: jnp.ndarray  # [Ts, 3, 3] object-space sorted verts
    blas_tri_id: jnp.ndarray  # [Ts] i32 -> global object-tri id
    # per instance
    inst_root: jnp.ndarray  # [I] i32 BLAS root (absolute)
    inst_inv: jnp.ndarray  # [I, 12] f32 world->object (3x4 row-major)
    num_instances: int
    num_obj_tris: int


def _np(a):
    return np.asarray(a)


def build_tlas(meshes, instances) -> tuple[TLAS, "np.ndarray", dict]:
    """Host build. Returns (tlas, obj_info, groups) where obj_info is a
    dict of global object-space per-triangle arrays (positions, normals,
    uvs, mat/sampled/inst(-1)/geo/prim columns) for shade-row packing, and
    groups maps geometry-group key -> (tri_base, tri_count) for reuse.

    A "geometry group" is the tuple of (mesh, material, sampled) of an
    instance's geometry list: instances with identical groups share one
    BLAS (the reference keys BLAS dedup on geometry content,
    Accel.zig:313-343). Hidden instances keep their TLAS slot with an
    empty (inverted) AABB so visibility toggles stay shape-preserving.
    """
    from ..scene.world import _flatten_object  # object-space attr logic

    # --- unique geometry groups -> object-space flatten of ONE copy each
    keys = []
    key_of_inst = []
    for inst in instances:
        k = tuple((g.mesh, g.material, g.sampled) for g in inst.geometries)
        key_of_inst.append(k)
        if k not in keys:
            keys.append(k)

    class _G:  # minimal Instance stand-in for _flatten_object
        def __init__(self, geometries):
            self.geometries = geometries
            self.visible = True

    class _Geo:
        def __init__(self, mesh, material, sampled):
            self.mesh = mesh
            self.material = material
            self.sampled = sampled

    proto = [_G([_Geo(*g) for g in k]) for k in keys]
    cache = _flatten_object(meshes, proto)
    if cache is None:
        raise ValueError("cannot build a TLAS over an empty scene")

    groups = {}
    for gi, k in enumerate(keys):
        s, e = cache.slices[gi]
        groups[k] = (s, e - s)

    obj_info = dict(
        positions=cache.obj_p,
        normals=cache.obj_n,
        uvs=cache.uvs,
        mat_ids=cache.mat_ids,
        sampled=cache.sampled,
        # instance id is per-hit in TLAS mode, not per-row
        inst_ids=np.full(len(cache.obj_p), -1, np.int32),
        geo_ids=cache.geo_ids,
        prim_ids=cache.prim_ids,
    )

    # --- one BLAS per group, concatenated with absolute links
    b_min, b_max, b_left, b_count, b_escape = [], [], [], [], []
    b_tris, b_tid = [], []
    group_root = {}
    group_box = {}
    node_off = 0
    tri_off = 0
    for k in keys:
        s, cnt = groups[k]
        verts = cache.obj_p[s:s + cnt]
        bvh = lbvh.build(verts, leaf_size=BLAS_LEAF, as_numpy=True)
        M = len(_np(bvh.aabb_min))
        left = _np(bvh.left).astype(np.int64).copy()
        count = _np(bvh.count).astype(np.int32)
        esc = _np(bvh.escape).astype(np.int64).copy()
        is_leaf = count > 0
        left[is_leaf] += tri_off  # abs sorted-tri offset
        left[~is_leaf] += node_off  # abs node index
        esc[esc >= 0] += node_off
        order = _np(bvh.tri_order).astype(np.int64)
        b_min.append(_np(bvh.aabb_min))
        b_max.append(_np(bvh.aabb_max))
        b_left.append(left.astype(np.int32))
        b_count.append(count)
        b_escape.append(esc.astype(np.int32))
        b_tris.append(verts[order])
        b_tid.append((order + s).astype(np.int32))
        group_root[k] = node_off
        group_box[k] = (_np(bvh.aabb_min)[0].copy(),
                        _np(bvh.aabb_max)[0].copy())
        node_off += M
        tri_off += cnt

    # --- per-instance world AABBs + inverse transforms
    I = len(instances)
    inst_root = np.empty(I, np.int32)
    inst_inv = np.empty((I, 12), np.float32)
    box_lo = np.empty((I, 3), np.float32)
    box_hi = np.empty((I, 3), np.float32)
    for i, inst in enumerate(instances):
        k = key_of_inst[i]
        inst_root[i] = group_root[k]
        M = np.asarray(inst.transform, np.float32)
        lin, trans = M[:, :3], M[:, 3]
        inv_lin = np.linalg.inv(
            lin if abs(np.linalg.det(lin)) > 1e-20
            else lin + np.eye(3, dtype=np.float32) * 1e-6
        ).astype(np.float32)
        inst_inv[i, :9] = inv_lin.reshape(9)
        inst_inv[i, 9:12] = -inv_lin @ trans
        lo, hi = group_box[k]
        corners = np.stack(np.meshgrid(*zip(lo, hi), indexing="ij"),
                           axis=-1).reshape(8, 3)
        wc = corners @ lin.T + trans
        box_lo[i], box_hi[i] = wc.min(0), wc.max(0)
        if not inst.visible:
            # hidden: keep the TLAS slot (shape-stable) but make entry
            # impossible — the traversal treats a -1 root as "no BLAS"
            inst_root[i] = -1
            # collapse the box to the instance origin so it costs ~nothing
            box_lo[i] = box_hi[i] = trans

    # --- top-level BVH over instance boxes: reuse the triangle builder by
    # encoding each box as the degenerate triangle (lo, hi, lo) — its AABB
    # is the instance box and its centroid the box center. leaf_size=1
    # guarantees one instance per leaf (instance entry needs no slot loop).
    fake = np.stack([box_lo, box_hi, box_lo], axis=1)
    top = lbvh.build(fake, leaf_size=1, as_numpy=True)
    order = _np(top.tri_order).astype(np.int64)

    return TLAS(
        top_min=jnp.asarray(_np(top.aabb_min)),
        top_max=jnp.asarray(_np(top.aabb_max)),
        top_left=jnp.asarray(_np(top.left), jnp.int32),
        top_count=jnp.asarray(_np(top.count), jnp.int32),
        top_escape=jnp.asarray(_np(top.escape), jnp.int32),
        top_inst=jnp.asarray(order, jnp.int32),
        blas_min=jnp.asarray(np.concatenate(b_min)),
        blas_max=jnp.asarray(np.concatenate(b_max)),
        blas_left=jnp.asarray(np.concatenate(b_left)),
        blas_count=jnp.asarray(np.concatenate(b_count)),
        blas_escape=jnp.asarray(np.concatenate(b_escape)),
        blas_tris=jnp.asarray(np.concatenate(b_tris)),
        blas_tri_id=jnp.asarray(np.concatenate(b_tid)),
        inst_root=jnp.asarray(inst_root),
        inst_inv=jnp.asarray(inst_inv),
        num_instances=I,
        num_obj_tris=tri_off,
    ), obj_info, groups


def _obj_ray(tlas, inst, ray_o, ray_d):
    inv = tlas.inst_inv[jnp.clip(inst, 0, tlas.num_instances - 1)]
    R = inv[:, :9].reshape(-1, 3, 3)
    oo = mat_vec(R, ray_o) + inv[:, 9:12]
    dd = mat_vec(R, ray_d)
    return oo, dd


def closest_hit_tlas(tlas: TLAS, ray_o, ray_d, t_max,
                     active_in=None) -> Hit:
    """Closest hit through the two-level structure. Returns Hit with
    `tri` = global OBJECT triangle id and `inst` = instance id (-1 miss)."""
    N = ray_o.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (N,))
    inv_dw = _safe_inv(ray_d)
    Mt = tlas.top_left.shape[0]
    Mb = tlas.blas_left.shape[0]
    Ts = tlas.blas_tris.shape[0]

    tcur0 = jnp.zeros(N, jnp.int32)
    if active_in is not None:
        tcur0 = jnp.where(active_in, tcur0, -1)

    def cond(st):
        tcur, bcur = st[0], st[1]
        return jnp.any((tcur >= 0) | (bcur >= 0))

    def body(st):
        (tcur, bcur, inst, oo, dd, inv_do,
         t_best, tri, u, v, hinst) = st
        in_b = bcur >= 0

        # ---- TLAS arm
        tn = jnp.clip(tcur, 0, Mt - 1)
        t_act = ~in_b & (tcur >= 0)
        box = t_act & _aabb_hit(
            tlas.top_min[tn], tlas.top_max[tn], ray_o, inv_dw, t_best
        )
        is_leaf = tlas.top_count[tn] > 0
        enter = box & is_leaf
        descend = box & ~is_leaf
        left_t = tlas.top_left[tn]
        new_tcur = jnp.where(
            t_act,
            jnp.where(descend, left_t, tlas.top_escape[tn]),
            tcur,
        )
        inst_new = tlas.top_inst[jnp.clip(left_t, 0,
                                          tlas.num_instances - 1)]
        inst = jnp.where(enter, inst_new, inst)
        oo_n, dd_n = _obj_ray(tlas, inst, ray_o, ray_d)
        oo = jnp.where(enter[:, None], oo_n, oo)
        dd = jnp.where(enter[:, None], dd_n, dd)
        inv_do = jnp.where(enter[:, None], _safe_inv(dd_n), inv_do)
        bcur = jnp.where(
            enter,
            tlas.inst_root[jnp.clip(inst, 0, tlas.num_instances - 1)],
            bcur,
        )
        tcur = new_tcur

        # ---- BLAS arm (object-space ray; t is world t — d unnormalized)
        bn = jnp.clip(bcur, 0, Mb - 1)
        bbox = in_b & _aabb_hit(
            tlas.blas_min[bn], tlas.blas_max[bn], oo, inv_do, t_best
        )
        left_b = tlas.blas_left[bn]
        cnt = tlas.blas_count[bn]
        leaf_b = cnt > 0
        leaf_do = bbox & leaf_b
        for j in range(BLAS_LEAF):
            lane = leaf_do & (j < cnt)
            s = jnp.clip(left_b + j, 0, Ts - 1)
            tv = tlas.blas_tris[s]
            h, t, uu, vv = _tri_intersect(
                tv[:, 0], tv[:, 1], tv[:, 2], oo, dd, 0.0, t_best
            )
            take = lane & h
            t_best = jnp.where(take, t, t_best)
            tri = jnp.where(take, tlas.blas_tri_id[s], tri)
            u = jnp.where(take, uu, u)
            v = jnp.where(take, vv, v)
            hinst = jnp.where(take, inst, hinst)
        nxt = jnp.where(bbox & ~leaf_b, left_b, tlas.blas_escape[bn])
        bcur = jnp.where(in_b, nxt, bcur)

        return (tcur, bcur, inst, oo, dd, inv_do,
                t_best, tri, u, v, hinst)

    z3 = jnp.zeros((N, 3), jnp.float32)
    init = (
        tcur0,
        jnp.full(N, -1, jnp.int32),
        jnp.zeros(N, jnp.int32),
        z3, z3, z3,
        t_max,
        jnp.full(N, -1, jnp.int32),
        jnp.zeros(N, jnp.float32),
        jnp.zeros(N, jnp.float32),
        jnp.full(N, -1, jnp.int32),
    )
    out = jax.lax.while_loop(cond, body, init)
    return Hit(t=out[6], tri=out[7], u=out[8], v=out[9], inst=out[10])


def any_hit_tlas(tlas: TLAS, ray_o, ray_d, t_max,
                 active_in=None) -> jnp.ndarray:
    """True where any occluder lies in (0, t_max); lanes stop at first
    hit (ShadowIntersection::hit semantics)."""
    N = ray_o.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (N,))
    inv_dw = _safe_inv(ray_d)
    Mt = tlas.top_left.shape[0]
    Mb = tlas.blas_left.shape[0]
    Ts = tlas.blas_tris.shape[0]

    tcur0 = jnp.zeros(N, jnp.int32)
    if active_in is not None:
        tcur0 = jnp.where(active_in, tcur0, -1)

    def cond(st):
        tcur, bcur = st[0], st[1]
        return jnp.any((tcur >= 0) | (bcur >= 0))

    def body(st):
        tcur, bcur, inst, oo, dd, inv_do, occ = st
        in_b = bcur >= 0

        tn = jnp.clip(tcur, 0, Mt - 1)
        t_act = ~in_b & (tcur >= 0)
        box = t_act & _aabb_hit(
            tlas.top_min[tn], tlas.top_max[tn], ray_o, inv_dw, t_max
        )
        is_leaf = tlas.top_count[tn] > 0
        enter = box & is_leaf
        descend = box & ~is_leaf
        left_t = tlas.top_left[tn]
        new_tcur = jnp.where(
            t_act,
            jnp.where(descend, left_t, tlas.top_escape[tn]),
            tcur,
        )
        inst_new = tlas.top_inst[jnp.clip(left_t, 0,
                                          tlas.num_instances - 1)]
        inst = jnp.where(enter, inst_new, inst)
        oo_n, dd_n = _obj_ray(tlas, inst, ray_o, ray_d)
        oo = jnp.where(enter[:, None], oo_n, oo)
        dd = jnp.where(enter[:, None], dd_n, dd)
        inv_do = jnp.where(enter[:, None], _safe_inv(dd_n), inv_do)
        bcur = jnp.where(
            enter,
            tlas.inst_root[jnp.clip(inst, 0, tlas.num_instances - 1)],
            bcur,
        )
        tcur = new_tcur

        bn = jnp.clip(bcur, 0, Mb - 1)
        bbox = in_b & _aabb_hit(
            tlas.blas_min[bn], tlas.blas_max[bn], oo, inv_do, t_max
        )
        left_b = tlas.blas_left[bn]
        cnt = tlas.blas_count[bn]
        leaf_b = cnt > 0
        leaf_do = bbox & leaf_b
        found = jnp.zeros(N, bool)
        for j in range(BLAS_LEAF):
            lane = leaf_do & (j < cnt)
            s = jnp.clip(left_b + j, 0, Ts - 1)
            tv = tlas.blas_tris[s]
            h, _, _, _ = _tri_intersect(
                tv[:, 0], tv[:, 1], tv[:, 2], oo, dd, 0.0, t_max
            )
            found = found | (lane & h)
        occ = occ | found
        nxt = jnp.where(bbox & ~leaf_b, left_b, tlas.blas_escape[bn])
        bcur = jnp.where(in_b, nxt, bcur)
        # first hit terminates the lane entirely
        tcur = jnp.where(found, -1, tcur)
        bcur = jnp.where(found, -1, bcur)

        return tcur, bcur, inst, oo, dd, inv_do, occ

    z3 = jnp.zeros((N, 3), jnp.float32)
    init = (
        tcur0,
        jnp.full(N, -1, jnp.int32),
        jnp.zeros(N, jnp.int32),
        z3, z3, z3,
        jnp.zeros(N, bool),
    )
    out = jax.lax.while_loop(cond, body, init)
    return out[6]
