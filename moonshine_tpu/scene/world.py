"""World: host scene state -> flat device scene.

The reference aggregates MeshManager + MaterialManager + Accel into World
(engine/hrtsystem/World.zig:36-39) with GPU-side buffers addressed through
instance/geometry indirection tables (world.hlsl:49-72). This design
flattens harder: every *instance* of every triangle becomes one record in
world space, so a hit decodes with direct gathers instead of a 4-level
pointer chase (instance -> geometry -> mesh -> vertex addresses). Instanced
geometry trades memory for locality, up to a flatten cap past which the
two-level structure (accel/tlas.py) takes over.

Per-triangle corner attributes are precomputed at build:
  * positions: object->world by the instance transform
  * normals: inverse-transpose transform (missing normals fall back to the
    geometric normal, world.hlsl:158-161)
  * texcoords: the reference's default corner uvs (0,0),(1,0),(1,1) when
    absent (world.hlsl:138-143)
  * mirrored instances (negative determinant) swap corners 1/2 so the
    geometric normal computed from world positions keeps the reference's
    object-space orientation.

Incremental edit surface (set_transform / set_visibility / update_material /
set_background) mirrors the reference's live-edit paths (Accel.zig:567-679,
hydra.zig:435-513). `build()` is staged: each edit kind dirties only its
stage, and a rebuild reuses everything clean —

  * transform/visibility edits re-transform the cached object-space flatten
    and *refit* the BVH host-side (lbvh.refit_host), the TLAS-update
    analogue. Hidden instances collapse
    to zero-area point triangles instead of leaving the arrays, so every
    refit keeps identical array shapes — jitted render traces are reused
    with no recompilation (the XLA analogue of in-place GPU buffer updates).
  * material edits rebuild only the material table + texture atlas.
  * background edits rebuild only the envmap.
  * adding meshes/instances (topology) triggers the full build.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..accel import lbvh
from ..accel.intersect import device_accel
from ..accel.packed import PackedBVH
from ..core import alias_table
from ..core.gather import gather_rows
from ..lights.envmap import EnvMap, build_envmap, constant_envmap
from .textures import MaterialAtlas, MaterialBlockBuilder
from .types import (
    Geometry,
    Glass,
    Instance,
    Lambert,
    MaterialInfo,
    Mesh,
    Mirror,
    StandardPBR,
)

# material type codes (world.hlsl:31-36 enum order)
TYPE_GLASS, TYPE_LAMBERT, TYPE_MIRROR, TYPE_PBR = 0, 1, 2, 3


class MaterialTable(NamedTuple):
    """One packed row per material so a hit decodes with a single gather.
    Integer fields stored as f32 (exact below 2^24).

    Layout (constant planes put values in the row so shading skips their
    atlas fetch; see MaterialAtlas tokens):
      0 type | 5 ior always
      1-4: BSDF rect (textured bsdf plane) OR 1-3 color + 4 metalness
      6 roughness, 10-11 normal_rg (constant bsdf plane only)
      7-9 emissive values (constant emissive plane only)
      12-15: emissive-block rect (textured emissive plane only)
    """

    packed: jnp.ndarray  # [M, 16] f32


class EmitterTable(NamedTuple):
    """Alias table over world-space triangle areas of sampled geometries
    (Accel.zig:491-539).

    `rows` packs everything the NEE light path reads per drawn emitter —
    corners, uvs, emissive (constant value or atlas rect), original tri
    id — so light sampling gathers from this E-row table instead of the
    T-row tri_shade table (E is usually orders of magnitude smaller)."""

    select: jnp.ndarray  # [E] f32
    alias: jnp.ndarray  # [E] u32
    tri: jnp.ndarray  # [E] i32 original triangle ids
    # [E, 25]: 0:9 corners | 9:15 uvs | 15:18 emissive const |
    # 18:22 emissive atlas rect | 22 original tri id | 23:25 pad
    rows: jnp.ndarray
    count: jnp.ndarray  # scalar i32
    weight_sum: jnp.ndarray  # scalar f32 (total emissive area)


class DeviceScene(NamedTuple):
    bvh: lbvh.BVH
    tri_verts_sorted: jnp.ndarray  # [T,3,3] in the BVH's sorted order
    # the same tree and triangles as records for the CUDA kernel
    # (accel/packed.py); traversal goes through accel/intersect.py
    packed: PackedBVH | None
    inv_order: jnp.ndarray  # [T] i32: original tri id -> sorted slot
    # one packed row per triangle so a hit decodes with a single gather:
    # 0-8 corner positions, 9-17 corner normals (world, inverse-transpose),
    # 18-23 corner uvs, 24 material id, 25 sampled flag, 26 instance id,
    # 27 geometry id, 28 primitive id (ids f32-exact below 2^24),
    # 32-47 the triangle's MaterialTable row (folded so geometry and
    # material decode share one gather)
    tri_shade: jnp.ndarray  # [T, 48] f32
    materials: MaterialTable
    mat_atlas: MaterialAtlas
    env: EnvMap
    emitters: EmitterTable
    # two-level instancing mode (accel/tlas.py — the reference's BLAS
    # dedup, Accel.zig:313-343): set when the flatten would exceed the
    # instanced-triangle cap (or MSN_FORCE_TLAS=1). tri_shade rows then
    # hold OBJECT-space corners/normals and traversal returns
    # (object tri, instance); the decode applies inst_tf per lane.
    # inst_tf packs [I, 13]: object->world linear (9) + translation (3)
    # + det sign (1, flips the geometric normal under mirroring).
    tlas: object = None
    inst_tf: jnp.ndarray | None = None

    @property
    def num_tris(self) -> int:
        if self.bvh is None:
            return int(self.tri_shade.shape[0])
        return self.bvh.num_tris

    def corner_positions(self, tri_ids):
        """Gather [N,3,3] world corner positions for original tri ids."""
        row = gather_rows(self.tri_shade, tri_ids)
        return row[:, 0:9].reshape(*tri_ids.shape, 3, 3)


@dataclass
class _FlattenCache:
    """Everything geometry-edit-invariant about the flattened scene: the
    object-space per-triangle attributes plus the acceleration-structure
    topology (numpy, host-resident). A transform/visibility edit replays
    `_world_transform` + host refits over this instead of rebuilding."""

    obj_p: np.ndarray  # [T,3,3] object-space corner positions
    obj_n: np.ndarray  # [T,3,3] object-space corner normals (resolved)
    uvs: np.ndarray  # [T,3,2] (pre mirror-swap)
    mat_ids: np.ndarray  # [T] i32
    sampled: np.ndarray  # [T] bool
    inst_ids: np.ndarray  # [T] i32
    geo_ids: np.ndarray  # [T] i32
    prim_ids: np.ndarray  # [T] i32
    slices: list  # per instance id: (start, end) triangle range
    bvh_host: lbvh.BVH  # numpy-array BVH (topology for refit_host)
    inv_order: np.ndarray  # [T] i32
    emitter_tris: np.ndarray  # [E] i64 sampled tri ids (incl. hidden)


class World:
    """Mutable host scene; `build()` freezes it into a DeviceScene.
    Repeated `build()` calls return the cached scene, rebuilding only the
    stages whose inputs changed (see module docstring)."""

    MAX_TEXTURES = 1024  # parity cap (MaterialManager.zig:286)

    def __init__(self):
        self.meshes: list[Mesh] = []
        self.materials: list[MaterialInfo] = []
        self.instances: list[Instance] = []
        # backgrounds: an array of env maps with one active, matching the
        # reference's BackgroundManager handle array + per-render selection
        # (BackgroundManager.zig:29-142, Scene.zig:64-77). Built EnvMaps
        # are cached per handle, so switching the active background swaps
        # a prebuilt table instead of re-preprocessing.
        self._backgrounds: list = []  # (equirect | None, size) per handle
        self._active_background: Optional[int] = None
        self._env_cache: dict = {}
        self._scene: Optional[DeviceScene] = None
        self._cache: Optional[_FlattenCache] = None
        self._mat_packed_host: Optional[np.ndarray] = None
        self._emitter_host: Optional[tuple] = None
        self._builder: Optional[str] = None
        self._dirty_topology = True
        self._dirty_transforms = False
        self._dirty_materials = False
        self._dirty_env = False

    # --- creation API (parity: MeshManager/MaterialManager/Accel upload) ---

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        self._dirty_topology = True
        return len(self.meshes) - 1

    def add_material(self, info: MaterialInfo) -> int:
        self.materials.append(info)
        self._dirty_materials = True
        return len(self.materials) - 1

    def add_instance(self, instance: Instance) -> int:
        self.instances.append(instance)
        self._dirty_topology = True
        return len(self.instances) - 1

    def add_background(self, equirect_rgb: Optional[np.ndarray],
                       size: Optional[int] = None) -> int:
        """Register an environment map (BackgroundManager.addBackground);
        None = default 1x1 white. Returns a handle for use_background."""
        self._backgrounds.append((equirect_rgb, size))
        return len(self._backgrounds) - 1

    def use_background(self, handle: int):
        """Select the active background (Scene.pushDescriptors' background
        argument)."""
        if not 0 <= handle < len(self._backgrounds):
            raise IndexError(f"no background {handle}")
        if handle != self._active_background:
            self._active_background = handle
            self._dirty_env = True

    def set_background(self, equirect_rgb: Optional[np.ndarray], size: Optional[int] = None):
        """Single-slot convenience: register + select in one call."""
        self.use_background(self.add_background(equirect_rgb, size))

    # --- live-edit surface (parity: Accel.zig:567-679, hydra.zig:435-513) ---

    def set_transform(self, instance: int, transform: np.ndarray):
        self.instances[instance].transform = np.asarray(transform, np.float32)
        self._dirty_transforms = True

    def set_visibility(self, instance: int, visible: bool):
        self.instances[instance].visible = visible
        self._dirty_transforms = True

    def update_material(self, handle: int, info: MaterialInfo):
        self.materials[handle] = info
        self._dirty_materials = True

    # --- freeze ---

    def build(self, builder: str = "auto") -> DeviceScene:
        """Freeze to device arrays. builder: 'auto' (default) picks
        'karras' (Morton/LBVH) below 50k triangles and 'sah' (binned SAH)
        above — SAH's higher tree quality is worth +6-11% on the big
        incoherent scenes that are traversal-bound, while small coherent
        scenes measure a few percent better on the flatter Morton trees.
        Both refit identically.

        Returns the cached scene when nothing changed; rebuilds only dirty
        stages otherwise (transform edits refit, material/env edits swap
        just their tables)."""
        # 'auto' matches whatever it resolved to last time; an explicit
        # different builder forces a full rebuild
        if (self._builder is not None and builder != "auto"
                and builder != self._builder):
            self._dirty_topology = True
        if builder != "auto":
            self._builder = builder

        if self._scene is not None and not (
            self._dirty_topology or self._dirty_transforms
            or self._dirty_materials or self._dirty_env
        ):
            return self._scene

        if self._scene is None or self._dirty_topology:
            scene = self._full_build(builder)
            self._dirty_materials = self._dirty_env = False
            self._dirty_transforms = False
        else:
            scene = self._scene
            if self._dirty_transforms:
                scene = self._refit(scene)
                self._dirty_transforms = False
            if self._dirty_materials:
                mat_table, mat_atlas, packed_np = _build_materials(
                    self.materials, MaterialBlockBuilder()
                )
                self._mat_packed_host = packed_np
                emitters = scene.emitters
                if self._emitter_host is not None:
                    tv, tuv, tmids, etris = self._emitter_host
                    if len(etris):
                        emitters = emitters._replace(rows=jnp.asarray(
                            _emitter_rows(tv, tuv, tmids, packed_np, etris)))
                scene = scene._replace(
                    materials=mat_table,
                    mat_atlas=mat_atlas,
                    emitters=emitters,
                    tri_shade=_refold_tri_mat(scene.tri_shade,
                                              mat_table.packed),
                )
                self._dirty_materials = False
            if self._dirty_env:
                scene = scene._replace(env=self._build_env())
                self._dirty_env = False

        self._dirty_topology = False
        self._scene = scene
        return scene

    def _build_env(self) -> EnvMap:
        h = self._active_background
        if h not in self._env_cache:
            if h is None:
                self._env_cache[h] = constant_envmap((1.0, 1.0, 1.0))
            else:
                equirect, size = self._backgrounds[h]
                self._env_cache[h] = (
                    constant_envmap((1.0, 1.0, 1.0)) if equirect is None
                    else build_envmap(equirect, size)
                )
        return self._env_cache[h]

    def _full_build(self, builder: str) -> DeviceScene:
        # instancing escape hatch: the flatten materializes one world-space
        # record per instanced triangle (the memory-for-locality trade this
        # module's docstring owns), so heavily-instanced content — the
        # reference renders 4096 instances of one 100k-tri mesh with a
        # single deduplicated BLAS (Accel.zig:313-343) — would silently
        # allocate count*tris rows. Refuse crisply past a cap instead:
        # ~16M rows ≈ 2 GB tri_shade + ~1.4 GB BVH/verts, a fraction of
        # device memory but minutes of host flatten/build.
        # MSN_MAX_FLAT_TRIS overrides for hosts that can take more.
        # hidden instances still occupy (degenerate) rows so visibility
        # toggles never change array shapes — count them all
        flat_tris = sum(
            len(self.meshes[g.mesh].indices)
            for inst in self.instances
            for g in inst.geometries
        ) if self.instances else 0
        cap = int(os.environ.get("MSN_MAX_FLAT_TRIS", str(16_000_000)))
        force_tlas = os.environ.get("MSN_FORCE_TLAS", "0") == "1"
        if (flat_tris > cap or force_tlas) and self.instances:
            # past the cap the flatten's memory-for-locality trade stops
            # paying: switch to the two-level structure (shared BLAS per
            # unique geometry group + TLAS over instance AABBs) — the
            # reference's BLAS dedup (Accel.zig:313-343). Slower per ray
            # (jnp fallback traversal) but capability-complete at any
            # instance count. MSN_FORCE_TLAS=1 forces it for A/B/testing.
            if flat_tris > cap:
                warnings.warn(
                    f"scene flattens to {flat_tris:,} instanced triangles "
                    f"(cap {cap:,}): using two-level instancing (shared "
                    "BLAS + TLAS) instead of the flattened scene."
                )
            return self._build_tlas_scene()

        mat_table, mat_atlas, packed_np = _build_materials(
            self.materials, MaterialBlockBuilder()
        )
        self._mat_packed_host = packed_np

        cache = _flatten_object(self.meshes, self.instances)
        if cache is None:
            # empty scene (World.createEmpty parity): a single degenerate
            # triangle that can never be hit keeps shapes valid
            verts = np.zeros((1, 3, 3), np.float32)
            normals = np.zeros((1, 3, 3), np.float32)
            normals[:, :, 2] = 1.0
            uvs = np.zeros((1, 3, 2), np.float32)
            mat_ids = np.zeros(1, np.int32)
            sampled = np.zeros(1, bool)
            inst_ids = np.full(1, -1, np.int32)
            geo_ids = np.zeros(1, np.int32)
            prim_ids = np.zeros(1, np.int32)
        else:
            verts, normals, uvs = _world_transform(cache, self.instances)
            mat_ids, sampled = cache.mat_ids, cache.sampled
            inst_ids, geo_ids, prim_ids = (
                cache.inst_ids, cache.geo_ids, cache.prim_ids
            )
        T = len(verts)

        if builder == "auto":
            builder = "sah" if T > 50_000 else "karras"
            self._builder = builder
        if builder == "sah":
            # SBVH-style spatial splits: large triangles (interior walls,
            # floors) become several clipped references so leaf boxes stay
            # tight instead of spanning the scene. MSN_PRESPLIT=<factor>
            # sets the reference budget (<=1 disables, the default).
            presplit = float(os.environ.get("MSN_PRESPLIT", "0"))
            refs = (lbvh.presplit_refs(verts, max_refs_factor=presplit)
                    if presplit > 1.0 else None)
            bvh = lbvh.build_sah(verts, as_numpy=True, refs=refs)
        else:
            bvh = lbvh.build(verts, as_numpy=True)
        order = np.asarray(bvh.tri_order)
        # with spatial splits `order` duplicates triangle ids; inv_order
        # keeps one (arbitrary) sorted slot per triangle
        inv_order = np.empty(T, np.int64)
        inv_order[order] = np.arange(len(order))

        emitter_tris = np.nonzero(sampled)[0]
        emitters = _build_emitters(verts, emitter_tris, uvs, mat_ids,
                                   packed_np)
        # kept for material edits (re-pack emitter rows without a rebuild)
        self._emitter_host = (verts[emitter_tris], uvs[emitter_tris],
                              np.asarray(mat_ids)[emitter_tris],
                              emitter_tris)

        if cache is not None:
            cache.bvh_host = bvh
            cache.inv_order = inv_order
            cache.emitter_tris = emitter_tris
        self._cache = cache

        tri_shade = _pack_tri_shade(
            verts, normals, uvs, mat_ids, sampled, inst_ids, geo_ids,
            prim_ids, packed_np,
        )

        accel = device_accel(bvh, verts)
        return DeviceScene(
            bvh=accel.bvh,
            tri_verts_sorted=accel.tri_verts_sorted,
            packed=accel.packed,
            inv_order=jnp.asarray(inv_order, jnp.int32),
            tri_shade=jnp.asarray(tri_shade),
            materials=mat_table,
            mat_atlas=mat_atlas,
            env=self._build_env(),
            emitters=emitters,
        )

    def _refit(self, scene: DeviceScene) -> DeviceScene:
        """Transform/visibility edit: re-transform the cached object-space
        flatten and refit the BVH host-side. Every output array keeps its
        shape, so jitted render functions are reused as-is — the analogue
        of Accel.recordUpdateSingleTransform +
        recordRebuild (TLAS refit, Accel.zig:567-679)."""
        c = self._cache
        if c is None:
            return self._full_build(self._builder or "auto")
        verts, normals, uvs = _world_transform(c, self.instances)

        b = c.bvh_host
        b_min, b_max = lbvh.refit_host(
            b.left, b.count, b.escape, b.tri_order, verts
        )
        accel = device_accel(b._replace(aabb_min=b_min, aabb_max=b_max),
                             verts, topology=scene.bvh)

        tri_shade = _pack_tri_shade(
            verts, normals, uvs, c.mat_ids, c.sampled, c.inst_ids,
            c.geo_ids, c.prim_ids, self._mat_packed_host,
        )
        emitters = _build_emitters(verts, c.emitter_tris, uvs, c.mat_ids,
                                   self._mat_packed_host)
        self._emitter_host = (verts[c.emitter_tris], uvs[c.emitter_tris],
                              np.asarray(c.mat_ids)[c.emitter_tris],
                              c.emitter_tris)

        return scene._replace(
            bvh=accel.bvh,
            tri_verts_sorted=accel.tri_verts_sorted,
            packed=accel.packed,
            tri_shade=jnp.asarray(tri_shade),
            emitters=emitters,
        )

    def _build_tlas_scene(self) -> DeviceScene:
        """Two-level-instancing build (accel/tlas.py): one object-space
        BLAS per unique geometry group, a TLAS over instance AABBs, and
        object-space shade rows transformed per lane at decode time.
        Edits on this mode do a full (cheap: per-UNIQUE-mesh) rebuild —
        no refit cache is kept."""
        from ..accel import tlas as tlas_mod

        mat_table, mat_atlas, packed_np = _build_materials(
            self.materials, MaterialBlockBuilder()
        )
        self._mat_packed_host = packed_np

        t, obj, _groups = tlas_mod.build_tlas(self.meshes, self.instances)

        tri_shade = _pack_tri_shade(
            obj["positions"], obj["normals"], obj["uvs"], obj["mat_ids"],
            obj["sampled"], obj["inst_ids"], obj["geo_ids"],
            obj["prim_ids"], packed_np,
        )

        I = len(self.instances)
        inst_tf = np.zeros((max(I, 1), 13), np.float32)
        inst_tf[:, 12] = 1.0
        for i, inst in enumerate(self.instances):
            M = np.asarray(inst.transform, np.float32)
            inst_tf[i, :9] = M[:, :3].reshape(9)
            inst_tf[i, 9:12] = M[:, 3]
            inst_tf[i, 12] = 1.0 if np.linalg.det(M[:, :3]) >= 0 else -1.0

        # emitters: flatten ONLY sampled geometries of visible instances
        # (small by construction), so NEE sampling and hit-side MIS pdfs
        # match the flattened path's semantics exactly
        e_insts = [
            Instance(transform=inst.transform,
                     geometries=[g for g in inst.geometries if g.sampled])
            for inst in self.instances
            if inst.visible and any(g.sampled for g in inst.geometries)
        ]
        if e_insts:
            c = _flatten_object(self.meshes, e_insts)
            ev, _en, eu = _world_transform(c, e_insts)
            emitter_tris = np.nonzero(c.sampled)[0]
            emitters = _build_emitters(ev, emitter_tris, eu, c.mat_ids,
                                       packed_np)
            self._emitter_host = (ev[emitter_tris], eu[emitter_tris],
                                  np.asarray(c.mat_ids)[emitter_tris],
                                  emitter_tris)
        else:
            empty = np.zeros(0, np.int64)
            emitters = _build_emitters(
                np.zeros((1, 3, 3), np.float32), empty,
                np.zeros((1, 3, 2), np.float32), np.zeros(1, np.int32),
                packed_np,
            )
            self._emitter_host = None

        self._cache = None  # edits trigger a full (cheap) rebuild
        return DeviceScene(
            bvh=None,
            tri_verts_sorted=None,
            packed=None,
            inv_order=None,
            tri_shade=jnp.asarray(tri_shade),
            materials=mat_table,
            mat_atlas=mat_atlas,
            env=self._build_env(),
            emitters=emitters,
            tlas=t,
            inst_tf=jnp.asarray(inst_tf),
        )


def _pack_tri_shade(verts, normals, uvs, mat_ids, sampled, inst_ids,
                    geo_ids, prim_ids, mat_packed) -> np.ndarray:
    T = len(verts)
    tri_shade = np.zeros((T, 48), np.float32)
    tri_shade[:, 0:9] = verts.reshape(T, 9)
    tri_shade[:, 9:18] = normals.reshape(T, 9)
    tri_shade[:, 18:24] = uvs.reshape(T, 6)
    tri_shade[:, 24] = mat_ids
    tri_shade[:, 25] = sampled
    tri_shade[:, 26] = inst_ids
    tri_shade[:, 27] = geo_ids
    tri_shade[:, 28] = prim_ids
    # 32:48 — the triangle's material row, folded in so a hit decodes
    # geometry AND material with ONE gather
    tri_shade[:, 32:48] = mat_packed[
        np.clip(mat_ids, 0, len(mat_packed) - 1)
    ]
    return tri_shade


@jax.jit
def _refold_tri_mat(tri_shade, packed):
    """Material-edit refold: rewrite the folded material columns from the
    new packed table in one jitted device dispatch."""
    ids = jnp.clip(tri_shade[:, 24].astype(jnp.int32), 0,
                   packed.shape[0] - 1)
    return tri_shade.at[:, 32:48].set(packed[ids])


def _build_materials(materials, builder: MaterialBlockBuilder) -> MaterialTable:
    n = max(len(materials), 1)
    type_ = np.zeros(n, np.int32)
    ior = np.full(n, 1.5, np.float32)

    default_normal = (0.5, 0.5)  # decodes to (0,0,1) tangent normal
    white3 = (1.0, 1.0, 1.0)
    black3 = (0.0, 0.0, 0.0)

    if not materials:
        builder.add(white3, 0.0, 1.0, black3, default_normal)

    for i, m in enumerate(materials):
        normal = default_normal if m.normal is None else m.normal
        emissive = m.emissive
        v = m.variant
        if isinstance(v, StandardPBR):
            type_[i] = TYPE_PBR
            builder.add(v.color, v.metalness, v.roughness, emissive, normal)
            ior[i] = v.ior
        elif isinstance(v, Lambert):
            type_[i] = TYPE_LAMBERT
            builder.add(v.color, 0.0, 1.0, emissive, normal)
        elif isinstance(v, Glass):
            type_[i] = TYPE_GLASS
            ior[i] = v.ior
            builder.add(white3, 0.0, 1.0, emissive, normal)
        elif isinstance(v, Mirror):
            type_[i] = TYPE_MIRROR
            builder.add(white3, 0.0, 1.0, emissive, normal)
        else:
            raise TypeError(f"unknown material variant {v!r}")

    atlas, rects, constants = builder.build()
    packed = np.zeros((n, 16), np.float32)
    packed[:, 0] = type_
    packed[:, 5] = ior
    if atlas.bsdf_constant:
        packed[:, 1:4] = constants[:, 0:3]  # color
        packed[:, 4] = constants[:, 3]  # metalness
        packed[:, 6] = constants[:, 4]  # roughness
        packed[:, 10:12] = constants[:, 8:10]  # normal rg
    else:
        packed[:, 1:5] = rects[:, 0]  # BSDF block rect
    if atlas.emissive_constant:
        packed[:, 7:10] = constants[:, 5:8]  # emissive
    else:
        packed[:, 12:16] = rects[:, 1]  # emissive block rect
    return MaterialTable(packed=jnp.asarray(packed)), atlas, packed


def _flatten_object(meshes, instances) -> Optional[_FlattenCache]:
    """Object-space flatten of ALL instances (visible or not — hidden ones
    stay in the arrays so visibility toggles are shape-preserving refits).
    Returns None for a scene with no triangles."""
    obj_p, obj_n, uvs = [], [], []
    mat_ids, sampled, inst_ids, geo_ids, prim_ids = [], [], [], [], []
    slices = []
    t = 0

    for inst_id, inst in enumerate(instances):
        start = t
        for geo_id, geo in enumerate(inst.geometries):
            mesh = meshes[geo.mesh]
            idx = np.asarray(mesh.indices, np.int64).reshape(-1, 3)
            F = len(idx)
            pos = np.asarray(mesh.positions, np.float32)
            p = pos[idx]  # [F,3,3] object space

            if mesh.indexed_attributes:
                attr_idx = idx
            else:
                attr_idx = np.arange(F * 3, dtype=np.int64).reshape(F, 3)

            if mesh.normals is not None:
                nrm = np.asarray(mesh.normals, np.float32)[attr_idx]
            else:
                gn = np.cross(p[:, 0] - p[:, 2], p[:, 1] - p[:, 2])
                gl = np.linalg.norm(gn, axis=-1, keepdims=True)
                gn = gn / np.maximum(gl, 1e-20)
                nrm = np.repeat(gn[:, None, :], 3, axis=1)

            if mesh.texcoords is not None:
                uv = np.asarray(mesh.texcoords, np.float32)[attr_idx]
            else:
                uv = np.broadcast_to(
                    np.asarray([[0, 0], [1, 0], [1, 1]], np.float32), (F, 3, 2)
                ).copy()

            obj_p.append(p)
            obj_n.append(nrm)
            uvs.append(uv)
            mat_ids.append(np.full(F, geo.material, np.int32))
            sampled.append(np.full(F, geo.sampled, bool))
            inst_ids.append(np.full(F, inst_id, np.int32))
            geo_ids.append(np.full(F, geo_id, np.int32))
            prim_ids.append(np.arange(F, dtype=np.int32))
            t += F
        slices.append((start, t))

    if t == 0:
        return None
    cat = lambda xs: np.concatenate(xs, axis=0)
    return _FlattenCache(
        obj_p=cat(obj_p).astype(np.float32),
        obj_n=cat(obj_n).astype(np.float32),
        uvs=cat(uvs).astype(np.float32),
        mat_ids=cat(mat_ids),
        sampled=cat(sampled),
        inst_ids=cat(inst_ids),
        geo_ids=cat(geo_ids),
        prim_ids=cat(prim_ids),
        slices=slices,
        bvh_host=None,  # filled by _full_build
        inv_order=None,
        emitter_tris=None,
    )


def _world_transform(cache: _FlattenCache, instances):
    """Apply per-instance transforms to the cached object-space flatten.
    Hidden instances collapse to their translation point (zero-area tris
    Moller-Trumbore can never hit), keeping shapes refit-stable."""
    T = len(cache.obj_p)
    verts = np.empty((T, 3, 3), np.float32)
    normals = np.empty((T, 3, 3), np.float32)
    uvs = cache.uvs.copy()

    for inst_id, inst in enumerate(instances):
        s, e = cache.slices[inst_id]
        if s == e:
            continue
        M = np.asarray(inst.transform, np.float32)
        lin = M[:, :3]
        trans = M[:, 3]
        if not inst.visible:
            verts[s:e] = trans
            normals[s:e] = np.float32([0, 0, 1])
            continue
        det = float(np.linalg.det(lin))
        nrm_m = np.linalg.inv(lin).T if abs(det) > 1e-20 else lin
        pw = cache.obj_p[s:e] @ lin.T + trans
        nw = cache.obj_n[s:e] @ nrm_m.T
        nw = nw / np.maximum(
            np.linalg.norm(nw, axis=-1, keepdims=True), 1e-20
        )
        if det < 0.0:
            pw = pw[:, [0, 2, 1]]
            nw = nw[:, [0, 2, 1]]
            uvs[s:e] = uvs[s:e][:, [0, 2, 1]]
        verts[s:e] = pw
        normals[s:e] = nw
    return verts, normals, uvs


def _emitter_rows(tv, tuv, tmids, mat_packed, emitter_tris) -> np.ndarray:
    """Pack the per-emitter light rows (EmitterTable.rows layout)."""
    E = len(emitter_tris)
    rows = np.zeros((E, 25), np.float32)
    rows[:, 0:9] = tv.reshape(E, 9)
    rows[:, 9:15] = tuv.reshape(E, 6)
    mrow = mat_packed[np.clip(tmids, 0, len(mat_packed) - 1)]
    rows[:, 15:18] = mrow[:, 7:10]  # constant-plane emissive value
    rows[:, 18:22] = mrow[:, 12:16]  # textured emissive block rect
    rows[:, 22] = emitter_tris
    return rows


def _build_emitters(verts, emitter_tris, uvs, mat_ids,
                    mat_packed) -> EmitterTable:
    """Alias table over world-space areas of the (fixed) sampled-tri set.
    Hidden emitters have zero area and zero selection weight; when every
    emitter is hidden, count drops to 0 so NEE skips mesh lights — the
    table's SHAPE never changes across refits."""
    if len(emitter_tris) == 0:
        return EmitterTable(
            select=jnp.ones(1, jnp.float32),
            alias=jnp.zeros(1, jnp.uint32),
            tri=jnp.zeros(1, jnp.int32),
            rows=jnp.zeros((1, 25), jnp.float32),
            count=jnp.asarray(0, jnp.int32),
            weight_sum=jnp.asarray(0.0, jnp.float32),
        )
    tv = verts[emitter_tris]
    areas = 0.5 * np.linalg.norm(
        np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=-1
    )
    table = alias_table.build(areas)
    count = int(table.count) if float(table.weight_sum) > 0.0 else 0
    rows = _emitter_rows(tv, uvs[emitter_tris], mat_ids[emitter_tris],
                         mat_packed, emitter_tris)
    return EmitterTable(
        select=table.select,
        alias=table.alias,
        tri=jnp.asarray(emitter_tris, jnp.int32),
        rows=jnp.asarray(rows),
        count=jnp.asarray(count, jnp.int32),
        weight_sum=jnp.asarray(table.weight_sum, jnp.float32),
    )
