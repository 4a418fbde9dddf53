"""Staged World.build: transform/visibility edits refit instead of
rebuilding topology; material/background edits swap only their stage.

Parity surface: Accel.zig:567-679 (recordUpdateSingleTransform,
updateVisibility, recordRebuild = TLAS refit) and hydra.zig:225-311 (the
per-frame instance-update path). The twist under test: every edit kind
keeps array shapes identical, so jitted render functions never recompile.
"""

import numpy as np
import pytest

import jax

from moonshine_tpu.accel.packed import closest_hit_np
from moonshine_tpu.accel.traverse import closest_hit
from moonshine_tpu.core.mathutil import INF_T
from moonshine_tpu.scene.types import (
    Geometry, Instance, Lambert, MaterialInfo, translate,
)
from moonshine_tpu.scene.world import World

from fixtures import icosphere


def two_sphere_world():
    w = World()
    sphere = w.add_mesh(icosphere(2, with_normals=False))
    mat = w.add_material(MaterialInfo(variant=Lambert(color=(1, 1, 1))))
    a = w.add_instance(Instance(transform=translate(-2, 0, 0),
                                geometries=[Geometry(sphere, mat)]))
    b = w.add_instance(Instance(transform=translate(2, 0, 0),
                                geometries=[Geometry(sphere, mat)]))
    w.set_background(None)
    return w, a, b


def hit_tris(scene, origins):
    """Closest-hit tri ids for downward rays from the given origins."""
    o = np.asarray(origins, np.float32)
    d = np.tile(np.float32([0, 0, -1]), (len(o), 1))
    hit = closest_hit(scene.bvh, scene.tri_verts_sorted, o, d, INF_T)
    return np.asarray(hit.tri), np.asarray(hit.t)


class TestIncrementalBuild:
    def test_clean_build_returns_cached_scene(self):
        w, _, _ = two_sphere_world()
        s1 = w.build()
        s2 = w.build()
        assert s2 is s1

    def test_transform_edit_refits_without_topology_rebuild(self):
        w, a, b = two_sphere_world()
        s1 = w.build()
        w.set_transform(b, translate(2, 0, 5))
        s2 = w.build()
        # topology + untouched stages are reused by object identity
        assert s2.bvh.tri_order is s1.bvh.tri_order
        assert s2.env is s1.env
        assert s2.materials.packed is s1.materials.packed
        assert s2.mat_atlas is s1.mat_atlas
        # shapes identical (no re-jit), geometry moved
        assert s2.packed.nodes.shape == s1.packed.nodes.shape
        assert s2.tri_shade.shape == s1.tri_shade.shape
        assert not np.array_equal(np.asarray(s2.packed.nodes),
                                  np.asarray(s1.packed.nodes))

    def test_refit_matches_full_rebuild_hits(self):
        w, a, b = two_sphere_world()
        w.build()
        w.set_transform(b, translate(2, 1, 0))
        refit_scene = w.build()

        fresh, _, _ = two_sphere_world()
        fresh.set_transform(1, translate(2, 1, 0))
        full_scene = fresh.build()

        origins = [(-2, 0, 5), (2, 1, 5), (2, 0, 5), (0, 0, 5)]
        tri_r, t_r = hit_tris(refit_scene, origins)
        tri_f, t_f = hit_tris(full_scene, origins)
        # same surfaces hit at the same distances (tri ids are order-
        # dependent between builds; distances are not)
        np.testing.assert_allclose(t_r, t_f, rtol=1e-5)
        assert (tri_r >= 0).tolist() == (tri_f >= 0).tolist()

    def test_visibility_toggle_is_shape_stable_refit(self):
        w, a, b = two_sphere_world()
        s1 = w.build()
        tri, t = hit_tris(s1, [(2, 0, 5)])
        assert tri[0] >= 0

        w.set_visibility(b, False)
        s2 = w.build()
        assert s2.tri_shade.shape == s1.tri_shade.shape
        assert s2.bvh.tri_order is s1.bvh.tri_order
        tri, t = hit_tris(s2, [(2, 0, 5)])
        assert tri[0] < 0  # hidden sphere no longer hit

        w.set_visibility(b, True)
        s3 = w.build()
        tri, t = hit_tris(s3, [(2, 0, 5)])
        assert tri[0] >= 0  # back again, geometry restored exactly

    def test_packet_kernel_agrees_after_refit(self):
        w, a, b = two_sphere_world()
        w.build()
        w.set_transform(b, translate(2, 0, 3))
        scene = w.build()
        o = np.float32([[-2, 0, 5], [2, 0, 5], [0, 0, 5]])
        d = np.tile(np.float32([0, 0, -1]), (3, 1))
        ref = closest_hit(scene.bvh, scene.tri_verts_sorted, o, d, INF_T)
        # the CUDA kernel's records after the refit, walked by its twin
        pk_t, pk_tri, _, _ = closest_hit_np(
            jax.device_get(scene.packed), np.asarray(scene.bvh.tri_order),
            o, d, INF_T)
        np.testing.assert_allclose(pk_t, np.asarray(ref.t), rtol=1e-5)
        np.testing.assert_array_equal(pk_tri, np.asarray(ref.tri))

    def test_material_edit_rebuilds_only_materials(self):
        w, a, b = two_sphere_world()
        s1 = w.build()
        w.update_material(0, MaterialInfo(variant=Lambert(color=(1, 0, 0))))
        s2 = w.build()
        assert s2.bvh is s1.bvh
        assert s2.packed is s1.packed
        assert s2.env is s1.env
        assert s2.materials.packed is not s1.materials.packed
        # tri_shade is refolded (material cols 32:48 ride in it), but the
        # geometry columns must be untouched — no geometry rebuild
        np.testing.assert_array_equal(np.asarray(s2.tri_shade[:, :32]),
                                      np.asarray(s1.tri_shade[:, :32]))
        np.testing.assert_array_equal(
            np.asarray(s2.tri_shade[:, 32:]),
            np.asarray(s2.materials.packed)[
                np.asarray(s1.tri_shade[:, 24], np.int32)],
        )

    def test_background_edit_rebuilds_only_env(self):
        w, a, b = two_sphere_world()
        s1 = w.build()
        sky = np.zeros((4, 8, 3), np.float32)
        sky[:2] = 2.0
        w.set_background(sky)
        s2 = w.build()
        assert s2.bvh is s1.bvh
        assert s2.packed is s1.packed
        assert s2.materials.packed is s1.materials.packed
        assert s2.env is not s1.env

    def test_topology_edit_triggers_full_rebuild(self):
        w, a, b = two_sphere_world()
        s1 = w.build()
        sphere2 = w.add_mesh(icosphere(1, with_normals=False))
        w.add_instance(Instance(transform=translate(0, 0, 8),
                                geometries=[Geometry(sphere2, 0)]))
        s2 = w.build()
        assert s2.num_tris > s1.num_tris
        tri, _ = hit_tris(s2, [(0, 0, 12)])
        assert tri[0] >= 0

    def test_emitter_refit_tracks_transform_scale(self):
        """Emissive area (alias-table weight_sum) follows instance scale."""
        from moonshine_tpu.scene.types import scale_uniform

        w = World()
        quad = w.add_mesh(__import__(
            "moonshine_tpu.scene.types", fromlist=["Mesh"]).Mesh(
            positions=np.float32([[-1, -1, 0], [1, -1, 0],
                                  [1, 1, 0], [-1, 1, 0]]),
            indices=np.uint32([[0, 1, 2], [0, 2, 3]])))
        mat = w.add_material(MaterialInfo(variant=Lambert(color=(0, 0, 0)),
                                          emissive=(5.0, 5.0, 5.0)))
        inst = w.add_instance(Instance(
            transform=translate(0, 0, 2),
            geometries=[Geometry(quad, mat, sampled=True)]))
        s1 = w.build()
        w1 = float(s1.emitters.weight_sum)
        w.set_transform(inst, scale_uniform(2.0, (0, 0, 2)))
        s2 = w.build()
        assert float(s2.emitters.weight_sum) == pytest.approx(4 * w1, rel=1e-5)
        # hiding the only emitter drops count to 0 with unchanged shapes
        w.set_visibility(inst, False)
        s3 = w.build()
        assert int(s3.emitters.count) == 0
        assert s3.emitters.select.shape == s2.emitters.select.shape

    def test_multiple_backgrounds_switch_and_cache(self):
        """BackgroundManager array parity: several registered env maps,
        active selected per render; switching back reuses the prebuilt
        table (no re-preprocess)."""
        w, a, b = two_sphere_world()
        dark = np.full((4, 8, 3), 0.1, np.float32)
        bright = np.full((4, 8, 3), 5.0, np.float32)
        h_dark = w.add_background(dark)
        h_bright = w.add_background(bright)

        w.use_background(h_dark)
        s1 = w.build()
        env_dark = s1.env
        w.use_background(h_bright)
        s2 = w.build()
        assert s2.env is not env_dark
        assert float(s2.env.integral) > float(env_dark.integral)
        assert s2.bvh is s1.bvh  # only the env stage rebuilt

        w.use_background(h_dark)
        s3 = w.build()
        assert s3.env is env_dark  # cached table reused


class TestInstancingCap:
    def test_flatten_cap_switches_to_tlas(self, monkeypatch):
        """Past the flatten cap the build switches to true two-level
        instancing (shared BLAS per unique geometry + TLAS over instance
        AABBs, accel/tlas.py — the reference's Accel.zig:313-343 dedup)
        with a warning, instead of silently allocating count*tris rows.
        Round 4 merely refused here; round 5 renders it."""
        monkeypatch.setenv("MSN_MAX_FLAT_TRIS", "1000")
        w = World()
        sphere = w.add_mesh(icosphere(2, with_normals=False))
        mat = w.add_material(MaterialInfo(variant=Lambert(color=(1, 1, 1))))
        n_tris = len(icosphere(2, with_normals=False).indices)
        n_inst = 1000 // n_tris + 2
        for i in range(n_inst):
            w.add_instance(Instance(transform=translate(i * 3.0, 0, 0),
                                    geometries=[Geometry(sphere, mat)]))
        w.set_background(None)
        with pytest.warns(UserWarning, match="two-level instancing"):
            scene = w.build()
        assert scene.tlas is not None
        # shared BLAS: object rows stay one-mesh-sized
        assert scene.tri_shade.shape[0] == n_tris
        assert scene.tlas.num_instances == n_inst

    def test_cap_override(self, monkeypatch):
        monkeypatch.setenv("MSN_MAX_FLAT_TRIS", "100000000")
        w, a, b = two_sphere_world()
        assert w.build() is not None
