"""Two-level instancing (accel/tlas.py): the shared-BLAS + TLAS path must
render the same images as the flattened path, and engage
automatically past the instanced-triangle cap (the reference's BLAS dedup,
Accel.zig:313-343)."""

import os

import numpy as np
import pytest

from fixtures import icosphere
from moonshine_tpu.accel import tlas as tlas_mod, traverse
from moonshine_tpu.integrator import PathConfig
from moonshine_tpu.scene.types import (
    Geometry, Instance, Lambert, Lens, MaterialInfo, Mesh, Mirror,
    identity_transform, translate,
)
from moonshine_tpu.scene.world import World, _flatten_object, _world_transform


def instanced_world(n=5, emissive=True, mirrored=False, hidden=None):
    """n instances of one icosphere + a floor + (optionally) an emissive
    quad, exercising shared-BLAS dedup, translations, a rotation, a
    non-uniform scale, and (optionally) a mirroring transform."""
    w = World()
    sphere = w.add_mesh(icosphere(2))
    floor = w.add_mesh(Mesh(
        positions=np.float32([[-20, -20, -2], [20, -20, -2],
                              [20, 20, -2], [-20, 20, -2]]),
        indices=np.uint32([[0, 1, 2], [0, 2, 3]]),
    ))
    red = w.add_material(MaterialInfo(variant=Lambert(color=(0.8, 0.2, 0.2))))
    grey = w.add_material(MaterialInfo(variant=Lambert(color=(0.6, 0.6, 0.6))))

    rng = np.random.RandomState(3)
    for i in range(n):
        M = np.zeros((3, 4), np.float32)
        if i == 1:
            # rotation about z + translation
            c, s = np.cos(0.7), np.sin(0.7)
            M[:, :3] = np.float32([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        elif i == 2:
            M[:, :3] = np.diag([0.5, 1.3, 0.8]).astype(np.float32)
        elif i == 3 and mirrored:
            M[:, :3] = np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
        else:
            M[:, :3] = np.eye(3, dtype=np.float32)
        M[:, 3] = rng.uniform(-4, 4, 3).astype(np.float32)
        M[2, 3] = abs(M[2, 3]) * 0.25  # keep above the floor
        w.add_instance(Instance(
            transform=M, geometries=[Geometry(sphere, red)],
            visible=(hidden is None or i != hidden),
        ))
    w.add_instance(Instance(transform=identity_transform(),
                            geometries=[Geometry(floor, grey)]))
    if emissive:
        quad = w.add_mesh(Mesh(
            positions=np.float32([[-1, -1, 6], [1, -1, 6],
                                  [1, 1, 6], [-1, 1, 6]]),
            indices=np.uint32([[0, 2, 1], [0, 3, 2]]),
        ))
        lamp = w.add_material(MaterialInfo(
            variant=Lambert(color=(0, 0, 0)), emissive=(8.0, 8.0, 8.0)))
        w.add_instance(Instance(transform=translate(0, 0, 0),
                                geometries=[Geometry(quad, lamp,
                                                     sampled=True)]))
    sky = np.full((8, 16, 3), 0.4, np.float32)
    w.set_background(sky, size=8)
    return w


def flat_world_verts(w):
    cache = _flatten_object(w.meshes, w.instances)
    verts, _, _ = _world_transform(cache, w.instances)
    vis = np.ones(len(verts), bool)
    for i, inst in enumerate(w.instances):
        s, e = cache.slices[i]
        if not inst.visible:
            vis[s:e] = False
    return verts[vis]


def build_tlas_scene(w):
    os.environ["MSN_FORCE_TLAS"] = "1"
    try:
        return w.build()
    finally:
        del os.environ["MSN_FORCE_TLAS"]


LENS = Lens(origin=np.float32([0, -12, 2]), forward=np.float32([0, 1, -0.1]),
            up=np.float32([0, 0, 1]), vfov=np.pi / 4)


def render(scene, size=48, spp=2):
    import jax.numpy as jnp

    from moonshine_tpu.render.camera import LensArrays
    from moonshine_tpu.render.renderer import render_spp

    la = LensArrays.from_lens(LENS)
    img, _ = render_spp(scene, la, size, size,
                        0, spp, PathConfig(max_bounces=3))
    return np.asarray(img)


class TestTlasTraversal:
    def test_closest_matches_brute_force(self):
        w = instanced_world(n=6, mirrored=True)
        scene = build_tlas_scene(w)
        assert scene.tlas is not None and scene.packed is None

        verts = flat_world_verts(w)
        rng = np.random.RandomState(11)
        o = rng.uniform(-8, 8, (256, 3)).astype(np.float32)
        o[:, 1] = -12.0
        d = rng.normal(size=(256, 3)).astype(np.float32)
        d[:, 1] = np.abs(d[:, 1]) + 0.3
        d /= np.linalg.norm(d, axis=-1, keepdims=True)

        got = tlas_mod.closest_hit_tlas(scene.tlas, o, d, 1e12)
        want = traverse.brute_force_closest(verts, o, d, 1e12)
        np.testing.assert_array_equal(np.asarray(got.is_hit),
                                      np.asarray(want.is_hit))
        hit = np.asarray(want.is_hit)
        np.testing.assert_allclose(np.asarray(got.t)[hit],
                                   np.asarray(want.t)[hit],
                                   rtol=2e-4, atol=1e-4)
        # every hit lane reports a valid instance
        assert (np.asarray(got.inst)[hit] >= 0).all()

    def test_anyhit_matches_brute_force(self):
        w = instanced_world(n=6)
        scene = build_tlas_scene(w)
        verts = flat_world_verts(w)
        rng = np.random.RandomState(12)
        o = rng.uniform(-8, 8, (256, 3)).astype(np.float32)
        o[:, 1] = -12.0
        d = rng.normal(size=(256, 3)).astype(np.float32)
        d[:, 1] = np.abs(d[:, 1]) + 0.3
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t_max = 14.0
        got = np.asarray(tlas_mod.any_hit_tlas(scene.tlas, o, d, t_max))
        bf = traverse.brute_force_closest(verts, o, d, t_max)
        want = np.asarray(bf.is_hit)
        np.testing.assert_array_equal(got, want)

    def test_hidden_instance_never_hit(self):
        w = instanced_world(n=4, emissive=False, hidden=2)
        scene = build_tlas_scene(w)
        rng = np.random.RandomState(13)
        o = rng.uniform(-8, 8, (128, 3)).astype(np.float32)
        o[:, 1] = -12.0
        d = rng.normal(size=(128, 3)).astype(np.float32)
        d[:, 1] = np.abs(d[:, 1]) + 0.3
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        got = tlas_mod.closest_hit_tlas(scene.tlas, o, d, 1e12)
        assert not (np.asarray(got.inst) == 2).any()

    def test_respects_active_mask(self):
        import jax.numpy as jnp

        w = instanced_world(n=3, emissive=False)
        scene = build_tlas_scene(w)
        o = np.zeros((64, 3), np.float32)
        o[:, 1] = -12.0
        d = np.zeros((64, 3), np.float32)
        d[:, 1] = 1.0
        active = jnp.arange(64) % 2 == 0
        got = tlas_mod.closest_hit_tlas(scene.tlas, o, d, 1e12,
                                        active_in=active)
        inactive = ~np.asarray(active)
        assert (np.asarray(got.tri)[inactive] == -1).all()


class TestTlasRender:
    def test_image_matches_flattened(self):
        """Same scene, flattened path vs two-level path: identical
        RNG streams, same surfaces -> images agree to fp tolerance (the
        two paths intersect in different spaces, so t/frames differ by
        ulps that a 3-bounce render amplifies slightly)."""
        w = instanced_world(n=5, mirrored=True)
        ref = render(w.build())
        w2 = instanced_world(n=5, mirrored=True)
        scene2 = build_tlas_scene(w2)
        img = render(scene2)
        # the overwhelming majority of pixels must be essentially equal
        close = np.isclose(img, ref, rtol=5e-3, atol=5e-3)
        assert close.mean() > 0.995, (
            f"only {close.mean():.4f} of pixels match "
            f"(max abs diff {np.abs(img - ref).max():.4g})"
        )
        np.testing.assert_allclose(img.mean(), ref.mean(), rtol=2e-3)

    def test_hidden_instance_render(self):
        w = instanced_world(n=4, emissive=False, hidden=1)
        ref = render(w.build())
        w2 = instanced_world(n=4, emissive=False, hidden=1)
        img = render(build_tlas_scene(w2))
        close = np.isclose(img, ref, rtol=5e-3, atol=5e-3)
        assert close.mean() > 0.995

    def test_cap_switches_to_tlas_with_warning(self):
        w = instanced_world(n=5)
        os.environ["MSN_MAX_FLAT_TRIS"] = "100"
        try:
            with pytest.warns(UserWarning, match="two-level instancing"):
                scene = w.build()
        finally:
            del os.environ["MSN_MAX_FLAT_TRIS"]
        assert scene.tlas is not None
        img = render(scene)
        assert np.isfinite(img).all() and img.mean() > 0.0

    def test_blas_dedup_shares_storage(self):
        """1k instances of one mesh must NOT materialize 1k copies of its
        triangles (the whole point of the reference's BLAS dedup)."""
        w = World()
        sphere = w.add_mesh(icosphere(2))
        red = w.add_material(MaterialInfo(variant=Lambert(color=(0.8, 0.2, 0.2))))
        rng = np.random.RandomState(5)
        n_inst = 1000
        for _ in range(n_inst):
            x, y, z = rng.uniform(-50, 50, 3)
            w.add_instance(Instance(transform=translate(x, y, z),
                                    geometries=[Geometry(sphere, red)]))
        w.set_background(np.full((4, 8, 3), 0.3, np.float32), size=4)
        scene = build_tlas_scene(w)
        n_mesh_tris = len(w.meshes[sphere].indices)
        assert scene.tri_shade.shape[0] == n_mesh_tris
        assert scene.tlas.num_instances == n_inst
        assert scene.tlas.blas_tris.shape[0] == n_mesh_tris
        img = render(scene, size=32, spp=1)
        assert np.isfinite(img).all()

    def test_pick_reports_instance(self):
        from moonshine_tpu.engine.engine import Engine

        w = World()
        sphere = w.add_mesh(icosphere(2))
        red = w.add_material(MaterialInfo(variant=Lambert(color=(0.8, 0.2, 0.2))))
        w.add_instance(Instance(transform=translate(5, 0, 0),
                                geometries=[Geometry(sphere, red)]))
        w.add_instance(Instance(transform=identity_transform(),
                                geometries=[Geometry(sphere, red)]))
        w.set_background(np.full((4, 8, 3), 0.3, np.float32), size=4)
        os.environ["MSN_FORCE_TLAS"] = "1"
        try:
            eng = Engine()
            eng.world = w  # engine builds its world on first use
            lens = eng.create_lens(Lens(
                origin=np.float32([0, -6, 0]), forward=np.float32([0, 1, 0]),
                up=np.float32([0, 0, 1]), vfov=np.pi / 4))
            # center pixel: the unit sphere at the origin (instance 1)
            res = eng.pick(lens, 64, 64, 32, 32)
        finally:
            del os.environ["MSN_FORCE_TLAS"]
        assert res.instance == 1
        assert res.primitive >= 0
