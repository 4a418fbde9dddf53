"""Pinned-image drift tests.

Renders small deterministic versions of ladder rungs 1-3 (furnace,
Cornell, mirror+glass HDR env) and compares against EXR goldens committed
under tests/goldens/ (rendered on the CPU, whose traversal is
accel/traverse.py). Perf work that silently changes images (traversal
tie-breaks, RNG stream shifts, shading reorders) fails here first.

Regenerate intentionally after a *reviewed* behavior change with:
    python tests/test_goldens.py --regen
"""

import pathlib
import sys

import numpy as np
import pytest

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "goldens"


def _configs():
    from fixtures import icosphere
    from glb_builder import cornell_box_glb
    from moonshine_tpu.integrator import PathConfig
    from moonshine_tpu.scene import gltf
    from moonshine_tpu.scene.types import (
        Geometry, Glass, Instance, Lambert, Lens, MaterialInfo, Mesh,
        Mirror, identity_transform, translate,
    )
    from moonshine_tpu.scene.world import World

    lens = Lens(origin=np.float32([0, -3, 0]),
                forward=np.float32([0, 1, 0]),
                up=np.float32([0, 0, 1]), vfov=np.pi / 4)

    def furnace():
        w = World()
        mesh = w.add_mesh(icosphere(2, with_normals=False))
        mat = w.add_material(MaterialInfo(variant=Lambert(color=(1, 1, 1))))
        w.add_instance(Instance(transform=identity_transform(),
                                geometries=[Geometry(mesh, mat)]))
        w.set_background(None)
        cfg = PathConfig(max_bounces=8, env_samples_per_bounce=0,
                         mesh_samples_per_bounce=0, unroll=False)
        return w.build(), lens, (64, 64), 8, cfg

    def cornell():
        world = gltf.world_from_glb(cornell_box_glb())
        world.set_background(np.zeros((4, 8, 3), np.float32))
        clens = gltf.lens_from_glb(cornell_box_glb())
        cfg = PathConfig(max_bounces=4, env_samples_per_bounce=0,
                         mesh_samples_per_bounce=1)
        return world.build(), clens, (96, 96), 8, cfg

    def mirror_glass():
        w = World()
        sphere = w.add_mesh(icosphere(3))
        floor = w.add_mesh(Mesh(
            positions=np.float32([[-20, -20, -1], [20, -20, -1],
                                  [20, 20, -1], [-20, 20, -1]]),
            indices=np.uint32([[0, 1, 2], [0, 2, 3]])))
        mats = [w.add_material(MaterialInfo(variant=Mirror())),
                w.add_material(MaterialInfo(variant=Glass(ior=1.5))),
                w.add_material(MaterialInfo(
                    variant=Lambert(color=(0.6, 0.6, 0.6))))]
        for x, m in [(-1.5, 0), (1.5, 1)]:
            w.add_instance(Instance(transform=translate(x, 0, 0),
                                    geometries=[Geometry(sphere, mats[m])]))
        w.add_instance(Instance(transform=identity_transform(),
                                geometries=[Geometry(floor, mats[2])]))
        sky = np.zeros((16, 32, 3), np.float32)
        sky[:, :, :] = 0.2
        sky[2:4, 5:10] = 12.0
        w.set_background(sky, size=16)
        cfg = PathConfig(max_bounces=6, env_samples_per_bounce=1,
                         mesh_samples_per_bounce=0)
        return w.build(), lens, (96, 96), 8, cfg

    return {"furnace": furnace, "cornell": cornell,
            "mirror_glass": mirror_glass}


def _render(builder):
    from moonshine_tpu.render.camera import LensArrays
    from moonshine_tpu.render.renderer import render_spp

    scene, lens, (h, w), spp, cfg = builder()
    img, _ = render_spp(scene, LensArrays.from_lens(lens), h, w, 0, spp, cfg)
    return np.asarray(img) / spp


@pytest.mark.parametrize("name", ["furnace", "cornell", "mirror_glass"])
def test_image_matches_golden(name):
    from moonshine_tpu.io.exr import read_exr

    path = GOLDEN_DIR / f"{name}.exr"
    if not path.exists():
        pytest.skip(f"golden {path} not generated yet (--regen)")
    golden = read_exr(path)[..., :3]
    img = _render(_configs()[name])
    # float32 EXR storage is exact; any drift is a behavior change
    diff = np.abs(img - golden).max()
    assert diff <= 2e-6, f"{name}: image drifted from golden (max {diff})"


def test_furnace_analytic():
    """Rung-1 acceptance vs analytic truth (tests.zig:257-345): every
    pixel of the albedo-1 furnace integrates to exactly 1.0."""
    img = _render(_configs()["furnace"])
    assert np.abs(img - 1.0).max() < 1e-5


def test_mirror_glass_energy():
    """Rung-3 statistical acceptance: delta transport conserves energy —
    the render's mean radiance cannot exceed the sky's max emission, and
    the sun patch must be visible in reflections (mean above ambient)."""
    img = _render(_configs()["mirror_glass"])
    assert np.isfinite(img).all()
    assert 0.2 * 0.2 < img.mean() < 12.0
    assert img.max() > 1.0  # specular path to the sun patch survives


if __name__ == "__main__":
    if "--regen" in sys.argv:
        here = pathlib.Path(__file__).resolve().parent
        sys.path.insert(0, str(here))
        sys.path.insert(0, str(here.parent))
        import jax

        jax.config.update("jax_platforms", "cpu")
        from moonshine_tpu.io.exr import write_exr

        GOLDEN_DIR.mkdir(exist_ok=True)
        for name, builder in _configs().items():
            img = _render(builder)
            write_exr(GOLDEN_DIR / f"{name}.exr", img)
            print(f"wrote {name}.exr mean={img.mean():.5f}")
    else:
        pytest.main([__file__, "-q"])
