"""Flat-function adapter behind the native C ABI.

The C++ shim (native/engine_shim.cpp) embeds a Python interpreter and calls
these module-level functions — plain ints/floats/memoryviews only, no
objects across the boundary. This is the moonshine.h-equivalent surface
(hydra/moonshine.h:72-95) that DCC integrations (a USD Hydra delegate, a
Blender add-on) link against.

Engines, sensor buffers, etc. are kept alive in module registries keyed by
integer handles, mirroring the reference's opaque HdMoonshine* + u32 handle
scheme.

The device is JAX's own choice: set JAX_PLATFORMS (e.g. `cpu`) in the
host process's environment to pin one.
"""

from __future__ import annotations

import numpy as np

from .engine import Engine
from .scene.types import Lens

_engines: dict[int, Engine] = {}
_sensor_buffers: dict[tuple[int, int], np.ndarray] = {}
_next_engine = [1]


def create() -> int:
    handle = _next_engine[0]
    _next_engine[0] += 1
    _engines[handle] = Engine()
    return handle


def destroy(engine: int) -> None:
    _engines.pop(engine, None)
    for key in [k for k in _sensor_buffers if k[0] == engine]:
        _sensor_buffers.pop(key)


def _e(engine: int) -> Engine:
    return _engines[engine]


def create_mesh(engine: int, positions, normals, texcoords, indices) -> int:
    """Buffers arrive as memoryviews of f32/u32; non-indexed attributes like
    the reference's hydra path (moonshine.h CreateMesh)."""
    pos = np.frombuffer(positions, np.float32).reshape(-1, 3).copy()
    idx = np.frombuffer(indices, np.uint32).reshape(-1, 3).copy()
    nrm = (
        np.frombuffer(normals, np.float32).reshape(-1, 3).copy()
        if normals is not None and len(normals) else None
    )
    uv = (
        np.frombuffer(texcoords, np.float32).reshape(-1, 2).copy()
        if texcoords is not None and len(texcoords) else None
    )
    indexed = True
    if nrm is not None and len(nrm) == 3 * len(idx) and len(nrm) != len(pos):
        indexed = False
    if uv is not None and len(uv) == 3 * len(idx) and len(uv) != len(pos):
        indexed = False
    return _e(engine).create_mesh(pos, idx, nrm, uv, indexed_attributes=indexed)


def create_solid_texture1(engine: int, v: float) -> int:
    return _e(engine).create_solid_texture([v])


def create_solid_texture2(engine: int, x: float, y: float) -> int:
    return _e(engine).create_solid_texture([x, y])


def create_solid_texture3(engine: int, x: float, y: float, z: float) -> int:
    return _e(engine).create_solid_texture([x, y, z])


def create_raw_texture(engine: int, data, width: int, height: int,
                       format: int) -> int:
    """format 0 = f16x4, 1 = u8x4_srgb (moonshine.h TextureFormat)."""
    if format == 0:
        img = np.frombuffer(data, np.float16).reshape(height, width, 4)
        return _e(engine).create_raw_texture(img.astype(np.float32))
    img = np.frombuffer(data, np.uint8).reshape(height, width, 4)
    return _e(engine).create_raw_texture(img, srgb=True)


def create_material(engine: int, normal: int, emissive: int, color: int,
                    metalness: int, roughness: int, ior: float) -> int:
    return _e(engine).create_material(
        color=color, metalness=metalness, roughness=roughness,
        emissive=emissive, normal=normal if normal >= 0 else None, ior=ior,
    )


def set_material_normal(engine: int, mat: int, image: int) -> None:
    _e(engine).set_material_normal(mat, image)


def set_material_emissive(engine: int, mat: int, image: int) -> None:
    _e(engine).set_material_emissive(mat, image)


def set_material_color(engine: int, mat: int, image: int) -> None:
    _e(engine).set_material_color(mat, image)


def set_material_metalness(engine: int, mat: int, image: int) -> None:
    _e(engine).set_material_metalness(mat, image)


def set_material_roughness(engine: int, mat: int, image: int) -> None:
    _e(engine).set_material_roughness(mat, image)


def set_material_ior(engine: int, mat: int, ior: float) -> None:
    _e(engine).set_material_ior(mat, ior)


def create_instance(engine: int, transform, geometries, visible: bool) -> int:
    """transform: 12 f32 (row-major 3x4); geometries: u32 triples
    (mesh, material, sampled)."""
    t = np.frombuffer(transform, np.float32).reshape(3, 4).copy()
    g = np.frombuffer(geometries, np.uint32).reshape(-1, 3)
    geoms = [(int(m), int(mat), bool(s)) for m, mat, s in g]
    return _e(engine).create_instance(t, geoms, visible=visible)


def destroy_instance(engine: int, inst: int) -> None:
    _e(engine).destroy_instance(inst)


def set_instance_transform(engine: int, inst: int, transform) -> None:
    t = np.frombuffer(transform, np.float32).reshape(3, 4).copy()
    _e(engine).set_instance_transform(inst, t)


def set_instance_visibility(engine: int, inst: int, visible: bool) -> None:
    _e(engine).set_instance_visibility(inst, visible)


def create_sensor(engine: int, width: int, height: int) -> int:
    handle = _e(engine).create_sensor(width, height)
    _sensor_buffers[(engine, handle)] = np.zeros(
        (height, width, 4), np.float32
    )
    return handle


def create_lens(engine: int, ox, oy, oz, fx, fy, fz, ux, uy, uz,
                vfov, aperture, focus_distance) -> int:
    return _e(engine).create_lens(_lens(ox, oy, oz, fx, fy, fz, ux, uy, uz,
                                        vfov, aperture, focus_distance))


def set_lens(engine: int, lens: int, ox, oy, oz, fx, fy, fz, ux, uy, uz,
             vfov, aperture, focus_distance) -> None:
    _e(engine).set_lens(lens, _lens(ox, oy, oz, fx, fy, fz, ux, uy, uz,
                                    vfov, aperture, focus_distance))


def _lens(ox, oy, oz, fx, fy, fz, ux, uy, uz, vfov, aperture, focus):
    return Lens(
        origin=np.asarray([ox, oy, oz], np.float32),
        forward=np.asarray([fx, fy, fz], np.float32),
        up=np.asarray([ux, uy, uz], np.float32),
        vfov=vfov, aperture=aperture, focus_distance=focus,
    )


def render(engine: int, sensor: int, lens: int) -> bool:
    """One progressive sample; refreshes the sensor's pinned host buffer
    (HdMoonshineRender semantics: hydra.zig:145-363)."""
    try:
        img = _e(engine).render(sensor, lens)
        _sensor_buffers[(engine, sensor)][...] = img
        return True
    except Exception:
        import traceback

        traceback.print_exc()
        return False


def rebuild_pipeline(engine: int) -> bool:
    # static config unchanged -> jit cache already matches; kept for ABI parity
    return True


def get_sensor_data_ptr(engine: int, sensor: int) -> int:
    """Address of the persistent RGBA f32 host buffer (the reference maps
    readback memory straight into the render buffer, renderBuffer.hpp:25-27)."""
    return int(_sensor_buffers[(engine, sensor)].ctypes.data)


def sample_count(engine: int, sensor: int) -> int:
    return _e(engine).sample_count(sensor)
