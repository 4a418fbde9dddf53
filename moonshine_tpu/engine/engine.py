"""Persistent progressive rendering engine.

Capability parity with the reference's hydra/online surface
(hydra/hydra.zig:62-559, hydra/moonshine.h:72-95): an engine object owns
meshes, image/texture handles, materials, instances, sensors and lenses;
callers mutate state (queued, like the reference's material-update queue)
and call `render(sensor, lens)` to accumulate one progressive sample.

Differences from the reference:
  * instead of in-place GPU buffer updates + TLAS refit, mutations mark the
    flattened device scene dirty; the next render re-freezes it (XLA's
    static-shape analogue of the reference's upload+refit path). Pure
    transform/visibility edits reuse cached mesh flattening.
  * "RebuildPipeline" (spec-constant changes) is `set_config`: the next
    render re-jits, which is exactly what the reference's DXC rebuild does.
  * sensors accumulate running means and can checkpoint to disk — the
    save/resume capability the reference lists as a TODO.

The object-pick query (ObjectPicker.zig:89-128 / input.hlsl) is `pick`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..accel.intersect import closest_hit
from ..core.mathutil import INF_T
from ..integrator.path import PathConfig
from ..render.camera import LensArrays, generate_rays, pixel_uv
from ..render.renderer import render_sample, render_spp, use_staged
from ..render.sensor import Sensor, accumulate
from ..scene.types import Geometry, Instance, Lens, MaterialInfo, Mesh, StandardPBR
from ..scene.world import World


@jax.jit
def _pick_hit(scene, lens_arrays, width, height, x, y):
    """Closest hit of the camera ray through pixel (x, y), as one
    dispatch (all four traced: one executable for every image size)."""
    px = jnp.asarray(x, jnp.uint32)[None]
    py = jnp.asarray(y, jnp.uint32)[None]
    uv = pixel_uv(px, py, width, height,
                  jnp.full((1, 2), 0.5, jnp.float32), False)
    o, d = generate_rays(lens_arrays, width, height, uv,
                         jnp.zeros((1, 2), jnp.float32))
    return closest_hit(scene, o, d, INF_T)


@dataclass
class _EngineMaterial:
    """Image-handle-based material record (moonshine.h Material)."""

    normal: Optional[int]
    emissive: int
    color: int
    metalness: int
    roughness: int
    ior: float


@dataclass
class PickResult:
    instance: int  # -1 on miss
    geometry: int
    primitive: int
    barycentrics: tuple[float, float]

    @property
    def hit(self) -> bool:
        return self.instance >= 0


class Engine:
    """Thread-safe progressive engine (the reference serializes multithreaded
    hydra callers with a mutex, hydra.zig:77-78 — so do we)."""

    def __init__(self, config: PathConfig | None = None):
        self._lock = threading.RLock()
        # serializes frames while keeping _lock free during device work
        self._render_lock = threading.Lock()
        self._sensor_gen: dict = {}  # sensor -> generation (bumped on reset)
        self.world = World()
        self.images: list = []  # host images / constants, by handle
        self._materials: list[_EngineMaterial] = []
        self.sensors: list[Sensor] = []
        self.lenses: list[Lens] = []
        # hydra pipeline defaults (hydra.zig:95-105): deep bounces, NEE off
        self.config = config or PathConfig(
            max_bounces=1024, env_samples_per_bounce=0,
            mesh_samples_per_bounce=0,
        )
        self._scene = None
        self._dirty = True
        self._pending_rays: list = []  # device counters from wait=False frames
        self._mesh = None  # multi-chip device mesh (set_mesh)
        self._mesh_fallback_warned = False
        self.metrics: dict = {"renders": 0, "rays": 0.0, "render_seconds": 0.0}

    def set_mesh(self, mesh_or_spec) -> None:
        """Enable multi-chip rendering: a jax.sharding.Mesh from
        parallel.make_mesh, or a spec string ('auto' / 'SP,DP'). Frames
        whose height divides by dp and spp by sp render via
        parallel.render_sharded; others fall back to single-device.
        None disables."""
        if isinstance(mesh_or_spec, str):
            from ..parallel import mesh_from_spec

            mesh_or_spec = mesh_from_spec(mesh_or_spec)
        if mesh_or_spec is not None:
            names = tuple(getattr(mesh_or_spec, "axis_names", ()))
            if "sp" not in names or "dp" not in names:
                raise ValueError(
                    "mesh must have 'sp' and 'dp' axes (use "
                    f"parallel.make_mesh / mesh_from_spec); got {names}"
                )
        with self._lock:
            self._mesh = mesh_or_spec
            self._mesh_fallback_warned = False

    # --- images (TextureManager surface: moonshine.h CreateSolidTexture*/CreateRawTexture) ---

    def create_solid_texture(self, value) -> int:
        with self._lock:
            self.images.append(np.asarray(value, np.float32).reshape(1, 1, -1))
            self._dirty = True
            return len(self.images) - 1

    def create_raw_texture(self, pixels: np.ndarray, srgb: bool = False) -> int:
        """pixels: [h, w, c] float [0,1] or uint8; srgb decodes to linear
        (the reference's u8x4_srgb format)."""
        img = np.asarray(pixels)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if srgb:
            from ..scene.gltf import srgb_to_linear

            img = img.copy()
            img[..., :3] = srgb_to_linear(img[..., :3])
        with self._lock:
            self.images.append(img)
            self._dirty = True
            return len(self.images) - 1

    # --- meshes (moonshine.h CreateMesh; non-indexed attributes like hydra) ---

    def create_mesh(self, positions, indices, normals=None, texcoords=None,
                    indexed_attributes: bool = True) -> int:
        with self._lock:
            handle = self.world.add_mesh(
                Mesh(
                    positions=np.asarray(positions, np.float32),
                    indices=np.asarray(indices, np.uint32),
                    normals=None if normals is None else np.asarray(normals, np.float32),
                    texcoords=None if texcoords is None else np.asarray(texcoords, np.float32),
                    indexed_attributes=indexed_attributes,
                )
            )
            self._dirty = True
            return handle

    # --- materials (moonshine.h CreateMaterial + SetMaterial*) ---

    def create_material(self, color: int, metalness: int, roughness: int,
                        emissive: int, normal: Optional[int] = None,
                        ior: float = 1.5) -> int:
        """StandardPBR from image handles (the only variant the reference's
        hydra exposes, hydra.zig:423-433)."""
        with self._lock:
            rec = _EngineMaterial(
                normal=normal, emissive=emissive, color=color,
                metalness=metalness, roughness=roughness, ior=ior,
            )
            self._materials.append(rec)
            handle = self.world.add_material(self._to_info(rec))
            self._dirty = True
            return handle

    def _to_info(self, rec: _EngineMaterial) -> MaterialInfo:
        img = lambda h: self.images[h]
        return MaterialInfo(
            variant=StandardPBR(
                color=img(rec.color),
                metalness=img(rec.metalness),
                roughness=img(rec.roughness),
                ior=rec.ior,
            ),
            normal=None if rec.normal is None else img(rec.normal)[..., :2],
            emissive=img(rec.emissive),
        )

    def _set_material(self, handle: int, **updates) -> None:
        with self._lock:
            rec = self._materials[handle]
            for k, v in updates.items():
                setattr(rec, k, v)
            self.world.update_material(handle, self._to_info(rec))
            self._dirty = True

    def set_material_normal(self, handle: int, image: int):
        self._set_material(handle, normal=image)

    def set_material_emissive(self, handle: int, image: int):
        self._set_material(handle, emissive=image)

    def set_material_color(self, handle: int, image: int):
        self._set_material(handle, color=image)

    def set_material_metalness(self, handle: int, image: int):
        self._set_material(handle, metalness=image)

    def set_material_roughness(self, handle: int, image: int):
        self._set_material(handle, roughness=image)

    def set_material_ior(self, handle: int, ior: float):
        self._set_material(handle, ior=ior)

    # --- instances (moonshine.h Create/DestroyInstance, SetTransform/Visibility) ---

    def create_instance(self, transform, geometries, visible=True) -> int:
        with self._lock:
            handle = self.world.add_instance(
                Instance(
                    transform=np.asarray(transform, np.float32),
                    geometries=[
                        g if isinstance(g, Geometry) else Geometry(*g)
                        for g in geometries
                    ],
                    visible=visible,
                )
            )
            self._dirty = True
            return handle

    def destroy_instance(self, handle: int):
        """The reference 'destroys' by hiding (hydra.zig:497-500)."""
        self.set_instance_visibility(handle, False)

    def set_instance_transform(self, handle: int, transform):
        with self._lock:
            self.world.set_transform(handle, transform)
            self._dirty = True

    def set_instance_visibility(self, handle: int, visible: bool):
        with self._lock:
            self.world.set_visibility(handle, visible)
            self._dirty = True

    # --- background ---

    def set_background(self, equirect_rgb: Optional[np.ndarray], size=None):
        with self._lock:
            self.world.set_background(equirect_rgb, size)
            self._dirty = True

    def add_background(self, equirect_rgb: Optional[np.ndarray],
                       size=None) -> int:
        """Register an env map without selecting it (BackgroundManager
        array surface)."""
        with self._lock:
            return self.world.add_background(equirect_rgb, size)

    def use_background(self, handle: int):
        """Switch the active env map; prebuilt tables swap instantly."""
        with self._lock:
            self.world.use_background(handle)
            self._dirty = True

    # --- sensors / lenses (moonshine.h CreateSensor/CreateLens/SetLens) ---

    def create_sensor(self, width: int, height: int) -> int:
        with self._lock:
            self.sensors.append(Sensor.create(height, width))
            return len(self.sensors) - 1

    def reset_sensor(self, handle: int):
        """Restart accumulation (Sensor.clear, the GUI 'reset' button)."""
        with self._lock:
            self.sensors[handle] = self.sensors[handle].clear()
            self._sensor_gen[handle] = self._sensor_gen.get(handle, 0) + 1

    def get_sensor_data(self, handle: int) -> np.ndarray:
        """[H, W, 4] float32 RGBA running mean (GetSensorData parity)."""
        with self._lock:
            img = np.asarray(self.sensors[handle].image)
            return np.concatenate(
                [img, np.ones((*img.shape[:2], 1), np.float32)], axis=-1
            )

    def sample_count(self, handle: int) -> int:
        return int(self.sensors[handle].sample_count)

    def create_lens(self, lens: Lens) -> int:
        with self._lock:
            self.lenses.append(lens)
            return len(self.lenses) - 1

    def set_lens(self, handle: int, lens: Lens):
        with self._lock:
            self.lenses[handle] = lens
            # moving the camera restarts accumulation in the online frontend;
            # hydra resets the sensor explicitly — we leave sensors alone

    # --- pipeline (moonshine.h RebuildPipeline / GUI spec-constant editor) ---

    def set_config(self, config: PathConfig):
        """Changing static integrator knobs re-jits on next render — the XLA
        analogue of the reference's live DXC pipeline rebuild."""
        with self._lock:
            self.config = config

    # --- scene freeze ---

    def _ensure_scene(self):
        if self._dirty or self._scene is None:
            self._scene = self.world.build()
            self._dirty = False
        return self._scene

    # --- render (moonshine.h HdMoonshineRender: one 1-spp accumulate) ---

    def render(self, sensor: int, lens: int, spp: int = 1,
               wait: bool = True) -> Optional[np.ndarray]:
        """Accumulate spp progressive samples.

        wait=True (default, hydra semantics): blocks until the frame is on
        the host and returns it. wait=False is the Display double-buffer
        analogue (displaysystem/Display.zig:14-28 frames_in_flight=2): the
        dispatch is queued on the device and the call returns None
        immediately — XLA's async dispatch overlaps it with whatever the
        host does next (e.g. serving the previous frame); read results
        later with get_sensor_data."""
        # Frames serialize on a dedicated render lock, but the engine
        # lock is held only to snapshot state and to commit results —
        # picks / edits / status reads from other threads (the viewer's
        # HTTP handlers) stay responsive during a multi-second device
        # render. The reference holds its one mutex across the whole
        # frame (hydra.zig:146) — affordable there because a frame is
        # milliseconds; ours can be seconds.
        with self._render_lock:
            with self._lock:
                scene = self._ensure_scene()
                s = self.sensors[sensor]
                gen = self._sensor_gen.get(sensor, 0)
                lens_arrays = LensArrays.from_lens(self.lenses[lens])
                cfg = self.config
            with self._lock:
                mesh = self._mesh
            h, w = s.image.shape[:2]
            t0 = time.perf_counter()
            rays_parts = []
            use_mesh = (
                mesh is not None
                and h % mesh.shape["dp"] == 0
                and spp % mesh.shape["sp"] == 0
            )
            if mesh is not None and not use_mesh:
                with self._lock:
                    warn = not getattr(self, "_mesh_fallback_warned", False)
                    self._mesh_fallback_warned = True
                if warn:
                    import warnings

                    warnings.warn(
                        f"multi-chip mesh configured (sp={mesh.shape['sp']}, "
                        f"dp={mesh.shape['dp']}) but height {h} % dp or "
                        f"spp {spp} % sp != 0 — rendering single-device. "
                        "Pick dividing shapes to use the mesh.",
                        RuntimeWarning, stacklevel=2,
                    )
            if use_mesh:
                from ..parallel import render_sharded

                img, rays = render_sharded(
                    scene, lens_arrays, h, w, spp, cfg, mesh,
                    # hydra disables the y-flip (hydra.zig:95-105)
                    flip_image=False, base_sample=s.sample_count,
                )
                # render_sharded returns the spp-mean; accumulate takes sums
                s = accumulate(s, img * spp, spp)
                rays_parts.append(rays)
            elif use_staged(h * w, cfg):
                # large frames: one staged per-bounce dispatch chain for
                # all spp (renderer.MAX_LANES)
                img, rays = render_spp(scene, lens_arrays, h, w,
                                       s.sample_count, spp, cfg, False)
                s = accumulate(s, img, spp)
                rays_parts.append(rays)
            else:
                prev = None
                for _ in range(spp):
                    img, rays = render_sample(
                        scene, lens_arrays, h, w, s.sample_count, cfg,
                        False,
                    )
                    s = accumulate(s, img, 1)
                    rays_parts.append(rays)
                    # the device runs dispatches in order, so a pick from
                    # another thread waits for everything queued before
                    # it: keep at most two samples in flight
                    if wait and prev is not None:
                        prev.block_until_ready()
                    prev = img
            if not wait:
                # no host sync at all — even reading the ray counter would
                # block on the dispatched computation
                with self._lock:
                    if self._sensor_gen.get(sensor, 0) == gen:
                        self.sensors[sensor] = s
                        self._pending_rays.extend(rays_parts)
                    self.metrics["renders"] += 1
                return None
            rays_now = sum(float(r) for r in rays_parts)
            np.asarray(s.image)  # sync — outside the engine lock
            dt = time.perf_counter() - t0
            with self._lock:
                if self._sensor_gen.get(sensor, 0) == gen:
                    # a reset_sensor during the render discards this frame
                    self.sensors[sensor] = s
                rays_pending = sum(float(r) for r in self._pending_rays)
                self._pending_rays.clear()
                self.metrics["renders"] += 1
                self.metrics["rays"] += rays_now + rays_pending
                self.metrics["render_seconds"] += dt
                self.metrics["last_frame_seconds"] = dt
                self.metrics["last_mrays_per_sec"] = rays_now / dt / 1e6
        return self.get_sensor_data(sensor)

    # --- object picking (ObjectPicker.zig:89-128, input.hlsl) ---

    def pick(self, lens: int, width: int, height: int, x: int, y: int) -> PickResult:
        """Trace one camera ray through pixel (x, y); returns hit ids."""
        with self._lock:
            scene = self._ensure_scene()
            lens_arrays = LensArrays.from_lens(self.lenses[lens])
            hit = _pick_hit(scene, lens_arrays, width, height, x, y)
            if int(hit.tri[0]) < 0:
                return PickResult(-1, -1, -1, (0.0, 0.0))
            row = np.asarray(scene.tri_shade[hit.tri[0]])
            # two-level instancing: the instance id is per-hit (object
            # rows are shared across instances, so col 26 holds -1 there)
            instance = (int(hit.inst[0]) if hit.inst is not None
                        else int(row[26]))
            return PickResult(
                instance=instance,
                geometry=int(row[27]),
                primitive=int(row[28]),
                barycentrics=(float(hit.u[0]), float(hit.v[0])),
            )

    # --- checkpoint / resume (SURVEY.md §5 improvement slot) ---

    def save_checkpoint(self, path, sensor: int):
        with self._lock:
            s = self.sensors[sensor]
            np.savez(
                path,
                image=np.asarray(s.image),
                sample_count=int(s.sample_count),
            )

    def load_checkpoint(self, path, sensor: int):
        with self._lock:
            data = np.load(path)
            self.sensors[sensor] = Sensor(
                image=jnp.asarray(data["image"]),
                sample_count=jnp.asarray(int(data["sample_count"]), jnp.int32),
            )
            self._sensor_gen[sensor] = self._sensor_gen.get(sensor, 0) + 1
