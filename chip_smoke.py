"""Runs the renderer's main path once on an NVIDIA GPU, phase by phase.

    python chip_smoke.py            # every one-card phase, in order
    python chip_smoke.py --four     # the four-card sharded path only

One-card phases:

  device      jax.devices(), device_kind and the card's name and power
              limit; exits non-zero when JAX finds no GPU.
  traversal   the CUDA traversal kernel against the plain JAX walk
              (accel/traverse.py) on the same arrays: the small oracle
              cases of tests/test_intersect.py, bounce-1 rays of
              room_184k at 1920x1080 and of the flagship at 512x512
              (closest and any-hit, agreement and time per call), one
              whole frame of each scene with each traversal, and the
              per-bounce resort on/off images (equal to 1e-6).
  offline     the offline CLI's main(argv) on the Cornell glb and a
              procedural EXR sky, 512x512 at 16 spp; reads the EXR back.
  furnace     the white furnace at 256x256, 64 spp, russian roulette
              live: the mean must be within 1e-3 of 1.0.
  flagship    the flagship at 128x128, 8 spp, on the GPU and on the CPU
              backend of this process: per-channel means within 3
              standard errors.
  engine      room_184k through Engine at 1920x1080 (the staged path):
              a few 1-spp frames, one transform edit, one more frame.
  room_1m     the ~1M-triangle room: build time, one 1080p frame, peak
              device memory.
  instanced   a small instanced scene through the two-level TLAS path
              (MSN_FORCE_TLAS=1) against its flattened render.

--four renders room_184k at 1080p, 4 spp, with parallel.render_sharded on
meshes (1,4), (2,2) and (4,1), and compares each image with the one-card
render of the same frame.

Every phase raises on failure. Timings and checks print as they happen;
the last line of stdout is one JSON object naming the device. The compile
cache goes to JAX_COMPILATION_CACHE_DIR when that is set, otherwise to
<repo>/.jax_cache. The script starts no other process that uses JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent

# traversal agreement with accel/traverse.py (kernel vs plain walk, same
# arrays). Both run the same float32 slab and Moller-Trumbore arithmetic
# in the same node order, but nvcc and XLA contract different multiply-
# adds into FMAs, so the last bits of det/u/v/t can differ: a ray that
# meets a shared edge within an ulp may take the neighbour triangle (at
# the same t) or slip through the crack to a surface behind. Hence
# agreement on nearly all lanes rather than all, t close but not equal,
# and a differing triangle only at an edge: the hits lie at the same
# distance, or one of them lies on its triangle's edge.
MIN_AGREE = 0.9999  # hit/miss, triangle id and any-hit agreement
T_RTOL = 1e-5  # relative t agreement where both hit the same triangle
TIE_RTOL = 1e-4  # differing triangles at the same t: an edge tie
EDGE_EPS = 1e-4  # smallest barycentric of a hit on a triangle's edge
# whole frames through either traversal: identical RNG streams, so a
# pixel differs only where an edge tie sent a path elsewhere
FRAME_ATOL = 1e-3
MIN_FRAME_CLOSE = 0.995

ROOM_184K = dict(grid=6, subdivisions=4)
ROOM_1M = dict(grid=7, subdivisions=5)
HD = (1080, 1920)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, ok: bool, detail: str = "") -> None:
    log(f"{'PASS' if ok else 'FAIL'}  {name}  {detail}")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def _repo_imports():
    for p in (str(ROOT), str(ROOT / "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)


def peak_bytes(device=None) -> int:
    import jax

    stats = (device or jax.devices()[0]).memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def timed(fn, *args, reps: int = 3):
    """(seconds of each timed call, last result); one untimed warm-up
    call (compilation) first. Every call ends in block_until_ready."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times, out


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


# ---------------------------------------------------------------- device

def phase_device() -> dict:
    import jax

    devs = jax.devices()
    log(f"jax {jax.__version__} devices: {devs}")
    dev = devs[0]
    log(f"platform {dev.platform} kind {dev.device_kind} count {len(devs)}")
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found "
                         f"{dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"nvidia-smi: {smi.stdout.strip()}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devs)}


# ------------------------------------------------------------- traversal

def build_room(grid: int, subdivisions: int):
    """(DeviceScene, Lens, host build seconds) of the procedural room."""
    import jax

    from moonshine_tpu.scene.procedural import room_scene

    world, lens = room_scene(grid=grid, subdivisions=subdivisions)
    t0 = time.perf_counter()
    scene = jax.block_until_ready(world.build())
    return world, scene, lens, time.perf_counter() - t0


def bounce1_rays(scene, lens, height: int, width: int, seed: int = 0):
    """Bounce-1 rays of a frame: camera rays traced to their first hit,
    then a cosine-distributed continuation from each hit (closest-hit
    lanes) and 2N shadow rays from the same points (any-hit lanes: N
    segments to random points in the scene box, N unbounded rays).
    Returns (o, d, active, so, sd, s_tmax, s_active)."""
    import jax
    import jax.numpy as jnp

    from moonshine_tpu.accel import intersect
    from moonshine_tpu.core.mathutil import (
        INF_T, face_forward, normalize, offset_along_normal, safe_normalize,
    )
    from moonshine_tpu.render.camera import LensArrays
    from moonshine_tpu.render.renderer import _sample_rays

    o, d, _ = _sample_rays(LensArrays.from_lens(lens), height, width,
                           seed, True)

    @jax.jit
    def make(scene, o, d):
        n_lanes = o.shape[0]
        hit = intersect.closest_hit(scene, o, d, INF_T)
        k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
        c = scene.corner_positions(jnp.clip(hit.tri, 0, scene.num_tris - 1))
        n = safe_normalize(jnp.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0]))
        n = face_forward(n, -d)
        p = offset_along_normal(o + hit.t[:, None] * d, n)
        nd = normalize(n + normalize(jax.random.normal(k1, (n_lanes, 3))))
        lo, hi = scene.bvh.aabb_min[0], scene.bvh.aabb_max[0]
        target = lo + jax.random.uniform(k2, (n_lanes, 3)) * (hi - lo)
        seg = target - p
        dist = jnp.linalg.norm(seg, axis=-1)
        sd1 = seg / jnp.maximum(dist, 1e-20)[:, None]
        sd2 = normalize(n + normalize(jax.random.normal(k3, (n_lanes, 3))))
        active = hit.is_hit
        return (p, nd, active, jnp.concatenate([p, p]),
                jnp.concatenate([sd1, sd2]),
                jnp.concatenate([dist, jnp.full_like(dist, INF_T)]),
                jnp.concatenate([active, active]))

    return make(scene, o, d)


def compare_traversal(name: str, scene, rays, reps: int = 3) -> dict:
    """Kernel vs plain walk on the same bounce-1 arrays: agreement checks
    and seconds per call of each."""
    import jax
    import numpy as np

    from moonshine_tpu.accel import intersect
    from moonshine_tpu.core.mathutil import INF_T

    o, d, active, so, sd, s_tmax, s_active = rays
    plain = scene._replace(packed=None)
    closest = jax.jit(lambda s, o, d, a: intersect.closest_hit(
        s, o, d, INF_T, a))
    anyhit = jax.jit(lambda s, o, d, t, a: intersect.any_hit(s, o, d, t, a))

    t_ck, hk = timed(closest, scene, o, d, active, reps=reps)
    t_cp, hp = timed(closest, plain, o, d, active, reps=reps)
    t_ak, ak = timed(anyhit, scene, so, sd, s_tmax, s_active, reps=reps)
    t_ap, ap = timed(anyhit, plain, so, sd, s_tmax, s_active, reps=reps)

    tk, tp = np.asarray(hk.t), np.asarray(hp.t)
    ik, ip = np.asarray(hk.tri), np.asarray(hp.tri)
    both = (ik >= 0) & (ip >= 0)
    hit_agree = float(((ik >= 0) == (ip >= 0)).mean())
    tri_agree = float((ik == ip).mean())
    rel = np.abs(tk - tp) / np.maximum(np.abs(tp), 1e-30)
    same = both & (ik == ip)
    t_agree = float((rel[same] <= T_RTOL).mean()) if same.any() else 1.0

    def on_edge(h):
        u, v = np.asarray(h.u), np.asarray(h.v)
        return np.minimum(np.minimum(u, v), 1.0 - u - v) <= EDGE_EPS

    differ = both & (ik != ip)
    edge = (rel <= TIE_RTOL) | on_edge(hk) | on_edge(hp)
    differ_max = float(rel[differ].max()) if differ.any() else 0.0
    any_agree = float((np.asarray(ak) == np.asarray(ap)).mean())
    n = len(ik)
    check(f"{name} closest hit/miss", hit_agree >= MIN_AGREE,
          f"agree {hit_agree!r} over {n} lanes "
          f"({int(active.sum())} active, {int((ip >= 0).sum())} hits)")
    check(f"{name} closest triangle id", tri_agree >= MIN_AGREE,
          f"agree {tri_agree!r}")
    check(f"{name} closest t", t_agree >= MIN_AGREE,
          f"share within {T_RTOL} rel {t_agree!r}, max rel "
          f"{float(rel[same].max()) if same.any() else 0.0!r}")
    check(f"{name} differing triangles are edge cases",
          bool(edge[differ].all()),
          f"{int(differ.sum())} lanes, {int((differ & ~edge).sum())} "
          f"off-edge, max rel dt {differ_max!r}")
    check(f"{name} any-hit", any_agree >= MIN_AGREE,
          f"agree {any_agree!r} over {len(ak)} lanes "
          f"({int(np.asarray(ap).sum())} occluded)")
    res = {"closest_kernel_s": median(t_ck), "closest_plain_s": median(t_cp),
           "any_kernel_s": median(t_ak), "any_plain_s": median(t_ap)}
    log(f"TIME {name} closest per call: kernel {res['closest_kernel_s']!r} s"
        f" plain {res['closest_plain_s']!r} s ({n} lanes); any-hit: kernel "
        f"{res['any_kernel_s']!r} s plain {res['any_plain_s']!r} s "
        f"({len(ak)} lanes)")
    return res


def compare_frames(name: str, scene, lens, height: int, width: int, spp: int,
                   cfg, reps: int = 2) -> dict:
    """One whole frame through the public render path with each traversal:
    seconds per frame, and the images must agree."""
    import numpy as np

    from moonshine_tpu.render.camera import LensArrays
    from moonshine_tpu.render.renderer import render_spp

    la = LensArrays.from_lens(lens)
    frame = lambda s: render_spp(s, la, height, width, 0, spp, cfg)[0]
    t_k, img_k = timed(frame, scene, reps=reps)
    t_p, img_p = timed(frame, scene._replace(packed=None), reps=reps)
    a, b = np.asarray(img_k) / spp, np.asarray(img_p) / spp
    close = float(np.isclose(a, b, atol=FRAME_ATOL).mean())
    check(f"{name} frame kernel vs plain", np.isfinite(a).all() and
          close >= MIN_FRAME_CLOSE, f"close {close!r}, means "
          f"{float(a.mean())!r} / {float(b.mean())!r}")
    res = {"frame_kernel_s": median(t_k), "frame_plain_s": median(t_p)}
    log(f"TIME {name} frame {width}x{height} {spp} spp: kernel "
        f"{t_k!r} s plain {t_p!r} s")
    return res


def check_resort_identical(scene, lens, size: int = 128) -> None:
    """The per-bounce coherence resort reorders lanes only, so the image
    with it on and off must agree to the tolerance of
    tests/test_staged.py; whether it is bit-identical is logged. It is not
    always: the resorted program (a lane sort and prefix-shrunk bounces
    in conds) is fused differently, so XLA may contract other multiply-
    adds into FMAs (the H100 showed 1-ulp differences)."""
    import numpy as np

    from moonshine_tpu.integrator import PathConfig
    from moonshine_tpu.render.camera import LensArrays
    from moonshine_tpu.render.renderer import render_sample

    la = LensArrays.from_lens(lens)
    imgs = []
    for resort in (False, True):
        cfg = PathConfig(max_bounces=3, env_samples_per_bounce=1,
                         mesh_samples_per_bounce=1, resort_bounces=resort)
        imgs.append(np.asarray(render_sample(scene, la, size, size, 0,
                                             cfg)[0]))
    diff = float(np.abs(imgs[0] - imgs[1]).max())
    check("resort on/off images equal",
          np.allclose(imgs[0], imgs[1], rtol=1e-5, atol=1e-6),
          f"bit-identical {np.array_equal(imgs[0], imgs[1])}, max abs diff "
          f"{diff!r}, mean {float(imgs[0].mean())!r}")


def run_oracle_cases(device) -> None:
    """The small-scene oracle cases of tests/test_intersect.py, run with
    the entry point on `device`."""
    import test_intersect

    for case_id, fn, kwargs in test_intersect.CASES:
        fn(test_intersect.Impl("cuda", device), **kwargs)
        log(f"PASS  oracle {case_id}")


def phase_traversal(room=ROOM_184K, room_res=HD, flag_res=(512, 512),
                    frame_spp=1, resort_size=128, reps=3, oracle=True,
                    max_bounces=4, state=None) -> dict:
    import jax

    from __graft_entry__ import _flagship_scene
    from moonshine_tpu.integrator import PathConfig

    if oracle:
        run_oracle_cases(jax.devices()[0])
    world, scene, lens, build_s = build_room(**room)
    log(f"room {room}: {scene.num_tris} triangles, host build "
        f"{build_s!r} s")
    if state is not None:
        state["room"] = (world, scene, lens)
    flag, flag_lens = _flagship_scene()
    cfg = PathConfig(max_bounces=max_bounces, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    out = {}
    for name, sc, ln, (h, w) in (("room", scene, lens, room_res),
                                 ("flagship", flag, flag_lens, flag_res)):
        rays = bounce1_rays(sc, ln, h, w)
        out[name] = compare_traversal(f"{name} {w}x{h}", sc, rays, reps=reps)
        del rays
        out[name].update(compare_frames(f"{name}", sc, ln, h, w, frame_spp,
                                        cfg))
    check_resort_identical(flag, flag_lens, resort_size)
    log(f"traversal summary: {json.dumps(out)}")
    return out


# --------------------------------------------------------------- offline

def phase_offline(size: int = 512, spp: int = 16,
                  max_bounces: int | None = None) -> None:
    import numpy as np

    from glb_builder import cornell_box_glb
    from moonshine_tpu.io.exr import read_exr, write_exr
    from moonshine_tpu.render import offline

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        glb = tmp / "cornell.glb"
        glb.write_bytes(cornell_box_glb())
        sky = np.zeros((32, 64, 3), np.float32)
        sky[:] = np.linspace(2.0, 0.1, 32, dtype=np.float32)[:, None, None]
        sky[4:8, 10:16] = 40.0  # a sun patch for the env sampler
        write_exr(tmp / "sky.exr", sky)
        out = tmp / "out.exr"
        argv = [str(glb), str(tmp / "sky.exr"), str(out), "--spp", str(spp),
                "--width", str(size), "--height", str(size)]
        if max_bounces is not None:
            argv += ["--max-bounces", str(max_bounces)]
        t0 = time.perf_counter()
        rc = offline.main(argv)
        dt = time.perf_counter() - t0
        img = read_exr(out)
    check("offline CLI exit code", rc == 0, f"rc {rc!r}")
    check("offline EXR read back", img.shape[:2] == (size, size)
          and np.isfinite(img).all() and float(img[..., :3].mean()) > 0.0,
          f"shape {img.shape}, mean {float(img[..., :3].mean())!r}, "
          f"{dt!r} s in main()")


# --------------------------------------------------------------- furnace

def phase_furnace(size: int = 256, spp: int = 64, tol: float = 1e-3) -> None:
    """White furnace with russian roulette live (max_bounces=8; RR starts
    after bounce 3): every pixel's expectation is exactly 1, so the mean
    over ~4M paths must sit within 1e-3 of it (its noise is ~1e-4)."""
    import numpy as np

    from moonshine_tpu.integrator import PathConfig
    from moonshine_tpu.render.renderer import render
    from test_furnace import furnace_world, outside_lens

    scene = furnace_world(albedo=1.0).build()
    cfg = PathConfig(max_bounces=8, env_samples_per_bounce=0,
                     mesh_samples_per_bounce=0)
    t0 = time.perf_counter()
    sensor, rays = render(scene, outside_lens(), size, size, spp=spp, cfg=cfg)
    img = np.asarray(sensor.image)
    dt = time.perf_counter() - t0
    mean = float(img.mean())
    check("furnace mean == 1", abs(mean - 1.0) < tol,
          f"mean {mean!r} var {float(img.var())!r} ({size}x{size}, {spp} "
          f"spp, {rays!r} rays, {dt!r} s)")


# -------------------------------------------------------------- flagship

def channel_means(sum_img, spp: int):
    """Per-channel image mean and its standard error over pixels."""
    import numpy as np

    px = np.asarray(sum_img, np.float64).reshape(-1, 3) / spp
    return px.mean(axis=0), px.std(axis=0, ddof=1) / np.sqrt(len(px))


def phase_flagship(size: int = 128, spp: int = 8, other=None,
                   max_bounces=4) -> None:
    """The flagship rendered on the default device and on `other` (the
    CPU backend by default) with the same (sample, x, y)-keyed streams:
    per-channel means must agree within 3 standard errors."""
    import jax
    import numpy as np

    from __graft_entry__ import _flagship_scene
    from moonshine_tpu.integrator import PathConfig
    from moonshine_tpu.render.camera import LensArrays
    from moonshine_tpu.render.renderer import render_spp

    scene, lens = _flagship_scene()
    la = LensArrays.from_lens(lens)
    cfg = PathConfig(max_bounces=max_bounces, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    other = other or jax.devices("cpu")[0]
    img_a = np.asarray(render_spp(scene, la, size, size, 0, spp, cfg)[0])
    scene_b, la_b = jax.device_put((scene, la), other)
    with jax.default_device(other):
        img_b = np.asarray(render_spp(scene_b, la_b, size, size, 0, spp,
                                      cfg)[0])
    (ma, sa), (mb, sb) = channel_means(img_a, spp), channel_means(img_b, spp)
    z = np.abs(ma - mb) / np.sqrt(sa ** 2 + sb ** 2)
    check(f"flagship {jax.devices()[0].platform} vs {other.platform} means",
          np.isfinite(img_a).all() and bool((z <= 3.0).all()),
          f"means {ma.tolist()} / {mb.tolist()}, |diff|/se {z.tolist()}")


# ---------------------------------------------------------------- engine

def phase_engine(room=ROOM_184K, res=HD, frames: int = 3, max_bounces=4,
                 state=None) -> None:
    """room_184k through the Engine API at full size: progressive 1-spp
    frames on the staged path, a transform edit (refit), one more
    frame."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from moonshine_tpu.engine import Engine
    from moonshine_tpu.integrator import PathConfig
    from moonshine_tpu.integrator import path as path_mod
    from moonshine_tpu.render.camera import LensArrays
    from moonshine_tpu.render.renderer import _sample_rays, use_staged
    from moonshine_tpu.scene.types import translate

    if state is not None and "room" in state:
        world, _, lens = state.pop("room")
    else:
        from moonshine_tpu.scene.procedural import room_scene

        world, lens = room_scene(**room)
    h, w = res
    cfg = PathConfig(max_bounces=max_bounces, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    log(f"engine {w}x{h}: staged path {use_staged(h * w, cfg)}")
    eng = Engine(config=cfg)
    eng.world = world
    sensor = eng.create_sensor(w, h)
    lens_h = eng.create_lens(lens)
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        img = eng.render(sensor, lens_h)
        times.append(time.perf_counter() - t0)
    check("engine frames finite", np.isfinite(img).all()
          and float(img[..., :3].mean()) > 0.0,
          f"{frames} frames, seconds {times!r}, mean "
          f"{float(img[..., :3].mean())!r}, metrics {eng.metrics!r}")

    # transform edit: move one sphere instance (a refit, shapes unchanged)
    inst = next(i for i, it in enumerate(world.instances)
                if len(it.geometries) and not it.geometries[0].sampled)
    tf = np.asarray(world.instances[inst].transform, np.float32).copy()
    eng.set_instance_transform(inst, tf @ np.vstack(
        [translate(0.1, 0.0, 0.05), [0, 0, 0, 1]]).astype(np.float32))
    t0 = time.perf_counter()
    img = eng.render(sensor, lens_h)
    dt = time.perf_counter() - t0
    check("engine frame after transform edit", np.isfinite(img).all(),
          f"{dt!r} s, samples {eng.sample_count(sensor)}")

    # the staged bounce program at this size
    scene = world.build()
    o, d, rng = _sample_rays(LensArrays.from_lens(lens), h, w, 0, True)
    st = jax.jit(path_mod._init_state)(o, d, rng)
    compiled = path_mod._staged_bounce.lower(
        scene, st, jnp.asarray(1, jnp.int32), cfg=cfg, resort=False,
        last=False).compile()
    log(f"staged bounce memory_analysis: {compiled.memory_analysis()}")
    log(f"engine peak_bytes_in_use {peak_bytes()!r}")


# --------------------------------------------------------------- room_1m

def phase_room_1m(room=ROOM_1M, res=HD, max_bounces=4) -> None:
    import numpy as np

    from moonshine_tpu.integrator import PathConfig
    from moonshine_tpu.render.camera import LensArrays
    from moonshine_tpu.render.renderer import render_spp

    _, scene, lens, build_s = build_room(**room)
    h, w = res
    cfg = PathConfig(max_bounces=max_bounces, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    t0 = time.perf_counter()
    img, rays = render_spp(scene, LensArrays.from_lens(lens), h, w, 0, 1, cfg)
    img = np.asarray(img)
    dt = time.perf_counter() - t0
    check("room_1m frame", np.isfinite(img).all() and float(img.mean()) > 0,
          f"{scene.num_tris} triangles, build {build_s!r} s, first frame "
          f"{dt!r} s (compile included), {float(rays)!r} rays, peak "
          f"{peak_bytes()!r} bytes")


# ------------------------------------------------------------- instanced

def phase_instanced(size: int = 256, spp: int = 4) -> None:
    import numpy as np

    import test_tlas

    w = test_tlas.instanced_world(n=5, mirrored=True)
    ref = test_tlas.render(w.build(), size=size, spp=spp)
    scene = test_tlas.build_tlas_scene(
        test_tlas.instanced_world(n=5, mirrored=True))
    img = test_tlas.render(scene, size=size, spp=spp)
    close = float(np.isclose(img, ref, rtol=5e-3, atol=5e-3).mean())
    # the two structures intersect in different spaces (object vs world),
    # so t and frames differ by ulps that a 3-bounce render amplifies on
    # a few paths; same tolerance as tests/test_tlas.py
    check("TLAS image vs flattened", scene.tlas is not None
          and close > 0.995 and abs(img.mean() / ref.mean() - 1) < 2e-3,
          f"close {close!r}, means {float(img.mean())!r} / "
          f"{float(ref.mean())!r}")


# ------------------------------------------------------------------ four

MESHES = ((1, 4), (2, 2), (4, 1))


def phase_four(room=ROOM_184K, res=HD, spp: int = 4, meshes=MESHES,
               devices=None, max_bounces=4) -> None:
    """render_sharded on each (sp, dp) mesh against the one-card render
    of the same frame: equal up to f32 summation order."""
    import jax
    import numpy as np

    from moonshine_tpu.integrator import PathConfig
    from moonshine_tpu.parallel import make_mesh, render_sharded
    from moonshine_tpu.render.camera import LensArrays
    from moonshine_tpu.render.renderer import render_spp

    devices = devices or jax.devices()[:4]
    check("four devices", len(devices) == 4, f"{devices}")
    _, scene, lens, build_s = build_room(**room)
    la = LensArrays.from_lens(lens)
    h, w = res
    cfg = PathConfig(max_bounces=max_bounces, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)
    t0 = time.perf_counter()
    ref = np.asarray(render_spp(scene, la, h, w, 0, spp, cfg)[0]) / spp
    log(f"one-card {w}x{h} {spp} spp: {time.perf_counter() - t0!r} s "
        f"(compile included), build {build_s!r} s")
    for sp, dp in meshes:
        mesh = make_mesh(devices[:sp * dp], sp=sp)
        t0 = time.perf_counter()
        img, rays = render_sharded(scene, la, h, w, spp, cfg, mesh)
        img = np.asarray(img)
        dt = time.perf_counter() - t0
        diff = float(np.abs(img - ref).max())
        close = float(np.isclose(img, ref, rtol=1e-4, atol=1e-5).mean())
        mean_rel = abs(float(img.mean()) / float(ref.mean()) - 1.0)
        # the sp axis sums samples in another order (psum of per-shard
        # sums), and a shard small enough for the fused graph is compiled
        # as another program than the staged one-card frame, so XLA may
        # contract other multiply-adds into FMAs and an edge tie may send
        # a rare path elsewhere (MIN_FRAME_CLOSE)
        check(f"mesh sp={sp} dp={dp} vs one card",
              close >= MIN_FRAME_CLOSE and mean_rel <= 1e-4,
              f"close {close!r}, max abs diff {diff!r}, mean rel "
              f"{mean_rel!r}, {dt!r} s (compile included), "
              f"{float(rays)!r} rays")
        log("per-device peak_bytes_in_use " + ", ".join(
            f"{d.id}:{peak_bytes(d)!r}" for d in devices))


PHASES = {
    "traversal": phase_traversal,
    "offline": phase_offline,
    "furnace": phase_furnace,
    "flagship": phase_flagship,
    "engine": phase_engine,
    "room_1m": phase_room_1m,
    "instanced": phase_instanced,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded path")
    p.add_argument("--only", default=None,
                   help="comma-separated one-card phases to run "
                        f"({', '.join(PHASES)})")
    p.add_argument("--keep-going", action="store_true",
                   help="run the remaining phases after a failure (the "
                        "run still fails and prints no result)")
    args = p.parse_args(argv)

    # before JAX first reads its config
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                          str(ROOT / ".jax_cache"))
    device = phase_device()
    _repo_imports()
    t_start = time.perf_counter()
    if args.four:
        phase_four()
    else:
        names = args.only.split(",") if args.only else list(PHASES)
        unknown = set(names) - set(PHASES)
        if unknown:
            raise SystemExit(f"unknown phases {sorted(unknown)}")
        state, failed = {}, []
        for name in names:
            t0 = time.perf_counter()
            log(f"=== phase {name}")
            fn = PHASES[name]
            try:
                if name in ("traversal", "engine"):
                    fn(state=state)
                else:
                    fn()
            except Exception:
                if not args.keep_going:
                    raise
                traceback.print_exc()
                failed.append(name)
            log(f"=== phase {name} done in {time.perf_counter() - t0!r} s")
        if failed:
            log(f"FAILED phases: {', '.join(failed)}")
            return 1
    log(f"total {time.perf_counter() - t_start!r} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
