"""Config-ladder benchmark (BASELINE.md): runs each rung on the attached
GPU and prints a table + JSON lines. bench.py stays the single-line
flagship metric; this is the detailed view.

By default every rung runs in its own process (`--only` is the
single-rung worker mode), so no rung inherits another's compiled variants
or memory. The `flagship` rung runs bench.py itself. A rung that fails
fails the run.

Usage: python scripts/bench_ladder.py [--quick] [--full] [--only RUNG]
  --quick  2 spp per rung instead of 6
  --full   adds the ~1M-triangle room rung (BASELINE.md rung 4 scale)
  --only   run a single rung in THIS process (worker mode / A/B runs)
"""

import os as _os
import pathlib as _pl
_os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    str(_pl.Path(__file__).resolve().parent.parent / ".jax_cache"))


import argparse
import json
import sys
import time

import numpy as np


def device_mem_mb():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use") or stats.get("bytes_in_use") or 0
    return round(peak / 1e6, 1)


def run_rung(name, scene, lens, size, spp, cfg, build_seconds=None):
    import jax.numpy as jnp
    from moonshine_tpu.render.camera import LensArrays
    from moonshine_tpu.render.renderer import render_spp

    la = LensArrays.from_lens(lens)
    h, w = size
    # one device dispatch for all spp (same protocol as bench.py)
    img, rays = render_spp(scene, la, h, w, 0, spp, cfg)
    img.block_until_ready()
    t0 = time.perf_counter()
    img, rays = render_spp(scene, la, h, w, spp, spp, cfg)
    img.block_until_ready()
    total_rays = float(rays)
    dt = time.perf_counter() - t0
    result = {
        "rung": name,
        "tris": scene.num_tris,
        "resolution": f"{w}x{h}",
        "spp_timed": spp,
        "mrays_per_sec": round(total_rays / dt / 1e6, 3),
        "spp_per_sec": round(spp / dt, 3),
        "seconds_per_spp": round(dt / spp, 4),
    }
    if build_seconds is not None:
        result["build_seconds"] = round(build_seconds, 2)
        result["peak_device_mb"] = device_mem_mb()
    print(json.dumps(result), flush=True)
    return result


RUNGS = ["furnace", "cornell", "mirror_glass", "room_184k"]


def orchestrate(args):
    """Fresh-process ladder: one subprocess per rung + bench.py flagship."""
    import subprocess

    here = _pl.Path(__file__).resolve()
    root = here.parent.parent
    rungs = list(RUNGS) + (["room_1m"] if args.full else [])
    results = []
    failed = []
    for rung in rungs:
        cmd = [sys.executable, str(here), "--only", rung]
        if args.quick:
            cmd.append("--quick")
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=str(root), timeout=3600)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("{")), None)
        if proc.returncode or line is None:
            print(f"[{rung}] FAILED:\n{proc.stdout}\n{proc.stderr[-2000:]}",
                  flush=True)
            failed.append(rung)
            continue
        r = json.loads(line)
        print(json.dumps(r), flush=True)
        results.append(r)
    # flagship row = the driver's own bench.py, verbatim, fresh process
    proc = subprocess.run([sys.executable, str(root / "bench.py")],
                          capture_output=True, text=True, cwd=str(root),
                          timeout=3600)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("{")), None)
    if proc.returncode == 0 and line is not None:
        b = json.loads(line)
        r = {"rung": "flagship(bench.py)", "tris": 964,
             "resolution": "512x512",
             "mrays_per_sec": b["value"],
             "spp_per_sec": None}
        print(json.dumps(r), flush=True)
        results.append(r)
    else:
        print(f"[flagship] bench.py FAILED:\n{proc.stderr[-2000:]}",
              flush=True)
        failed.append("flagship")

    print("\nrung               tris      Mrays/s   spp/s @res")
    for r in results:
        spp_s = (f"{r['spp_per_sec']:>8.2f}"
                 if r.get("spp_per_sec") is not None else "       -")
        print(f"{r['rung']:<18} {r['tris']:>8} {r['mrays_per_sec']:>8.2f}"
              f" {spp_s} @{r['resolution']}")
    if failed:
        print(f"FAILED rungs: {', '.join(failed)}", flush=True)
        return 1
    return 0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--full", action="store_true")
    p.add_argument("--only", default=None)
    args = p.parse_args(argv)
    if args.only is None:
        return orchestrate(args)
    spp = 2 if args.quick else 6

    def want(name):
        return args.only is None or args.only == name

    import pathlib

    import jax

    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "tests"))
    from fixtures import icosphere
    from glb_builder import cornell_box_glb
    from moonshine_tpu.integrator import PathConfig
    from moonshine_tpu.scene import gltf
    from moonshine_tpu.scene.procedural import room_scene
    from moonshine_tpu.scene.types import (
        Geometry, Glass, Instance, Lambert, Lens, MaterialInfo, Mesh,
        Mirror, identity_transform, translate,
    )
    from moonshine_tpu.scene.world import World

    results = []
    lens = Lens(origin=np.float32([0, -3, 0]), forward=np.float32([0, 1, 0]),
                up=np.float32([0, 0, 1]), vfov=np.pi / 4)

    # 1. furnace
    if want("furnace"):
        w = World()
        mesh = w.add_mesh(icosphere(3, with_normals=False))
        mat = w.add_material(MaterialInfo(variant=Lambert(color=(1, 1, 1))))
        w.add_instance(Instance(transform=identity_transform(),
                                geometries=[Geometry(mesh, mat)]))
        w.set_background(None)
        results.append(run_rung(
            "furnace", w.build(), lens, (256, 256), spp,
            PathConfig(max_bounces=16, env_samples_per_bounce=0,
                       mesh_samples_per_bounce=0, unroll=False),
        ))

    # 2. cornell box (NEE + MIS)
    if want("cornell"):
        world = gltf.world_from_glb(cornell_box_glb())
        world.set_background(np.zeros((4, 8, 3), np.float32))
        clens = gltf.lens_from_glb(cornell_box_glb())
        results.append(run_rung(
            "cornell", world.build(), clens, (512, 512), spp,
            PathConfig(max_bounces=4, env_samples_per_bounce=0,
                       mesh_samples_per_bounce=1),
        ))

    # 3. mirror + glass spheres under an HDR gradient env
    if want("mirror_glass"):
        w = World()
        sphere = w.add_mesh(icosphere(4))
        floor = w.add_mesh(Mesh(
            positions=np.float32([[-20, -20, -1], [20, -20, -1],
                                  [20, 20, -1], [-20, 20, -1]]),
            indices=np.uint32([[0, 1, 2], [0, 2, 3]])))
        mats = [w.add_material(MaterialInfo(variant=Mirror())),
                w.add_material(MaterialInfo(variant=Glass(ior=1.5))),
                w.add_material(MaterialInfo(variant=Lambert(color=(0.6, 0.6, 0.6))))]
        for x, m in [(-1.5, 0), (1.5, 1)]:
            w.add_instance(Instance(transform=translate(x, 0, 0),
                                    geometries=[Geometry(sphere, mats[m])]))
        w.add_instance(Instance(transform=identity_transform(),
                                geometries=[Geometry(floor, mats[2])]))
        sky = np.zeros((64, 128, 3), np.float32)
        sky[:, :, :] = 0.2
        sky[8:16, 20:40] = 12.0  # bright "sun" patch: alias-table stress
        w.set_background(sky, size=64)
        results.append(run_rung(
            "mirror_glass", w.build(), lens, (512, 512), spp,
            PathConfig(max_bounces=8, env_samples_per_bounce=1,
                       mesh_samples_per_bounce=0),
        ))

    # 4. big interior (Salle-de-bain-class stand-in)
    if want("room_184k"):
        world, rlens = room_scene(grid=6, subdivisions=4)
        results.append(run_rung(
            "room_184k", world.build(), rlens, (512, 512), max(spp // 2, 1),
            PathConfig(max_bounces=4, env_samples_per_bounce=1,
                       mesh_samples_per_bounce=1),
        ))

    # 5. ~1M-triangle proof (BASELINE.md rung 4 scale; --full only: the
    # host BVH build takes a few minutes)
    if (args.full or args.only == "room_1m") and want("room_1m"):
        world, rlens = room_scene(grid=7, subdivisions=5)
        t0 = time.perf_counter()
        scene = world.build()
        jax.block_until_ready(scene)
        build_s = time.perf_counter() - t0
        results.append(run_rung(
            "room_1m", scene, rlens, (512, 512), max(spp // 2, 1),
            PathConfig(max_bounces=4, env_samples_per_bounce=1,
                       mesh_samples_per_bounce=1),
            build_seconds=build_s,
        ))

    print("\nrung            tris      Mrays/s   spp/s @res")
    for r in results:
        print(f"{r['rung']:<15} {r['tris']:>8} {r['mrays_per_sec']:>8.2f}"
              f" {r['spp_per_sec']:>8.2f} @{r['resolution']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
