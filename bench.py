"""Benchmark: path-tracing throughput of the flagship scene on one GPU.

Renders the flagship procedural scene (Cornell-style box, mirror/glass/PBR
spheres, emissive area light, textured floor — every material and NEE path
live) at 512x512, 8 spp per dispatch, and reports Mrays/s. Each timed run
is paired with the rays it traced. Exits non-zero without a GPU.

Prints exactly one JSON line.
"""

import json
import os
import pathlib
import sys
import time

# persistent XLA compile cache (jax honors this env var)
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    str(pathlib.Path(__file__).resolve().parent / ".jax_cache"),
)


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1

    from __graft_entry__ import _flagship_scene
    from moonshine_tpu.integrator.path import PathConfig
    from moonshine_tpu.render.camera import LensArrays
    from moonshine_tpu.render.renderer import render_spp

    scene, lens = _flagship_scene()
    lens_arrays = LensArrays.from_lens(lens)
    H, W = 512, 512
    cfg = PathConfig(
        max_bounces=4, env_samples_per_bounce=1, mesh_samples_per_bounce=1
    )
    n_samples = 8

    def run(start):
        # one device dispatch for all spp
        return render_spp(scene, lens_arrays, H, W, start, n_samples, cfg)

    # warmup + compile
    acc, rays = run(0)
    acc.block_until_ready()

    runs = []  # (seconds, rays traced) per timed dispatch
    for i in range(3):
        t0 = time.perf_counter()
        acc, rays = run((i + 1) * n_samples)
        acc.block_until_ready()
        runs.append((time.perf_counter() - t0, float(rays)))

    rates = [r / dt / 1e6 for dt, r in runs]
    result = {
        "metric": "Mrays/sec/chip",
        "value": rates[0],
        "unit": "Mrays/s",
        "runs_s": [dt for dt, _ in runs],
        "mrays_per_run": rates,
        "mrays_best": max(rates),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
