"""1080p staged-path measurement.

Renders the 184k-triangle room interior at 512x512 (fused dispatch) and
1920x1080 (staged per-bounce path) and reports Mrays/s + spp/s for both:
per-ray throughput at 1080p should stay close to the 512^2 rate.
"""

import os as _os
import pathlib as _pl
_os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    str(_pl.Path(__file__).resolve().parent.parent / ".jax_cache"))


import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tests"))

import jax

from moonshine_tpu.integrator import PathConfig
from moonshine_tpu.render.camera import LensArrays
from moonshine_tpu.render.renderer import render_spp
from moonshine_tpu.scene.procedural import room_scene


def measure(scene, la, h, w, spp, cfg):
    img, rays = render_spp(scene, la, h, w, 0, spp, cfg)
    img.block_until_ready()
    t0 = time.perf_counter()
    img, rays = render_spp(scene, la, h, w, spp, spp, cfg)
    img.block_until_ready()
    dt = time.perf_counter() - t0
    return float(rays) / dt / 1e6, spp / dt


def main(argv=None):
    # each resolution runs in its own subprocess, so neither inherits
    # the other's compiled variants or memory
    import argparse
    import subprocess

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["512", "1080"], default=None)
    args = ap.parse_args(argv)

    if args.only is None:
        failed = False
        here = str(pathlib.Path(__file__).resolve())
        for rung in ("512", "1080"):
            proc = subprocess.run(
                [sys.executable, here, "--only", rung],
                capture_output=True, text=True, timeout=3600)
            for ln in proc.stdout.splitlines():
                if ln.startswith("{"):
                    print(ln, flush=True)
            if proc.returncode:
                print(f"[{rung}] FAILED:\n{proc.stderr[-1500:]}", flush=True)
                failed = True
        return 1 if failed else 0

    world, lens = room_scene(grid=6, subdivisions=4)
    scene = world.build()
    la = LensArrays.from_lens(lens)
    cfg = PathConfig(max_bounces=4, env_samples_per_bounce=1,
                     mesh_samples_per_bounce=1)

    if args.only == "512":
        m512, s512 = measure(scene, la, 512, 512, 3, cfg)
        print(json.dumps({"res": "512x512", "mrays_per_sec": round(m512, 3),
                          "spp_per_sec": round(s512, 3)}), flush=True)
    else:
        m1080, s1080 = measure(scene, la, 1080, 1920, 2, cfg)
        print(json.dumps({"res": "1920x1080",
                          "mrays_per_sec": round(m1080, 3),
                          "spp_per_sec": round(s1080, 4)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
