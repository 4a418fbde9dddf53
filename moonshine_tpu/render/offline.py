"""Offline (headless) renderer CLI.

Parity target: the `offline` frontend (offline/main.zig:80-203):
`moonshine-offline scene.glb skybox.exr out.exr [--spp N]` renders at
1280x720 by default with max_bounces 1024, printing per-phase timings like
the reference's IntervalLogger (offline/main.zig:59-76).

Run as `python -m moonshine_tpu.render.offline ...`.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..integrator import PathConfig
from ..io.exr import read_exr, write_exr
from ..scene.gltf import lens_from_glb, world_from_glb
from .renderer import render


class IntervalLogger:
    """Phase timing (offline/main.zig:59-76)."""

    def __init__(self):
        self.t = time.monotonic()

    def log(self, phase: str):
        now = time.monotonic()
        print(f"{phase}: {now - self.t:.3f}s", flush=True)
        self.t = now


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="moonshine-offline",
        description="headless path tracer",
    )
    p.add_argument("glb", help="binary glTF scene")
    p.add_argument("skybox", help="equirectangular EXR environment map")
    p.add_argument("out", help="output EXR path")
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--max-bounces", type=int, default=1024)
    p.add_argument("--env-samples", type=int, default=1)
    p.add_argument("--mesh-samples", type=int, default=1)
    p.add_argument(
        "--mesh", default=None, metavar="SP,DP",
        help="render on a multi-chip device mesh: 'auto' (all devices) or "
             "'SP,DP' sample/row shard counts (e.g. '2,4'); height must "
             "divide by DP and spp by SP",
    )
    args = p.parse_args(argv)

    timer = IntervalLogger()

    world = world_from_glb(args.glb)
    lens = lens_from_glb(args.glb)
    sky = read_exr(args.skybox)
    world.set_background(sky[..., :3])
    timer.log("load scene")

    scene = world.build()
    timer.log("build device scene (BVH + atlas + envmap)")

    cfg = PathConfig(
        max_bounces=args.max_bounces,
        env_samples_per_bounce=args.env_samples,
        mesh_samples_per_bounce=args.mesh_samples,
    )
    if args.mesh:
        from ..parallel import mesh_from_spec, render_sharded
        from .camera import LensArrays

        mesh = mesh_from_spec(args.mesh)
        image, rays = render_sharded(
            scene, LensArrays.from_lens(lens), args.height, args.width,
            args.spp, cfg, mesh,
        )
        image = np.asarray(image)
        timer.log(
            f"render {args.spp} spp on mesh sp={mesh.shape['sp']} "
            f"dp={mesh.shape['dp']} ({float(rays)/1e6:.1f} Mrays)"
        )
    else:
        sensor, rays = render(
            scene, lens, args.height, args.width, spp=args.spp, cfg=cfg
        )
        image = np.asarray(sensor.image)  # blocks until device work completes
        timer.log(f"render {args.spp} spp ({rays/1e6:.1f} Mrays)")

    write_exr(args.out, image)
    timer.log("write exr")
    return 0


if __name__ == "__main__":
    sys.exit(main())
