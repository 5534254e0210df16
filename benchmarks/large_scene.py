"""Large-scene stress: the production closest-hit route on big scenes.

Renders a random triangle cloud (or a scene preset) at the given scale
through the wavefront integrator and prints Mrays/s, the BVH's size and
depth, and whether the image is finite. BVH build and upload are set-up
time and reported apart.

Usage: python benchmarks/large_scene.py [--tris 1000000] [--spp 2]
           [--preset reference_bunny300k] [--intersector auto|bvh] ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tris", type=int, default=1_000_000)
    ap.add_argument("--preset", default=None,
                    help="use a scene preset (e.g. reference_bunny70k) "
                    "instead of a random cloud")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--pool", type=int, default=15, help="log2 pool size")
    ap.add_argument("--intersector", default="auto", choices=("auto", "bvh"))
    args = ap.parse_args()

    import jax

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from metalpathtracer_tpu.utils import enable_persistent_compile_cache

    enable_persistent_compile_cache()

    from metalpathtracer_tpu.render import (
        Camera,
        render_image_wavefront,
        upload_scene,
    )
    from metalpathtracer_tpu.render.integrator import RenderConfig
    from metalpathtracer_tpu.scene import presets

    t0 = time.perf_counter()
    if args.preset:
        host = getattr(presets, args.preset)()
        args.tris = -1  # reported from the scene below
    else:
        host = presets.random_tri_cloud(args.tris, seed=1)
    scene = upload_scene(host)
    print(
        f"scene: {args.tris} tris built+uploaded in "
        f"{time.perf_counter() - t0:.1f}s; BVH {scene.node_a.shape[0]} "
        f"nodes, depth {scene.max_depth}",
        file=sys.stderr,
    )

    if args.preset:
        camera = Camera.reset()  # the reference scene's default view
    else:
        camera = Camera.look_at((0, 0, 28), (0, 0, 0), vfov_deg=55.0)
    cfg = RenderConfig(
        max_depth=args.depth, bounces_per_iter=1, intersector=args.intersector
    )

    t0 = time.perf_counter()
    img, rays = render_image_wavefront(
        scene, camera, args.width, args.height, args.spp, seed=0, cfg=cfg,
        pool_size=1 << args.pool,
    )
    jax.block_until_ready(img)
    compile_s = time.perf_counter() - t0

    best = 0.0
    for rep in range(2):
        t0 = time.perf_counter()
        img, rays = render_image_wavefront(
            scene, camera, args.width, args.height, args.spp, seed=rep + 1,
            cfg=cfg, pool_size=1 << args.pool,
        )
        jax.block_until_ready(img)
        best = max(best, rays / (time.perf_counter() - t0) / 1e6)

    import numpy as np

    a = np.asarray(img)
    print(
        json.dumps(
            dict(
                tris=args.tris,
                device=jax.devices()[0].device_kind,
                mrays=round(best, 3),
                intersector=args.intersector,
                compile_s=round(compile_s, 1),
                mean=float(a.mean()),
                finite=bool(np.isfinite(a).all()),
            )
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
