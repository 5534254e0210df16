"""One timed wavefront render with CLI-selected settings — the sweep unit.

Env knobs of the integrator (MPT_*) bind at import time, so sweep them in
fresh processes and compare the printed Mrays/s. `--ab-sort` instead
compares `RenderConfig.sort_lanes` off and on inside one process, in turns
(off, on, on, off), so both run on the same card.

Usage: python benchmarks/perf_probe.py [--pool LOG2] [--bpi N] [--spp N]
           [--depth N] [--scene PATH] [--intersector auto|bvh|brute]
           [--no-sort] [--ab-sort] [--tag STR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sort", action=argparse.BooleanOptionalAction,
                    default=True, help="cfg.sort_lanes (default on)")
    ap.add_argument("--ab-sort", action="store_true",
                    help="time sort_lanes off and on in turns")
    ap.add_argument("--intersector", default="auto",
                    choices=("auto", "bvh", "brute"))
    ap.add_argument("--pool", type=int, default=15, help="log2 pool size")
    ap.add_argument("--bpi", type=int, default=1)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=32)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--scene", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    import jax

    from metalpathtracer_tpu.render import (
        Camera,
        render_image_wavefront,
        upload_scene,
    )
    from metalpathtracer_tpu.render.integrator import RenderConfig
    from metalpathtracer_tpu.scene import load_scene_xml
    from metalpathtracer_tpu.utils import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    dev = jax.devices()[0]
    scene_path = args.scene or os.path.join(repo, "scenes", "reference.xml")
    scene = upload_scene(load_scene_xml(scene_path))
    camera = Camera.reset()

    def cfg_for(sort):
        return RenderConfig(max_depth=args.depth, bounces_per_iter=args.bpi,
                            sort_lanes=sort, intersector=args.intersector)

    def run(cfg):
        kw = dict(spp=args.spp, cfg=cfg, pool_size=1 << args.pool)
        best = 0.0
        for rep in range(args.reps):
            t0 = time.perf_counter()
            img, rays = render_image_wavefront(
                scene, camera, args.width, args.height, seed=rep + 1, **kw
            )
            jax.block_until_ready(img)
            best = max(best, rays / (time.perf_counter() - t0) / 1e6)
        return best, float(img.mean())

    order = [False, True, True, False] if args.ab_sort else [args.sort]
    compile_s = {}
    for sort in set(order):  # warm up (compile) every variant first
        t0 = time.perf_counter()
        run_cfg = cfg_for(sort)
        img, _ = render_image_wavefront(scene, camera, args.width,
                                        args.height, seed=0, spp=args.spp,
                                        cfg=run_cfg,
                                        pool_size=1 << args.pool)
        jax.block_until_ready(img)
        compile_s[sort] = round(time.perf_counter() - t0, 2)
    rows = []
    for sort in order:
        mrays, mean = run(cfg_for(sort))
        rows.append(dict(sort_lanes=sort, mrays=mrays, mean=mean))
        print(f"sort_lanes={sort}: {mrays:.3f} Mrays/s", file=sys.stderr)
    print(json.dumps(dict(
        tag=args.tag, device=dev.device_kind, intersector=args.intersector,
        pool=args.pool, bpi=args.bpi, spp=args.spp, depth=args.depth,
        size=f"{args.width}x{args.height}", scene=os.path.basename(scene_path),
        first_call_s={str(k): v for k, v in compile_s.items()}, runs=rows,
        env={k: v for k, v in os.environ.items() if k.startswith("MPT_")},
    )))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
