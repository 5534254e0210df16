"""Command-line renderer — the framework's batch front-end.

The reference has no CLI: its only config surface is scene.xml plus
compile-time constants (SURVEY.md §5 "Config"). This exposes those constants
as flags (resolution = ApplicationDelegate.cpp:24, max bounces =
PathTracing.h:216, the camera defaults of Camera.h:24-32) and adds what the
reference intended but never built: renders written to `runs/`
(`<root>/runs/.gitkeep`), progressive checkpoints, and resume.

Usage:
    python -m metalpathtracer_tpu.cli --scene scenes/cornell.xml \
        --width 512 --height 512 --spp 128 --output runs/cornell.png
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="metalpathtracer_tpu",
        description="Progressive Monte Carlo path tracer (JAX; CUDA BVH "
                    "walk on NVIDIA GPUs)",
    )
    p.add_argument("--scene", required=True, help="scene.xml path")
    p.add_argument("--width", type=int, default=1280)  # reference default
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=64, help="samples per pixel")
    p.add_argument("--max-depth", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default=None, help="output PNG (default runs/<scene>.png)")
    p.add_argument("--npz", default=None, help="also dump linear radiance npz")
    p.add_argument("--camera-pos", default="0,20,50", help="x,y,z (reference default)")
    p.add_argument("--camera-target", default=None, help="x,y,z look-at point")
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--intersector", default="auto",
                   choices=["auto", "bvh", "brute"],
                   help="closest-hit route (auto = the CUDA BVH walk on a "
                        "GPU, the plain-JAX traversal elsewhere; 'bvh' "
                        "forces the plain traversal, 'brute' the "
                        "exhaustive oracle)")
    p.add_argument("--nee", action="store_true", help="next-event estimation")
    p.add_argument("--rr-start", type=int, default=0,
                   help="first Russian-roulette bounce (0 = off)")
    p.add_argument("--clamp", action="store_true",
                   help="reference-faithful per-sample [0,1] clamp")
    p.add_argument("--spp-per-pass", type=int, default=None)
    p.add_argument("--wavefront", action="store_true",
                   help="persistent-wavefront integrator with lane "
                        "regeneration (fastest on open scenes)")
    p.add_argument("--pool-size", type=int, default=None,
                   help="wavefront lane-pool size (default: auto)")
    p.add_argument("--bounces-per-iter", type=int, default=1,
                   help="wavefront bounces per regeneration cycle")
    p.add_argument("--checkpoint", default=None,
                   help="progressive checkpoint path (save after each pass)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--checkpoint-every", type=int, default=16,
                   help="samples between checkpoint writes")
    p.add_argument("--tile-shard", action="store_true",
                   help="shard pixel tiles across all local devices")
    p.add_argument("--stats-json", action="store_true",
                   help="print a machine-readable stats line")
    return p


def _vec3(s: str):
    parts = [float(x) for x in s.split(",")]
    if len(parts) != 3:
        raise ValueError(f"expected x,y,z got {s!r}")
    return tuple(parts)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # import here so --help stays fast and backend env vars can be set first
    import numpy as np

    from metalpathtracer_tpu.utils import enable_persistent_compile_cache

    # without this a fresh process pays the full XLA compile of the
    # wavefront program on every invocation
    enable_persistent_compile_cache()

    from metalpathtracer_tpu.io import save_checkpoint, load_checkpoint, write_png
    from metalpathtracer_tpu.render import (
        Camera,
        RenderConfig,
        accumulate,
        init_accum,
        render_image,
        to_image,
        upload_scene,
    )
    from metalpathtracer_tpu.scene import load_scene_xml

    host = load_scene_xml(args.scene)
    print(
        f"Scene loaded: {host.primitive_count} primitives "
        f"({host.primitive_count - host.triangle_count} spheres, "
        f"{host.triangle_count} triangles)",
        file=sys.stderr,
    )
    t0 = time.time()
    scene = upload_scene(host)
    print(
        f"BVH: {scene.node_a.shape[0]} nodes, depth {scene.max_depth}, "
        f"built+uploaded in {time.time() - t0:.2f}s",
        file=sys.stderr,
    )

    pos = _vec3(args.camera_pos)
    if args.camera_target is not None:
        cam = Camera.look_at(pos, _vec3(args.camera_target), vfov_deg=args.fov)
    else:
        import dataclasses
        import jax.numpy as jnp

        cam = dataclasses.replace(
            Camera.reset(),
            position=jnp.asarray(np.asarray(pos, np.float32)),
            vfov_deg=jnp.float32(args.fov),
        )

    cfg = RenderConfig(
        max_depth=args.max_depth,
        intersector=args.intersector,
        clamp_radiance=args.clamp,
        rr_start=args.rr_start,
        nee=args.nee,
        bounces_per_iter=args.bounces_per_iter,
    )

    output = args.output
    if output is None:
        base = os.path.splitext(os.path.basename(args.scene))[0]
        os.makedirs("runs", exist_ok=True)
        output = os.path.join("runs", f"{base}.png")

    t0 = time.time()
    if args.tile_shard:
        if args.wavefront:
            from metalpathtracer_tpu.parallel import render_image_wavefront_sharded

            img, rays = render_image_wavefront_sharded(
                scene, cam, args.width, args.height, args.spp,
                seed=args.seed, cfg=cfg, pool_size=args.pool_size,
            )
        else:
            from metalpathtracer_tpu.parallel import render_image_sharded

            img, rays = render_image_sharded(
                scene, cam, args.width, args.height, args.spp,
                seed=args.seed, cfg=cfg,
            )
        img = np.asarray(img)
    elif args.checkpoint:
        import hashlib

        import jax.numpy as jnp

        # fingerprint the run: resuming with a different scene/camera/config
        # would silently blend two renders into one accumulation (ADVICE r1)
        with open(args.scene, "rb") as f:
            scene_sha = hashlib.sha256(f.read()).hexdigest()[:16]
        fingerprint = {
            "scene_sha": scene_sha,
            "size": f"{args.width}x{args.height}",
            "camera": f"{args.camera_pos}|{args.camera_target}|{args.fov}",
            "cfg": repr(cfg),
        }
        state = init_accum(args.width, args.height)
        run_seed = args.seed
        if args.resume and os.path.exists(args.checkpoint):
            state, run_seed, meta = load_checkpoint(args.checkpoint)
            mismatches = [
                f"  {k}: checkpoint={meta[k]!s} run={v}"
                for k, v in fingerprint.items()
                if k in meta and str(meta[k]) != v
            ]
            if mismatches:
                print(
                    f"error: checkpoint {args.checkpoint} was written by a "
                    "different run; refusing to blend accumulations:\n"
                    + "\n".join(mismatches),
                    file=sys.stderr,
                )
                return 2
            if not meta:
                print("warning: checkpoint has no fingerprint (old format); "
                      "cannot validate it matches this run", file=sys.stderr)
            # the checkpoint's seed wins: mixing seeds across the resume
            # boundary would break the bit-identical-resume contract
            print(f"resumed at {int(state.spp)} spp (seed {run_seed})",
                  file=sys.stderr)
        while int(state.spp) < args.spp:
            k = min(args.checkpoint_every, args.spp - int(state.spp))
            state = accumulate(
                state, scene, cam, args.width, args.height, k,
                jnp.uint32(run_seed & 0xFFFFFFFF), cfg,
            )
            save_checkpoint(args.checkpoint, state, run_seed, meta=fingerprint)
            print(f"checkpoint at {int(state.spp)}/{args.spp} spp", file=sys.stderr)
        img = np.asarray(to_image(state, clamp=False))
        rays = None
    elif args.wavefront:
        from metalpathtracer_tpu.render import render_image_wavefront

        img, rays = render_image_wavefront(
            scene, cam, args.width, args.height, args.spp,
            seed=args.seed, cfg=cfg, pool_size=args.pool_size,
        )
        img = np.asarray(img)
    else:
        img, rays = render_image(
            scene, cam, args.width, args.height, args.spp,
            seed=args.seed, cfg=cfg, spp_per_pass=args.spp_per_pass,
        )
        img = np.asarray(img)
    dt = time.time() - t0

    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    write_png(output, img)
    if args.npz:
        np.savez_compressed(args.npz, radiance=img, spp=args.spp, seed=args.seed)

    stats = {
        "output": output,
        "width": args.width,
        "height": args.height,
        "spp": args.spp,
        "seconds": round(dt, 3),
        "spp_per_sec": round(args.spp / dt, 3),
    }
    if rays is not None:
        stats["rays"] = int(rays)
        stats["mrays_per_sec"] = round(rays / dt / 1e6, 3)
    print(
        f"wrote {output}: {args.width}x{args.height} @ {args.spp} spp in {dt:.2f}s"
        + (f" ({stats['mrays_per_sec']} Mrays/s)" if rays is not None else ""),
        file=sys.stderr,
    )
    if args.stats_json:
        print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
