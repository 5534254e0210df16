#!/usr/bin/env python3
"""Smoke test of the path tracer on one NVIDIA GPU.

Drives the main path once, through the entry points a user calls, at the
sizes the repository benchmarks (the reference scene at 1280x720, depth 32,
spp 4; the 79k- and 318k-triangle bunny scenes at 512^2, depth 8, spp 2),
checks every result against the plain references, and prints as its last
line

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases, all in this one process (a second JAX process could not reserve
the card's memory):

  1. device        the platform is "gpu"; the card's name and power limit
  2. build         `make -C native`; compile the production closest hit at
                   the flagship's 921,600 rays, print its memory analysis
  3. oracle        production route vs `closest_hit_bruteforce` on three
                   ray sets
  4. kernel-vs-xla the CUDA walk vs XLA's `closest_hit_bvh`, alone (on
                   primary rays, one bounce, and masked occlusion queries
                   bounded by `t_max`) and end to end; the tests marked
                   `gpu` make the checks of phases 3 and 4 at small size
  5. main path     `cli --wavefront` on the flagship, the two bunny scenes,
                   8 frames of `pipeline.accumulate` at 720p and 1 spp, a
                   bit-exact checkpoint resume
  6. image         the flagship rendered by the production route and by
                   the brute-force oracle agree, as shipped and with NEE
                   (so shadow rays) and Russian roulette

    python chip_smoke.py              # phases 1-6 on one card
    python chip_smoke.py --multi-gpu  # only the four-card phase

It exits non-zero, without the result line, when JAX finds no GPU or any
phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = dict(width=1280, height=720, spp=4, depth=32)
BUNNY = dict(width=512, height=512, spp=2, depth=8)
# BASELINE config 5: scenes/multimesh.xml at 1080p, depth 8
MULTI = dict(width=1920, height=1080, spp=4, depth=8)
# image check (phase 6): mean radiance within 0.5%, and at most 0.5% of
# pixels differing by more than 1e-3 (one flipped hit changes a whole path)
IMAGE_MEAN_RTOL = 5e-3
IMAGE_PIXEL_ATOL = 1e-3
IMAGE_MAX_DIFF_FRAC = 5e-3
# the render options of BASELINE config 4 (benchmarks/run_configs.py):
# next-event estimation, whose shadow rays are the production route's
# occlusion queries, and Russian roulette from bounce 3
NEE = dict(nee=True, rr_start=3)


class PhaseError(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def best_time(fn, *args, reps=5):
    """(best seconds over `reps` calls after one warm-up, last output)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def flagship_scene():
    from metalpathtracer_tpu.render import upload_scene
    from metalpathtracer_tpu.scene import load_scene_xml

    return upload_scene(load_scene_xml(os.path.join(REPO, "scenes",
                                                    "reference.xml")))


def primary_rays(width, height):
    import jax
    import jax.numpy as jnp

    from metalpathtracer_tpu.core import rng
    from metalpathtracer_tpu.render import Camera, generate_rays

    pix = jnp.arange(width * height, dtype=jnp.uint32)
    gen = jax.jit(generate_rays, static_argnums=(1, 2))
    return gen(Camera.reset(), width, height, pix, jnp.uint32(0),
               rng.seed_from_int(0))


def scattered_rays(scene, o, d):
    """One diffuse bounce off the primary hits: (o, d, active)."""
    import jax
    import jax.numpy as jnp

    from metalpathtracer_tpu.core import rng, vecmath as vm
    from metalpathtracer_tpu.render.integrator import closest_hit
    from metalpathtracer_tpu.render.intersect import surface_interaction_packed

    @jax.jit
    def bounce(scene, o, d):
        t, idx = closest_hit(scene, o, d)
        hit = idx >= 0
        geom = scene.geom_table[jnp.maximum(idx, 0)]
        point, normal, _ = surface_interaction_packed(
            geom, o, d, jnp.where(hit, t, 0.0))
        n = o.shape[0]
        u = rng.random_unit_vector(rng.seed_from_int(1),
                                   jnp.arange(n, dtype=jnp.uint32),
                                   jnp.uint32(0), 1)
        d2 = vm.normalize(normal + u)
        scale = jnp.maximum(1.0, jnp.max(jnp.abs(point), axis=-1))
        o2 = point + (1e-4 * scale)[:, None] * normal
        return o2, d2, hit

    return bounce(scene, o, d)


# ---------------------------------------------------------------- phases


def phase_device():
    import jax

    dev = jax.devices()[0]
    require(dev.platform == "gpu",
            f"no GPU: JAX's first device is {dev.platform}")
    say(f"[1 device] {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    say(f"[1 device] nvidia-smi: {card_name_and_power()}")
    return dev


def phase_build(scene, o, d):
    import jax

    from metalpathtracer_tpu.render import hit_cuda
    from metalpathtracer_tpu.render.integrator import closest_hit

    t0 = time.perf_counter()
    proc = subprocess.run(
        ["make", "-C", os.path.join(REPO, "native"), f"PYTHON={sys.executable}"],
        capture_output=True, text=True,
    )
    require(proc.returncode == 0, f"make -C native failed:\n{proc.stdout}\n"
            f"{proc.stderr}")
    say(f"[2 build] make -C native: {time.perf_counter() - t0:.2f} s")
    hit_cuda.load_library()

    t0 = time.perf_counter()
    compiled = jax.jit(closest_hit).lower(scene, o, d).compile()
    say(f"[2 build] closest hit compiled for {o.shape[0]} rays in "
        f"{time.perf_counter() - t0:.2f} s")
    say(f"[2 build] memory analysis: {compiled.memory_analysis()}")


def phase_oracle(scene, o, d):
    import jax.numpy as jnp
    import numpy as np

    from oracle_check import check, ray_batch

    from metalpathtracer_tpu.render import upload_scene
    from metalpathtracer_tpu.scene import presets
    from metalpathtracer_tpu.scene.types import PRIM_TRIANGLE

    results = []
    rng_np = np.random.default_rng(11)
    bo, bd = ray_batch(4096, -2.0, 2.0, rng_np)
    results.append(check(scene, jnp.asarray(bo), jnp.asarray(bd), "bunny"))
    results.append(check(scene, o, d, "flagship-primary"))

    host = presets.reference_bunny300k()
    packed = host.pack()
    tri = packed.prim_type == PRIM_TRIANGLE
    verts = np.concatenate([packed.p0[tri], packed.p1[tri], packed.p2[tri]])
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    big = upload_scene(packed)
    say(f"[3 oracle] bunny300k: {int(tri.sum())} triangles, "
        f"BVH depth {big.max_depth}")
    r = np.random.default_rng(12)
    o3 = r.uniform(lo, hi, (4096, 3)).astype(np.float32)
    t3 = r.uniform(lo, hi, (4096, 3)).astype(np.float32)
    d3 = t3 - o3
    d3 /= np.maximum(np.linalg.norm(d3, axis=1, keepdims=True), 1e-8)
    results.append(check(big, jnp.asarray(o3), jnp.asarray(d3),
                         "bunny300k-incoherent", brute_chunk=1024))
    for res in results:
        say(f"[3 oracle] {json.dumps(res)}")
        require(res["ok"], f"oracle check {res['tag']} failed")
        require(res["hits"] > 0, f"oracle set {res['tag']} hit nothing")
    return big


def phase_kernel_vs_xla(scene, o, d):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from oracle_check import check_vs_traversal

    from metalpathtracer_tpu.render.integrator import closest_hit

    def route(kind):
        return jax.jit(lambda s, o, d, a, tm: closest_hit(
            s, o, d, kind, active=a, t_max=tm))

    cuda, xla = route("auto"), route("bvh")
    o2, d2, act = scattered_rays(scene, o, d)
    # an occlusion query as NEE makes it: every other bounce ray, bounded
    # by a distance drawn around its closest hit (half of them end before
    # it and must miss)
    t2, _ = xla(scene, o2, d2, act, None)
    u = np.random.default_rng(13).uniform(0.0, 2.0, t2.shape)
    t_occ = jnp.asarray(np.minimum(np.asarray(t2), 1e3) * u, jnp.float32)
    occ = act & (jnp.arange(act.shape[0]) % 2 == 0)
    for tag, ro, rd, ra, rt in (("primary", o, d, None, None),
                                ("bounce-1", o2, d2, act, None),
                                ("occlusion", o2, d2, occ, t_occ)):
        tc, _ = best_time(cuda, scene, ro, rd, ra, rt)
        tx, _ = best_time(xla, scene, ro, rd, ra, rt)
        res = check_vs_traversal(scene, ro, rd, tag, ra, rt)
        say(f"[4 kernel-vs-xla] alone {tag}: cuda {1e3 * tc:.3f} ms, xla "
            f"closest_hit_bvh {1e3 * tx:.3f} ms, xla/cuda {tx / tc:.2f}x; "
            f"{json.dumps(res)}")
        require(res["ok"], f"CUDA walk and XLA traversal disagree on {tag}")
        require(res["hits"] > 0, f"ray set {tag} hit nothing")


def render_cell(scene, cam, cell, intersector="auto", reps=2, **options):
    """Wavefront render of one cell: (Mrays/s, best seconds, first-call
    seconds, image, rays). With reps=0 the first call's time counts;
    `options` go to RenderConfig."""
    import numpy as np

    from metalpathtracer_tpu.render import RenderConfig, render_image_wavefront

    cfg = RenderConfig(max_depth=cell["depth"], intersector=intersector,
                       **options)
    t0 = time.perf_counter()
    img, rays = render_image_wavefront(scene, cam, cell["width"],
                                       cell["height"], cell["spp"], seed=0,
                                       cfg=cfg)
    first = time.perf_counter() - t0
    best = first if reps == 0 else float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        img, rays = render_image_wavefront(scene, cam, cell["width"],
                                           cell["height"], cell["spp"],
                                           seed=0, cfg=cfg)
        best = min(best, time.perf_counter() - t0)
    return rays / best / 1e6, best, first, np.asarray(img), rays


def phase_end_to_end(cells, intersector, tag):
    import numpy as np

    from metalpathtracer_tpu.render import Camera

    out = {}
    for name, (scene, cell) in cells.items():
        mrays, best, first, img, rays = render_cell(
            scene, Camera.reset(), cell, intersector)
        require(np.isfinite(img).all(), f"{name} ({intersector}) not finite")
        out[name] = (mrays, img)
        say(f"[{tag}] {name} {intersector}: {rays} rays, {best:.4f} s, "
            f"{mrays:.3f} Mrays/s (first call {first:.2f} s), "
            f"peak_bytes_in_use {peak_bytes()}")
    return out


def phase_main_path(scene):
    import tempfile

    import jax
    import jax.numpy as jnp
    import numpy as np

    from metalpathtracer_tpu import cli
    from metalpathtracer_tpu.io import load_checkpoint, save_checkpoint
    from metalpathtracer_tpu.render import (
        Camera, RenderConfig, accumulate, init_accum,
    )

    os.makedirs(os.path.join(REPO, "runs"), exist_ok=True)
    argv = ["--scene", os.path.join(REPO, "scenes", "reference.xml"),
            "--wavefront", "--width", str(FLAGSHIP["width"]),
            "--height", str(FLAGSHIP["height"]), "--spp", str(FLAGSHIP["spp"]),
            "--max-depth", str(FLAGSHIP["depth"]), "--stats-json",
            "--output", os.path.join(REPO, "runs", "chip_smoke_reference.png")]
    for i in range(2):  # the first call compiles
        t0 = time.perf_counter()
        rc = cli.main(argv)
        require(rc == 0, f"cli exited {rc}")
        say(f"[5 main] cli --wavefront call {i}: wall "
            f"{time.perf_counter() - t0:.3f} s, peak_bytes_in_use "
            f"{peak_bytes()}")

    w, h = FLAGSHIP["width"], FLAGSHIP["height"]
    cam = Camera.reset()
    cfg = RenderConfig(max_depth=FLAGSHIP["depth"])
    seed = jnp.uint32(0)
    state = init_accum(w, h)
    times = []
    for _ in range(8):
        t0 = time.perf_counter()
        state = jax.block_until_ready(
            accumulate(state, scene, cam, w, h, 1, seed, cfg))
        times.append(time.perf_counter() - t0)
    straight = np.asarray(state.rgb_sum)
    require(np.isfinite(straight).all(), "accumulate gave non-finite values")
    steady = sorted(times[1:])
    say(f"[5 main] accumulate 8 frames {w}x{h} 1 spp: first "
        f"{times[0]:.3f} s, steady p50 {1e3 * steady[len(steady) // 2]:.2f} ms"
        f" max {1e3 * steady[-1]:.2f} ms, peak_bytes_in_use {peak_bytes()}")

    state = init_accum(w, h)
    for _ in range(4):
        state = accumulate(state, scene, cam, w, h, 1, seed, cfg)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "runs")) as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        save_checkpoint(path, state, 0)
        state, run_seed, _ = load_checkpoint(path)
    for _ in range(4):
        state = accumulate(state, scene, cam, w, h, 1,
                           jnp.uint32(run_seed), cfg)
    resumed = np.asarray(state.rgb_sum)
    require(int(state.spp) == 8, "resumed state lost samples")
    require(np.array_equal(resumed, straight),
            "checkpoint resume is not bit-exact")
    say("[5 main] checkpoint save + resume after 4 of 8 frames: bit-exact")


def compare_images(tag, prod_img, brute_img):
    import numpy as np

    require(np.isfinite(prod_img).all() and np.isfinite(brute_img).all(),
            f"{tag}: non-finite radiance")
    m_p, m_b = float(prod_img.mean()), float(brute_img.mean())
    require(m_p > 1e-3, f"{tag}: image is black (mean {m_p})")
    rel = abs(m_p - m_b) / m_b
    diff_frac = float((np.abs(prod_img - brute_img).max(axis=-1)
                       > IMAGE_PIXEL_ATOL).mean())
    say(f"[6 image] {tag}: mean production {m_p:.6f} brute {m_b:.6f} (rel "
        f"{rel:.2e}); pixels off by > {IMAGE_PIXEL_ATOL}: {100 * diff_frac:.4f}%")
    require(rel <= IMAGE_MEAN_RTOL,
            f"{tag}: mean radiance disagrees with brute force")
    require(diff_frac <= IMAGE_MAX_DIFF_FRAC,
            f"{tag}: too many pixels disagree with brute force")


def phase_image(scene, prod_img):
    """The flagship rendered by the production route and by the
    brute-force oracle, as shipped and with NEE + RR (whose shadow rays
    are the production route's occlusion queries, bounded by `t_max`)."""
    from metalpathtracer_tpu.render import Camera

    cam = Camera.reset()
    _, _, _, brute_img, _ = render_cell(scene, cam, FLAGSHIP, "brute", reps=0)
    compare_images("flagship", prod_img, brute_img)

    imgs = {}
    for kind in ("auto", "brute"):
        _, _, _, imgs[kind], rays = render_cell(scene, cam, FLAGSHIP, kind,
                                                reps=0, **NEE)
        say(f"[6 image] flagship NEE + RR {kind}: {rays} rays")
    compare_images("flagship NEE + RR", imgs["auto"], imgs["brute"])


def phase_multi_gpu():
    import jax
    import numpy as np

    from metalpathtracer_tpu.parallel import (
        accumulate_sharded, init_accum_sharded, make_mesh,
        render_image_wavefront_sharded,
    )
    from metalpathtracer_tpu.render import (
        Camera, RenderConfig, render_image_wavefront, to_image, upload_scene,
    )
    from metalpathtracer_tpu.scene import load_scene_xml

    require(len(jax.devices()) >= 4,
            f"--multi-gpu needs 4 devices, found {len(jax.devices())}")
    mesh = make_mesh(4)
    scene = upload_scene(load_scene_xml(os.path.join(REPO, "scenes",
                                                     "multimesh.xml")))
    cam = Camera.reset()
    cfg = RenderConfig(max_depth=MULTI["depth"])
    w, h, spp = MULTI["width"], MULTI["height"], MULTI["spp"]

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = fn()
        return out, first, time.perf_counter() - t0

    (single, r1), f1, t1 = timed(lambda: render_image_wavefront(
        scene, cam, w, h, spp, seed=0, cfg=cfg))
    single = np.asarray(single)
    say(f"[multi] single device {w}x{h} spp {spp}: {t1:.4f} s "
        f"({r1 / t1 / 1e6:.3f} Mrays/s, first call {f1:.2f} s)")
    (sharded, r4), f4, t4 = timed(lambda: render_image_wavefront_sharded(
        scene, cam, w, h, spp, seed=0, cfg=cfg, mesh=mesh))
    sharded = np.asarray(sharded)
    say(f"[multi] render_image_wavefront_sharded on 4: {t4:.4f} s "
        f"({r4 / t4 / 1e6:.3f} Mrays/s, first call {f4:.2f} s)")
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)
    require(r4 == r1, f"sharded render traced {r4} rays, single {r1}")

    def accum():
        st = init_accum_sharded(w, h, mesh)
        rays = 0
        for _ in range(spp // 2):
            st, r = accumulate_sharded(st, scene, cam, 2, seed=0, cfg=cfg,
                                       mesh=mesh)
            rays += r
        return np.asarray(to_image(st, clamp=False)), rays

    (acc, ra), fa, ta = timed(accum)
    say(f"[multi] accumulate_sharded 2 x 2 spp on 4: {ta:.4f} s "
        f"({ra / ta / 1e6:.3f} Mrays/s, first call {fa:.2f} s)")
    np.testing.assert_allclose(acc, single, rtol=1e-5, atol=1e-6)
    say("[multi] sharded render and sharded accumulation match the single-"
        "device render (rtol 1e-5, atol 1e-6)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's device is {dev.platform})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from metalpathtracer_tpu.utils import enable_persistent_compile_cache

    say(f"compile cache: {enable_persistent_compile_cache()}")
    t_start = time.perf_counter()
    try:
        dev = phase_device()
        if args.multi_gpu:
            phase_multi_gpu()
        else:
            from metalpathtracer_tpu.render import upload_scene
            from metalpathtracer_tpu.scene import presets

            scene = flagship_scene()
            o, d = primary_rays(FLAGSHIP["width"], FLAGSHIP["height"])
            phase_build(scene, o, d)
            big = phase_oracle(scene, o, d)
            phase_kernel_vs_xla(scene, o, d)
            cells = {
                "flagship": (scene, FLAGSHIP),
                "bunny70k": (upload_scene(presets.reference_bunny70k()),
                             BUNNY),
                "bunny300k": (big, BUNNY),
            }
            prod = phase_end_to_end(cells, "auto", "5 main")
            phase_end_to_end(cells, "bvh", "4 kernel-vs-xla")
            phase_main_path(scene)
            phase_image(scene, prod["flagship"][1])
    except (PhaseError, AssertionError) as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(f"nvidia-smi: {card_name_and_power()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
