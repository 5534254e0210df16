"""Benchmark harness — prints ONE JSON line with the headline metric.

Metric: Mrays/sec on one GPU on the flagship scene (the reference's shipped
scene: 3 spheres + 4968-tri bunny, `scenes/reference.xml`) at the
reference's default 1280x720 / 32-bounce configuration
(`ApplicationDelegate.cpp:24`, `PathTracing.h:216`), spp 4. The reference
publishes no numbers of its own (SURVEY.md §6).

Rays are counted exactly: the integrator sums live lanes per bounce
(`metalpathtracer_tpu/render/integrator.py`), so Mrays/sec reflects rays
actually traced, not pixels x spp x max_depth.

Legs, in this order: the interactive viewer (a child process that runs
before this process first touches JAX, so one process holds the card at a
time), the flagship (pipelined and single-shot), and the 79k/318k-triangle
bunny scenes. Any failed leg fails the run. The card's name and power
limit (`nvidia-smi`) are printed and recorded.

Usage: python bench.py   (needs an NVIDIA GPU; exits non-zero without one)
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def card_name_and_power() -> str:
    """`nvidia-smi`'s name and power limit of the first card; raises when
    there is no NVIDIA card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    try:
        card = card_name_and_power()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"bench: no NVIDIA GPU ({e!r})", file=sys.stderr)
        return 1
    print(f"card: {card}", file=sys.stderr)
    out = {}
    if os.environ.get("MPT_BENCH_VIEWER", "1") == "1":
        out["viewer_512x288_fps"] = round(_viewer_fps(REPO), 3)

    import jax

    sys.path.insert(0, REPO)
    from metalpathtracer_tpu.core import rng
    from metalpathtracer_tpu.render import Camera, upload_scene
    from metalpathtracer_tpu.render.integrator import (
        RenderConfig,
        trace_wavefront,
    )
    from metalpathtracer_tpu.scene import load_scene_xml, presets
    from metalpathtracer_tpu.utils import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: JAX found no GPU (device {dev.platform})",
              file=sys.stderr)
        return 1
    print(f"benchmarking on {dev.platform} ({dev.device_kind})",
          file=sys.stderr)

    scene = upload_scene(load_scene_xml(os.path.join(REPO, "scenes",
                                                     "reference.xml")))
    camera = Camera.reset()  # the reference's default view
    width, height = 1280, 720
    # env knobs exist for sweeps only; the defaults are the shipped
    # configuration (pool 2^15 was chosen for an earlier accelerator and
    # is not re-tuned)
    cfg = RenderConfig(
        max_depth=32,
        bounces_per_iter=int(os.environ.get("MPT_BENCH_BPI", "1")),
    )
    spp = 4
    pool = 1 << int(os.environ.get("MPT_BENCH_POOL", "15"))

    @functools.partial(jax.jit, static_argnames=("spp", "pool"))
    def render(scene, camera, seed, spp, pool):
        return trace_wavefront(scene, camera, width, height, spp, seed, cfg,
                               pool)

    # warmup / compile (set-up time, reported as compile_s)
    t0 = time.perf_counter()
    fb, rays = jax.block_until_ready(
        render(scene, camera, rng.seed_from_int(0), spp, pool))
    compile_s = time.perf_counter() - t0
    print(f"warmup (compile + first pass): {compile_s:.1f}s", file=sys.stderr)

    # timed: best of repeated passes. Each pass times one render alone
    # (single-shot), then PIPE renders dispatched back to back with one
    # wait, as the progressive renderer and the viewer issue them.
    PIPE = int(os.environ.get("MPT_BENCH_PIPE", "3"))
    best, best_single = 0.0, 0.0
    for rep in range(4):
        t0 = time.perf_counter()
        fb, rays = jax.block_until_ready(render(
            scene, camera, rng.seed_from_int(rep * PIPE + 1), spp, pool))
        dt_single = time.perf_counter() - t0
        single = int(rays) / dt_single / 1e6
        best_single = max(best_single, single)

        t0 = time.perf_counter()
        outs = jax.block_until_ready([
            render(scene, camera, rng.seed_from_int(rep * PIPE + 2 + i),
                   spp, pool)
            for i in range(PIPE)
        ])
        dt = (time.perf_counter() - t0) / PIPE
        rays = sum(int(r) for _, r in outs)
        mrays = rays / PIPE / dt / 1e6
        best = max(best, mrays)
        print(
            f"pass {rep}: {rays // PIPE} rays in {dt:.4f}s/render = "
            f"{mrays:.3f} Mrays/s pipelined ({single:.3f} single-shot)",
            file=sys.stderr,
        )

    out.update({
        "metric": (
            "Mrays/sec on one GPU (reference scene, 720p, 32 bounces, "
            "spp 4, steady-state)"
        ),
        "value": round(best, 3),
        "unit": "Mrays/s",
        "single_shot_mrays": round(best_single, 3),
        # samples/sec scaled to a 1080p frame: samples/s = pixels*spp /
        # seconds_per_render, seconds_per_render = rays / (Mrays/s)
        "spp_per_sec_1080p": round(
            (width * height * spp) * (best * 1e6) / (rays // PIPE)
            / 2073600.0,
            3,
        ),
        "compile_s": round(compile_s, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "nvidia_smi": card,
    })

    # Large-scene legs: 512^2, spp 2, depth 8, the reference camera; one
    # warmup + 2 pipelined passes each.
    if os.environ.get("MPT_BENCH_SCENES", "1") == "1":
        lcfg = RenderConfig(max_depth=8)

        @functools.partial(jax.jit, static_argnames=("spp", "pool"))
        def render_large(scene, camera, seed, spp, pool):
            return trace_wavefront(scene, camera, 512, 512, spp, seed, lcfg,
                                   pool)

        for name, preset in (
            ("bunny70k_mrays", presets.reference_bunny70k),
            ("bunny300k_mrays", presets.reference_bunny300k),
        ):
            t0 = time.perf_counter()
            sc = upload_scene(preset())
            jax.block_until_ready(
                render_large(sc, camera, rng.seed_from_int(0), 2, pool))
            warm_s = time.perf_counter() - t0
            lbest = 0.0
            for rep in range(2):
                t0 = time.perf_counter()
                outs = jax.block_until_ready([
                    render_large(sc, camera,
                                 rng.seed_from_int(rep * 2 + 1 + i), 2, pool)
                    for i in range(2)
                ])
                dt = (time.perf_counter() - t0) / 2
                lr = sum(int(r) for _, r in outs)
                lbest = max(lbest, lr / 2 / dt / 1e6)
            out[name] = round(lbest, 3)
            print(f"{name}: {lbest:.3f} Mrays/s (warmup {warm_s:.1f}s)",
                  file=sys.stderr)

    print(json.dumps(out))
    return 0


def _viewer_fps(repo: str, frames: int = 90, width: int = 512,
                height: int = 288) -> float:
    """Steady-state viewer fps: drive the terminal viewer through a pty
    for `frames` frames with MPT_VIEWER_TRACE on, return 1/mean(dt) over
    the steady tail (frames 10+). The child is the only JAX process while
    it runs; its stderr is drained by a thread so it can never block on a
    full pipe."""
    import pty
    import re
    import select

    code = (
        f"import sys; sys.path.insert(0, {repo!r});"
        "import jax;"
        "d = jax.devices()[0];"
        "sys.exit(f'viewer child found no GPU ({d.platform})')"
        " if d.platform != 'gpu' else None;"
        "from metalpathtracer_tpu.viewer import main;"
        f"main(['--scene', {os.path.join(repo, 'scenes', 'reference.xml')!r},"
        f"'--width','{width}','--height','{height}',"
        f"'--max-frames','{frames}'])"
    )
    env = dict(os.environ, MPT_VIEWER_TRACE="1", COLUMNS="100", LINES="30")
    m, s = pty.openpty()
    p = subprocess.Popen([sys.executable, "-c", code], stdin=s, stdout=s,
                         stderr=subprocess.PIPE, close_fds=True, env=env)
    os.close(s)
    err_chunks: list[bytes] = []
    drain = threading.Thread(
        target=lambda: err_chunks.extend(iter(lambda: p.stderr.read(4096),
                                              b"")),
        daemon=True,
    )
    drain.start()
    deadline = time.time() + 900
    try:
        while time.time() < deadline and p.poll() is None:
            r, _, _ = select.select([m], [], [], 0.5)
            if r:
                try:
                    os.read(m, 1 << 20)  # drain the terminal output
                except OSError:
                    break
        p.wait(timeout=60)
    finally:
        try:
            os.close(m)
        except OSError:
            pass
        if p.poll() is None:
            p.kill()
            p.wait()
    drain.join(timeout=60)
    err = b"".join(err_chunks).decode(errors="replace")
    if p.returncode != 0:
        raise RuntimeError(f"viewer exited {p.returncode}:\n{err[-4000:]}")
    dts = [float(x) for x in re.findall(r"dt ([\d.]+)s", err)][10:]
    if len(dts) < 10:
        raise RuntimeError(f"viewer traced only {len(dts) + 10} frames")
    mean_dt = sum(dts) / len(dts)
    print(f"viewer {width}x{height}: {1 / mean_dt:.3f} fps steady "
          f"(mean dt {1e3 * mean_dt:.2f} ms over {len(dts)} frames)",
          file=sys.stderr)
    return 1.0 / mean_dt


if __name__ == "__main__":
    raise SystemExit(main())
