"""Fidelity gate: RMSE between estimators at matched vs converged spp.

BASELINE.md: "pixel RMSE < 1e-3 vs the reference estimator at 1024 spp on a
Cornell box". The reference binary can't run here (macOS Metal), so the gate
is estimator-vs-estimator: the naive path (exactly the reference's
semantics: Lambertian + emissive-continue + sky, depth 32) converged at high
spp is the ground truth; the production estimator (NEE + RR) must agree
within the RMSE budget. Any bias in either estimator shows up as a floor
the RMSE refuses to cross as spp grows.

    python benchmarks/fidelity.py [--spp-ref 1024] [--spp-test 1024] [--res 128]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def converged(res: int, gate: float, rungs: list[int]) -> int:
    """Convergence study (VERDICT r2 missing #3): cross-estimator RMSE on a
    small tile at an spp ladder, demonstrating the curve tracks 1/sqrt(spp)
    down THROUGH the 1e-3 gate with no bias floor. The naive arm's
    per-sample sigma (~1) makes 1e-3 reachable only near ~1M spp — which a
    small tile renders in minutes at production speed."""
    import jax
    import numpy as np

    from metalpathtracer_tpu.render import (
        Camera,
        RenderConfig,
        accumulate_wavefront,
        init_accum,
        upload_scene,
    )
    from metalpathtracer_tpu.scene import presets
    from metalpathtracer_tpu.utils import rmse

    scene = upload_scene(presets.cornell_spheres())
    cam = Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)

    # Progressive accumulation in fixed-size chunks: spp is baked into the
    # traced program, so rendering each rung outright would compile a fresh
    # multi-minute executable per rung per estimator. Chunked accumulation
    # reuses ONE compiled program per estimator (RNG streams key on
    # (pixel, sample) via sample_offset, so the chunked estimate is
    # bit-identical to a monolithic render).
    chunk = min(rungs[0], 4096)
    arms = {
        "ref": (1, RenderConfig(max_depth=32), init_accum(res, res)),
        "test": (2, RenderConfig(max_depth=32, nee=True, rr_start=4),
                 init_accum(res, res)),
    }
    rows = []
    t0 = time.perf_counter()
    done = 0
    for spp in rungs:
        while done < spp:
            n = min(chunk, spp - done)
            for name, (seed, cfg, st) in arms.items():
                st, _ = accumulate_wavefront(
                    st, scene, cam, res, res, n, seed, cfg
                )
                arms[name] = (seed, cfg, st)
            done += n
        ref_img = np.asarray(arms["ref"][2].rgb_sum) / spp
        test_img = np.asarray(arms["test"][2].rgb_sum) / spp
        err = rmse(test_img, ref_img)
        rows.append(dict(spp=spp, rmse=round(float(err), 7),
                         rmse_x_sqrt_spp=round(float(err) * spp ** 0.5, 4),
                         seconds=round(time.perf_counter() - t0, 1)))
        print(json.dumps(rows[-1]), file=sys.stderr)
    final = rows[-1]["rmse"]
    # no bias floor: rmse*sqrt(spp) stays ~constant (pure MC decay) — allow
    # 2x drift across the ladder for finite-pixel statistics
    decay = rows[-1]["rmse_x_sqrt_spp"] <= 2.0 * rows[0]["rmse_x_sqrt_spp"]
    out = dict(
        metric="converged cross-estimator RMSE ladder (Cornell box)",
        resolution=f"{res}x{res}",
        rungs=rows,
        final_rmse=final,
        gate=gate,
        tracks_inv_sqrt_spp=bool(decay),
        passes=bool(final < gate and decay),
    )
    print(json.dumps(out))
    return 0 if out["passes"] else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp-ref", type=int, default=1024)
    ap.add_argument("--spp-test", type=int, default=1024)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--gate", type=float, default=1e-3)
    ap.add_argument("--converged", action="store_true",
                    help="spp-ladder convergence study on a small tile "
                    "(16x16 default res; override with --res)")
    ap.add_argument(
        "--rungs", type=str,
        default="16384,131072,1048576,4194304",
        help="spp ladder; the measured noise constant (~1.0 * spp^-1/2 on "
        "the 16x16 Cornell tile) crosses the 1e-3 gate near 1M spp",
    )
    args = ap.parse_args()
    from metalpathtracer_tpu.utils import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    if args.converged:
        res = args.res if args.res != 128 else 16
        return converged(res, args.gate,
                         [int(s) for s in args.rungs.split(",")])

    import jax
    import numpy as np

    from metalpathtracer_tpu.render import (
        Camera,
        RenderConfig,
        render_image_wavefront,
        upload_scene,
    )
    from metalpathtracer_tpu.scene import presets
    from metalpathtracer_tpu.utils import rmse

    scene = upload_scene(presets.cornell_spheres())
    cam = Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)
    r = args.res

    t0 = time.perf_counter()
    ref_img, _ = render_image_wavefront(
        scene, cam, r, r, args.spp_ref, seed=1,
        cfg=RenderConfig(max_depth=32),  # the reference's exact estimator
    )
    jax.block_until_ready(ref_img)
    t_ref = time.perf_counter() - t0

    # second naive render with a different seed: the Monte-Carlo noise floor.
    # Two INDEPENDENT unbiased renders at finite spp differ by ~sigma/sqrt(spp)
    # per pixel, so the meaningful fidelity statement is "the cross-estimator
    # RMSE is indistinguishable from the same-estimator noise floor" — any
    # estimator bias shows up as cross-RMSE exceeding the floor.
    ref2_img, _ = render_image_wavefront(
        scene, cam, r, r, args.spp_ref, seed=3,
        cfg=RenderConfig(max_depth=32),
    )

    t0 = time.perf_counter()
    test_img, _ = render_image_wavefront(
        scene, cam, r, r, args.spp_test, seed=2,
        cfg=RenderConfig(max_depth=32, nee=True, rr_start=4),
    )
    jax.block_until_ready(test_img)
    t_test = time.perf_counter() - t0

    err = rmse(np.asarray(test_img), np.asarray(ref_img))
    floor = rmse(np.asarray(ref2_img), np.asarray(ref_img))
    mean_err = abs(float(np.asarray(test_img).mean())
                   - float(np.asarray(ref_img).mean()))
    rec = {
        "metric": "RMSE (NEE+RR vs naive reference estimator, Cornell box)",
        "resolution": f"{r}x{r}",
        "spp_ref": args.spp_ref,
        "spp_test": args.spp_test,
        "rmse": round(err, 6),
        "noise_floor_rmse": round(floor, 6),
        "mean_abs_bias": round(mean_err, 6),
        "gate": args.gate,
        # pass if cross-estimator error is explained by MC noise OR beats
        # the absolute gate outright. The floor is measured between two
        # spp_ref renders (expected noise ~ sqrt(2/spp_ref)); the test-vs-ref
        # comparison carries sqrt(1/spp_test + 1/spp_ref), so scale the
        # criterion accordingly before applying a 1.25x slack.
        "pass": bool(
            err < args.gate
            or err
            <= 1.25
            * ((1 / args.spp_test + 1 / args.spp_ref) / (2 / args.spp_ref))
            ** 0.5
            * floor
        ),
        "seconds_ref": round(t_ref, 2),
        "seconds_test": round(t_test, 2),
    }
    print(json.dumps(rec))
    return 0 if rec["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
