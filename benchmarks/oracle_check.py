"""Brute-force-oracle check of the production closest-hit route.

Runs the production route (`integrator.closest_hit`, "auto": the CUDA BVH
walk on a GPU) and the exhaustive `closest_hit_bruteforce` over the same
rays on the device and diffs hit ids and distances. Both sides evaluate
the same Moller-Trumbore and sphere formulas in float32 without a matrix
product, so they differ only where FMA contraction differs between nvcc
and XLA: an id may flip on an edge shared by two triangles, and t may
differ in its last bits.

Where ids agree, a triangle's t must agree to 1e-4 relative. A sphere's t
gets 2^-20 of its radius on top: the quadratic's c = |oc|^2 - r^2 cancels,
so f32 leaves t uncertain by a few ulp of r (intersect.ray_sphere), and on
the r = 10000 ground sphere XLA's own CPU and GPU results differ by ~1e-2
relative at t < 1.

Ray sets:
  - bunny: the reference scene (4,968-tri bunny + spheres), incoherent rays
    between random points of [-2, 2]^3.
  - cloud: a random sliver-triangle cloud with incoherent rays.

Usage: python benchmarks/oracle_check.py [--cloud-tris 100000] [--rays 4096]
Prints one JSON line. Exit code 1 when a set fails `check`'s limits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# limits: id mismatches as a share of hits, |dt| / t where ids agree, and
# the extra |dt| a sphere hit may carry per unit of its radius
MAX_MISMATCH_FRAC = 1e-3
MAX_REL_T_DIFF = 1e-4
SPHERE_T_PER_RADIUS = 2.0**-20


def ray_batch(n, lo, hi, rng_np):
    """`n` rays from uniform points of [lo, hi]^3 toward other such
    points (unit directions)."""
    import numpy as np

    o = rng_np.uniform(lo, hi, (n, 3)).astype(np.float32)
    target = rng_np.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = target - o
    nrm = np.linalg.norm(d, axis=1, keepdims=True)
    d = (d / np.maximum(nrm, 1e-8)).astype(np.float32)
    return o, d


def check(scene, o, d, tag, brute_chunk=128):
    """Production route vs brute force on rays `o`, `d`. Returns a dict
    with the hit count, id mismatches, the largest |dt| / t where ids agree
    on triangles, the largest |dt| / (1e-4 t + 2^-20 r) on spheres (ok
    below 1), and `ok` against the module's limits."""
    import jax
    import numpy as np

    from metalpathtracer_tpu.render.integrator import closest_hit
    from metalpathtracer_tpu.render.intersect import closest_hit_bruteforce
    from metalpathtracer_tpu.scene.types import PRIM_SPHERE

    t_p, i_p = jax.jit(closest_hit)(scene, o, d)
    t_b, i_b = jax.jit(closest_hit_bruteforce, static_argnames="chunk")(
        scene, o, d, chunk=brute_chunk
    )
    t_p, i_p = np.asarray(t_p), np.asarray(i_p)
    t_b, i_b = np.asarray(t_b), np.asarray(i_b)

    hits = int((i_b >= 0).sum())
    id_mismatch = int((i_p != i_b).sum())
    both = (i_p == i_b) & (i_b >= 0)
    prim = np.maximum(i_b, 0)
    sphere = np.asarray(scene.prim_type)[prim] == PRIM_SPHERE
    radius = np.asarray(scene.p1)[prim, 0]
    with np.errstate(invalid="ignore"):  # inf - inf on shared misses
        dt = np.where(both, np.abs(t_p - t_b), 0.0)
    tri = both & ~sphere
    sph = both & sphere
    rel = float((dt[tri] / t_b[tri]).max()) if tri.any() else 0.0
    sph_ratio = float(
        (dt[sph] / (MAX_REL_T_DIFF * t_b[sph]
                    + SPHERE_T_PER_RADIUS * radius[sph])).max()
    ) if sph.any() else 0.0
    frac = id_mismatch / max(hits, 1)
    ok = (frac <= MAX_MISMATCH_FRAC and rel <= MAX_REL_T_DIFF
          and sph_ratio <= 1.0)
    print(
        f"{tag}: {len(i_b)} rays, {hits} hits, {id_mismatch} id mismatches "
        f"({100 * frac:.4f}%), triangle max |dt|/t {rel:.3e}, sphere "
        f"|dt| at {sph_ratio:.3f} of its limit -> {'ok' if ok else 'FAIL'}",
        file=sys.stderr,
    )
    return dict(tag=tag, rays=len(i_b), hits=hits, id_mismatch=id_mismatch,
                mismatch_frac=frac, tri_max_rel_t_diff=rel,
                sphere_t_diff_of_limit=sph_ratio, ok=bool(ok))


def check_vs_traversal(scene, o, d, tag, active=None, t_max=None):
    """Production route vs the plain-JAX `closest_hit_bvh` with the
    inputs the oracle cannot take: the `active` mask and the `t_max` bound
    of an occlusion query. Returns a dict with the hit count, id
    mismatches, how many masked-out rays either route reported as a hit
    (must be 0), the largest triangle |dt| / t where ids agree, and `ok`
    against the module's limits."""
    import jax
    import numpy as np

    from metalpathtracer_tpu.render.integrator import closest_hit
    from metalpathtracer_tpu.scene.types import PRIM_TRIANGLE

    hit_fn = jax.jit(closest_hit, static_argnames="intersector")
    t_p, i_p = hit_fn(scene, o, d, intersector="auto", active=active,
                      t_max=t_max)
    t_x, i_x = hit_fn(scene, o, d, intersector="bvh", active=active,
                      t_max=t_max)
    t_p, i_p = np.asarray(t_p), np.asarray(i_p)
    t_x, i_x = np.asarray(t_x), np.asarray(i_x)

    hits = int((i_x >= 0).sum())
    id_mismatch = int((i_p != i_x).sum())
    masked = (np.zeros(len(i_x), bool) if active is None
              else ~np.asarray(active))
    masked_hits = int(((i_p >= 0) & masked).sum() + ((i_x >= 0) & masked).sum())
    tri = ((i_p == i_x) & (i_x >= 0)
           & (np.asarray(scene.prim_type)[np.maximum(i_x, 0)] == PRIM_TRIANGLE))
    rel = (float((np.abs(t_p[tri] - t_x[tri]) / t_x[tri]).max())
           if tri.any() else 0.0)
    frac = id_mismatch / max(hits, 1)
    ok = frac <= MAX_MISMATCH_FRAC and rel <= MAX_REL_T_DIFF and masked_hits == 0
    print(
        f"{tag}: {len(i_x)} rays ({len(i_x) - int(masked.sum())} active), "
        f"{hits} hits, {id_mismatch} id mismatches vs closest_hit_bvh, "
        f"{masked_hits} hits on masked rays, triangle max |dt|/t {rel:.3e} "
        f"-> {'ok' if ok else 'FAIL'}",
        file=sys.stderr,
    )
    return dict(tag=tag, rays=len(i_x), hits=hits, id_mismatch=id_mismatch,
                mismatch_frac=frac, masked_hits=masked_hits,
                tri_max_rel_t_diff=rel, ok=bool(ok))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cloud-tris", type=int, default=100_000)
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--skip-cloud", action="store_true")
    args = ap.parse_args()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from metalpathtracer_tpu.render import upload_scene
    from metalpathtracer_tpu.scene import load_scene_xml, presets
    from metalpathtracer_tpu.utils import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    print(f"backend {jax.default_backend()}", file=sys.stderr)
    rng_np = np.random.default_rng(11)
    results = []

    scene = upload_scene(
        load_scene_xml(os.path.join(repo, "scenes", "reference.xml"))
    )
    o, d = ray_batch(args.rays, -2.0, 2.0, rng_np)
    results.append(check(scene, jnp.asarray(o), jnp.asarray(d), "bunny"))

    if not args.skip_cloud:
        cloud = upload_scene(presets.random_tri_cloud(args.cloud_tris, seed=1))
        o, d = ray_batch(args.rays, -12.0, 12.0, rng_np)
        results.append(check(cloud, jnp.asarray(o), jnp.asarray(d), "cloud",
                             brute_chunk=1024))

    ok = all(r["ok"] for r in results)
    print(json.dumps(dict(backend=jax.default_backend(), ok=ok,
                          results=results)))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
