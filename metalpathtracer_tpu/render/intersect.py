"""Ray-primitive intersection, vectorized over dense (ray, primitive) blocks.

Wavefront counterpart of the reference's per-thread intersectors: the inline
sphere quadratic and Moller-Trumbore tests inside `firstHitBVH`
(`MetalCpp Path Tracer/Renderer/Shaders/PathTracing.h:120-176`) and the
standalone `Intersect.h:10-83` helpers. Instead of one ray testing one
primitive at a time, every function here evaluates an (N, C) block of
ray-primitive pairs as dense vector math; `closest_hit_bruteforce` scans the
whole primitive soup in chunks (BASELINE configs 1-2, "flat triangle list"),
while the BVH path (`render/traverse.py`) gathers 8-wide leaf blocks.

Epsilons preserved from the reference: ray t_min 1e-4
(`PathTracing.h:100,134,165`), triangle parallel-test 1e-5
(`PathTracing.h:148`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from metalpathtracer_tpu.core import vecmath as vm
from metalpathtracer_tpu.scene.types import PRIM_SPHERE, PRIM_TRIANGLE

T_MIN = 1e-4
TRI_PARALLEL_EPS = 1e-5
INF = float("inf")  # plain float: a jnp scalar here would init the backend at import


def ray_sphere(o, d, center, radius, t_min=T_MIN, t_max=None, both_roots=True):
    """Sphere quadratic over broadcastable (..., 3) rays and centers.

    Reference inline version uses only the near root
    (`PathTracing.h:126-141`); `both_roots=True` also accepts the far root
    (like `Intersect.h:10-40`) so dielectrics and interior views work.

    Far-root robustness: for giant spheres (the reference's r=10000 ground),
    f32 rounding makes c = |oc|^2 - r^2 uncertain by ~eps*r^2, so a ray
    LEAVING the surface sees a spurious far root at t ~ eps*r about half the
    time — silently re-absorbing scattered rays and losing direct light
    (found via a 3-5%% NEE-vs-naive bias). Spurious far roots are bounded by
    t_far ~ eps*r/cos(theta), while genuine interior chords are at least
    ~2*sqrt(2*r*depth), so the far root must exceed a radius-scaled floor.
    No sign test on c: it is noise-level exactly at surfaces, and gating on
    it made rays with a sub-t_min near root TUNNEL through contact geometry
    (sphere resting on ground). Only sub-3.3e-3-cosine grazers can still
    alias, ~0.2%% of cosine-weighted scatters. Returns t (inf on miss).
    """
    oc = o - center
    a = vm.dot(d, d)
    b = vm.dot(oc, d)  # half-b form, as the reference
    c = vm.dot(oc, oc) - radius * radius
    disc = b * b - a * c
    sqrt_d = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_near = (-b - sqrt_d) / a
    t_far = (-b + sqrt_d) / a

    valid = disc > 0.0
    far_floor = jnp.maximum(t_min, 3.0e-5 * radius)  # >> eps*r spurious roots
    ok_near = valid & (t_near > t_min)
    ok_far = valid & (t_far > far_floor)
    if t_max is not None:
        ok_near &= t_near < t_max
        ok_far &= t_far < t_max
    t = jnp.where(ok_near, t_near, jnp.where(ok_far if both_roots else False, t_far, INF))
    return t


def ray_triangle(o, d, v0, v1, v2, t_min=T_MIN, t_max=None):
    """Moller-Trumbore over broadcastable (..., 3) rays and triangle verts
    (reference `PathTracing.h:143-176`). Returns t (inf on miss)."""
    e1 = v1 - v0
    e2 = v2 - v0
    h = vm.cross(d, e2)
    a = vm.dot(e1, h)
    parallel = jnp.abs(a) <= TRI_PARALLEL_EPS
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = o - v0
    u = f * vm.dot(s, h)
    q = vm.cross(s, e1)
    v = f * vm.dot(d, q)
    t = f * vm.dot(e2, q)
    ok = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
    )
    if t_max is not None:
        ok &= t < t_max
    return jnp.where(ok, t, INF)


def ray_aabb(o, inv_d, box_lo, box_hi, t_min, t_max):
    """Slab test (reference `intersectAABB`, `PathTracing.h:52-72`).

    `t_max` is the current closest hit (the reference passes `in.t`).
    Broadcastable over (..., 3); returns bool.
    """
    t0 = (box_lo - o) * inv_d
    t1 = (box_hi - o) * inv_d
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    # 0 * inf = NaN when a direction component is 0 and the origin lies on
    # the box plane (inherited from the reference's intersectAABB); a NaN
    # axis must not constrain the interval, else axis-parallel rays falsely
    # miss. (The reference has the same latent defect — not replicated.)
    lo = jnp.where(jnp.isnan(lo), -INF, lo)
    hi = jnp.where(jnp.isnan(hi), INF, hi)
    enter = jnp.maximum(jnp.max(lo, axis=-1), t_min)
    exit_ = jnp.minimum(jnp.min(hi, axis=-1), t_max)
    return exit_ > enter


def intersect_prims_block(o, d, prim_type, p0, p1, p2, t_min=T_MIN, t_max=None):
    """Intersect rays (N, 3) against a block of primitives laid out
    broadcast-compatibly (e.g. (N, C, 3) gathered or (1, C, 3) shared).

    Returns t of shape (N, C) — inf where missed or padding (PRIM_NONE).
    """
    t_sph = ray_sphere(o, d, p0, p1[..., 0], t_min, t_max)
    t_tri = ray_triangle(o, d, p0, p1, p2, t_min, t_max)
    t = jnp.where(
        prim_type == PRIM_SPHERE,
        t_sph,
        jnp.where(prim_type == PRIM_TRIANGLE, t_tri, INF),
    )
    return t


def closest_hit_bruteforce(scene, o, d, t_min=T_MIN, chunk: int = 128):
    """Closest hit by scanning all primitives in fixed-size chunks.

    The wavefront equivalent of the reference's (pre-BVH) linear `firstHit`:
    every ray tests every primitive, but as dense (N, chunk) blocks scanned
    with `lax.scan` so peak memory stays bounded. Exact — used as the oracle
    for BVH traversal tests and as the fast path for small scenes where
    traversal bookkeeping costs more than brute force.

    Returns (t, prim_idx): float32 (N,), int32 (N,) with -1 for miss.
    """
    total = scene.prim_type.shape[0]
    chunk = min(chunk, total)
    n_chunks = -(-total // chunk)
    pad_to = n_chunks * chunk

    pt = jnp.pad(scene.prim_type, (0, pad_to - total), constant_values=2)
    p0 = jnp.pad(scene.p0, ((0, pad_to - total), (0, 0)))
    p1 = jnp.pad(scene.p1, ((0, pad_to - total), (0, 0)))
    p2 = jnp.pad(scene.p2, ((0, pad_to - total), (0, 0)))

    o_b = o[:, None, :]
    d_b = d[:, None, :]

    def body(carry, chunk_data):
        best_t, best_i = carry
        c_pt, c_p0, c_p1, c_p2, base = chunk_data
        t = intersect_prims_block(
            o_b, d_b, c_pt[None, :], c_p0[None], c_p1[None], c_p2[None], t_min
        )
        # closest within this chunk
        j = jnp.argmin(t, axis=1)
        tj = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
        better = tj < best_t
        best_t = jnp.where(better, tj, best_t)
        best_i = jnp.where(better, base + j.astype(jnp.int32), best_i)
        return (best_t, best_i), None

    chunks = (
        pt.reshape(n_chunks, chunk),
        p0.reshape(n_chunks, chunk, 3),
        p1.reshape(n_chunks, chunk, 3),
        p2.reshape(n_chunks, chunk, 3),
        jnp.arange(n_chunks, dtype=jnp.int32) * chunk,
    )
    init = (
        jnp.full(o.shape[:-1], INF),
        jnp.full(o.shape[:-1], -1, jnp.int32),
    )
    (best_t, best_i), _ = jax.lax.scan(body, init, chunks)
    return best_t, best_i


def surface_interaction_packed(geom_row, o, d, t):
    """Like `surface_interaction` but from a pre-gathered (N, 16) row of
    `scene.geom_table` — ONE gather instead of four. Returns
    (point, normal, front_face)."""
    p0 = geom_row[:, 0:3]
    p1 = geom_row[:, 3:6]
    p2 = geom_row[:, 6:9]
    ptype = geom_row[:, 9]

    point = o + t[..., None] * d
    sph_n = vm.normalize(point - p0)
    tri_n = vm.normalize(vm.cross(p1 - p0, p2 - p0))
    normal = vm.where3(ptype == PRIM_SPHERE, sph_n, tri_n)
    front_face = vm.dot(normal, d) < 0.0
    normal = vm.where3(front_face, normal, -normal)
    return point, normal, front_face


def surface_interaction(scene, o, d, t, prim_idx):
    """Recompute hit point / geometric normal / front-face flag for winning
    hits (reference computes these inline during traversal,
    `PathTracing.h:130-201`; recomputing only for winners is cheaper in the
    wavefront layout).

    Returns (point, normal, front_face); normal is flipped to oppose the ray
    like the reference (`PathTracing.h:196-201`). `prim_idx` may be -1
    (miss) — outputs are garbage-but-finite there and must be masked by the
    caller.
    """
    idx = jnp.maximum(prim_idx, 0)
    ptype = scene.prim_type[idx]
    p0 = scene.p0[idx]
    p1 = scene.p1[idx]
    p2 = scene.p2[idx]

    point = o + t[..., None] * d

    sph_n = vm.normalize(point - p0)
    tri_n = vm.normalize(vm.cross(p1 - p0, p2 - p0))
    normal = vm.where3(ptype == PRIM_SPHERE, sph_n, tri_n)

    front_face = vm.dot(normal, d) < 0.0
    normal = vm.where3(front_face, normal, -normal)
    return point, normal, front_face
