"""Path-tracing integrator over the ray wavefront.

Rebuilds the reference's `rayColor` bounce loop (`MetalCpp Path Tracer/
Renderer/Shaders/PathTracing.h:207-259`) as a wavefront: a `lax.while_loop`
over bounce index carrying (origin, direction, light, throughput, active)
arrays for every ray. All rays advance one bounce per iteration with masked
updates; the loop exits early once every ray has terminated — the collective
equivalent of the megakernel's per-thread `break`.

Estimator semantics preserved (SURVEY.md §7 "hard parts" (c)):
- miss → sky gradient, terminate (`PathTracing.h:221-231`)
- emissive hit adds `throughput * emission * power` and KEEPS bouncing
  (`PathTracing.h:245-249`)
- throughput *= albedo once per bounce (`PathTracing.h:256`)
- new origin offset 1e-4 along the normal (`PathTracing.h:253`)
- optional per-sample clamp of radiance to [0,1] (`PathTracing.h:258`) —
  biased (appendix 9) but required for golden parity; off by default.

Extensions the reference lacks but BASELINE configs 3-4 require: all BSDF
lobes wired (mirror/glossy/dielectric), Russian-roulette termination, and
next-event estimation over a flux-weighted light table (emissive spheres
AND triangles) with power-heuristic MIS against the BSDF route.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp

from metalpathtracer_tpu.core import rng, vecmath as vm
from metalpathtracer_tpu.render import bsdf
from metalpathtracer_tpu.render.intersect import (
    T_MIN,
    closest_hit_bruteforce,
    surface_interaction_packed,
)
from metalpathtracer_tpu.render.traverse import closest_hit_bvh

# Sweep knobs, read ONCE at import (ADVICE r3): trace_wavefront is traced
# under the caller's jit whose cache keys on shapes/cfg only, so a mid-
# process env toggle would silently reuse the previously traced program.
# Import-time reads make the process-wide value explicit; sweeps must use
# fresh processes.
_ENV_BANK_K = int(os.environ.get("MPT_BANK_K", "8"))
_ENV_BANK_K_EXPLICIT = "MPT_BANK_K" in os.environ
_ENV_SORT_EVERY = int(os.environ.get("MPT_SORT_EVERY", "4"))
_ENV_DRAIN_SORT = os.environ.get("MPT_DRAIN_SORT", "")
# capped fb scatter: scatter only the first pool/SCATTER_CAP_DIV rows of
# the (pend-first) sorted pool, falling back to the full-pool scatter via
# a scalar lax.cond when more lanes hold pending banks than the prefix
# holds (short-path scenes: every lane banks every window). 0 disables.
# Most scattered rows carry no bank at steady state (a lane banks about
# once per window), so a prefix covers the real ones. It exists for an
# accelerator whose scatter cost per row; not re-measured on the GPU.
_ENV_SCATTER_CAP_DIV = int(os.environ.get("MPT_SCATTER_CAP_DIV", "4"))

# static routing of the most recent trace_wavefront TRACE (see the
# assignment site below) — a debug/validation surface, not runtime state
LAST_PLAN: dict = {}


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static integrator configuration (hashable; becomes part of the jit
    cache key). The reference hardcodes all of these
    (`PathTracing.h:216`, `Scene.h:223`, SURVEY.md §5 config note)."""

    max_depth: int = 32  # reference maxRayDepth (PathTracing.h:216)
    # closest-hit route: "auto" resolves by backend (resolve_intersector):
    # the CUDA BVH walk on a GPU, the plain-JAX BVH traversal elsewhere.
    # "bvh" forces the plain traversal, "brute" the exhaustive oracle.
    intersector: str = "auto"
    brute_chunk: int = 128
    # wavefront lane sorting: reorder the pool by origin Morton cell and
    # direction octant every sort_every advances, so neighbouring lanes
    # walk similar BVH paths. The permutation rides through two packed
    # matrices (2 row-gathers). Ignored for triangle-free scenes.
    # Positional RNG makes the estimate invariant to any lane permutation.
    # Off by default: with the CUDA walk the sort costs more than the
    # coherence it buys (flagship on an H100, PERF.md).
    sort_lanes: bool = False
    clamp_radiance: bool = False  # reference's per-sample [0,1] clamp
    rr_start: int = 0  # 0 = off; else first bounce eligible for roulette
    # next-event estimation: one flux-weighted light sample per diffuse
    # bounce over ALL emissive primitives (spheres + triangles), combined
    # with the BSDF route by the power heuristic (MIS)
    nee: bool = False
    # wavefront bounces advanced per regeneration cycle: >1 amortizes the
    # fixed per-iteration regen cost when iteration count dominates (small
    # pools), at the price of lanes idling between their death and the next
    # regen. Estimate is invariant to this value.
    bounces_per_iter: int = 1
    # scale the scatter-origin offset with the hit point's coordinate
    # magnitude: the reference's fixed 1e-4 (PathTracing.h:253) is BELOW the
    # f32 position quantization once coordinates exceed ~2 (eps(25) ~ 2e-6
    # per ulp * mantissa ~ 1.5e-3), producing shadow acne ("sparkle") on
    # meshes at the shipped scene's scale. Off restores the exact reference
    # constant.
    adaptive_offset: bool = True
    # wavefront pixel-group banking width: one work item covers `bank_k`
    # ADJACENT pixels x spp samples, the lane accumulator widens to
    # (pool, 3*bank_k) and the framebuffer scatter writes (n_pix/bank_k,
    # 3*bank_k) rows. Where a scatter costs per row whatever its width or
    # masking (benchmarks/scatter_probe.py measures it), banking K pixels
    # per row divides the scatter's rows by K. 0 = auto (largest
    # k <= MPT_BANK_K [default 8] dividing n_pix with the pool kept busy);
    # 1 = per-pixel banking. Banking exists for an accelerator whose
    # scatter cost per row; not re-measured on the GPU.
    bank_k: int = 0


DEFAULT_CONFIG = RenderConfig()
# strict reference parity: per-sample [0,1] clamp (PathTracing.h:258) and
# the fixed 1e-4 scatter offset (PathTracing.h:253)
REFERENCE_CONFIG = RenderConfig(
    max_depth=32, clamp_radiance=True, adaptive_offset=False
)


INTERSECTORS = ("auto", "bvh", "brute")


def resolve_intersector(kind: str, platform: str) -> str:
    """The closest-hit route `kind` takes on backend `platform`
    (`jax.default_backend()`): "auto" is the CUDA BVH walk on "gpu" and
    the plain-JAX traversal everywhere else."""
    if kind not in INTERSECTORS:
        raise ValueError(
            f"unknown intersector {kind!r}; expected one of {INTERSECTORS}"
        )
    if kind == "auto":
        return "cuda" if platform == "gpu" else "bvh"
    return kind


def closest_hit(scene, o, d, intersector="auto", active=None, t_max=None,
                brute_chunk=128):
    """(t, idx) of the closest hit on the route `intersector` resolves to
    on the default backend. `active` masks rays out and `t_max` bounds the
    hit distance (an occlusion query); the brute-force oracle ignores
    both, which only costs it work: the integrator masks results by
    `active`, and a shadow ray's verdict compares the hit id with the
    light's."""
    kind = resolve_intersector(intersector, jax.default_backend())
    if kind == "cuda":
        from metalpathtracer_tpu.render import hit_cuda

        hit_cuda.load_library()
        return hit_cuda.closest_hit_cuda(scene, o, d, T_MIN, active, t_max)
    if kind == "bvh":
        return closest_hit_bvh(scene, o, d, T_MIN, active, t_max)
    return closest_hit_bruteforce(scene, o, d, T_MIN, chunk=brute_chunk)


def _trace_rays(scene, o, d, cfg, active=None, occ_t=None):
    """Closest hit + surface frame: (t, idx, normal, front_face)."""
    t, idx = closest_hit(scene, o, d, cfg.intersector, active, occ_t,
                         cfg.brute_chunk)
    geom_row = scene.geom_table[jnp.maximum(idx, 0)]
    _, normal, front_face = surface_interaction_packed(geom_row, o, d, t)
    return t, idx, normal, front_face


def _fetch_material(scene, idx):
    """Per-hit material row. With a small material bank this is a 4-byte
    id gather and a one-hot (N, M) @ (M, 16) product; the direct 64-byte
    row gather is the fallback for scenes with >128 distinct materials."""
    m = scene.mat_bank.shape[0]
    if m <= 128:
        mid = scene.prim_mat_id[jnp.maximum(idx, 0)]
        onehot = (mid[:, None] == jnp.arange(m, dtype=jnp.int32)[None, :])
        # HIGHEST: a default-precision f32 product may round its operands
        # (TF32 on the GPU) and hand back rounded material constants
        return jnp.dot(
            onehot.astype(jnp.float32), scene.mat_bank,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    return scene.mat_table[jnp.maximum(idx, 0)]


def _sphere_cone_pdf(center, radius, point):
    """Solid-angle pdf of cone-sampling the sphere from `point` (uniform
    over the subtended cone): 1 / (2 pi (1 - cos_max)). 0 when `point` is
    inside the sphere (the sampler never fires there, so the MIS
    counterweight must vanish too)."""
    dist2 = vm.length_squared(center - point)
    sin_max2 = jnp.clip(radius * radius / jnp.maximum(dist2, 1e-20), 0.0, 1.0)
    cos_max = jnp.sqrt(1.0 - sin_max2)
    pdf = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_max), 1e-12)
    return jnp.where(dist2 > radius * radius, pdf, 0.0)


def _sample_light(scene, point, u_pick, u1, u2):
    """Flux-weighted next-event sample over the scene's light table
    (emissive spheres AND triangles — the single-brightest-sphere sampler
    this replaces covered only BASELINE config 4's simplest scene family).

    Spheres: uniform direction within the subtended cone. Triangles:
    uniform-area point sample, pdf converted to solid angle. Returns
    (dir, dist, radiance, pdf (solid-angle, incl. pick prob), light_prim,
    valid). pdf is 0 where invalid; callers gate on it.
    """
    j = jnp.clip(
        jnp.searchsorted(scene.light_cdf, u_pick, side="left"),
        0, scene.light_cdf.shape[0] - 1,
    )
    kind = scene.light_kind[j]
    q0 = scene.light_q0[j]
    e1 = scene.light_e1[j]
    e2 = scene.light_e2[j]
    nrm = scene.light_normal[j]
    emission = scene.light_emission[j]
    area = scene.light_area[j]
    pick_p = scene.light_pick_p[j]
    lprim = scene.light_prim[j]

    # --- sphere: cone sampling around the center direction ---
    to_c = q0 - point
    dist2 = jnp.maximum(vm.length_squared(to_c), 1e-20)
    cdist = jnp.sqrt(dist2)
    w = to_c / cdist[..., None]
    radius = e1[..., 0]
    sin_max2 = jnp.clip(radius * radius / dist2, 0.0, 1.0)
    cos_max = jnp.sqrt(1.0 - sin_max2)
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = 2.0 * jnp.pi * u2
    a = vm.where3(
        jnp.abs(w[..., 0]) > 0.9,
        jnp.array([0.0, 1.0, 0.0]),
        jnp.array([1.0, 0.0, 0.0]),
    )
    t1 = vm.normalize(vm.cross(a, w))
    t2 = vm.cross(w, t1)
    sph_dir = (
        t1 * (sin_t * jnp.cos(phi))[..., None]
        + t2 * (sin_t * jnp.sin(phi))[..., None]
        + w * cos_t[..., None]
    )
    sph_pdf = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_max), 1e-12)
    sph_valid = dist2 > radius * radius  # inside the light: no cone

    # --- triangle: uniform area sample, pdf -> solid angle ---
    su = jnp.sqrt(u1)
    b1 = 1.0 - su
    b2 = u2 * su
    x_l = q0 + b1[..., None] * e1 + b2[..., None] * e2
    to_l = x_l - point
    tdist2 = jnp.maximum(vm.length_squared(to_l), 1e-20)
    tdist = jnp.sqrt(tdist2)
    tri_dir = to_l / tdist[..., None]
    # two-sided emitter (reference semantics: emission counts regardless of
    # face, PathTracing.h:245-249) -> |cos| at the light
    cos_l = jnp.abs(vm.dot(nrm, tri_dir))
    tri_pdf = tdist2 / jnp.maximum(cos_l * area, 1e-12)
    tri_valid = cos_l > 1e-6

    is_tri = kind == 1
    dir_out = vm.where3(is_tri, tri_dir, sph_dir)
    dist = jnp.where(is_tri, tdist, cdist)
    pdf_sa = jnp.where(is_tri, tri_pdf, sph_pdf)
    valid = (pick_p > 0.0) & jnp.where(is_tri, tri_valid, sph_valid)
    pdf = jnp.where(valid, pick_p * pdf_sa, 0.0)
    return dir_out, dist, emission, pdf, lprim, valid


def _light_pdf_toward(scene, origin, d, t, idx):
    """Solid-angle pdf (incl. pick prob) with which `_sample_light` would
    have generated direction `d` from `origin`, given the ray hit light
    primitive `idx` at distance `t`. 0 if the hit prim is not in the light
    table. This is the MIS counterweight for BSDF-found emission."""
    lid = scene.prim_light_id[jnp.maximum(idx, 0)]
    lid_c = jnp.maximum(lid, 0)
    kind = scene.light_kind[lid_c]
    pick_p = scene.light_pick_p[lid_c]
    q0 = scene.light_q0[lid_c]
    radius = scene.light_e1[lid_c, 0]
    nrm = scene.light_normal[lid_c]
    area = scene.light_area[lid_c]

    sph_pdf = _sphere_cone_pdf(q0, radius, origin)
    cos_l = jnp.abs(vm.dot(nrm, d))
    tri_pdf = (t * t) / jnp.maximum(cos_l * area, 1e-12)
    pdf = jnp.where(kind == 1, tri_pdf, sph_pdf) * pick_p
    return jnp.where((lid >= 0) & (idx >= 0), pdf, 0.0)


def _bounce_step(scene, o, d, light, throughput, active, prev_pdf,
                 pixel_id, sample_id, bounce, seed, cfg):
    """Advance every lane one bounce (shared by the scan integrator and the
    regeneration wavefront). `bounce` may be a scalar or a per-lane (N,)
    array; RNG draws key on it either way. `prev_pdf` carries the cosine
    pdf of the PREVIOUS bounce's scattered direction for lanes whose
    previous bounce also ran light sampling (0 otherwise) — the MIS
    counterweight that lets the light-sample and BSDF routes both count
    every emitter without double-counting. Returns
    (o, d, light, throughput, still_active, prev_pdf, rays_counted,
    shadow_counted). rays_counted INCLUDES the NEE shadow
    rays; shadow_counted reports them separately so metrics can label
    occlusion probes apart from full path rays (VERDICT r3 weak #8 —
    shadow rays are distance-bounded queries, not flagship-equivalent
    work)."""
    rays_counted = jnp.sum(active, dtype=jnp.int32)
    shadow_counted = jnp.zeros((), jnp.int32)

    t, idx, normal, front_face = _trace_rays(
        scene, o, d, cfg, active=active
    )
    miss = idx < 0

    # --- sky on miss (PathTracing.h:225-231) ---
    sky = bsdf.sky_color(d)
    light = light + jnp.where((active & miss)[:, None], throughput * sky, 0.0)

    hit_live = active & ~miss
    point = o + t[:, None] * d
    mat_row = _fetch_material(scene, idx)
    albedo = mat_row[:, 0:3]
    mat_type = mat_row[:, 3]
    emission = mat_row[:, 4:7]
    power = mat_row[:, 7]
    fuzz = mat_row[:, 8]

    use_nee = cfg.nee and scene.num_lights > 0

    # --- emissive accumulation (PathTracing.h:245-249) ---
    # With NEE the BSDF route still counts every light hit, weighted by the
    # power-heuristic MIS counterweight against the light sampler's density
    # for this same direction (1 when the previous bounce was specular, a
    # camera ray, or never sampled lights).
    emissive = bsdf.is_emissive(mat_type, power)
    count_emission = hit_live & emissive
    emit = throughput * emission * power[:, None]
    if use_nee:
        pdf_l_hit = _light_pdf_toward(scene, o, d, t, idx)
        w_bsdf = jnp.where(
            prev_pdf > 0.0,
            (prev_pdf * prev_pdf)
            / jnp.maximum(prev_pdf * prev_pdf + pdf_l_hit * pdf_l_hit, 1e-20),
            1.0,
        )
        emit = emit * w_bsdf[:, None]
    light = light + jnp.where(count_emission[:, None], emit, 0.0)

    # --- next-event estimation + MIS (extension; BASELINE config 4) ---
    # Covers the Lambertian lobe AND the glossy (fuzzy-mirror) lobe
    # (VERDICT r3 weak #3 — glossy surfaces previously got no light
    # sampling, keeping firefly variance on glossy scenes). Both lobes
    # satisfy the operational identity f * cos = albedo * pdf_b (the
    # scatter route multiplies throughput by albedo once per bounce,
    # PathTracing.h:256), so the light-route contribution unifies to
    #   tp * albedo * L * pdf_b(ldir) / pdf_l * w_light
    # with pdf_b the lobe's solid-angle density at the light direction:
    # cos/pi for Lambertian, bsdf.glossy_pdf for the fuzz cone. Pure
    # mirrors (fuzz == 0) and dielectrics stay delta lobes — no NEE, MIS
    # weight 1 on their BSDF route.
    if use_nee:
        is_diffuse = (mat_type == 0.0) | (mat_type == 2.0)
        is_glossy = (mat_type < 0.0) & (fuzz > 0.0) & (fuzz < 1.0)
        refl = vm.reflect(d, normal)  # same lobe center as sample_bsdf's
        u_pick = rng.uniform1(
            seed, pixel_id, sample_id, bounce, rng.PURPOSE_LIGHT_PICK
        )
        ul1, ul2 = rng.uniform2(
            seed, pixel_id, sample_id, bounce, rng.PURPOSE_LIGHT
        )
        ldir, ldist, lrad, pdf_l, lprim, lvalid = _sample_light(
            scene, point, u_pick, ul1, ul2
        )
        cos_s = vm.dot(normal, ldir)
        pdf_b_l = jnp.where(
            is_glossy,
            bsdf.glossy_pdf(refl, fuzz, ldir),
            jnp.maximum(cos_s, 0.0) / jnp.pi,
        )
        # glossy lanes whose light sample falls outside the fuzz cone have
        # pdf_b_l == 0 -> zero contribution; skip their shadow rays
        cand = (
            hit_live & (cos_s > 0.0) & lvalid & ~emissive
            & (is_diffuse | (is_glossy & (pdf_b_l > 0.0)))
        )
        s_o = point + (1e-3) * normal
        # shadow query: hits beyond the light distance are irrelevant, so
        # the walk prunes past it (the 1.001 slack keeps the light's own
        # surface inside the bound)
        st, sidx, _, _ = _trace_rays(
            scene, s_o, ldir, cfg, active=cand, occ_t=ldist * 1.001
        )
        shadow_counted = jnp.sum(cand, dtype=jnp.int32)
        rays_counted = rays_counted + shadow_counted
        lit = cand & (sidx == lprim)
        # power heuristic against the same lobe's pdf for this direction
        w_light = (pdf_l * pdf_l) / jnp.maximum(
            pdf_l * pdf_l + pdf_b_l * pdf_b_l, 1e-20
        )
        scale = pdf_b_l * w_light / jnp.maximum(pdf_l, 1e-12)
        contrib = throughput * albedo * lrad * scale[..., None]
        light = light + jnp.where(lit[:, None], contrib, 0.0)
        nee_ran = hit_live & (is_diffuse | is_glossy) & ~emissive

    # --- scatter (PathTracing.h:251-256, Scatter.h wired) ---
    unit_vec = rng.random_unit_vector(seed, pixel_id, sample_id, bounce)
    u_fres = rng.uniform1(seed, pixel_id, sample_id, bounce, rng.PURPOSE_FRESNEL)
    d_out, offset_sign = bsdf.sample_bsdf(
        d, normal, front_face, mat_type, fuzz, unit_vec, u_fres
    )
    if cfg.adaptive_offset:
        scale = jnp.maximum(1.0, jnp.max(jnp.abs(point), axis=-1))
        new_o = point + (1e-4 * offset_sign * scale)[..., None] * normal
    else:
        new_o = point + (1e-4 * offset_sign)[..., None] * normal
    new_tp = throughput * albedo

    # --- Russian roulette (extension; unbiased early termination) ---
    if cfg.rr_start > 0:
        u_rr = rng.uniform1(seed, pixel_id, sample_id, bounce, rng.PURPOSE_RR)
        p = jnp.clip(jnp.max(new_tp, axis=-1), 0.05, 1.0)
        do_rr = bounce >= cfg.rr_start  # scalar or per-lane
        scale = jnp.where(do_rr, 1.0 / p, 1.0)
        new_tp = new_tp * scale[..., None]
        survive = (~do_rr) | (u_rr < p)
        hit_live = hit_live & survive

    # MIS counterweight source for the NEXT bounce: the sampled lobe's pdf
    # of the direction we just scattered, on lanes where light sampling ran
    # (cosine pdf for Lambertian, the fuzz-cone pdf for glossy)
    if use_nee:
        pdf_next = jnp.where(
            is_glossy,
            bsdf.glossy_pdf(refl, fuzz, d_out),
            jnp.maximum(vm.dot(normal, d_out), 0.0) / jnp.pi,
        )
        new_pdf = jnp.where(nee_ran, pdf_next, 0.0)
    else:
        new_pdf = jnp.zeros_like(prev_pdf)

    o = vm.where3(hit_live, new_o, o)
    d = vm.where3(hit_live, d_out, d)
    throughput = jnp.where(hit_live[:, None], new_tp, throughput)
    prev_pdf = jnp.where(hit_live, new_pdf, prev_pdf)
    return (o, d, light, throughput, hit_live, prev_pdf, rays_counted,
            shadow_counted)


def trace(scene, o, d, pixel_id, sample_id, seed, cfg: RenderConfig = DEFAULT_CONFIG):
    """Trace one path per lane to completion.

    Args:
      scene: DeviceScene. o, d: float32 (N, 3) primary rays (d unit).
      pixel_id: uint32 (N,) positional RNG stream ids.
      sample_id: scalar uint32 — which spp sample this is.
      seed: scalar uint32 global seed.

    Returns (radiance (N, 3), rays_traced ()): total emitted+sky light
    gathered along each path, and the number of rays actually traced
    (for Mrays/sec accounting, SURVEY.md §5 tracing note).
    """
    n = o.shape[0]
    light = jnp.zeros((n, 3), jnp.float32)
    throughput = jnp.ones((n, 3), jnp.float32)
    active = jnp.ones((n,), bool)
    # prev_pdf: cosine pdf of the previous bounce's scattered direction on
    # lanes whose previous bounce ran light sampling (MIS counterweight).
    # Camera rays sampled nothing -> 0.
    prev_pdf = jnp.zeros((n,), jnp.float32)
    rays_traced = jnp.zeros((), jnp.int32)

    def cond(state):
        bounce, _, _, _, _, active, _, _ = state
        return (bounce < cfg.max_depth) & jnp.any(active)

    def body(state):
        bounce, o, d, light, throughput, active, prev_pdf, rays_traced = state
        o, d, light, throughput, active, prev_pdf, counted, _ = _bounce_step(
            scene, o, d, light, throughput, active, prev_pdf,
            pixel_id, sample_id, bounce, seed, cfg,
        )
        return (bounce + 1, o, d, light, throughput, active, prev_pdf,
                rays_traced + counted)

    _, _, _, light, _, _, _, rays_traced = jax.lax.while_loop(
        cond,
        body,
        (jnp.int32(0), o, d, light, throughput, active, prev_pdf, rays_traced),
    )
    if cfg.clamp_radiance:
        light = jnp.clip(light, 0.0, 1.0)
    return light, rays_traced


def trace_wavefront(scene, camera, width, height, spp, seed,
                    cfg: RenderConfig = DEFAULT_CONFIG,
                    pool_size: int | None = None,
                    pixel_offset: int = 0,
                    n_pixels: int | None = None,
                    sample_offset=0,
                    return_stats: bool = False):
    """Persistent-wavefront path tracing with lane regeneration.

    The scan integrator (`trace`) keeps one lane per pixel-sample and wastes
    every terminated lane until the whole batch drains — fine for enclosed
    scenes, terrible for open ones where most paths die on bounce 1. Here a
    fixed pool of lanes processes the (pixel, sample) work queue: when a
    path terminates, its radiance is scatter-added to the framebuffer and
    the lane immediately restarts on the next queued sample, so every
    iteration traces a DENSE pool. This is the stream-compaction design of
    the north star without dynamic shapes: work ids are dense counters,
    positions come from a cumulative sum over terminated lanes.

    Determinism: RNG streams are keyed on (pixel, sample, bounce), never on
    the lane, so the estimate equals `trace` exactly up to framebuffer
    addition order.

    `pixel_offset`/`n_pixels` restrict the work queue to a contiguous pixel
    range (tile sharding): pixel ids stay GLOBAL (RNG/raygen invariance)
    while the returned framebuffer covers only the local range.

    Returns (rgb_sum (n_pixels, 3), rays_traced) — divide by spp.
    """
    from metalpathtracer_tpu.render.pipeline import generate_rays

    n_pix = n_pixels if n_pixels is not None else width * height
    if n_pix * spp > (1 << 31):
        raise ValueError(
            f"{n_pix * spp} work items overflow the uint32 queue; render in "
            "chunks via render_image/sample_offset instead"
        )
    if pool_size is None:
        # 2^15 was chosen for an earlier accelerator; not re-tuned
        pool_size = min(n_pix * spp, 1 << 15)
    pool = int(pool_size)

    # samples-per-bank: when the image carries enough parallelism, one lane
    # traces ALL spp samples of its pixel (and, with bank_k > 1, of a whole
    # group of adjacent pixels) before banking, so the framebuffer
    # scatter-add runs once per pixel GROUP, not once per sample — and its
    # indices are structurally unique, unlocking XLA's parallel scatter
    # path. Small images fall back to per-sample items to keep the pool
    # busy.
    spb = spp if n_pix >= pool else 1
    chunks = spp // spb
    # pixel-group banking (see RenderConfig.bank_k): one work item =
    # bank_k ADJACENT pixels x spb samples, banked to the framebuffer as
    # ONE (3*bank_k)-wide row. The scatter's cost is per ROW, so K divides
    # the scatter tax by K at the price of a K-times-longer drain tail
    # (each straggler item carries K*spb paths).
    bank_k = 1
    if spb == spp:  # only group when a lane already owns whole pixels
        k_req = cfg.bank_k or _ENV_BANK_K
        explicit = bool(cfg.bank_k) or _ENV_BANK_K_EXPLICIT
        for k in (16, 8, 4, 2, 1):
            # queue-depth guard: grouping at K shortens the work queue by
            # K, and a queue below ~4 pool-fills pushes work into the
            # drain tail (K paths per straggler item). Prefer the largest
            # K that keeps >= 4 fills; an explicit cfg/env request
            # overrides for sweeps.
            deep_enough = explicit or (n_pix // k) * chunks >= 4 * pool
            if k <= k_req and n_pix % k == 0 and n_pix // k >= pool \
                    and deep_enough:
                bank_k = k
                break
    groups = n_pix // bank_k
    per_item = bank_k * spb  # path completions per work item
    total = groups * chunks  # work items = (pixel-group, sample-chunk)
    unique_bank = spb == spp  # item <-> fb row is 1:1 -> no add collisions

    # capped fb scatter (see _ENV_SCATTER_CAP_DIV): sound only when every
    # feed window ends with a pend-first sort, i.e. when lane sorting is
    # on at all — unsorted pools leave real banks anywhere in the pool.
    scatter_cap = 0
    if (_ENV_SCATTER_CAP_DIV > 0 and cfg.sort_lanes
            and scene.num_tris > 0 and pool >= 4 * _ENV_SCATTER_CAP_DIV):
        scatter_cap = pool // _ENV_SCATTER_CAP_DIV

    # static routing record (trace-time Python values only): lets the
    # multichip dryrun / tests ASSERT which paths a given configuration
    # engages instead of re-deriving the eligibility logic (VERDICT r4 #7)
    global LAST_PLAN
    LAST_PLAN = dict(
        pool=pool, spb=spb, chunks=chunks, bank_k=bank_k, groups=groups,
        scatter_cap=scatter_cap,
        sort_lanes=bool(cfg.sort_lanes and scene.num_tris > 0),
    )

    def fb_row_of(item):
        """Framebuffer row an item banks to."""
        return item % jnp.uint32(groups)

    def pix_samp_of(item, schunk):
        """(pixel, sample) of a work unit — BOTH the raygen and the
        in-flight RNG streams must use this single definition."""
        g_item = item
        pixel = (
            (g_item % jnp.uint32(groups)) * jnp.uint32(bank_k)
            + schunk // jnp.uint32(spb)
            + jnp.uint32(pixel_offset)
        )
        sample = (
            (g_item // jnp.uint32(groups)) * jnp.uint32(spb)
            + (schunk % jnp.uint32(spb))
            + jnp.asarray(sample_offset, jnp.uint32)
        )
        return pixel, sample

    def ray_for(item, schunk):
        pixel, sample = pix_samp_of(item, schunk)
        o, d = generate_rays(camera, width, height, pixel, sample, seed)
        return pixel, sample, o, d

    item0 = jnp.arange(pool, dtype=jnp.uint32)
    schunk0 = jnp.zeros((pool,), jnp.uint32)
    pixel, sample, o, d = ray_for(item0, schunk0)
    state = dict(
        item=item0,
        schunk=schunk0,
        acc=jnp.zeros((pool, 3 * bank_k), jnp.float32),
        o=o,
        d=d,
        bounce=jnp.zeros((pool,), jnp.int32),
        light=jnp.zeros((pool, 3), jnp.float32),
        tp=jnp.ones((pool, 3), jnp.float32),
        prev_pdf=jnp.zeros((pool,), jnp.float32),
        alive=item0 < total,
        # `groups` fb rows; lanes with no pending bank carry the UNIQUE
        # out-of-bounds index `groups + lane` and scatter in mode="drop":
        # indices stay pairwise distinct (no duplicate-under-unique_indices
        # UB), while dropped rows never reach the write stage.
        fb=jnp.zeros((groups, 3 * bank_k), jnp.float32),
        next_item=jnp.uint32(min(pool, total)),
        rays=jnp.zeros((), jnp.int32),
        shadow=jnp.zeros((), jnp.int32),
        # pending-bank slots (scattered once per flush window); a lane
        # banks at most once per window (banks are >= per_item advances
        # apart, see the flush_every note below), so a slot is always free
        # when its lane banks
        pend_idx=jnp.uint32(groups) + jnp.arange(pool, dtype=jnp.uint32),
        pend_rgb=jnp.zeros((pool, 3 * bank_k), jnp.float32),
    )

    # A scatter-add may cost per pool ROW no matter how many rows are
    # masked out. Banks are provably rare: a lane
    # banks only after spb path completions, and `advance` can complete AT
    # MOST ONE path per call (path_done fires once, whatever
    # bounces_per_iter is) — so banks are >= spb advances apart. The loop
    # body therefore runs `flush_every` advances, collects their banks in
    # local pending slots (each lane banks at most once per body by the
    # bound above), and runs ONE scatter per body. With
    # pixel-group banking the cadence stretches to per_item advances, so
    # the flush window covers the whole item; the lane sort keeps its own
    # finer cadence (sort_every) INSIDE the window, with the pending-bank
    # slots riding the permutation so a slot always belongs to the path
    # currently occupying its lane.
    sort_every = min(spb, _ENV_SORT_EVERY)
    flush_every = max(1, per_item // sort_every) * sort_every

    def advance(st):
        """bounces_per_iter bounce steps + per-sample bookkeeping (shared by
        the feed and drain loops). Returns the post-advance lane state plus
        path_done/bank masks; the caller handles banking and the queue."""
        alive = st["alive"]
        o, d, light, tp = st["o"], st["d"], st["light"], st["tp"]
        prev_pdf = st["prev_pdf"]
        bounce = st["bounce"]
        item, schunk = st["item"], st["schunk"]
        pixel, sample = pix_samp_of(item, schunk)
        still = alive
        counted = jnp.zeros((), jnp.int32)
        shadow = jnp.zeros((), jnp.int32)
        # multiple bounces per iteration amortize the regen machinery
        # (cumsum, scatter-add, raygen, ~20 masked updates) whose fixed op
        # cost dominates when the pool is small
        for k in range(max(1, cfg.bounces_per_iter)):
            step_active = still & (bounce + k < cfg.max_depth)
            o, d, light, tp, still, prev_pdf, c, sh = _bounce_step(
                scene, o, d, light, tp, step_active, prev_pdf,
                pixel, sample, bounce + k, seed, cfg,
            )
            counted = counted + c
            shadow = shadow + sh
        bounce_next = bounce + max(1, cfg.bounces_per_iter)
        survivors = still & (bounce_next < cfg.max_depth)
        path_done = alive & ~survivors

        # per-sample flush into the lane-local accumulator (the reference's
        # per-sample [0,1] clamp applies here, PathTracing.h:258). With
        # pixel-group banking the accumulator holds bank_k pixel slots and
        # the completion lands in slot schunk // spb (a K-wide one-hot
        # masked add instead of a per-completion scatter).
        ps = jnp.clip(light, 0.0, 1.0) if cfg.clamp_radiance else light
        if bank_k == 1:
            acc = st["acc"] + jnp.where(path_done[:, None], ps, 0.0)
        else:
            sub = (schunk // jnp.uint32(spb)).astype(jnp.int32)
            slot = (
                jnp.arange(bank_k, dtype=jnp.int32)[None, :] == sub[:, None]
            )  # (pool, K)
            mask = path_done[:, None] & slot
            # -1: `advance` also runs on the drain phase's narrowed pools
            acc = st["acc"] + jnp.where(
                mask[:, :, None], ps[:, None, :], 0.0
            ).reshape(-1, 3 * bank_k)
        light = jnp.where(path_done[:, None], 0.0, light)

        schunk_next = schunk + path_done.astype(jnp.uint32)
        more = path_done & (schunk_next < jnp.uint32(per_item))
        bank = path_done & ~more  # item finished -> bank to framebuffer

        st = dict(
            st, o=o, d=d, light=light, tp=tp, prev_pdf=prev_pdf, acc=acc,
            bounce=bounce_next,
            schunk=jnp.where(path_done, jnp.where(bank, 0, schunk_next),
                             schunk),
            alive=survivors,
            rays=st["rays"] + counted,
            shadow=st["shadow"] + shadow,
        )
        return st, path_done, more, bank

    def restart_lanes(st, restart):
        """Fresh primary rays for lanes whose (item, schunk) changed."""
        _, _, no, nd = ray_for(st["item"], st["schunk"])
        return dict(
            st,
            o=vm.where3(restart, no, st["o"]),
            d=vm.where3(restart, nd, st["d"]),
            tp=jnp.where(restart[:, None], 1.0, st["tp"]),
            bounce=jnp.where(restart, 0, st["bounce"]),
            prev_pdf=jnp.where(restart, 0.0, st["prev_pdf"]),
            alive=st["alive"] | restart,
        )

    def maybe_sort(st, pend_idx=None, pend_rgb=None, pend_first=True):
        # origin-locality sort: lanes whose origins share a Morton cell
        # (and whose directions share an octant) become neighbours. The
        # permutation rides through two packed matrices — 2 wide
        # row-gathers instead of 11 per-array gathers.
        o, d, alive = st["o"], st["d"], st["alive"]
        span = jnp.maximum(scene.node_hi[0] - scene.node_lo[0], 1e-6)
        q = jnp.clip(
            (o - scene.node_lo[0]) / span * 31.0, 0.0, 31.0
        ).astype(jnp.uint32)

        def spread3(v):  # part1by2 (works for <=10-bit inputs)
            v = (v | (v << 16)) & jnp.uint32(0x030000FF)
            v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
            v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
            v = (v | (v << 2)) & jnp.uint32(0x09249249)
            return v

        morton = (
            spread3(q[:, 0]) | (spread3(q[:, 1]) << 1)
            | (spread3(q[:, 2]) << 2)
        )
        octant = (
            (d[:, 0] > 0).astype(jnp.uint32)
            | ((d[:, 1] > 0).astype(jnp.uint32) << 1)
            | ((d[:, 2] > 0).astype(jnp.uint32) << 2)
        )
        # dead lanes last, then origin-major: origin locality is what
        # groups lanes that walk the same BVH nodes
        key = (
            jnp.where(alive, jnp.uint32(0), jnp.uint32(1) << 31)
            | (morton << 3)
            | octant
        )
        if pend_rgb is not None and scatter_cap:
            # pend-first major bit: lanes holding an unscattered bank sort
            # to the pool front, so the body's fb scatter can cover every
            # real bank with a fixed prefix (see the capped-scatter note at
            # the body). Costs the coherence key its LSB (the least
            # significant ordering bit). Pend-holders just regenerated on
            # CONSECUTIVE items — adjacent pixel groups — so the cluster
            # they form is itself spatially coherent. Only the WINDOW-FINAL
            # sort feeds the capped scatter, so intermediate sorts keep the
            # full coherence key (ADVICE r4 #1): `pend_first` is a traced
            # flag — one wide select, no extra compiled sort_block variant.
            haspend = pend_idx < jnp.uint32(groups)
            pf = jnp.asarray(pend_first, bool)
            pend_bit = jnp.where(haspend, jnp.uint32(0), jnp.uint32(1) << 31)
            key = jnp.where(pf, (key >> 1) | pend_bit, key)
        perm = jnp.argsort(key)
        ka = 3 * bank_k  # acc / pend_rgb column width
        fparts = [st["o"], st["d"], st["acc"], st["light"], st["tp"],
                  st["prev_pdf"][:, None]]
        iparts = [st["item"].astype(jnp.int32),
                  st["schunk"].astype(jnp.int32),
                  st["bounce"],
                  st["alive"].astype(jnp.int32)]
        if pend_rgb is not None:  # feed phase: pending banks ride along
            fparts.append(pend_rgb)
            iparts.append(pend_idx.astype(jnp.int32))
        fpack = jnp.concatenate(fparts, axis=1)[perm]
        ipack = jnp.stack(iparts, axis=1)[perm]
        st = dict(
            st,
            o=fpack[:, 0:3], d=fpack[:, 3:6], acc=fpack[:, 6:6 + ka],
            light=fpack[:, 6 + ka:9 + ka], tp=fpack[:, 9 + ka:12 + ka],
            prev_pdf=fpack[:, 12 + ka],
            item=ipack[:, 0].astype(jnp.uint32),
            schunk=ipack[:, 1].astype(jnp.uint32),
            bounce=ipack[:, 2],
            alive=ipack[:, 3] > 0,
        )
        if pend_rgb is None:
            return st
        return st, ipack[:, 4].astype(jnp.uint32), fpack[:, 13 + ka:]


    # The feed body DEGENERATES into a drain once the queue empties (regen
    # = bank & (new_item < total) goes false and lanes just die), so the
    # feed loop and the first drain stage share ONE compiled program: the
    # cond keeps iterating until live lanes fit the final narrow stage.
    # Compile time: each separately compiled drain stage holds a full
    # advance graph, so the feed loop and the first drain stage share one
    # program (at `pool`) and a single narrow final stage (at `min_w`)
    # catches the long stragglers. Full-pool passes for stragglers between
    # min_w and pool alive lanes are the price.
    min_w = min(pool, 1024)
    drain_stop = min_w if pool > min_w else 0

    def cond(st):
        return (st["next_item"] < jnp.uint32(total)) | (
            jnp.sum(st["alive"], dtype=jnp.int32) > drain_stop
        )

    def body(st):
        fb = st.pop("fb")
        next_item = st.pop("next_item")
        pend_idx = st.pop("pend_idx")
        pend_rgb = st.pop("pend_rgb")

        # One ADVANCE instance traced inside a fori_loop instead of a
        # Python unroll: the unrolled body multiplied the compiled program
        # by flush_every advance graphs (each holding the full intersector
        # + regen machinery), and compile wall-time is a tracked budget.
        # The pending-bank slots ride the loop
        # carry — each lane banks at most once per flush_every window (see
        # the cadence bound above), so `where(bank, ...)` still collects
        # every bank exactly once.
        def one_advance(_, carry):
            st, pend_idx, pend_rgb, next_item = carry
            st, path_done, more, bank = advance(st)
            pend_idx = jnp.where(bank, fb_row_of(st["item"]), pend_idx)
            pend_rgb = jnp.where(bank[:, None], st["acc"], pend_rgb)
            st["acc"] = jnp.where(bank[:, None], 0.0, st["acc"])
            # queue pop: dense position among banked lanes -> next item
            slot = jnp.cumsum(bank.astype(jnp.uint32)) - 1
            new_item = next_item + slot
            regen = bank & (new_item < total)
            st["item"] = jnp.where(regen, new_item, st["item"])
            st = restart_lanes(st, more | regen)
            next_item = jnp.minimum(
                next_item + jnp.sum(bank, dtype=jnp.uint32),
                jnp.uint32(total),
            )
            return (st, pend_idx, pend_rgb, next_item)

        def sort_block(bi, carry):
            carry = jax.lax.fori_loop(0, sort_every, one_advance, carry)
            st, pend_idx, pend_rgb, next_item = carry
            if cfg.sort_lanes and scene.num_tris > 0:
                st, pend_idx, pend_rgb = maybe_sort(
                    st, pend_idx, pend_rgb,
                    pend_first=(bi == n_blocks - 1),
                )
            return (st, pend_idx, pend_rgb, next_item)

        carry = (st, pend_idx, pend_rgb, next_item)
        n_blocks = flush_every // sort_every
        if n_blocks > 1:
            carry = jax.lax.fori_loop(0, n_blocks, sort_block, carry)
        else:
            carry = sort_block(0, carry)
        st, pend_idx, pend_rgb, next_item = carry
        # All indices are pairwise distinct (when unique_bank): banked
        # lanes hit their pixel-group row (< groups), everyone else a
        # private OOB index (>= groups) that mode="drop" discards before
        # the write stage — no duplicate-under-unique_indices UB
        # (VERDICT r3 weak #4) and no dummy-row write traffic.
        if scatter_cap:
            # The window's final maybe_sort ordered pend-holders first
            # (pend-first major bit), so when <= scatter_cap lanes hold a
            # real bank the prefix covers them all and the per-row
            # scatter cost shrinks by the divisor; rows past the prefix are
            # all dropped OOB lanes whose omission changes nothing. The
            # scalar-pred cond is REAL control flow at the XLA level (one
            # branch executes); short-path scenes where every lane banks
            # each window take the full-scatter branch and lose nothing.
            n_pend = jnp.sum(
                (pend_idx < jnp.uint32(groups)).astype(jnp.int32)
            )
            if os.environ.get("MPT_DEBUG_PEND", "0") == "1":
                # CPU-only diagnostic: per-window pend counts, to size the
                # cap divisor against the completion-wave distribution
                jax.debug.print("PEND {} cap {}", n_pend, scatter_cap)
            fb = jax.lax.cond(
                n_pend <= scatter_cap,
                lambda f: f.at[pend_idx[:scatter_cap]].add(
                    pend_rgb[:scatter_cap], mode="drop",
                    unique_indices=unique_bank,
                ),
                lambda f: f.at[pend_idx].add(
                    pend_rgb, mode="drop",
                    unique_indices=unique_bank,
                ),
                fb,
            )
        else:
            fb = fb.at[pend_idx].add(
                pend_rgb, mode="drop",
                unique_indices=unique_bank
            )
        # fresh slots for the next window
        pend_idx = jnp.uint32(groups) + jnp.arange(pool, dtype=jnp.uint32)
        pend_rgb = jnp.zeros((pool, 3 * bank_k), jnp.float32)
        return dict(st, fb=fb, next_item=next_item, pend_idx=pend_idx,
                    pend_rgb=pend_rgb)

    state = jax.lax.while_loop(cond, body, state)

    # ---- final drain stage: queue exhausted AND live lanes fit min_w ----
    # (a terminated lane can no longer be refilled; mid-chunk lanes still
    # restart on their remaining samples)
    fb = state.pop("fb")
    state.pop("next_item")
    state.pop("pend_idx")  # empty at a window boundary (scattered already)
    state.pop("pend_rgb")
    drain = state
    # the merged loop banked its finished lanes already (pend scatter);
    # zero their residue so the flushes below stay idempotent
    dead0 = ~drain["alive"]
    drain["light"] = jnp.where(dead0[:, None], 0.0, drain["light"])
    drain["acc"] = jnp.where(dead0[:, None], 0.0, drain["acc"])

    # drain-phase sorting: ON whenever feed sorting is on (short-queue
    # configs spend about half their advances in the drain). Env override
    # for sweeps.
    drain_sort = (
        (_ENV_DRAIN_SORT == "1")
        if _ENV_DRAIN_SORT
        else (cfg.sort_lanes and scene.num_tris > 0)
    )

    def drain_stage(st, stop_below: int):
        """Advance bounces (no queue) until live lanes fit `stop_below`,
        sorting the pool on the feed cadence when `drain_sort` (see above).
        The checked-every-sort_every stop condition just means a stage can
        overshoot a few advances — later stages flush the extra dead lanes
        all the same."""

        def dcond(s):
            return jnp.sum(s["alive"], dtype=jnp.int32) > stop_below

        def done_adv(_, s):
            s, path_done, more, bank = advance(s)
            return restart_lanes(s, more)

        def dbody(s):
            s = jax.lax.fori_loop(0, sort_every, done_adv, s)
            if drain_sort:
                s = maybe_sort(s)
            return s

        return jax.lax.while_loop(dcond, dbody, st)

    def flush(fb, st):
        """Bank dead lanes' accumulated radiance, then zero it (so a lane
        flushed at stage k adds nothing at stage k+1). Lanes whose item was
        never assigned (pool > total) are excluded — their item id aliases
        a real pixel modulo n_pix, which would break the unique-indices
        contract of the scatter. Excluded/live lanes carry a private OOB
        index (unique, dropped before the write stage — see the fb
        allocation note)."""
        w = st["item"].shape[0]  # drain stages narrow the pool
        dead = ~st["alive"] & (st["item"] < jnp.uint32(total))
        idx = jnp.where(dead, fb_row_of(st["item"]),
                        jnp.uint32(groups)
                        + jnp.arange(w, dtype=jnp.uint32))
        fb = fb.at[idx].add(
            st["acc"], mode="drop", unique_indices=unique_bank
        )
        return fb, dict(st, acc=jnp.where(dead[:, None], 0.0, st["acc"]))

    if pool > min_w:
        # merged loop guaranteed alive <= min_w: compact live lanes first
        # (stable sort), slice to the narrow width, drain the stragglers
        live_first = jnp.argsort(~drain["alive"])  # stable: live lanes first
        drain = {
            k: (v if v.ndim == 0 else v[live_first][:min_w])
            for k, v in drain.items()
        }
    drain = drain_stage(drain, 0)
    fb, drain = flush(fb, drain)
    # (groups, 3*bank_k) rows are K row-major (pixel, rgb) blocks — the
    # reshape recovers the (n_pix, 3) contract exactly
    fb = fb.reshape(n_pix, 3)
    if return_stats:
        return fb, drain["rays"], dict(
            # NEE occlusion probes, included in `rays` but reported apart
            # so config tables can't present shadow-probe throughput as
            # flagship-equivalent Mrays/s (VERDICT r3 weak #8)
            shadow_rays=drain["shadow"],
        )
    return fb, drain["rays"]
