"""BSDF sampling and the sky miss shader, vectorized over the wavefront.

Implements every material model of the reference — including the two that
its megakernel never wired in (`scatter()` at `MetalCpp Path Tracer/
Renderer/Shaders/Scatter.h:22-43` is dead code; `rayColor` hardcodes
Lambertian at `PathTracing.h:251-255`, SURVEY.md appendix 5). Conventions
(`Scene/Material.h`, `Scatter.h`):

- material_type == 0: Lambertian (normal + uniform-sphere point)
- material_type <  0: mirror; our `fuzz` extension adds glossy roughness
- material_type >  0 (and != 2): dielectric with IOR = material_type,
  Schlick reflectance + total-internal-reflection (`Scatter.h:10-20`)
- material_type == 2: emissive marker — scatters Lambertian like the
  reference's `rayColor` (`PathTracing.h:245-249`)

All lanes evaluate all lobes and select — the wavefront has no per-lane
branching, and the select is cheap next to the intersection work.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from metalpathtracer_tpu.core import vecmath as vm

# numpy on purpose: jnp arrays at import time would initialize the backend
# before callers can pin a platform (jnp converts these on use)
SKY_HORIZON = np.array([1.0, 1.0, 1.0], np.float32)
SKY_ZENITH = np.array([0.6, 0.7, 1.0], np.float32)


def sky_color(d_unit: jnp.ndarray) -> jnp.ndarray:
    """Miss shader: vertical gradient white → pale blue (reference
    `PathTracing.h:225-231`). `d_unit` is the unit ray direction (..., 3)."""
    t = 0.5 * (d_unit[..., 1] + 1.0)
    return vm.mix(SKY_HORIZON, SKY_ZENITH, t[..., None])


def is_emissive(material_type, emission_power):
    """Reference hit test `emissionPower > 0.0 || materialType == 2`
    (`PathTracing.h:245`)."""
    return (emission_power > 0.0) | (material_type == 2.0)


def glossy_pdf(refl_unit, fuzz, w):
    """Solid-angle pdf of the fuzzy-mirror lobe `normalize(refl + fuzz*s)`,
    s uniform on the unit sphere (the sampler in `sample_bsdf`).

    Derivation: the sample point x = c + r*s (c = refl_unit, r = fuzz) is
    uniform on a radius-r sphere at distance 1; a direction w with angle
    theta to c (sin theta < r) meets that sphere at t+- = cos theta -+
    sqrt(r^2 - sin^2 theta), and projecting the surface density 1/(4 pi r^2)
    through the area->solid-angle Jacobian t^2/|cos alpha| at both points
    gives

        p(w) = (t+^2 + t-^2) / (4 pi r sqrt(r^2 - sin^2 theta))
             = (cos 2theta + r^2) / (2 pi r sqrt(r^2 - sin^2 theta))

    (numerator always > 1 - r^2 >= 0 inside the cone). Zero outside the
    cone or when r is outside (0, 1). This is the exact pdf of the
    UNTRUNCATED lobe; `sample_bsdf`'s below-horizon fallback (rare, grazing
    only) re-aims those samples at the pure reflection, which this pdf
    ignores — MIS weights remain a valid partition of unity (they need not
    be true densities), and the light-route BRDF estimate inherits only the
    fallback's tiny near-grazing mass. Validated against an MC histogram in
    tests/test_bsdf.py."""
    r2 = fuzz * fuzz
    cos_t = vm.dot(refl_unit, w)
    sin2 = jnp.maximum(0.0, 1.0 - cos_t * cos_t)
    disc = r2 - sin2
    inside = (disc > 0.0) & (cos_t > 0.0) & (fuzz > 0.0) & (fuzz < 1.0)
    root = jnp.sqrt(jnp.maximum(disc, 1e-20))
    pdf = (2.0 * cos_t * cos_t - 1.0 + r2) / (
        2.0 * jnp.pi * jnp.maximum(fuzz, 1e-8) * root
    )
    return jnp.where(inside, pdf, 0.0)


def sample_bsdf(
    d_in,  # (N, 3) unit incoming direction
    normal,  # (N, 3) unit, already flipped to oppose d_in
    front_face,  # (N,) bool
    material_type,  # (N,)
    fuzz,  # (N,)
    unit_vec,  # (N, 3) uniform sphere sample for the diffuse/glossy lobe
    u_fresnel,  # (N,) uniform for the dielectric reflect/refract choice
):
    """Sample the scatter direction for every lane.

    Returns (d_out, offset_sign): `d_out` unit (N, 3); `offset_sign` (N,)
    is +1 to offset the new origin along the normal, -1 for transmission
    (the reference always offsets +normal, `PathTracing.h:253` — correct for
    its Lambertian-only path; refraction must exit the back side).
    Throughput handling matches the reference: the caller multiplies albedo
    once per bounce regardless of lobe (`PathTracing.h:256`).
    """
    is_dielectric = (material_type > 0.0) & (material_type != 2.0)
    is_mirror = material_type < 0.0

    # --- Lambertian lobe (PathTracing.h:251-254) ---
    lam = vm.normalize(normal + unit_vec)
    # degenerate normal+unit ≈ 0 → fall back to the normal
    lam = vm.where3(vm.length_squared(lam) > 1e-12, lam, normal)

    # --- mirror / glossy lobe (Scatter.h:31 + fuzz extension) ---
    refl = vm.reflect(d_in, normal)
    mirror = vm.normalize(refl + fuzz[..., None] * unit_vec)
    # fuzzed direction driven under the surface → fall back to pure reflection
    mirror = vm.where3(vm.dot(mirror, normal) > 0.0, mirror, vm.normalize(refl))

    # --- dielectric lobe (Scatter.h:33-40) ---
    ior = jnp.where(is_dielectric, material_type, 1.5)
    eta = jnp.where(front_face, 1.0 / ior, ior)
    cos_theta = jnp.clip(vm.dot(-d_in, normal), 0.0, 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    cannot_refract = eta * sin_theta > 1.0
    reflectance = vm.schlick_reflectance(cos_theta, eta)
    choose_reflect = cannot_refract | (reflectance > u_fresnel)
    refracted = vm.refract(d_in, normal, eta)
    diel = vm.where3(choose_reflect, vm.normalize(refl), vm.normalize(refracted))

    d_out = vm.where3(is_dielectric, diel, vm.where3(is_mirror, mirror, lam))
    transmitted = is_dielectric & ~choose_reflect
    offset_sign = jnp.where(transmitted, -1.0, 1.0)
    return d_out, offset_sign
