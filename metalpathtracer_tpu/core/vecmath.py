"""Vectorized 3D math over (..., 3) float32 arrays.

Convention: geometry is stored SoA/batched as ``(..., 3)`` arrays and every
op below is shape-polymorphic over leading batch dims, so the whole ray
wavefront is one dense vector computation. This replaces the reference's
per-thread `simd::float3` scalar math (`MetalCpp Path Tracer/Renderer/Shaders/*`,
metal-cpp `simd` usage throughout `Renderer/Renderer.cpp`).
"""

from __future__ import annotations

import jax.numpy as jnp

# Epsilon used by the reference for ray offsets / t-range tests
# (reference `Renderer/Shaders/PathTracing.h:100,134,165,253`).
RAY_EPS = 1e-4


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis; keeps no trailing dim."""
    return jnp.sum(a * b, axis=-1)


def dot_keepdims(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched cross product over the trailing (3,) axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length_squared(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * a, axis=-1)


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(length_squared(a))


def normalize(a: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Safe normalize: returns a / |a|, guarding the |a|=0 case.

    The reference calls Metal's `normalize` unguarded (e.g. on
    `normal + randomUnitVector` at `PathTracing.h:252-254`); with batched math
    a single degenerate lane would poison the wavefront with NaNs, so we clamp.
    """
    norm2 = length_squared(a)
    inv = jnp.where(norm2 > eps, jax_rsqrt(norm2), 0.0)
    return a * inv[..., None]


def jax_rsqrt(x: jnp.ndarray) -> jnp.ndarray:
    return 1.0 / jnp.sqrt(x)


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of direction `d` about normal `n` (GLSL/Metal semantics).

    Reference: `Renderer/Shaders/Scatter.h:31` (`reflect(r.direction, i.normal)`).
    """
    return d - 2.0 * dot_keepdims(d, n) * n


def refract(d: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray) -> jnp.ndarray:
    """Refraction per Metal/GLSL `refract` for unit `d`, `n`, ratio `eta`.

    Returns 0-vector on total internal reflection (like GLSL). Callers are
    expected to have selected reflection already via `mirror_angle`-style
    logic (reference `Scatter.h:10-20,37-40`).
    """
    cos_i = -dot_keepdims(d, n)
    sin2_t = eta[..., None] ** 2 * jnp.maximum(0.0, 1.0 - cos_i**2)
    tir = sin2_t > 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    refr = eta[..., None] * d + (eta[..., None] * cos_i - cos_t) * n
    return jnp.where(tir, jnp.zeros_like(refr), refr)


def schlick_reflectance(cos_theta: jnp.ndarray, ref_idx: jnp.ndarray) -> jnp.ndarray:
    """Schlick's approximation to Fresnel reflectance.

    Reference: `Renderer/Shaders/Scatter.h:15-17`.
    """
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5


def mix(a: jnp.ndarray, b: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Linear interpolation matching Metal's `mix` (used for the sky gradient,
    reference `Renderer/Shaders/PathTracing.h:228`)."""
    return a + (b - a) * t


def where3(mask: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """`jnp.where` with a (...,)-shaped mask broadcast over trailing (3,)."""
    return jnp.where(mask[..., None], a, b)
