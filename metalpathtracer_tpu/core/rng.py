"""Counter-based threefry-2x32 RNG with positional sample streams.

The reference's RNG is a PCG-style hash seeded from screen-uv + a per-
invalidation host seed (`Renderer/Shaders/Random.h:6-40`,
`Fragment.metal:29`). It has two defects we must NOT replicate
(SURVEY.md appendix 1-3): the seed is not advanced between draws, and a
static camera retraces identical paths every frame because the seed lacks
the frame index.

This design is a *counter-based* generator: every random draw is a
pure function of

    (global seed, pixel id, sample index, bounce, purpose)

so the stream is reproducible, independent of device sharding (a pixel gets
the same randoms no matter which chip renders its tile), and checkpoint/
resume simply continues at the next sample counter. This is the threefry-2x32
block cipher (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
SC'11) — the same core JAX's PRNG uses — implemented here directly as
vectorized uint32 ops so we can key/counter it positionally without
per-lane `fold_in` vmaps.
"""

from __future__ import annotations

import jax.numpy as jnp

# Draw purposes within one (pixel, sample, bounce) step. Keeping them as an
# explicit enum guarantees no two draws in a bounce share a counter.
PURPOSE_JITTER_X = 0  # sub-pixel jitter (reference Fragment.metal:31-34)
PURPOSE_LOBE = 1  # BSDF lobe / scatter direction
PURPOSE_FRESNEL = 2  # dielectric reflect-vs-refract (Scatter.h:19)
PURPOSE_RR = 3  # Russian-roulette survival
PURPOSE_LIGHT = 4  # next-event-estimation light sampling
PURPOSE_LENS = 5  # depth-of-field lens sampling (future)
PURPOSE_LIGHT_PICK = 6  # which light the NEE shadow ray targets

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA  # threefry key-schedule parity constant


def _rotl(x: jnp.ndarray, r: int) -> jnp.ndarray:
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def _u32(x) -> jnp.ndarray:
    """Coerce to uint32, wrapping Python ints (negative seeds, >32-bit) mod 2^32."""
    if isinstance(x, int):
        x = x & 0xFFFFFFFF
    return jnp.asarray(x, jnp.uint32)


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds. All args broadcastable uint32 arrays.

    Returns two uint32 arrays of the broadcast shape. Matches JAX's
    `threefry_2x32` bit-for-bit (verified in tests/test_rng.py).
    """
    k0 = _u32(k0)
    k1 = _u32(k1)
    x0 = _u32(c0)
    x1 = _u32(c1)

    ks = (k0, k1, jnp.uint32(_PARITY) ^ k0 ^ k1)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]

    for block in range(5):  # 5 blocks of 4 rounds = 20 rounds
        rots = _ROTATIONS[0:4] if block % 2 == 0 else _ROTATIONS[4:8]
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        # key injection after each 4-round block
        x0 = x0 + ks[(block + 1) % 3]
        x1 = x1 + ks[(block + 2) % 3] + jnp.uint32(block + 1)
    return x0, x1


def bits_to_uniform(bits: jnp.ndarray) -> jnp.ndarray:
    """uint32 → float32 uniform in [0, 1) using the top 24 bits."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2.0**-24)


def uniform2(seed, pixel_id, sample_id, bounce, purpose):
    """Two independent U[0,1) floats per lane.

    `seed` is a scalar uint32; `pixel_id` is any-shape uint32 (position-based
    lane id); `sample_id`/`bounce`/`purpose` are scalars or broadcastable.
    """
    c1 = (_u32(bounce) << jnp.uint32(8)) | _u32(purpose)
    b0, b1 = threefry2x32(_u32(seed), _u32(pixel_id), _u32(sample_id), c1)
    return bits_to_uniform(b0), bits_to_uniform(b1)


def uniform1(seed, pixel_id, sample_id, bounce, purpose):
    u, _ = uniform2(seed, pixel_id, sample_id, bounce, purpose)
    return u


def uniform3(seed, pixel_id, sample_id, bounce, purpose):
    """Three independent U[0,1) floats per lane (two counter blocks)."""
    u0, u1 = uniform2(seed, pixel_id, sample_id, bounce, purpose)
    c1 = (_u32(bounce) << jnp.uint32(8)) | _u32(purpose) | jnp.uint32(0x80000000)
    b0, _ = threefry2x32(_u32(seed), _u32(pixel_id), _u32(sample_id), c1)
    return u0, u1, bits_to_uniform(b0)


def random_unit_vector(seed, pixel_id, sample_id, bounce, purpose=PURPOSE_LOBE):
    """Uniform point on the unit sphere, shaped `pixel_id.shape + (3,)`.

    Same parameterization as the reference (`PathTracing.h:25-30`):
    z = 2u1-1, t = 2*pi*u2, r = sqrt(1-z^2) — but with *independent* u1, u2
    (the reference reuses one seed for both draws, its appendix-1 defect).
    """
    u1, u2 = uniform2(seed, pixel_id, sample_id, bounce, purpose)
    z = 2.0 * u1 - 1.0
    t = (2.0 * jnp.pi) * u2
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([r * jnp.cos(t), r * jnp.sin(t), z], axis=-1)


def seed_from_int(seed: int) -> jnp.ndarray:
    return jnp.uint32(seed & 0xFFFFFFFF)
