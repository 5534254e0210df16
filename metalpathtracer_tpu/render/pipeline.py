"""Rendering pipeline: ray generation, sample batching, progressive state.

The JAX equivalent of the reference's per-frame host loop
(`Renderer::draw`, `MetalCpp Path Tracer/Renderer/Renderer.cpp:269-310`) and
the fragment shader's primary-ray + progressive-average logic
(`Renderer/Shaders/Fragment.metal:29-69`). One "frame" of the reference (one
sample per pixel, accumulated) maps to `accumulate(state, n_samples=1)`;
batch rendering maps to `render_image`.

Progressive accumulation keeps `(rgb_sum, spp)` rather than the reference's
running average, so resume is exact and the reference's per-frame clamp bias
(`Fragment.metal:67`, appendix 8/9) is avoided; tone mapping happens at
display time in `to_image`.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from metalpathtracer_tpu.core import rng
from metalpathtracer_tpu.render.camera import Camera, viewport_basis
from metalpathtracer_tpu.render.integrator import (
    DEFAULT_CONFIG,
    RenderConfig,
    trace,
)


def generate_rays(camera: Camera, width: int, height: int, pixel_id, sample_id, seed):
    """Jittered primary rays through pixel centers (reference
    `Fragment.metal:29-44`): screen coords sx=(px+u)/W, sy=(py+v)/H with
    u,v ~ U[0,1) — identical to the reference's uv +/- half-pixel jitter.
    Row 0 is the TOP of the image (y-flipped uv, `Vertex.metal:3-19`)."""
    origin, first_pixel, vu, vv = viewport_basis(camera, width, height)
    px = (pixel_id % jnp.uint32(width)).astype(jnp.float32)
    py = (pixel_id // jnp.uint32(width)).astype(jnp.float32)
    u1, u2 = rng.uniform2(seed, pixel_id, sample_id, 0, rng.PURPOSE_JITTER_X)
    sx = (px + u1) / width
    sy = (py + u2) / height
    d = (
        first_pixel[None, :]
        + sx[:, None] * vu[None, :]
        + sy[:, None] * vv[None, :]
        - origin[None, :]
    )
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(origin, d.shape)
    return o, d


def render_tile(scene, camera, width, height, pixel_id, sample_ids, seed, cfg):
    """Render `len(sample_ids)` samples for the given pixels; returns
    (rgb_sum (N, 3), rays_traced ()). `sample_ids` is a traced uint32 (S,)
    array scanned sequentially — S is static, the ids are not, so one
    compilation serves every progressive pass."""

    def one_sample(carry, sample_id):
        acc, rays = carry
        o, d = generate_rays(camera, width, height, pixel_id, sample_id, seed)
        radiance, r = trace(scene, o, d, pixel_id, sample_id, seed, cfg)
        return (acc + radiance, rays + r), None

    init = (
        jnp.zeros((pixel_id.shape[0], 3), jnp.float32),
        jnp.zeros((), jnp.int32),
    )
    (rgb_sum, rays), _ = jax.lax.scan(one_sample, init, sample_ids)
    return rgb_sum, rays


@functools.partial(
    jax.jit, static_argnames=("width", "height", "n_samples", "cfg")
)
def _render_pass(scene, camera, width, height, sample_start, n_samples, seed, cfg):
    pixel_id = jnp.arange(width * height, dtype=jnp.uint32)
    sample_ids = sample_start + jnp.arange(n_samples, dtype=jnp.uint32)
    rgb_sum, rays = render_tile(
        scene, camera, width, height, pixel_id, sample_ids, seed, cfg
    )
    return rgb_sum.reshape(height, width, 3), rays


def render_image(
    scene,
    camera: Camera,
    width: int,
    height: int,
    spp: int,
    seed: int = 0,
    cfg: RenderConfig = DEFAULT_CONFIG,
    spp_per_pass: int | None = None,
    sample_offset: int = 0,
):
    """Render a full image. Returns (image (H, W, 3) float32 linear mean,
    rays_traced int). Splits spp into passes to bound device memory; every
    pass reuses one compiled executable."""
    if spp <= 0:
        raise ValueError(f"spp must be positive, got {spp}")
    if spp_per_pass is None:
        # keep each pass's wavefront state comfortably in HBM
        spp_per_pass = max(1, min(spp, (1 << 22) // max(1, width * height)))
    rgb = jnp.zeros((height, width, 3), jnp.float32)
    rays = 0
    done = 0
    while done < spp:
        k = min(spp_per_pass, spp - done)
        part, r = _render_pass(
            scene,
            camera,
            width,
            height,
            jnp.uint32(sample_offset + done),
            k,
            rng.seed_from_int(seed),
            cfg,
        )
        rgb = rgb + part
        rays += int(r)
        done += k
    return rgb / spp, rays


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "cfg", "pool_size"),
)
def _render_wavefront_jit(scene, camera, width, height, spp, seed, cfg, pool_size):
    from metalpathtracer_tpu.render.integrator import trace_wavefront

    fb, rays, stats = trace_wavefront(
        scene, camera, width, height, spp, seed, cfg, pool_size,
        return_stats=True,
    )
    return fb.reshape(height, width, 3), rays, stats


def render_image_wavefront(
    scene,
    camera: Camera,
    width: int,
    height: int,
    spp: int,
    seed: int = 0,
    cfg: RenderConfig = DEFAULT_CONFIG,
    pool_size: int | None = None,
    return_stats: bool = False,
):
    """Render via the persistent-wavefront integrator (lane regeneration —
    see `integrator.trace_wavefront`). Same estimate as `render_image`;
    much faster on open scenes where most paths terminate early. All spp are
    processed in one device dispatch with bounded (pool-sized) live state.

    With `return_stats` a third dict is returned (integrator telemetry:
    `shadow_rays` — NEE occlusion probes included in rays_traced, reported
    apart so throughput tables can label them)."""
    if spp <= 0:
        raise ValueError(f"spp must be positive, got {spp}")
    if pool_size is None:
        pool_size = min(width * height * spp, 1 << 15)
    rgb_sum, rays, stats = _render_wavefront_jit(
        scene, camera, width, height, spp, rng.seed_from_int(seed), cfg,
        int(pool_size),
    )
    if return_stats:
        return rgb_sum / spp, int(rays), jax.tree.map(lambda v: v.item(), stats)
    return rgb_sum / spp, int(rays)


# ---------------------------------------------------------------------------
# Progressive accumulation (the reference's ping-pong textures + frameCount,
# `Renderer.cpp:228-241,251-267`, reborn as an explicit checkpointable state)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AccumState:
    rgb_sum: jax.Array  # float32 (H, W, 3) sum of per-sample radiance
    spp: jax.Array  # int32 scalar — samples accumulated so far


def init_accum(width: int, height: int) -> AccumState:
    return AccumState(
        rgb_sum=jnp.zeros((height, width, 3), jnp.float32),
        spp=jnp.zeros((), jnp.int32),
    )


@functools.partial(
    jax.jit, static_argnames=("width", "height", "n_samples", "cfg"), donate_argnums=(0,)
)
def accumulate(
    state: AccumState,
    scene,
    camera: Camera,
    width: int,
    height: int,
    n_samples: int,
    seed,
    cfg: RenderConfig = DEFAULT_CONFIG,
) -> AccumState:
    """Add `n_samples` new samples to the progressive state. The sample
    counter doubles as the RNG sample id, so camera-motion invalidation is
    just `init_accum` + a new state (no stale-seed retracing — the
    reference's appendix-2 defect)."""
    pixel_id = jnp.arange(width * height, dtype=jnp.uint32)
    sample_ids = state.spp.astype(jnp.uint32) + jnp.arange(n_samples, dtype=jnp.uint32)
    rgb_sum, _ = render_tile(scene, camera, width, height, pixel_id, sample_ids, seed, cfg)
    return AccumState(
        rgb_sum=state.rgb_sum + rgb_sum.reshape(height, width, 3),
        spp=state.spp + n_samples,
    )


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "n_samples", "cfg", "pool_size"),
    donate_argnums=(0,),
)
def accumulate_wavefront(
    state: AccumState,
    scene,
    camera: Camera,
    width: int,
    height: int,
    n_samples: int,
    seed,
    cfg: RenderConfig = DEFAULT_CONFIG,
    pool_size: int | None = None,
) -> tuple[AccumState, jax.Array]:
    """`accumulate` on the persistent-wavefront integrator — the interactive
    front-end's fast path (sample ids continue at state.spp via
    sample_offset, so progressive estimates match the scan route's exactly).
    Returns (state, rays_traced) for the viewer's Mrays/s status line."""
    from metalpathtracer_tpu.render.integrator import trace_wavefront

    fb, rays = trace_wavefront(
        scene, camera, width, height, n_samples, seed, cfg, pool_size,
        sample_offset=state.spp.astype(jnp.uint32),
    )
    return (
        AccumState(
            rgb_sum=state.rgb_sum + fb.reshape(height, width, 3),
            spp=state.spp + n_samples,
        ),
        rays,
    )


def to_image(state: AccumState, clamp: bool = True) -> jax.Array:
    """Resolve the progressive state to a displayable linear image
    (reference `Fragment.metal:62-67` running average + clamp)."""
    img = state.rgb_sum / jnp.maximum(state.spp, 1).astype(jnp.float32)
    return jnp.clip(img, 0.0, 1.0) if clamp else img
