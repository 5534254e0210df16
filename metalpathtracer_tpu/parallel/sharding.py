"""Multi-device rendering: tile and sample sharding over a device mesh.

The reference is strictly single-GPU — its entire parallelism model is the
rasterizer launching one fragment thread per pixel (SURVEY.md §2 note, §5
"Distributed communication backend: none"). The scaling axes here are:

- **tile sharding**: the pixel grid is split row-block-wise across devices;
  each device traces only its tile. Embarrassingly parallel; the
  framebuffer gather is the only collective.
- **sample sharding**: every device renders the full image with a disjoint
  slice of the spp budget; partial sums combine with one `psum`.

Because the RNG streams are positional — a draw depends on (pixel, sample,
bounce), never on lane position (`core/rng.py`) — both shardings produce
BIT-IDENTICAL images to a single device (tested in tests/test_sharding.py),
and the two axes compose into a 2-D mesh ("tiles", "samples").

All sharded entry points jit ONCE per (mesh, shape, config): the compiled
executables live in `functools.lru_cache`d builders keyed on the static
parameters, with seed / accumulation state as traced arguments — so
progressive and interactive multi-device use pays compilation exactly once.

Scene arrays are a few MB and are replicated per device; rays never cross
devices. This is the BASELINE config-5 design (1080p tile-sharded
progressive accumulation over four GPUs joined all to all by NVLink, so the
mesh follows the algorithm alone), including checkpointable progressive
accumulation via `init_accum_sharded` / `accumulate_sharded` (the
multi-device analog of
the reference's ping-pong textures, `Renderer.cpp:228-241,269-310`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from metalpathtracer_tpu.core import rng
from metalpathtracer_tpu.render.integrator import (
    DEFAULT_CONFIG,
    trace_wavefront,
)
from metalpathtracer_tpu.render.pipeline import AccumState, render_tile


def make_mesh(n_devices: int | None = None, axis: str = "tiles") -> Mesh:
    """1-D mesh over local devices (4 GPUs → 4-way tile sharding)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (axis,))


def make_mesh_2d(n_tiles: int, n_samples: int) -> Mesh:
    """2-D (tiles, samples) mesh for composed tile+sample sharding."""
    import numpy as np

    devices = np.asarray(jax.devices()[: n_tiles * n_samples]).reshape(
        n_tiles, n_samples
    )
    return Mesh(devices, ("tiles", "samples"))


def _check_divisible(height: int, n: int) -> None:
    if height % n != 0:
        raise ValueError(
            f"image height {height} must divide evenly across {n} tile shards"
        )


# ---------------------------------------------------------------------------
# cached one-shot renders (jit once per (mesh, shape, spp, cfg))
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tile_render_fn(mesh: Mesh, width: int, height: int, spp: int, cfg):
    n = mesh.devices.size
    rows_per = height // n

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P("tiles"), P()),
        check_vma=False,  # while_loop carries start as unvarying constants
    )
    def shard_fn(scene, camera, seed):
        i = jax.lax.axis_index("tiles")
        first = i.astype(jnp.uint32) * jnp.uint32(rows_per * width)
        pixel_id = first + jnp.arange(rows_per * width, dtype=jnp.uint32)
        sample_ids = jnp.arange(spp, dtype=jnp.uint32)
        rgb_sum, rays = render_tile(
            scene, camera, width, height, pixel_id, sample_ids, seed, cfg
        )
        rays = jax.lax.psum(rays, "tiles")
        return rgb_sum.reshape(rows_per, width, 3), rays

    return jax.jit(shard_fn)


def render_image_sharded(
    scene,
    camera,
    width: int,
    height: int,
    spp: int,
    seed: int = 0,
    cfg=DEFAULT_CONFIG,
    mesh: Mesh | None = None,
):
    """Tile-sharded render over a 1-D mesh. Returns (image (H, W, 3), rays).

    Each device traces `height / n` rows; results concatenate along rows.
    Identical output to `render_image` for any device count.
    """
    if mesh is None:
        mesh = make_mesh()
    _check_divisible(height, mesh.devices.size)
    fn = _tile_render_fn(mesh, width, height, spp, cfg)
    rgb_sum, rays = fn(scene, camera, rng.seed_from_int(seed))
    return rgb_sum / spp, int(rays)


@functools.lru_cache(maxsize=None)
def _wavefront_render_fn(
    mesh: Mesh, width: int, height: int, spp: int, cfg, pool_size
):
    n = mesh.devices.size
    rows_per = height // n
    n_local = rows_per * width

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P("tiles"), P()),
        check_vma=False,
    )
    def shard_fn(scene, camera, seed):
        i = jax.lax.axis_index("tiles")
        fb, rays = trace_wavefront(
            scene, camera, width, height, spp, seed, cfg, pool_size,
            pixel_offset=i.astype(jnp.uint32) * jnp.uint32(n_local),
            n_pixels=n_local,
        )
        return fb.reshape(rows_per, width, 3), jax.lax.psum(rays, "tiles")

    return jax.jit(shard_fn)


def render_image_wavefront_sharded(
    scene,
    camera,
    width: int,
    height: int,
    spp: int,
    seed: int = 0,
    cfg=DEFAULT_CONFIG,
    mesh: Mesh | None = None,
    pool_size: int | None = None,
):
    """Tile-sharded render where each chip runs the persistent-wavefront
    integrator over its own row block — the BASELINE config-5 layout with
    the round's fastest integrator. Each shard's regeneration queue, lane
    pool, and framebuffer scatter are chip-local; the only cross-chip
    traffic is the final framebuffer gather. Bit-identical to the
    single-device wavefront (positional RNG, global pixel ids). Delegates to
    `integrator.trace_wavefront` with a per-shard pixel range, so it honors
    the RenderConfig knobs that path honors (bounces_per_iter, rr_start,
    sort_lanes, ...).
    """
    if spp <= 0:
        raise ValueError(f"spp must be positive, got {spp}")
    if mesh is None:
        mesh = make_mesh()
    _check_divisible(height, mesh.devices.size)
    fn = _wavefront_render_fn(mesh, width, height, spp, cfg, pool_size)
    rgb_sum, rays = fn(scene, camera, rng.seed_from_int(seed))
    return rgb_sum / spp, int(rays)


@functools.lru_cache(maxsize=None)
def _sample_render_fn(mesh: Mesh, width: int, height: int, spp: int, cfg):
    n = mesh.devices.size
    spp_per = spp // n

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def shard_fn(scene, camera, seed):
        i = jax.lax.axis_index("samples")
        pixel_id = jnp.arange(width * height, dtype=jnp.uint32)
        sample_ids = i.astype(jnp.uint32) * jnp.uint32(spp_per) + jnp.arange(
            spp_per, dtype=jnp.uint32
        )
        rgb_sum, rays = render_tile(
            scene, camera, width, height, pixel_id, sample_ids, seed, cfg
        )
        rgb_sum = jax.lax.psum(rgb_sum, "samples")
        rays = jax.lax.psum(rays, "samples")
        return rgb_sum.reshape(height, width, 3), rays

    return jax.jit(shard_fn)


def render_image_sample_sharded(
    scene,
    camera,
    width: int,
    height: int,
    spp: int,
    seed: int = 0,
    cfg=DEFAULT_CONFIG,
    mesh: Mesh | None = None,
):
    """Sample-sharded render: chip i traces samples [i*spp/n, (i+1)*spp/n);
    partial framebuffer sums combine with one psum."""
    if mesh is None:
        mesh = make_mesh(axis="samples")
    n = mesh.devices.size
    if spp % n != 0:
        raise ValueError(f"spp {spp} must divide evenly across {n} shards")
    fn = _sample_render_fn(mesh, width, height, spp, cfg)
    rgb_sum, rays = fn(scene, camera, rng.seed_from_int(seed))
    return rgb_sum / spp, int(rays)


@functools.lru_cache(maxsize=None)
def _sample_wavefront_fn(
    mesh: Mesh, width: int, height: int, spp: int, cfg, pool_size
):
    n = mesh.shape["samples"]
    spp_per = spp // n

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def shard_fn(scene, camera, seed):
        i = jax.lax.axis_index("samples")
        fb, rays = trace_wavefront(
            scene, camera, width, height, spp_per, seed, cfg, pool_size,
            sample_offset=i.astype(jnp.uint32) * jnp.uint32(spp_per),
        )
        fb = jax.lax.psum(fb, "samples")
        return (
            fb.reshape(height, width, 3),
            jax.lax.psum(rays, "samples"),
        )

    return jax.jit(shard_fn)


def render_image_sample_sharded_wavefront(
    scene,
    camera,
    width: int,
    height: int,
    spp: int,
    seed: int = 0,
    cfg=DEFAULT_CONFIG,
    mesh: Mesh | None = None,
    pool_size: int | None = None,
):
    """Sample-sharded render on the persistent-wavefront integrator
    (VERDICT r3 weak #5 — the sample axis previously ran only the slow scan
    integrator): chip i traces samples [i*spp/n, (i+1)*spp/n) of EVERY
    pixel via its own wavefront pool (sample_offset keeps the positional
    RNG streams global), and partial framebuffer sums combine with one
    psum. Bit-identical to the single-device wavefront."""
    if mesh is None:
        mesh = make_mesh(axis="samples")
    n = mesh.devices.size
    if spp % n != 0:
        raise ValueError(f"spp {spp} must divide evenly across {n} shards")
    fn = _sample_wavefront_fn(mesh, width, height, spp, cfg, pool_size)
    rgb_sum, rays = fn(scene, camera, rng.seed_from_int(seed))
    return rgb_sum / spp, int(rays)


@functools.lru_cache(maxsize=None)
def _wavefront_2d_fn(
    mesh: Mesh, width: int, height: int, spp: int, cfg, pool_size
):
    nt = mesh.shape["tiles"]
    ns = mesh.shape["samples"]
    rows_per = height // nt
    n_local = rows_per * width
    spp_per = spp // ns

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P("tiles"), P()),
        check_vma=False,
    )
    def shard_fn(scene, camera, seed):
        ti = jax.lax.axis_index("tiles")
        si = jax.lax.axis_index("samples")
        fb, rays = trace_wavefront(
            scene, camera, width, height, spp_per, seed, cfg, pool_size,
            pixel_offset=ti.astype(jnp.uint32) * jnp.uint32(n_local),
            n_pixels=n_local,
            sample_offset=si.astype(jnp.uint32) * jnp.uint32(spp_per),
        )
        fb = jax.lax.psum(fb, "samples")
        return (
            fb.reshape(rows_per, width, 3),
            jax.lax.psum(rays, ("tiles", "samples")),
        )

    return jax.jit(shard_fn)


def render_image_sharded_2d_wavefront(
    scene,
    camera,
    width: int,
    height: int,
    spp: int,
    seed: int = 0,
    cfg=DEFAULT_CONFIG,
    mesh: Mesh | None = None,
    pool_size: int | None = None,
):
    """Composed tile x sample sharding on the wavefront integrator — the
    full BASELINE config-5 layout at the production integrator's speed.
    Tiles split rows (chip-local pools and scatters); samples split spp;
    the sample-axis psum is the only collective."""
    if mesh is None:
        mesh = make_mesh_2d(jax.device_count() // 2, 2)
    nt = mesh.shape["tiles"]
    ns = mesh.shape["samples"]
    _check_divisible(height, nt)
    if spp % ns != 0:
        raise ValueError(f"spp {spp} must divide across {ns} sample shards")
    fn = _wavefront_2d_fn(mesh, width, height, spp, cfg, pool_size)
    rgb_sum, rays = fn(scene, camera, rng.seed_from_int(seed))
    return rgb_sum / spp, int(rays)


@functools.lru_cache(maxsize=None)
def _render_2d_fn(mesh: Mesh, width: int, height: int, spp: int, cfg):
    nt = mesh.shape["tiles"]
    ns = mesh.shape["samples"]
    rows_per = height // nt
    spp_per = spp // ns

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P("tiles"), P()),
        check_vma=False,
    )
    def shard_fn(scene, camera, seed):
        ti = jax.lax.axis_index("tiles")
        si = jax.lax.axis_index("samples")
        first = ti.astype(jnp.uint32) * jnp.uint32(rows_per * width)
        pixel_id = first + jnp.arange(rows_per * width, dtype=jnp.uint32)
        sample_ids = si.astype(jnp.uint32) * jnp.uint32(spp_per) + jnp.arange(
            spp_per, dtype=jnp.uint32
        )
        rgb_sum, rays = render_tile(
            scene, camera, width, height, pixel_id, sample_ids, seed, cfg
        )
        rgb_sum = jax.lax.psum(rgb_sum, "samples")
        rays = jax.lax.psum(rays, ("tiles", "samples"))
        return rgb_sum.reshape(rows_per, width, 3), rays

    return jax.jit(shard_fn)


def render_image_sharded_2d(
    scene,
    camera,
    width: int,
    height: int,
    spp: int,
    seed: int = 0,
    cfg=DEFAULT_CONFIG,
    mesh: Mesh | None = None,
):
    """Composed tile x sample sharding over a 2-D mesh — the full BASELINE
    config-5 layout. Tiles split rows; samples split spp; the sample-axis
    psum is the only collective."""
    if mesh is None:
        mesh = make_mesh_2d(jax.device_count() // 2, 2)
    nt = mesh.shape["tiles"]
    ns = mesh.shape["samples"]
    _check_divisible(height, nt)
    if spp % ns != 0:
        raise ValueError(f"spp {spp} must divide across {ns} sample shards")
    fn = _render_2d_fn(mesh, width, height, spp, cfg)
    rgb_sum, rays = fn(scene, camera, rng.seed_from_int(seed))
    return rgb_sum / spp, int(rays)


# ---------------------------------------------------------------------------
# progressive tile-sharded accumulation (BASELINE config 5's "progressive")
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _accum_sharded_fn(
    mesh: Mesh, width: int, height: int, n_samples: int, cfg, pool_size
):
    n = mesh.devices.size
    rows_per = height // n
    n_local = rows_per * width

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("tiles"), P(), P(), P(), P()),
        out_specs=(P("tiles"), P()),
        check_vma=False,
    )
    def shard_fn(rgb_local, scene, camera, seed, spp0):
        i = jax.lax.axis_index("tiles")
        fb, rays = trace_wavefront(
            scene, camera, width, height, n_samples, seed, cfg, pool_size,
            pixel_offset=i.astype(jnp.uint32) * jnp.uint32(n_local),
            n_pixels=n_local,
            sample_offset=spp0,
        )
        return (
            rgb_local + fb.reshape(rows_per, width, 3),
            jax.lax.psum(rays, "tiles"),
        )

    return jax.jit(shard_fn, donate_argnums=(0,))


def init_accum_sharded(width: int, height: int, mesh: Mesh) -> AccumState:
    """Row-sharded progressive accumulation state (`AccumState` whose
    rgb_sum lives tile-sharded across the mesh)."""
    _check_divisible(height, mesh.devices.size)
    sharding = NamedSharding(mesh, P("tiles"))
    return AccumState(
        rgb_sum=jax.device_put(
            jnp.zeros((height, width, 3), jnp.float32), sharding
        ),
        spp=jnp.zeros((), jnp.int32),
    )


def accumulate_sharded(
    state: AccumState,
    scene,
    camera,
    n_samples: int,
    seed: int = 0,
    cfg=DEFAULT_CONFIG,
    mesh: Mesh | None = None,
    pool_size: int | None = None,
) -> tuple[AccumState, int]:
    """Add `n_samples` per pixel to a tile-sharded progressive accumulation.

    The multi-chip `pipeline.accumulate`: each chip traces its row block
    with the wavefront integrator (sample ids continue at `state.spp`, so
    the estimate is bit-identical to an unsharded render of the same total
    spp), and the sharded rgb_sum buffer is donated — no host round-trip,
    no per-step re-jit. Checkpoint by gathering `np.asarray(state.rgb_sum)`
    (io.checkpoint works unchanged); resume by `jax.device_put` back onto
    the mesh. Returns (new_state, rays_traced_this_step).
    """
    if n_samples <= 0:
        raise ValueError(f"n_samples must be positive, got {n_samples}")
    if mesh is None:
        mesh = make_mesh()
    height, width = state.rgb_sum.shape[:2]
    _check_divisible(height, mesh.devices.size)
    fn = _accum_sharded_fn(mesh, width, height, int(n_samples), cfg, pool_size)
    rgb_sum, rays = fn(
        state.rgb_sum,
        scene,
        camera,
        rng.seed_from_int(seed),
        state.spp.astype(jnp.uint32),
    )
    return AccumState(rgb_sum=rgb_sum, spp=state.spp + n_samples), int(rays)
