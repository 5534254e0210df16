"""Closest hit on an NVIDIA GPU: a per-ray BVH walk in CUDA, called through
`jax.ffi`.

The kernel (`native/closest_hit.cu`) runs one thread per ray over the BVH
that `upload_scene` already holds, the reference's `firstHitBVH`
(`PathTracing.h:75-204`), and returns the same `(t, idx)` contract as
`traverse.closest_hit_bvh`: `idx = -1` and `t = inf` on a miss or an
inactive ray. It has no CPU or interpret mode; `closest_hit_bvh` is its
plain reference and the CPU route.

The shared library is built from the committed source on first use
(`make -C native gpu`, incremental) or ahead of time with the same command.
A library that is missing or fails to load is an error: the renderer never
falls back to another route behind the caller's back.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from metalpathtracer_tpu.render.intersect import T_MIN

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(REPO, "native")
SOURCE = os.path.join(NATIVE_DIR, "closest_hit.cu")
LIB_PATH = os.path.join(NATIVE_DIR, "build", "libmpt_hit.so")
TARGET = "mpt_closest_hit"
# kMaxStack in closest_hit.cu: the walk pushes at most one node per level
MAX_DEPTH = 62
# rays are padded to whole thread blocks (kBlock in closest_hit.cu)
BLOCK = 128

_registered = False


def build_library() -> float:
    """Run `make -C native gpu`; returns its wall seconds. Raises
    RuntimeError with the compiler's output when the build fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        ["make", "-C", NATIVE_DIR, "gpu", f"PYTHON={sys.executable}"],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            "building the CUDA closest-hit library failed "
            f"(make -C native gpu):\n{proc.stdout}\n{proc.stderr}"
        )
    return time.perf_counter() - t0


def load_library() -> None:
    """Build (if stale) and register the FFI target, once per process."""
    global _registered
    if _registered:
        return
    build_library()
    try:
        lib = ctypes.cdll.LoadLibrary(LIB_PATH)
        handler = lib.MptClosestHit
    except (OSError, AttributeError) as e:
        raise RuntimeError(f"cannot load {LIB_PATH}: {e}") from e
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(handler), platform="CUDA"
    )
    _registered = True


def check_depth(max_depth: int) -> None:
    if max_depth > MAX_DEPTH:
        raise ValueError(
            f"BVH depth {max_depth} exceeds the CUDA walk's stack "
            f"(at most {MAX_DEPTH}; kMaxStack in native/closest_hit.cu)"
        )


def pad_rays(o, d, active, t_max):
    """Pad the ray arrays to whole thread blocks of BLOCK rays. Padding rays
    are inactive (they walk nothing) and point along +1 (no zero
    division)."""
    n = o.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    if t_max is None:
        t_max = jnp.full((n,), jnp.inf, jnp.float32)
    pad = (-n) % BLOCK
    return (
        jnp.pad(o.astype(jnp.float32), ((0, pad), (0, 0))),
        jnp.pad(d.astype(jnp.float32), ((0, pad), (0, 0)),
                constant_values=1.0),
        jnp.pad(active.astype(bool), (0, pad)),
        jnp.pad(t_max.astype(jnp.float32), (0, pad)),
    )


def closest_hit_cuda(scene, o, d, t_min=T_MIN, active=None, t_max=None):
    """Closest hit of rays `o`, `d` (N, 3) float32 against `scene`.

    `active` (N,) bool masks rays out (they return a miss without walking);
    `t_max` (N,) float32 bounds the hit distance, as an occlusion query
    needs. Returns (t float32 (N,), idx int32 (N,)). The FFI target must be
    registered (`load_library`) before the caller's jit lowers.
    """
    check_depth(int(scene.max_depth))
    n = o.shape[0]
    o, d, active, t_max = pad_rays(o, d, active, t_max)
    m = o.shape[0]
    call = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((m,), jnp.float32),
         jax.ShapeDtypeStruct((m,), jnp.int32)),
        vmap_method="broadcast_all",
    )
    t, idx = call(
        o, d, active, t_max,
        scene.node_lo, scene.node_hi, scene.node_a, scene.node_b,
        scene.prim_indices, scene.prim_type, scene.p0, scene.p1, scene.p2,
        t_min=np.float32(t_min), max_depth=np.int32(scene.max_depth),
    )
    return t[:n], idx[:n]
