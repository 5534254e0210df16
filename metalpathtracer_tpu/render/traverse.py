"""Wavefront BVH traversal inside `jax.lax.while_loop`.

Plain-JAX counterpart of the reference's per-thread stack traversal
(`firstHitBVH`, `MetalCpp Path Tracer/Renderer/Shaders/PathTracing.h:75-204`),
and the plain reference of the CUDA walk in `render/hit_cuda.py`:

- Every ray in the wavefront carries its own fixed-size stack as a row of an
  (N, S) int32 array; all rays step in lockstep (one node pop per ray per
  iteration) with masking instead of per-lane control flow.
- The stack bound S comes from the *actual* tree depth measured at build time
  (+2 slack), not a hardcoded 64 (`PathTracing.h:86`), keeping carried state
  small.
- Leaf handling is one dense (N, 8) intersection block per iteration
  (LEAF_SIZE = 8, reference `Scene/Scene.h:223`) rather than a scalar loop.
- The AABB test prunes against each ray's current best t, exactly like the
  reference passing `in.t` as tMax (`PathTracing.h:100`).
- The loop exits when every ray's stack is empty — a global early-exit the
  megakernel gets per-thread but a lockstep wavefront must take
  collectively.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from metalpathtracer_tpu.accel.bvh import LEAF_SIZE
from metalpathtracer_tpu.render.intersect import (
    INF,
    T_MIN,
    intersect_prims_block,
    ray_aabb,
)


def closest_hit_bvh(scene, o, d, t_min=T_MIN, active=None, t_max=None):
    """Closest hit via BVH traversal.

    Args: `scene` DeviceScene, `o`/`d` float32 (N, 3); optional `active`
    (N,) bool (masked rays walk nothing) and `t_max` (N,) float32 (hits
    must be nearer, the reference's `in.t` tMax). Returns (t, prim_idx):
    float32 (N,), int32 (N,) with (inf, -1) on a miss or an inactive ray.
    """
    n = o.shape[0]
    stack_size = int(scene.max_depth) + 2
    rows = jnp.arange(n, dtype=jnp.int32)
    inv_d = 1.0 / d  # inf on zero components is fine, like the reference

    stack = jnp.zeros((n, stack_size), jnp.int32)  # slot 0 preloaded with root 0
    sp = (jnp.ones((n,), jnp.int32) if active is None
          else active.astype(jnp.int32))
    best_t = (jnp.full((n,), INF) if t_max is None
              else t_max.astype(jnp.float32))
    best_i = jnp.full((n,), -1, jnp.int32)
    leaf_arange = jnp.arange(LEAF_SIZE, dtype=jnp.int32)[None, :]

    def cond(state):
        _, sp, _, _ = state
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, best_t, best_i = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = jnp.where(active, stack[rows, top], 0)
        sp = jnp.where(active, sp - 1, sp)

        lo = scene.node_lo[node]
        hi = scene.node_hi[node]
        a = scene.node_a[node]
        b = scene.node_b[node]

        hit_box = active & ray_aabb(o, inv_d, lo, hi, t_min, best_t)
        is_leaf = b > 0

        # --- leaf: one (N, 8) gathered intersection block ---
        slot = a[:, None] + leaf_arange  # (N, 8) slots into prim_indices
        lane_ok = hit_box[:, None] & is_leaf[:, None] & (leaf_arange < b[:, None])
        slot = jnp.clip(slot, 0, scene.prim_indices.shape[0] - 1)
        pidx = scene.prim_indices[slot]  # (N, 8) primitive ids
        t_blk = intersect_prims_block(
            o[:, None, :],
            d[:, None, :],
            scene.prim_type[pidx],
            scene.p0[pidx],
            scene.p1[pidx],
            scene.p2[pidx],
            t_min,
        )
        t_blk = jnp.where(lane_ok, t_blk, INF)
        j = jnp.argmin(t_blk, axis=1)
        t_leaf = t_blk[rows, j]
        better = t_leaf < best_t
        best_t = jnp.where(better, t_leaf, best_t)
        best_i = jnp.where(better, pidx[rows, j], best_i)

        # --- internal: push left then right child (popped right-first, like
        # the reference PathTracing.h:189-191) ---
        push = hit_box & ~is_leaf
        can_push = push & (sp + 2 <= stack_size)
        drop = jnp.int32(stack_size)  # out-of-range column → dropped write
        col0 = jnp.where(can_push, sp, drop)
        col1 = jnp.where(can_push, sp + 1, drop)
        stack = stack.at[rows, col0].set(a, mode="drop")
        stack = stack.at[rows, col1].set(-b, mode="drop")
        sp = jnp.where(can_push, sp + 2, sp)
        return stack, sp, best_t, best_i

    _, _, best_t, best_i = jax.lax.while_loop(
        cond, body, (stack, sp, best_t, best_i)
    )
    return jnp.where(best_i >= 0, best_t, INF), best_i
