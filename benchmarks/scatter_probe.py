"""Microbench: fb scatter-add vs a sort-compaction log endgame.

The wavefront banks finished lanes into the framebuffer with one
scatter-add per feed window (`integrator.trace_wavefront`). Pixel-group
banking and the capped scatter exist for a scatter that costs per update
row however many rows are masked drops; this measures whether it does. The alternative
measured here: per body, argsort the pending banks (banked-first) + gather
the packed (pool, 4) rows + dynamic_update_slice-append into a
(total+pool, 4) log; at the end, ONE argsort of the log by pixel key turns
the framebuffer into a dense slice — no scatter anywhere.

Each leg chains several iterations inside one jit and waits with
`block_until_ready`. Usage: python benchmarks/scatter_probe.py
"""

from __future__ import annotations

import os
import sys
import time


def timed(fn, *args, reps=3):
    jax.block_until_ready(fn(*args))
    best = 1e9
    for _r in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


if __name__ == "__main__":
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from metalpathtracer_tpu.utils import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    print(f"device: {jax.devices()[0].device_kind}")
    POOL = 1 << 14
    N_PIX = 921600
    BODIES = 16
    L = N_PIX + POOL

    key = jax.random.PRNGKey(0)
    # ~88% of rows banked, random pixel targets
    idx = jax.random.randint(key, (POOL,), 0, N_PIX, jnp.int32)
    bank = jax.random.uniform(jax.random.PRNGKey(1), (POOL,)) < 0.88
    pend_idx = jnp.where(bank, idx, N_PIX)
    pend_rgb = jax.random.uniform(jax.random.PRNGKey(2), (POOL, 3))

    # --- A: the incumbent scatter-add, BODIES calls chained ---
    @jax.jit
    def scatter_chain(fb, pend_idx, pend_rgb):
        def body(i, fb):
            return fb.at[pend_idx + (i % 7)].add(
                pend_rgb, mode="drop", unique_indices=True
            )
        return jax.lax.fori_loop(0, BODIES, body, fb)

    fb0 = jnp.zeros((N_PIX, 3), jnp.float32)
    t = timed(scatter_chain, fb0, pend_idx, pend_rgb)
    print(flush=True); print(f"A scatter-add      : {t*1e3:8.2f} ms total, "
          f"{t/BODIES*1e6:7.1f} us/body")

    # --- B: per-body compaction + DUS append, BODIES calls chained ---
    @jax.jit
    def log_chain(log, pend_idx, pend_rgb):
        def body(i, carry):
            log, cursor = carry
            k = (pend_idx + (i % 7)).astype(jnp.uint32)
            perm = jnp.argsort(k)  # banked (k < N_PIX) first, drops last
            packed = jnp.concatenate(
                [k[:, None].astype(jnp.float32), pend_rgb], axis=1
            )[perm]
            log = jax.lax.dynamic_update_slice(log, packed, (cursor, 0))
            nb = jnp.sum(k < N_PIX, dtype=jnp.int32)
            return log, jnp.minimum(cursor + nb, L - POOL)
        log, cursor = jax.lax.fori_loop(0, BODIES, body, (log, 0))
        return log

    log0 = jnp.full((L, 4), float(N_PIX), jnp.float32)
    t = timed(log_chain, log0, pend_idx, pend_rgb)
    print(f"B compact+append   : {t*1e3:8.2f} ms total, "
          f"{t/BODIES*1e6:7.1f} us/body")

    # --- C: the final global sort -> dense fb, ONE call ---
    big_key = jax.random.randint(jax.random.PRNGKey(3), (L,), 0, N_PIX + 1,
                                 jnp.int32)
    big_rgb = jax.random.uniform(jax.random.PRNGKey(4), (L, 3))

    @jax.jit
    def final_argsort_gather(k, rgb):
        perm = jnp.argsort(k.astype(jnp.uint32))
        return rgb[perm][:N_PIX]

    t = timed(final_argsort_gather, big_key, big_rgb)
    print(f"C argsort+gather   : {t*1e3:8.2f} ms (one call, {L} rows)")

    @jax.jit
    def final_multisort(k, rgb):
        out = jax.lax.sort(
            (k, rgb[:, 0], rgb[:, 1], rgb[:, 2]), num_keys=1
        )
        return jnp.stack(out[1:], axis=1)[:N_PIX]

    t = timed(final_multisort, big_key, big_rgb)
    print(f"C multisort        : {t*1e3:8.2f} ms (one call, {L} rows)")

    @jax.jit
    def final_packed_sort(k, rgb):
        # pack (key, rgb) into one (L, 4) array, argsort + row gather
        packed = jnp.concatenate(
            [k[:, None].astype(jnp.float32), rgb], axis=1
        )
        perm = jnp.argsort(k.astype(jnp.uint32))
        return packed[perm][:N_PIX, 1:]

    t = timed(final_packed_sort, big_key, big_rgb)
    print(f"C packedsort       : {t*1e3:8.2f} ms (one call, {L} rows)")
