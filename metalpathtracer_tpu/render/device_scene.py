"""DeviceScene: the packed scene + BVH as a JAX pytree of device arrays.

This is the JAX equivalent of the reference's GPU buffer set — the seven
fragment-shader bindings built in `Renderer::buildBuffers` /
`updateVisibleScene` (`MetalCpp Path Tracer/Renderer/Renderer.cpp:114-149,
184-223`): primitives, materials, BVH nodes, and the primitive index
permutation. Scene buffers are small (a few MB even at bunny scale) so under
multi-device sharding they are fully replicated per device (SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from metalpathtracer_tpu.accel.bvh import BVHArrays, build_bvh
from metalpathtracer_tpu.scene.types import PRIM_TRIANGLE, HostScene, PackedScene


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceScene:
    # primitives (SoA, padded)
    prim_type: jax.Array  # int32 (P,)
    p0: jax.Array  # float32 (P, 3)
    p1: jax.Array  # float32 (P, 3)
    p2: jax.Array  # float32 (P, 3)
    # materials
    albedo: jax.Array  # float32 (P, 3)
    material_type: jax.Array  # float32 (P,)
    emission_color: jax.Array  # float32 (P, 3)
    emission_power: jax.Array  # float32 (P,)
    fuzz: jax.Array  # float32 (P,)
    # linearized BVH
    node_lo: jax.Array  # float32 (M, 3)
    node_hi: jax.Array  # float32 (M, 3)
    node_a: jax.Array  # int32 (M,)
    node_b: jax.Array  # int32 (M,)
    prim_indices: jax.Array  # int32 (P,)
    # packed per-primitive tables: ONE gather per bounce instead of many.
    # geom: [p0(3), p1(3), p2(3), prim_type, 0, 0, 0, 0, 0, 0, 0]
    # mat:  [albedo(3), material_type, emission(3), power, fuzz, 0, ...]
    geom_table: jax.Array  # float32 (P, 16)
    mat_table: jax.Array  # float32 (P, 16)
    # material-bank indirection: scenes have few DISTINCT materials (one per
    # mesh/sphere), so the per-bounce material fetch becomes a 4-byte id
    # gather + a one-hot (N, M) @ (M, 16) product instead of a 64-byte row
    # gather.
    prim_mat_id: jax.Array  # int32 (P,)
    mat_bank: jax.Array  # float32 (M, 16), M padded to 8
    # light table for next-event estimation + MIS (integrator._sample_light):
    # every emissive primitive (sphere or triangle), power-weighted pick.
    # The reference has no light sampling at all (`PathTracing.h:207-259`
    # finds lights only by random hits); this is the BASELINE config-4 axis.
    light_kind: jax.Array  # int32 (L,) 0=sphere, 1=triangle
    light_prim: jax.Array  # int32 (L,) original primitive index
    light_q0: jax.Array  # float32 (L, 3) sphere center / tri v0
    light_e1: jax.Array  # float32 (L, 3) tri edge1; sphere [r, 0, 0]
    light_e2: jax.Array  # float32 (L, 3) tri edge2
    light_normal: jax.Array  # float32 (L, 3) unit normal (tris; 0 for spheres)
    light_emission: jax.Array  # float32 (L, 3) emission_color * power
    light_area: jax.Array  # float32 (L,) surface area
    light_pick_p: jax.Array  # float32 (L,) pick probability (flux-weighted)
    light_cdf: jax.Array  # float32 (L,) inclusive CDF over pick_p
    prim_light_id: jax.Array  # int32 (P,) light row per prim, -1 if none
    # static metadata (not traced)
    num_real: int = dataclasses.field(metadata=dict(static=True))
    max_depth: int = dataclasses.field(metadata=dict(static=True))
    num_tris: int = dataclasses.field(metadata=dict(static=True))
    num_lights: int = dataclasses.field(metadata=dict(static=True))


def _build_light_table(packed: PackedScene) -> dict:
    """Host-side light table over every emissive primitive. Pick weights are
    proportional to radiant flux (max emission channel x power x area), so a
    dim candle is rarely sampled next to a bright panel."""
    p = packed.num_padded
    real = np.arange(p) < packed.num_real
    brightness = packed.emission_power * packed.emission_color.max(axis=-1)
    sel = np.nonzero(real & (brightness > 0.0))[0].astype(np.int32)
    n = len(sel)

    kind = np.where(
        packed.prim_type[sel] == PRIM_TRIANGLE, 1, 0
    ).astype(np.int32)
    q0 = packed.p0[sel].astype(np.float32)
    e1 = np.where(
        kind[:, None] == 1,
        packed.p1[sel] - packed.p0[sel],
        np.concatenate(
            [packed.p1[sel, 0:1], np.zeros((n, 2), np.float32)], axis=1
        ),
    ).astype(np.float32)
    e2 = np.where(
        kind[:, None] == 1, packed.p2[sel] - packed.p0[sel], 0.0
    ).astype(np.float32)
    cr = np.cross(e1, e2)
    crlen = np.linalg.norm(cr, axis=-1)
    normal = np.where(
        (kind == 1)[:, None] & (crlen > 0)[:, None],
        cr / np.maximum(crlen, 1e-20)[:, None],
        0.0,
    ).astype(np.float32)
    radius = packed.p1[sel, 0]
    area = np.where(
        kind == 1, 0.5 * crlen, 4.0 * np.pi * radius * radius
    ).astype(np.float32)
    weight = brightness[sel] * area
    total = weight.sum()
    pick_p = (weight / total if total > 0 else weight).astype(np.float32)

    # pad to >= 1 row so the table is never empty (zero-weight padding)
    pad = max(1 - n, 0)

    def padr(a, fill=0):
        return np.concatenate(
            [a, np.full((pad, *a.shape[1:]), fill, a.dtype)]
        ) if pad else a

    prim_light_id = np.full(p, -1, np.int32)
    prim_light_id[sel] = np.arange(n, dtype=np.int32)

    cdf = np.cumsum(padr(pick_p))
    if total > 0:
        cdf[-1] = 1.0  # guard fp drift so searchsorted never overruns

    return dict(
        kind=padr(kind),
        prim=padr(sel, fill=-1),
        q0=padr(q0),
        e1=padr(e1),
        e2=padr(e2),
        normal=padr(normal),
        emission=padr(
            (packed.emission_color[sel]
             * packed.emission_power[sel, None]).astype(np.float32)
        ),
        area=padr(area),
        pick_p=padr(pick_p),
        cdf=cdf.astype(np.float32),
        prim_light_id=prim_light_id,
        n=n,
    )


def upload_scene(
    packed: PackedScene | HostScene, bvh: BVHArrays | None = None
) -> DeviceScene:
    """Pack (if needed), build the BVH (if not given), and move to device."""
    if isinstance(packed, HostScene):
        packed = packed.pack()
    if bvh is None:
        bvh = build_bvh(packed)

    p = packed.num_padded
    prim_indices = np.zeros(p, np.int32)
    prim_indices[: bvh.prim_indices.shape[0]] = bvh.prim_indices

    geom = np.zeros((p, 16), np.float32)
    geom[:, 0:3] = packed.p0
    geom[:, 3:6] = packed.p1
    geom[:, 6:9] = packed.p2
    geom[:, 9] = packed.prim_type
    mat = np.zeros((p, 16), np.float32)
    mat[:, 0:3] = packed.albedo
    mat[:, 3] = packed.material_type
    mat[:, 4:7] = packed.emission_color
    mat[:, 7] = packed.emission_power
    mat[:, 8] = packed.fuzz

    lights = _build_light_table(packed)

    mat_bank, prim_mat_id = np.unique(mat, axis=0, return_inverse=True)
    pad_m = (-mat_bank.shape[0]) % 8
    mat_bank = np.concatenate(
        [mat_bank, np.zeros((pad_m, 16), np.float32)]
    ).astype(np.float32)
    prim_mat_id = prim_mat_id.astype(np.int32)

    return DeviceScene(
        prim_type=jax.numpy.asarray(packed.prim_type),
        p0=jax.numpy.asarray(packed.p0),
        p1=jax.numpy.asarray(packed.p1),
        p2=jax.numpy.asarray(packed.p2),
        albedo=jax.numpy.asarray(packed.albedo),
        material_type=jax.numpy.asarray(packed.material_type),
        emission_color=jax.numpy.asarray(packed.emission_color),
        emission_power=jax.numpy.asarray(packed.emission_power),
        fuzz=jax.numpy.asarray(packed.fuzz),
        node_lo=jax.numpy.asarray(bvh.node_lo),
        node_hi=jax.numpy.asarray(bvh.node_hi),
        node_a=jax.numpy.asarray(bvh.node_a),
        node_b=jax.numpy.asarray(bvh.node_b),
        prim_indices=jax.numpy.asarray(prim_indices),
        geom_table=jax.numpy.asarray(geom),
        mat_table=jax.numpy.asarray(mat),
        prim_mat_id=jax.numpy.asarray(prim_mat_id),
        mat_bank=jax.numpy.asarray(mat_bank),
        light_kind=jax.numpy.asarray(lights["kind"]),
        light_prim=jax.numpy.asarray(lights["prim"]),
        light_q0=jax.numpy.asarray(lights["q0"]),
        light_e1=jax.numpy.asarray(lights["e1"]),
        light_e2=jax.numpy.asarray(lights["e2"]),
        light_normal=jax.numpy.asarray(lights["normal"]),
        light_emission=jax.numpy.asarray(lights["emission"]),
        light_area=jax.numpy.asarray(lights["area"]),
        light_pick_p=jax.numpy.asarray(lights["pick_p"]),
        light_cdf=jax.numpy.asarray(lights["cdf"]),
        prim_light_id=jax.numpy.asarray(lights["prim_light_id"]),
        num_real=int(packed.num_real),
        max_depth=int(bvh.max_depth),
        num_tris=int(np.sum(packed.prim_type == PRIM_TRIANGLE)),
        num_lights=int(lights["n"]),
    )
