"""The production closest-hit route must agree with the brute-force oracle.

`integrator.closest_hit` with intersector="auto" is the route the renderer
takes: the CUDA BVH walk on a GPU, the plain-JAX traversal
(`traverse.closest_hit_bvh`) here on the CPU. (The module and test names
date from the matmul intersector this route replaced.)
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metalpathtracer_tpu.render import Camera, RenderConfig, render_image, upload_scene
from metalpathtracer_tpu.render.integrator import closest_hit, resolve_intersector
from metalpathtracer_tpu.render.intersect import closest_hit_bruteforce
from metalpathtracer_tpu.scene import HostScene, Material, load_scene_xml, presets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_rays(n, seed=0, origin_span=30.0, center=(0, 20, 40)):
    r = np.random.default_rng(seed)
    o = r.uniform(-origin_span, origin_span, (n, 3)).astype(np.float32)
    o += np.asarray(center, np.float32)
    d = r.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("n", [64, 700, 2048])
def test_mm_matches_bruteforce_bunny(n):
    scene = upload_scene(load_scene_xml(os.path.join(REPO, "scenes", "reference.xml")))
    o, d = random_rays(n, seed=n)
    t0, i0 = closest_hit_bruteforce(scene, o, d)
    t1, i1 = closest_hit(scene, o, d)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i0))
    f = np.isfinite(np.asarray(t0))
    assert f.sum() > n // 10
    np.testing.assert_allclose(
        np.asarray(t1)[f], np.asarray(t0)[f], rtol=5e-4, atol=1e-2
    )


def test_mm_giant_sphere_precision():
    # r=10000 ground sphere: |c|^2 ~ 1e8 is where f32 cancellation bites;
    # the route must keep the oracle's t and its far-root floor
    s = HostScene()
    s.add_sphere((0, -10000, 0), 10000.0, Material())
    scene = upload_scene(s)
    o = jnp.array([[0.0, 5.0, 0.0]] * 4)
    d = jnp.asarray(
        np.array([[0, -1, 0], [0.6, -0.8, 0], [0, -0.7071, 0.7071], [1, 0, 0]],
                 np.float32)
    )
    t, idx = closest_hit(scene, o, d)
    t = np.asarray(t)
    np.testing.assert_allclose(t[0], 5.0, atol=1e-3)
    assert int(idx[3]) == -1  # horizontal ray misses
    # oracle agreement
    t0, i0 = closest_hit_bruteforce(scene, o, d)
    np.testing.assert_allclose(t[:3], np.asarray(t0)[:3], rtol=1e-6)


def test_mm_in_integrator_matches_brute_render():
    scene = upload_scene(presets.cornell_mesh(subdivisions=1))
    cam = Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)
    a, _ = render_image(scene, cam, 24, 24, spp=2, seed=5,
                        cfg=RenderConfig(max_depth=6, intersector="brute"))
    b, _ = render_image(scene, cam, 24, 24, spp=2, seed=5,
                        cfg=RenderConfig(max_depth=6, intersector="auto"))
    a, b = np.asarray(a), np.asarray(b)
    # same estimator + same RNG streams; a handful of pixels may diverge
    # where fp tie-breaks at grazing hits send the path down a different
    # (equally valid) bounce chain — bound the divergent fraction
    diff = np.abs(a - b)
    assert (diff > 1e-3).mean() < 0.02
    assert abs(a.mean() - b.mean()) < 5e-3


def test_auto_always_selects_mm():
    # "auto" is the plain-JAX traversal on this backend; the matmul route
    # is gone and its name is refused
    assert jax.default_backend() == "cpu"
    assert resolve_intersector("auto", jax.default_backend()) == "bvh"
    with pytest.raises(ValueError, match="unknown intersector"):
        resolve_intersector("mm", "cpu")
    with pytest.raises(ValueError, match="unknown intersector"):
        closest_hit(None, jnp.zeros((1, 3)), jnp.ones((1, 3)), "mm")


def test_mm_streaming_large_mesh():
    # two 20,480-tri icospheres: a mesh far past what the old matmul
    # kernel held resident; the walk must agree with brute force on ids
    from metalpathtracer_tpu.scene.procgen import icosphere

    v, f = icosphere(5, radius=2.0)  # 20480 tris
    s = HostScene()
    s.add_mesh(v, f, position=(0, 0, -5), scale=1.0, material=Material())
    s.add_mesh(v, f, position=(4, 0, -8), scale=0.8,
               material=Material(albedo=(0.9, 0.2, 0.2)))
    scene = upload_scene(s)
    assert scene.num_tris == 2 * 20480

    # rays aimed at the first mesh from a small origin cloud
    r = np.random.default_rng(11)
    o = r.uniform(-1.5, 1.5, (512, 3)).astype(np.float32) + np.array(
        [0, 0, 2], np.float32
    )
    target = r.uniform(-1.8, 1.8, (512, 3)).astype(np.float32) + np.array(
        [0, 0, -5], np.float32
    )
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    t0, i0 = closest_hit_bruteforce(scene, o, d)
    t1, i1 = closest_hit(scene, o, d)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i0))
    hit = np.asarray(i0) >= 0
    assert hit.sum() > 50
    np.testing.assert_allclose(
        np.asarray(t1)[hit], np.asarray(t0)[hit], rtol=5e-4, atol=1e-2
    )
