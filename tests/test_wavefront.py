"""The regeneration wavefront must compute EXACTLY the scan integrator's
estimate — RNG streams are positional, so lane assignment cannot matter."""

import numpy as np
import pytest

from metalpathtracer_tpu.render import (
    Camera,
    RenderConfig,
    render_image,
    render_image_wavefront,
    upload_scene,
)
from metalpathtracer_tpu.scene import presets

CAM = Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)


@pytest.fixture(scope="module")
def cornell():
    return upload_scene(presets.cornell_spheres())


def test_wavefront_matches_scan(cornell):
    cfg = RenderConfig(max_depth=6)
    a, ra = render_image(cornell, CAM, 24, 24, spp=4, seed=5, cfg=cfg)
    b, rb = render_image_wavefront(
        cornell, CAM, 24, 24, spp=4, seed=5, cfg=cfg, pool_size=512
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    assert ra == rb  # identical rays traced


def test_wavefront_pool_size_invariant(cornell):
    cfg = RenderConfig(max_depth=4)
    imgs = []
    for pool in (256, 1024, 24 * 24 * 2):
        img, _ = render_image_wavefront(
            cornell, CAM, 24, 24, spp=2, seed=9, cfg=cfg, pool_size=pool
        )
        imgs.append(np.asarray(img))
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(imgs[0], imgs[2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bank_k", [2, 4])
def test_wavefront_bank_k_matches_scan(cornell, bank_k):
    # ADVICE r3: the pixel-group banking restructure (widened one-hot
    # accumulator, pend slots riding the sort permutation, (groups, 3K) fb
    # reshape) must be validated on CPU, not only on chip — the auto picker
    # selects K=1 at every test geometry, so pin cfg.bank_k explicitly.
    # n_pix=576, pool=128 -> spb == spp and n_pix//k >= pool for k <= 4.
    cfg = RenderConfig(max_depth=6, bank_k=bank_k)
    a, ra = render_image(cornell, CAM, 24, 24, spp=4, seed=11, cfg=cfg)
    b, rb = render_image_wavefront(
        cornell, CAM, 24, 24, spp=4, seed=11, cfg=cfg, pool_size=128
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-6)
    assert ra == rb


def test_wavefront_with_rr_and_nee(cornell):
    cfg = RenderConfig(max_depth=8, rr_start=2, nee=True)
    a, _ = render_image(cornell, CAM, 16, 16, spp=4, seed=3, cfg=cfg)
    b, _ = render_image_wavefront(
        cornell, CAM, 16, 16, spp=4, seed=3, cfg=cfg, pool_size=333
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_wavefront_open_scene(cornell):
    # open scene: most paths terminate on bounce 1 — regeneration keeps the
    # pool dense and the result identical
    scene = upload_scene(presets.reference_default())
    cam = Camera.reset()
    cfg = RenderConfig(max_depth=8)
    a, ra = render_image(scene, cam, 32, 18, spp=2, seed=1, cfg=cfg)
    b, rb = render_image_wavefront(
        scene, cam, 32, 18, spp=2, seed=1, cfg=cfg, pool_size=128
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    assert ra == rb


def test_wavefront_bank_k_scatter_cap_matches_scan():
    """bank_k > 1 pixel-group banking under the capped fb scatter must
    still equal the scan integrator exactly (same (pixel, sample) set,
    positional RNG). Geometry chosen so the scatter-cap gate engages:
    triangle scene (scatter_cap needs tris), spb == spp, bank_k > 1,
    groups >= pool."""
    scene = upload_scene(presets.reference_default())
    cam = Camera.reset()
    cfg = RenderConfig(max_depth=6, bank_k=2, sort_lanes=True)
    # n_pix = 64*36 = 2304, pool 128: groups = 1152 >= pool, spb = spp = 4,
    # per_item = 8 -> cut cycles [1, 7]
    a, ra = render_image(scene, cam, 64, 36, spp=4, seed=7, cfg=cfg)
    b, rb = render_image_wavefront(
        scene, cam, 64, 36, spp=4, seed=7, cfg=cfg, pool_size=128
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-6)
    assert ra == rb


def test_wavefront_clamp(cornell):
    cfg = RenderConfig(max_depth=4, clamp_radiance=True)
    img, _ = render_image_wavefront(
        cornell, CAM, 16, 16, spp=2, seed=4, cfg=cfg, pool_size=256
    )
    assert float(np.asarray(img).max()) <= 1.0


def test_wavefront_rejects_bad_spp(cornell):
    with pytest.raises(ValueError):
        render_image_wavefront(cornell, CAM, 8, 8, spp=0)


def test_wavefront_bounces_per_iter_invariant(cornell):
    base, rb = render_image(cornell, CAM, 24, 24, spp=4, seed=5,
                            cfg=RenderConfig(max_depth=6), spp_per_pass=4)
    for bpi in (2, 3):
        img, r = render_image_wavefront(
            cornell, CAM, 24, 24, spp=4, seed=5,
            cfg=RenderConfig(max_depth=6, bounces_per_iter=bpi), pool_size=512,
        )
        np.testing.assert_allclose(np.asarray(img), np.asarray(base),
                                   rtol=1e-5, atol=1e-6)
        assert r == rb


def test_accumulate_wavefront_matches_scan_accumulate():
    """The viewer's progressive fast path (accumulate_wavefront, sample
    ids continuing at state.spp) must agree with the scan-based
    accumulate step for step."""
    import jax.numpy as jnp

    from metalpathtracer_tpu.render import (
        accumulate,
        accumulate_wavefront,
        init_accum,
        upload_scene,
    )
    from metalpathtracer_tpu.render.integrator import RenderConfig
    from metalpathtracer_tpu.scene import presets
    from metalpathtracer_tpu.render import Camera

    scene = upload_scene(presets.cornell_spheres())
    cam = Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0)
    cfg = RenderConfig(max_depth=4)

    a = init_accum(24, 24)
    b = init_accum(24, 24)
    for _ in range(2):
        a = accumulate(a, scene, cam, 24, 24, 2, jnp.uint32(0), cfg)
        b, rays = accumulate_wavefront(
            b, scene, cam, 24, 24, 2, jnp.uint32(0), cfg, pool_size=256
        )
        assert int(rays) > 0
    assert int(a.spp) == int(b.spp) == 4
    np.testing.assert_allclose(
        np.asarray(a.rgb_sum), np.asarray(b.rgb_sum), rtol=1e-5, atol=1e-6
    )


def test_wavefront_two_word_sort_key_matches_scan():
    """The lane sort (Morton origin + octant key, pend-first bit in the
    window-final sort — integrator.maybe_sort) must leave the estimate
    untouched on a dense triangle scene: RNG streams are positional, so
    the sort permutation cannot matter. (The name dates from a two-word
    sort key that was removed with the matmul intersector.)"""
    scene = upload_scene(presets.random_tri_cloud(8192, seed=3))
    assert scene.num_tris == 8192
    cam = Camera.look_at((0, 0, 28.0), (0, 0, 0), vfov_deg=45.0)
    cfg = RenderConfig(max_depth=4, sort_lanes=True)
    a, ra = render_image(scene, cam, 16, 16, spp=2, seed=13, cfg=cfg)
    b, rb = render_image_wavefront(
        scene, cam, 16, 16, spp=2, seed=13, cfg=cfg, pool_size=256
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-6)
    assert ra == rb
