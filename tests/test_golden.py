"""Golden-image regression tests (SURVEY.md §4.2).

Goldens are committed CPU renders with pinned seeds. They catch silent
estimator changes: any edit to RNG streams, BSDF math, intersection
acceptance, or accumulation order shows up as an RMSE jump. Regenerate
deliberately with `python tests/test_golden.py regen` after an intended
estimator change.
"""

import os
import sys

# allow direct execution (`python tests/test_golden.py regen`): python puts
# tests/ on sys.path, not the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from metalpathtracer_tpu.render import Camera, RenderConfig, render_image, upload_scene
from metalpathtracer_tpu.scene import presets
from metalpathtracer_tpu.utils import rmse

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

CASES = {
    "cornell_64_diffuse": dict(
        scene=lambda: presets.cornell_spheres(),
        camera=lambda: Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0),
        width=64, height=64, spp=8, seed=42,
        cfg=RenderConfig(max_depth=8),
    ),
    "cornell_materials": dict(
        scene=lambda: presets.cornell_materials(),
        camera=lambda: Camera.look_at((0, 2.5, 9.0), (0, 2.5, 0), vfov_deg=40.0),
        width=48, height=48, spp=8, seed=7,
        cfg=RenderConfig(max_depth=8),
    ),
    "reference_scene": dict(
        scene=lambda: presets.reference_default(
            os.path.join(os.path.dirname(GOLDEN_DIR), "..", "assets", "bunny.obj")
        ),
        camera=lambda: Camera.reset(),
        width=64, height=36, spp=4, seed=3,
        cfg=RenderConfig(max_depth=8),
    ),
}


def _render(case):
    scene = upload_scene(case["scene"]())
    img, _ = render_image(
        scene, case["camera"](), case["width"], case["height"],
        case["spp"], seed=case["seed"], cfg=case["cfg"],
    )
    return np.asarray(img)


def _golden_path(name):
    return os.path.join(GOLDEN_DIR, f"{name}.npz")


def regen():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, case in CASES.items():
        img = _render(case)
        np.savez_compressed(_golden_path(name), image=img)
        print(f"wrote {name}: mean={img.mean():.4f}")


def _check(name):
    case = CASES[name]
    with np.load(_golden_path(name)) as z:
        golden = z["image"]
    img = _render(case)
    err = rmse(img, golden)
    assert err < 1e-4, f"{name}: RMSE {err} vs golden (estimator changed?)"


def test_golden_cornell():
    _check("cornell_64_diffuse")


def test_golden_materials():
    _check("cornell_materials")


def test_golden_reference_scene():
    _check("reference_scene")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        import jax

        # goldens are CPU renders: never bake an accelerator's fp into them
        jax.config.update("jax_platforms", "cpu")
        regen()
