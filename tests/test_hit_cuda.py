"""The CUDA closest-hit wrapper (`render/hit_cuda.py`).

The kernel itself runs only on an NVIDIA GPU (a CUDA custom call has no
interpret mode); the tests marked `gpu` check it there and skip elsewhere.
Everything around it — shapes, padding, the choice of route, the build and
its failures — is Python that these CPU tests reach. `closest_hit_bvh`,
the kernel's plain reference, is checked against brute force in
test_render.py and test_intersect_mm.py.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metalpathtracer_tpu.render import hit_cuda, integrator, upload_scene
from metalpathtracer_tpu.render.integrator import closest_hit, resolve_intersector
from metalpathtracer_tpu.scene import load_scene_xml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene():
    return upload_scene(load_scene_xml(os.path.join(REPO, "scenes", "reference.xml")))


def _rays(n, seed=0):
    r = np.random.default_rng(seed)
    o = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = r.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("n", [1, 128, 700])
def test_cuda_output_shapes_and_dtypes(scene, n):
    o, d = _rays(n)
    t, idx = jax.eval_shape(hit_cuda.closest_hit_cuda, scene, o, d)
    assert (t.shape, t.dtype) == ((n,), jnp.float32)
    assert (idx.shape, idx.dtype) == ((n,), jnp.int32)


def test_cuda_pads_rays_to_whole_blocks(scene):
    o, d = _rays(700)
    active = jnp.asarray(np.arange(700) % 3 > 0)
    po, pd, pa, pt = hit_cuda.pad_rays(o, d, active, None)
    assert po.shape == pd.shape == (768, 3)
    np.testing.assert_array_equal(np.asarray(pa[:700]), np.asarray(active))
    assert not np.asarray(pa[700:]).any()  # padding walks nothing
    assert np.isinf(np.asarray(pt[:700])).all()
    assert (np.abs(np.asarray(pd[700:])) > 0).all()  # no zero division
    # the custom call sees whole blocks; the caller gets its N back
    jaxpr = jax.make_jaxpr(hit_cuda.closest_hit_cuda)(scene, o, d)
    calls = [e for e in jaxpr.eqns if "ffi" in e.primitive.name]
    assert len(calls) == 1
    assert calls[0].invars[0].aval.shape == (768, 3)
    assert [v.aval.shape for v in calls[0].outvars] == [(768,), (768,)]
    assert calls[0].params["target_name"] == hit_cuda.TARGET
    assert dict(calls[0].params["attributes"])["max_depth"] == scene.max_depth


def test_auto_resolution_per_backend():
    assert resolve_intersector("auto", "gpu") == "cuda"
    assert resolve_intersector("auto", "cpu") == "bvh"
    for kind in ("bvh", "brute"):  # explicit routes never change
        assert resolve_intersector(kind, "gpu") == kind
        assert resolve_intersector(kind, "cpu") == kind
    for bad in ("mm", "cuda", ""):
        with pytest.raises(ValueError):
            resolve_intersector(bad, "gpu")


def test_missing_library_on_gpu_is_an_error(scene, monkeypatch, tmp_path):
    # a GPU backend whose library cannot load must fail, not fall back to
    # the XLA traversal
    monkeypatch.setattr(hit_cuda, "_registered", False)
    monkeypatch.setattr(hit_cuda, "build_library", lambda: 0.0)
    monkeypatch.setattr(hit_cuda, "LIB_PATH", str(tmp_path / "missing.so"))
    monkeypatch.setattr(integrator.jax, "default_backend", lambda: "gpu")
    o, d = _rays(4)
    with pytest.raises(RuntimeError, match="cannot load"):
        closest_hit(scene, o, d)
    assert not hit_cuda._registered


def test_failed_build_is_an_error(monkeypatch, tmp_path):
    (tmp_path / "Makefile").write_text("gpu:\n\t@echo no compiler; false\n")
    monkeypatch.setattr(hit_cuda, "NATIVE_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no compiler"):
        hit_cuda.build_library()


def test_build_reads_only_tracked_sources():
    # `make -n` prints the build without running it; the GPU library is
    # compiled from the committed source alone, into the ignored build dir
    out = subprocess.run(
        ["make", "-n", "-B", "-C", hit_cuda.NATIVE_DIR, "gpu",
         f"PYTHON={sys.executable}", "NVCC=nvcc"],
        capture_output=True, text=True, check=True,
    ).stdout.replace("\\\n", " ")
    cmd = [line for line in out.splitlines() if line.startswith("nvcc")]
    assert len(cmd) == 1
    sources = re.findall(r"(\S+\.(?:cu|cpp|cc|h|cuh))\b", cmd[0])
    assert sources == [os.path.basename(hit_cuda.SOURCE)]
    assert os.path.isfile(hit_cuda.SOURCE)
    assert "sm_90a" in cmd[0] and "fast_math" not in cmd[0]
    assert re.search(r"-o build/libmpt_hit\.so\b", cmd[0])
    assert hit_cuda.LIB_PATH == os.path.join(hit_cuda.NATIVE_DIR, "build",
                                             "libmpt_hit.so")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "native/build/" in f.read().split()
    if os.path.isdir(os.path.join(REPO, ".git")):
        tracked = subprocess.run(
            ["git", "-C", REPO, "ls-files", "--error-unmatch",
             "native/closest_hit.cu", "native/Makefile"],
            capture_output=True, text=True,
        )
        assert tracked.returncode == 0, tracked.stderr


def test_depth_beyond_the_stack_is_an_error(scene):
    deep = dataclasses.replace(scene, max_depth=hit_cuda.MAX_DEPTH + 1)
    o, d = _rays(4)
    with pytest.raises(ValueError, match="exceeds the CUDA walk's stack"):
        jax.eval_shape(hit_cuda.closest_hit_cuda, deep, o, d)
    jax.eval_shape(hit_cuda.closest_hit_cuda,
                   dataclasses.replace(scene, max_depth=hit_cuda.MAX_DEPTH),
                   o, d)


def test_traversal_check_holds_masks_and_bounds(scene):
    # the check chip_smoke.py makes of the CUDA walk's `active` and `t_max`
    # inputs; here "auto" is the plain traversal, so it must agree exactly
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from oracle_check import check_vs_traversal

    o, d = _rays(512, seed=4)
    active = jnp.asarray(np.arange(512) % 5 > 0)
    t_max = jnp.full((512,), 3.0, jnp.float32)
    res = check_vs_traversal(scene, o, d, "masked", active, t_max)
    assert res["ok"] and res["id_mismatch"] == 0 and res["hits"] > 0, res
    t, idx = closest_hit(scene, o, d, "brute")
    t, idx = np.asarray(t), np.asarray(idx)
    # a bounded query hits exactly the active rays whose closest hit lies
    # within the bound
    assert res["hits"] == int(((idx >= 0) & (t < 3.0)
                               & np.asarray(active)).sum())


@pytest.mark.gpu
def test_cuda_matches_bruteforce_on_gpu(gpu, scene):
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from oracle_check import check, ray_batch

    o, d = ray_batch(4096, -2.0, 2.0, np.random.default_rng(11))
    res = check(scene, jnp.asarray(o), jnp.asarray(d), "bunny")
    assert res["ok"], res


@pytest.mark.gpu
def test_cuda_matches_xla_traversal_on_gpu(gpu, scene):
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from oracle_check import check_vs_traversal

    o, d = _rays(4096, seed=3)
    active = jnp.asarray(np.arange(4096) % 5 > 0)
    t_max = jnp.full((4096,), 3.0, jnp.float32)
    res = check_vs_traversal(scene, o, d, "masked", active, t_max)
    assert res["ok"] and res["id_mismatch"] == 0, res
