"""Observability: render statistics, image-error metrics, profiling hooks.

The reference's only observability is printf (SURVEY.md §5: scene stats at
`Renderer.cpp:118-124`, viewport dumps). Here renders report structured
stats (rays, Mrays/sec, spp/sec), image error is quantified (RMSE — the
BASELINE fidelity gate is RMSE < 1e-3 vs a converged reference), and
`jax.profiler` traces can wrap any render for per-op device timing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import numpy as np


@dataclasses.dataclass
class RenderStats:
    width: int
    height: int
    spp: int
    seconds: float
    rays: int | None = None

    @property
    def spp_per_sec(self) -> float:
        return self.spp / self.seconds if self.seconds > 0 else 0.0

    @property
    def mrays_per_sec(self) -> float | None:
        if self.rays is None or self.seconds <= 0:
            return None
        return self.rays / self.seconds / 1e6

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["spp_per_sec"] = round(self.spp_per_sec, 3)
        if self.mrays_per_sec is not None:
            d["mrays_per_sec"] = round(self.mrays_per_sec, 3)
        return d

    def json_line(self) -> str:
        return json.dumps(self.to_dict())


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square pixel error — the BASELINE.md fidelity metric."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def relative_mse(a: np.ndarray, ref: np.ndarray, eps: float = 1e-2) -> float:
    """Luminance-relative MSE (less dominated by bright lights than RMSE)."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.mean(((a - ref) ** 2) / (ref**2 + eps)))


class Timer:
    """Plain wall-clock timer. Does NOT synchronize the device — JAX
    dispatch is async, so wrap device work with `jax.block_until_ready`
    inside the block (or use `timed_render`, which does this for you)."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        return False


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a `jax.profiler` trace of the enclosed render (view with
    tensorboard or xprof). The reference's equivalent is Xcode's Metal
    debugger (SURVEY.md §5)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed_render(fn, *args, repeats: int = 1, **kwargs):
    """Run `fn(*args, **kwargs)` → ((image, rays), RenderStats). `fn` is any
    of the `render_image*` functions; warmup/compile excluded via one prior
    call."""
    import jax

    img, rays = fn(*args, **kwargs)
    jax.block_until_ready(img)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        img, rays = fn(*args, **kwargs)
        jax.block_until_ready(img)
        best = min(best, time.perf_counter() - t0)
    h, w = img.shape[:2]
    spp = kwargs.get("spp", args[4] if len(args) > 4 else 0)
    return (img, rays), RenderStats(w, h, spp, best, int(rays))


# the checkout's own cache directory (listed in .gitignore); a fixed path,
# because the path is part of the cache key
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_compile_cache() -> str | None:
    """Engage JAX's persistent compilation cache for this process: in
    `JAX_COMPILATION_CACHE_DIR` when that is set, else in the checkout's
    `.jax_cache/`. Call before the first jit. Returns the directory, or
    None (with a warning on stderr) when the cache could not be engaged.
    """
    import sys

    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    try:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    except Exception as e:  # read-only FS or a JAX without the option
        print(f"warning: persistent compile cache not engaged at {path}: "
              f"{e!r}", file=sys.stderr)
        return None
    return path
