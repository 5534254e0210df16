"""metalpathtracer_tpu — a progressive Monte Carlo path-tracing framework in JAX.

A from-scratch rebuild of the capabilities of omkhairate/MetalPathtracer
(a macOS Metal fragment-shader path tracer) as a JAX program that runs on
NVIDIA GPUs (and on the CPU for tests):

- JAX/XLA wavefront rendering pipeline instead of a per-pixel megakernel
  (reference: `MetalCpp Path Tracer/Renderer/Shaders/Fragment.metal`).
- Counter-based threefry RNG for reproducible, reshard-invariant sample
  streams (fixes the reference's seed-reuse defects,
  `Renderer/Shaders/Random.h`, `PathTracing.h:27-28`).
- Linearized SAH BVH, walked per ray by a CUDA kernel on the GPU and inside
  `jax.lax.while_loop` elsewhere (reference: `Scene/Scene.h:195-317`,
  `Renderer/Shaders/PathTracing.h:75-204`).
- Multi-device tile/sample sharding over a `jax.sharding.Mesh`.

Public API lives in the subpackages:

- `metalpathtracer_tpu.scene`   — scene model, XML/OBJ loaders, presets
- `metalpathtracer_tpu.accel`   — SAH BVH builder (NumPy + native C++)
- `metalpathtracer_tpu.render`  — camera, BSDFs, integrators, pipeline
- `metalpathtracer_tpu.parallel`— device-mesh sharding
- `metalpathtracer_tpu.io`     — PNG output, checkpoint/resume
"""

from metalpathtracer_tpu.version import __version__

__all__ = ["__version__"]
