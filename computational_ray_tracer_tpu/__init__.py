"""computational_ray_tracer_tpu — a differentiable spectral path tracer in JAX.

A JAX/XLA framework with the capabilities of the reference C++ renderer
``GiboDidact/Computational_ray_tracer`` (see SURVEY.md), re-architected for
accelerators (one CUDA kernel, for octree traversal on NVIDIA GPUs):

- wavefront ray batches (SoA jnp arrays) instead of recursive per-ray C++
- flattened tensor octree instead of pointer chasing
- counter-based stateless RNG instead of stateful samplers
- hero-wavelength spectral radiance carried on a trailing ``(..., 8)`` axis
- film accumulation as weighted per-pixel sums, resolved through a camera
  PixelSensor model
- differentiable pixel radiance w.r.t. material / light parameters
- multi-device scaling via ``jax.sharding.Mesh`` + ``shard_map``

Subpackages
-----------
ops        numerical substrate: spectra, color, sampling, RNG, shapes, octree,
           cameras, film, filters, Monte Carlo estimators
models     scene description, materials, lights, integrators (the layer the
           reference only sketched in Integrator.h/Shading.h/Lights.h)
parallel   device-mesh sharding of ray batches; distributed render/train steps
utils      asset I/O (OBJ), procedural meshes, images, checkpoints, config
geometry2d 2D computational-geometry domain (polygons, triangulation,
           art-gallery visibility) mirroring the reference's Geometry/
"""

__version__ = "0.1.0"

from computational_ray_tracer_tpu.ops import spectrum, color, sampling, rng
