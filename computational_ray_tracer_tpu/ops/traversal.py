"""The octree traversal op behind every mesh closest-hit and any-hit query.

On a CUDA device the op lowers to the per-ray CUDA kernel
(``native/octree_traverse.cu``), called through the XLA FFI. On every other
platform it lowers to the lockstep jnp loop ``octree.octree_traverse``, which
is also the kernel's test reference. ``lax.platform_dependent`` picks the
branch when the program is lowered for its device, so one jitted function
runs on either, and no scene or render option chooses.

Hit ids and distances are sampling decisions, not differentiable
quantities: the op carries zero tangents (``custom_jvp``), so both branches
give the same reparameterized gradient.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import jax
import jax.numpy as jnp

from computational_ray_tracer_tpu.ops import octree as octmod

FFI_TARGET = "crt_octree_traverse"

_register_lock = threading.Lock()
_registered = False


def _register_cuda_target():
    """Build and register the CUDA kernel once, if this process has a CUDA
    backend (a process without one never lowers the CUDA branch)."""
    global _registered
    with _register_lock:
        if _registered:
            return
        try:
            jax.devices("cuda")
        except RuntimeError:
            return
        from computational_ray_tracer_tpu import native
        lib = native.load_cuda()
        jax.ffi.register_ffi_target(
            FFI_TARGET, jax.ffi.pycapsule(lib.CrtOctreeTraverse),
            platform="CUDA")
        _registered = True


def _cuda_branch(anyhit, o, d, t_max, tree, mesh, tri_mask):
    batch = o.shape[:-1]
    n = int(np.prod(batch))
    if tri_mask is None:
        tri_mask = jnp.zeros((0,), jnp.bool_)
    f32, i32 = jnp.float32, jnp.int32
    out = jax.ffi.ffi_call(
        FFI_TARGET,
        (jax.ShapeDtypeStruct((n,), f32), jax.ShapeDtypeStruct((n,), i32),
         jax.ShapeDtypeStruct((n,), f32), jax.ShapeDtypeStruct((n,), f32),
         jax.ShapeDtypeStruct((n,), i32)))(
        o.reshape(n, 3).astype(f32), d.reshape(n, 3).astype(f32),
        t_max.reshape(n).astype(f32),
        tree.node_lo.astype(f32), tree.node_hi.astype(f32),
        tree.node_child0.astype(i32), tree.node_leaf_id.astype(i32),
        tree.leaf_tris.astype(i32),
        mesh.positions.astype(f32), mesh.indices.astype(i32),
        tri_mask.astype(jnp.bool_), anyhit=np.int32(anyhit))
    return tuple(x.reshape(batch) for x in out)


def _jnp_branch(anyhit, o, d, t_max, tree, mesh, tri_mask):
    del anyhit   # the closest hit answers an any-hit query too
    return octmod.octree_traverse(o, d, t_max, tree, mesh, tri_mask)


@functools.partial(jax.custom_jvp, nondiff_argnums=(0,))
def _traverse(anyhit, o, d, t_max, tree, mesh, tri_mask):
    return jax.lax.platform_dependent(
        o, d, t_max, tree, mesh, tri_mask,
        cuda=functools.partial(_cuda_branch, anyhit),
        default=functools.partial(_jnp_branch, anyhit))


@_traverse.defjvp
def _traverse_jvp(anyhit, primals, tangents):
    del tangents
    out = _traverse(anyhit, *primals)
    zeros = tuple(
        np.zeros(x.shape, jax.dtypes.float0)
        if jnp.issubdtype(x.dtype, jnp.integer) else jnp.zeros_like(x)
        for x in out)
    return out, zeros


def closest_hit(o, d, t_max, tree: octmod.Octree, mesh, tri_mask=None):
    """Closest triangle hit in (0, t_max) per ray. Returns (t, tri_idx, b1,
    b2, tri_tests) in ``octree_traverse``'s conventions: t is inf and
    tri_idx -1 on a miss."""
    _register_cuda_target()
    return _traverse(False, o, d, t_max, tree, mesh, tri_mask)


def any_hit(o, d, t_max, tree: octmod.Octree, mesh, tri_mask=None):
    """True where any triangle lies in (0, t_max). On the GPU each ray stops
    at its first hit."""
    _register_cuda_target()
    t, tri, _, _, _ = _traverse(True, o, d, t_max, tree, mesh, tri_mask)
    return jnp.isfinite(t) & (tri >= 0)
