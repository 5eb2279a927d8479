"""Flattened tensor octree over triangle meshes.

Capability parity with ``RayTracer/Octtree_Model.h:9-422`` (world-space
per-model octree, leaf capacity 40 with 0.01 child padding, split aborted when
all triangles land in one child, Möller triangle-box overlap gating, BFS
traversal that shrinks t_max on leaf hits, and PrintInfo occupancy
diagnostics), re-architected for a wavefront renderer:

- the *build* runs host-side (native C++, NumPy as the reference; it is
  one-shot scene setup, SURVEY §7 design stance #2) and emits flat
  int32/float32 node tensors: ``node_lo/node_hi (M,3)``, ``node_child0
  (M,)`` (8 children contiguous, -1 for leaves), and per-leaf triangle
  lists padded to the leaf capacity;
- ``octree_traverse`` is a branch-free ``lax.while_loop`` with an explicit
  fixed-depth stack per ray, vmapped over the whole wavefront. It runs on
  every platform without a kernel of its own and is the reference for the
  CUDA traversal (``ops/traversal.py``);
- traversal statistics (triangle tests — the reference's
  ``triangle_intersect_count``) come back as array outputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from computational_ray_tracer_tpu.ops import triangle as trimod
from computational_ray_tracer_tpu.ops.shapes import fp_gamma

TRIANGLE_CAPACITY = 40   # leaf split threshold (Octtree_Model.h:388)
# Child-bounds padding. The reference uses an ABSOLUTE 0.01 (Octtree_
# Model.h:279-358) — tuned for its dragon-x15-scale scene (extent ~30, i.e.
# ~3e-4 of the root extent). An absolute pad is pathological for unit-scale
# meshes (every deep cell overlaps its neighbours' triangles), so the
# default here is the same *relative* pad: 5e-4 x root max extent.
CHILD_PADDING_FRAC = 5e-4
MAX_DEPTH = 12
# Worst-case stack growth is +7 per level (push 8, pop 1). Both traversals
# (octree_traverse and native/octree_traverse.cu) use this size; build_octree
# rejects a tree whose depth, split chains included, could overflow it.
STACK_SIZE = 128
# Disk-cache invalidation token for the BUILT TREE (co-located with the
# builders so a semantic change can't forget it): bump whenever
# _build_octree_native / _build_octree_numpy / _split_oversized_leaves (or
# native/octree_builder.cpp, whose compile key also folds this in) change
# the tree they produce for identical inputs. Stale .cache entries would
# otherwise silently serve old trees across branches sharing the worktree.
BUILDER_VERSION = "v1"


# ---------------------------------------------------------------------------
# Möller triangle-box overlap (ThirdParty/AABB_triangle_Moller.h capability),
# vectorized over triangles in NumPy for the host-side build.
# ---------------------------------------------------------------------------

def _tri_box_overlap(center, half, v0, v1, v2):
    """SAT test: triangles (K,3)x3 vs one box (3,), returns (K,) bool."""
    v0 = v0 - center
    v1 = v1 - center
    v2 = v2 - center
    e0 = v1 - v0
    e1 = v2 - v1
    e2 = v0 - v2

    def axis_test(a, b, fa, fb, va, vb, i, j):
        p0 = a * va[:, i] - b * va[:, j]
        p1 = a * vb[:, i] - b * vb[:, j]
        pmin = np.minimum(p0, p1)
        pmax = np.maximum(p0, p1)
        rad = fa * half[i] + fb * half[j]
        return (pmin <= rad) & (pmax >= -rad)

    ok = np.ones(v0.shape[0], dtype=bool)
    for (e, pair) in ((e0, (v0, v2)), (e1, (v0, v2)), (e2, (v0, v1))):
        fe = np.abs(e)
        # 9 cross-axis tests, grouped per edge
        ok &= axis_test(e[:, 2], e[:, 1], fe[:, 2], fe[:, 1],
                        pair[0], pair[1], 1, 2)
        ok &= axis_test(-e[:, 2], -e[:, 0], fe[:, 2], fe[:, 0],
                        pair[0], pair[1], 0, 2)
        # note sign convention folds into min/max
        ok &= axis_test(e[:, 1], e[:, 0], fe[:, 1], fe[:, 0],
                        pair[0], pair[1], 0, 1)

    # AABB overlap on the 3 box axes
    for i in range(3):
        lo = np.minimum(np.minimum(v0[:, i], v1[:, i]), v2[:, i])
        hi = np.maximum(np.maximum(v0[:, i], v1[:, i]), v2[:, i])
        ok &= (lo <= half[i]) & (hi >= -half[i])

    # Plane-box overlap
    n = np.cross(e0, e1)
    d = -np.sum(n * v0, axis=1)
    r = np.sum(np.abs(n) * half[None, :], axis=1)
    ok &= np.abs(d) <= r
    return ok


# ---------------------------------------------------------------------------
# Build (host-side, top-down; preserves leaf-cap/padding/abort semantics)
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Octree:
    node_lo: jnp.ndarray       # (M, 3)
    node_hi: jnp.ndarray       # (M, 3)
    node_child0: jnp.ndarray   # (M,) int32, -1 for leaf
    node_leaf_id: jnp.ndarray  # (M,) int32, -1 for interior
    leaf_tris: jnp.ndarray     # (L, CAP) int32, -1 padded
    leaf_counts: jnp.ndarray   # (L,) int32

    def tree_flatten(self):
        return (self.node_lo, self.node_hi, self.node_child0,
                self.node_leaf_id, self.leaf_tris, self.leaf_counts), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n_nodes(self):
        return self.node_lo.shape[0]

    def info(self):
        """Occupancy diagnostics (PrintInfo, Octtree_Model.h:134-176)."""
        child0 = np.asarray(self.node_child0)
        counts = np.asarray(self.leaf_counts)
        n_leaves = int((child0 == -1).sum())
        return {
            "nodes": int(child0.shape[0]),
            "leaves": n_leaves,
            "empty_leaves": int((counts == 0).sum()),
            "avg_tris_per_leaf": float(counts.mean()) if len(counts) else 0.0,
            "max_tris_per_leaf": int(counts.max()) if len(counts) else 0,
        }


def _split_oversized_leaves(tree: Octree, cap):
    """Post-pass: any leaf holding more than ``cap`` triangles (the
    abort-split / max-depth escape hatches can produce them) becomes an
    interior node whose 8 children share its bounds and split the triangle
    list ~evenly (recursing while still over cap). Traversal results are
    identical — the same triangles get tested for any ray reaching those
    bounds — but the padded leaf width, which EVERY leaf step pays for,
    drops back to ``cap``."""
    counts = np.asarray(tree.leaf_counts)
    if counts.size == 0 or counts.max() <= cap:
        return tree
    node_lo = [row for row in np.asarray(tree.node_lo)]
    node_hi = [row for row in np.asarray(tree.node_hi)]
    child0 = list(np.asarray(tree.node_child0))
    leaf_id = list(np.asarray(tree.node_leaf_id))
    old_tris = np.asarray(tree.leaf_tris)
    leaves = [old_tris[i, :counts[i]] for i in range(len(counts))]

    # DEAD child bounds: the slab test can never pass (no NaNs either).
    dead_lo = np.full(3, 1e30, np.float32)
    dead_hi = np.full(3, -1e30, np.float32)

    new_leaves = {}          # leaf_idx -> tris (for rebuilt leaf table)
    work = [n for n in range(len(child0))
            if leaf_id[n] >= 0 and counts[leaf_id[n]] > cap]
    tris_of = {n: leaves[leaf_id[n]] for n in work}
    for n in work:
        leaf_id[n] = -1      # becomes interior
    while work:
        n = work.pop()
        tris = tris_of.pop(n)
        base = len(child0)
        child0[n] = base
        chunks = np.array_split(tris, 8)
        for c in range(8):
            if len(chunks[c]) == 0:
                node_lo.append(dead_lo)
                node_hi.append(dead_hi)
                child0.append(-1)
                leaf_id.append(-2)       # dead leaf, patched below
            else:
                node_lo.append(node_lo[n])
                node_hi.append(node_hi[n])
                child0.append(-1)
                if len(chunks[c]) > cap:
                    leaf_id.append(-1)
                    work.append(base + c)
                    tris_of[base + c] = chunks[c]
                else:
                    leaf_id.append(-3)   # pending leaf
                    new_leaves[base + c] = chunks[c]

    # Rebuild the leaf table: keep still-valid old leaves + the new chunks.
    out_tris, out_counts = [], []
    for n in range(len(child0)):
        if leaf_id[n] == -2:             # dead filler: empty leaf
            leaf_id[n] = len(out_tris)
            out_tris.append(np.zeros((0,), np.int64))
            out_counts.append(0)
        elif leaf_id[n] == -3:           # new chunk leaf
            leaf_id[n] = len(out_tris)
            out_tris.append(new_leaves[n])
            out_counts.append(len(new_leaves[n]))
        elif leaf_id[n] >= 0:            # surviving original leaf
            t = leaves[leaf_id[n]]
            leaf_id[n] = len(out_tris)
            out_tris.append(t)
            out_counts.append(len(t))
    new_cap = max(max(out_counts, default=1), 1)
    flat = np.full((len(out_tris), new_cap), -1, np.int32)
    for i, t in enumerate(out_tris):
        flat[i, :len(t)] = t
    return Octree(
        node_lo=np.asarray(node_lo, np.float32),
        node_hi=np.asarray(node_hi, np.float32),
        node_child0=np.asarray(child0, np.int32),
        node_leaf_id=np.asarray(leaf_id, np.int32),
        leaf_tris=flat,
        leaf_counts=np.asarray(out_counts, np.int32))


def build_octree(mesh: trimod.MeshData, capacity=TRIANGLE_CAPACITY,
                 max_depth=MAX_DEPTH, padding=None, backend="auto"):
    """Top-down octree build over a (world-space) mesh. Returns an Octree of
    flat device tensors.
    Splits stop at `capacity` triangles, `max_depth`, or when splitting
    fails to separate (the abort rule, Octtree_Model.h:331-340).

    backend: "native" (C++ builder), "numpy", or "auto" (native when
    available, else numpy). Both produce identical trees.

    padding: child-bounds pad as a FRACTION of each child box's extent
    (per axis, per level); None = CHILD_PADDING_FRAC. The reference's
    absolute 0.01 pad (Octtree_Model.h:288) is scale-dependent AND
    depth-dependent: at depth 10+ any absolute pad exceeds the boxes
    themselves and every fine-region triangle joins all neighboring
    leaves (measured: 16.4 avg leaf memberships / 8.3 GB leaf table on an
    870k-tri mixed-scale mesh with the old root-relative pad; 2-3 avg
    with the level-relative pad).

    The whole pipeline (build + oversized-leaf split) stays in host NumPy,
    reading the mesh from the host copy MeshData.build keeps, and uploads
    each tensor to the device once."""
    pos_np, idx_np = host_mesh_arrays(mesh)
    if padding is None:
        padding = CHILD_PADDING_FRAC

    # Content-keyed disk cache of the built (post-split) host tree
    # (utils.asset_cache, the reference's modelCache analog): the 327k-tri
    # native build+split costs ~1.8 s per fresh process. Keyed by a hash
    # of the exact mesh bytes + every build parameter, so a cached tree is
    # bit-identical to a rebuilt one. CRT_OCTREE_CACHE=0 disables.
    import hashlib
    import os as _os
    from computational_ray_tracer_tpu.utils import asset_cache
    cache_on = _os.environ.get("CRT_OCTREE_CACHE", "1") != "0"
    tree_np = None
    _FIELDS = ("node_lo", "node_hi", "node_child0", "node_leaf_id",
               "leaf_tris", "leaf_counts")
    if cache_on:
        h = hashlib.blake2b(digest_size=16)
        h.update(pos_np.tobytes())
        h.update(idx_np.tobytes())
        h.update(f"{BUILDER_VERSION}_c{capacity}_d{max_depth}"
                 f"_p{padding!r}".encode())
        # The native builder's exact output is part of the cached value:
        # fold its source bytes in so editing octree_builder.cpp can never
        # serve a stale tree (NumPy-builder changes bump BUILDER_VERSION).
        try:
            from computational_ray_tracer_tpu import native as _native_pkg
            cpp = _os.path.join(_os.path.dirname(_native_pkg.__file__),
                                "octree_builder.cpp")
            with open(cpp, "rb") as f:
                h.update(f.read())
        except OSError:
            pass
        key = f"octree_{h.hexdigest()}"
        hit = asset_cache.load(key)
        if hit is not None and all(f in hit for f in _FIELDS):
            tree_np = Octree(**{f: hit[f] for f in _FIELDS})
    if tree_np is None:
        tree = None
        if backend in ("auto", "native"):
            tree = _build_octree_native(pos_np, idx_np, capacity, max_depth,
                                        padding)
            if tree is None and backend == "native":
                raise RuntimeError("native octree builder unavailable "
                                   "(g++ compile failed?)")
        if tree is None:
            tree = _build_octree_numpy(pos_np, idx_np, capacity, max_depth,
                                       padding)
        tree_np = _split_oversized_leaves(tree, capacity)
        if cache_on:
            asset_cache.store(key, **{f: getattr(tree_np, f)
                                      for f in _FIELDS})
    depth = tree_depth(tree_np.node_child0)
    if 7 * depth + 1 > STACK_SIZE:
        raise ValueError(f"octree depth {depth} can overflow the "
                         f"{STACK_SIZE}-entry traversal stack")
    return Octree(
        node_lo=jnp.asarray(tree_np.node_lo),
        node_hi=jnp.asarray(tree_np.node_hi),
        node_child0=jnp.asarray(tree_np.node_child0),
        node_leaf_id=jnp.asarray(tree_np.node_leaf_id),
        leaf_tris=jnp.asarray(tree_np.leaf_tris),
        leaf_counts=jnp.asarray(tree_np.leaf_counts))


def tree_depth(node_child0):
    """Levels below the root (0 for a root leaf), split chains included."""
    child0 = np.asarray(node_child0)
    depth = 0
    level = np.array([0])
    while True:
        c0 = child0[level]
        c0 = c0[c0 >= 0]
        if c0.size == 0:
            return depth
        level = (c0[:, None] + np.arange(8)).reshape(-1)
        depth += 1


def host_mesh_arrays(mesh):
    """(positions, indices) as host NumPy, using the build-time host copy
    when present (saves a device->host copy; see MeshData.build)."""
    host = getattr(mesh, "_host", None)
    if host is not None:
        return (np.asarray(host[0], np.float32),
                np.asarray(host[1], np.int32))
    return (np.asarray(mesh.positions, np.float32),
            np.asarray(mesh.indices, np.int32))


def _build_octree_native(pos_np, idx_np, capacity, max_depth, padding):
    """C++ builder (native/octree_builder.cpp) via ctypes; None if the
    native library can't be built/loaded."""
    import ctypes
    from computational_ray_tracer_tpu import native

    lib = native.load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(np.asarray(pos_np, np.float32))
    idx = np.ascontiguousarray(np.asarray(idx_np, np.int32))
    out = native.CrtOctree()
    rc = lib.crt_build_octree(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pos.shape[0],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), idx.shape[0],
        capacity, max_depth, float(padding), ctypes.byref(out))
    if rc != 0:
        return None
    try:
        M, L, cap = int(out.n_nodes), int(out.n_leaves), int(out.leaf_cap)
        node_lo = np.ctypeslib.as_array(out.node_lo, (M, 3)).copy()
        node_hi = np.ctypeslib.as_array(out.node_hi, (M, 3)).copy()
        child0 = np.ctypeslib.as_array(out.node_child0, (M,)).copy()
        leaf_id = np.ctypeslib.as_array(out.node_leaf_id, (M,)).copy()
        leaf_tris = np.ctypeslib.as_array(out.leaf_tris, (L, cap)).copy()
        leaf_counts = np.ctypeslib.as_array(out.leaf_counts, (L,)).copy()
    finally:
        lib.crt_free_octree(ctypes.byref(out))
    return Octree(node_lo=node_lo, node_hi=node_hi, node_child0=child0,
                  node_leaf_id=leaf_id, leaf_tris=leaf_tris,
                  leaf_counts=leaf_counts)


def _build_octree_numpy(pos_np, idx_np, capacity=TRIANGLE_CAPACITY,
                        max_depth=MAX_DEPTH, padding=0.01):
    """Pure-NumPy reference builder (kept as fallback + test oracle)."""
    pos = np.asarray(pos_np, np.float64)
    idx = np.asarray(idx_np, np.int64)
    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]

    root_lo = pos.min(axis=0) - 1e-4
    root_hi = pos.max(axis=0) + 1e-4

    nodes_lo, nodes_hi, child0, leaf_id = [], [], [], []
    leaves = []

    def add_node(lo, hi):
        nodes_lo.append(lo)
        nodes_hi.append(hi)
        child0.append(-1)
        leaf_id.append(-1)
        return len(nodes_lo) - 1

    root = add_node(root_lo, root_hi)
    # worklist of (node_id, tri_ids, depth)
    work = [(root, np.arange(idx.shape[0]), 0)]
    while work:
        nid, tris, depth = work.pop()
        lo = nodes_lo[nid]
        hi = nodes_hi[nid]
        if len(tris) <= capacity or depth >= max_depth:
            leaf_id[nid] = len(leaves)
            leaves.append(tris)
            continue
        mid = (lo + hi) / 2.0
        # padding is a FRACTION of the child box extent per axis/level
        # (must match the native builder bit-for-bit — see
        # native/octree_builder.cpp Split)
        pad = padding * (np.asarray(hi) - np.asarray(lo)) * 0.5
        child_sets = []
        child_bounds = []
        for ix in (0, 1):
            for iy in (0, 1):
                for iz in (0, 1):
                    clo = np.array([lo[0] if ix == 0 else mid[0],
                                    lo[1] if iy == 0 else mid[1],
                                    lo[2] if iz == 0 else mid[2]])
                    chi = np.array([mid[0] if ix == 0 else hi[0],
                                    mid[1] if iy == 0 else hi[1],
                                    mid[2] if iz == 0 else hi[2]])
                    clo_p = clo - pad
                    chi_p = chi + pad
                    center = (clo_p + chi_p) / 2.0
                    half = (chi_p - clo_p) / 2.0
                    sel = _tri_box_overlap(center, half, v0[tris], v1[tris],
                                           v2[tris])
                    child_sets.append(tris[sel])
                    child_bounds.append((clo_p, chi_p))
        # Abort-split rule: no separation achieved
        if max(len(s) for s in child_sets) >= len(tris):
            leaf_id[nid] = len(leaves)
            leaves.append(tris)
            continue
        base = len(nodes_lo)
        child0[nid] = base
        for (clo, chi), s in zip(child_bounds, child_sets):
            cid = add_node(clo, chi)
            work.append((cid, s, depth + 1))

    # Flatten leaves padded to the max leaf size
    cap = max(max((len(t) for t in leaves), default=1), 1)
    leaf_tris = np.full((len(leaves), cap), -1, np.int32)
    leaf_counts = np.zeros(len(leaves), np.int32)
    for i, t in enumerate(leaves):
        leaf_tris[i, :len(t)] = t
        leaf_counts[i] = len(t)

    return Octree(
        node_lo=np.asarray(nodes_lo, np.float32),
        node_hi=np.asarray(nodes_hi, np.float32),
        node_child0=np.asarray(child0, np.int32),
        node_leaf_id=np.asarray(leaf_id, np.int32),
        leaf_tris=leaf_tris,
        leaf_counts=leaf_counts)


# ---------------------------------------------------------------------------
# Traversal (device): per-ray explicit stack, vectorized over the wavefront
# ---------------------------------------------------------------------------

def octree_traverse(o, d, t_max, tree: Octree, mesh: trimod.MeshData,
                    tri_mask=None):
    """Closest-hit traversal (Octtree_Model::Traverse, Octtree_Model.h:66-127
    capability). Returns (t, tri_idx, b1, b2, tri_tests).

    Per ray: pop node from stack → robust slab test → interior: push 8
    children; leaf: test its padded triangle list, shrink t. Runs as one
    lockstep while_loop over the whole batch (masked divergence).
    """
    batch_shape = o.shape[:-1]
    flat_o = o.reshape(-1, 3)
    flat_d = d.reshape(-1, 3)
    flat_tmax = t_max.reshape(-1)
    n = flat_o.shape[0]
    cap = tree.leaf_tris.shape[1]

    inv_d = 1.0 / jnp.where(jnp.abs(flat_d) < 1e-20,
                            jnp.sign(flat_d) * 1e-20 + 1e-30, flat_d)

    i0 = mesh.indices[:, 0]
    i1 = mesh.indices[:, 1]
    i2 = mesh.indices[:, 2]

    def cond(state):
        sp = state[0]
        return jnp.any(sp > 0)

    def body(state):
        sp, stack, t_best, tri_best, b1_best, b2_best, tests = state
        active = sp > 0
        sp_new = jnp.where(active, sp - 1, sp)
        node = jnp.take_along_axis(stack, jnp.maximum(sp_new, 0)[:, None],
                                   axis=1)[:, 0]
        node = jnp.where(active, node, 0)

        lo = tree.node_lo[node]
        hi = tree.node_hi[node]
        t0 = (lo - flat_o) * inv_d
        t1 = (hi - flat_o) * inv_d
        t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
        t_far = jnp.min(jnp.maximum(t0, t1), axis=-1) * (1.0 + 2.0 * fp_gamma(3))
        box_hit = active & (t_near <= t_far) & (t_far > 0.0) & (t_near < t_best)

        c0 = tree.node_child0[node]
        is_leaf = c0 < 0
        leaf = tree.node_leaf_id[node]

        # --- interior: push 8 children
        push = box_hit & ~is_leaf
        offs = jnp.arange(8, dtype=jnp.int32)
        new_entries = c0[:, None] + offs[None, :]
        pos = sp_new[:, None] + offs[None, :]
        stack = jax.vmap(
            lambda s, p, e, m: jax.lax.select(
                m, s.at[p].set(e), s))(stack, pos, new_entries, push)
        sp_after = jnp.where(push, sp_new + 8, sp_new)

        # --- leaf: test padded triangle list
        do_leaf = box_hit & is_leaf
        leaf_safe = jnp.maximum(leaf, 0)
        tri_ids = tree.leaf_tris[leaf_safe]            # (n, cap)
        tri_ok = (tri_ids >= 0) & do_leaf[:, None]
        tri_safe = jnp.maximum(tri_ids, 0)
        if tri_mask is not None:
            tri_ok = tri_ok & tri_mask[tri_safe]
        p0 = mesh.positions[i0[tri_safe]]
        p1 = mesh.positions[i1[tri_safe]]
        p2 = mesh.positions[i2[tri_safe]]
        t, b0, b1, b2, hit = trimod.triangle_intersect(
            flat_o[:, None, :], flat_d[:, None, :], t_best[:, None],
            p0, p1, p2)
        t = jnp.where(tri_ok, t, jnp.inf)
        j = jnp.argmin(t, axis=-1)
        t_leaf = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
        better = t_leaf < t_best
        t_best = jnp.where(better, t_leaf, t_best)
        tri_best = jnp.where(
            better, jnp.take_along_axis(tri_safe, j[:, None], axis=1)[:, 0],
            tri_best)
        b1_best = jnp.where(better,
                            jnp.take_along_axis(b1, j[:, None], axis=1)[:, 0],
                            b1_best)
        b2_best = jnp.where(better,
                            jnp.take_along_axis(b2, j[:, None], axis=1)[:, 0],
                            b2_best)
        tests = tests + jnp.sum(tri_ok, axis=-1).astype(jnp.int32)
        return (sp_after, stack, t_best, tri_best, b1_best, b2_best, tests)

    stack = jnp.zeros((n, STACK_SIZE), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)  # root pre-pushed at slot 0
    init = (sp, stack, flat_tmax, jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n,)), jnp.zeros((n,)), jnp.zeros((n,), jnp.int32))
    sp, stack, t_best, tri_best, b1b, b2b, tests = jax.lax.while_loop(
        cond, body, init)

    reshape = lambda x: x.reshape(batch_shape)
    return (reshape(jnp.where(jnp.isfinite(t_best) & (tri_best >= 0), t_best,
                              jnp.inf)),
            reshape(tri_best), reshape(b1b), reshape(b2b), reshape(tests))
