"""Native runtime components, loaded via ctypes.

The reference implements its whole runtime in C++; here JAX/XLA owns the
device compute, and the one-shot host-side runtime pieces that are
performance-critical — the octree builder (Octtree_Model::CreateOcttree
capability, ~100x over the NumPy builder on large meshes) and the OBJ/PLY
mesh loaders (AssetManager capability) — are C++ compiled on first use into
``libcrt_native.so``.

``load()`` returns the ctypes library or None (missing toolchain), letting
callers fall back to the NumPy implementations.

``load_cuda()`` compiles the CUDA octree traversal (``octree_traverse.cu``)
with nvcc on first use and returns the library. It only runs where a CUDA
device is present, and a failed build raises: there is nothing to fall back
to on the GPU.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libcrt_native.so")
_SRC = [os.path.join(_DIR, "octree_builder.cpp"),
        os.path.join(_DIR, "mesh_loader.cpp"),
        os.path.join(_DIR, "ply_loader.cpp")]
_CUDA_SRC = os.path.join(_DIR, "octree_traverse.cu")
_CUDA_SO = os.path.join(_DIR, "build", "libcrt_cuda.so")
_NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc")
_lock = threading.Lock()
_lib = None
_tried = False
_cuda_lib = None


class CrtOctree(ctypes.Structure):
    _fields_ = [
        ("n_nodes", ctypes.c_int64),
        ("n_leaves", ctypes.c_int64),
        ("leaf_cap", ctypes.c_int64),
        ("node_lo", ctypes.POINTER(ctypes.c_float)),
        ("node_hi", ctypes.POINTER(ctypes.c_float)),
        ("node_child0", ctypes.POINTER(ctypes.c_int32)),
        ("node_leaf_id", ctypes.POINTER(ctypes.c_int32)),
        ("leaf_tris", ctypes.POINTER(ctypes.c_int32)),
        ("leaf_counts", ctypes.POINTER(ctypes.c_int32)),
    ]


class CrtMesh(ctypes.Structure):
    _fields_ = [
        ("n_verts", ctypes.c_int64),
        ("n_tris", ctypes.c_int64),
        ("has_normals", ctypes.c_int32),
        ("has_uvs", ctypes.c_int32),
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("indices", ctypes.POINTER(ctypes.c_int32)),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
    ]


def _compile():
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", _SO] + _SRC
    subprocess.run(cmd, check=True, capture_output=True)


def load():
    """Compile (if needed) and load the native library; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            src_mtime = max(os.path.getmtime(s) for s in _SRC)
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < src_mtime):
                _compile()
            lib = ctypes.CDLL(_SO)
            lib.crt_build_octree.restype = ctypes.c_int
            lib.crt_build_octree.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
                ctypes.POINTER(CrtOctree)]
            lib.crt_free_octree.restype = None
            lib.crt_free_octree.argtypes = [ctypes.POINTER(CrtOctree)]
            lib.crt_load_obj.restype = ctypes.c_int
            lib.crt_load_obj.argtypes = [ctypes.c_char_p,
                                         ctypes.POINTER(CrtMesh)]
            lib.crt_load_ply.restype = ctypes.c_int
            lib.crt_load_ply.argtypes = [ctypes.c_char_p,
                                         ctypes.POINTER(CrtMesh)]
            lib.crt_free_mesh.restype = None
            lib.crt_free_mesh.argtypes = [ctypes.POINTER(CrtMesh)]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def _compile_cuda():
    import jax.ffi
    os.makedirs(os.path.dirname(_CUDA_SO), exist_ok=True)
    tmp = f"{_CUDA_SO}.{os.getpid()}.tmp"
    cmd = [_NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
           "-std=c++17", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _CUDA_SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, _CUDA_SO)


def load_cuda():
    """Compile (if stale) and load the CUDA traversal library."""
    global _cuda_lib
    with _lock:
        if _cuda_lib is None:
            if (not os.path.exists(_CUDA_SO) or os.path.getmtime(_CUDA_SO)
                    < os.path.getmtime(_CUDA_SRC)):
                _compile_cuda()
            _cuda_lib = ctypes.CDLL(_CUDA_SO)
        return _cuda_lib
