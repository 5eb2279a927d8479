// Octree ray traversal for NVIDIA GPUs, called from JAX through the XLA FFI.
//
// One thread per ray, each with its own stack in local memory: the standard
// GPU traversal, which the lockstep jnp loop (ops/octree.py::octree_traverse,
// the reference this kernel is tested against) cannot express. Inputs are
// the flat device Octree and MeshData tensors as they are, so no packing
// step exists:
//
//   node_lo/node_hi (M,3) f32, node_child0 (M,) i32 (8 contiguous children,
//   -1 for a leaf), node_leaf_id (M,) i32, leaf_tris (L,CAP) i32 (-1 padded
//   at the end), positions (V,3) f32, indices (F,3) i32, tri_mask (F,) or
//   (0,) bool.
//
// Outputs follow octree_traverse: t (inf on a miss), triangle id (-1 on a
// miss), barycentrics b1/b2 and the number of triangle tests per ray. With
// anyhit=1 the walk stops at the first hit in (0, t_max).
//
// The arithmetic mirrors the reference: the same reciprocal-direction slab
// test with the gamma(3) far-plane bound, and the watertight triangle test
// of ops/triangle.py::triangle_intersect. Two differences are deliberate:
// difference_of_products takes its exact product error from fmaf instead
// of a Dekker split, and children are visited front to back (the ray's
// direction octant first) with the running t_best as the triangle test's
// t_max. Both change only which of two triangles wins at an exact tie
// (a shared edge or vertex) and the last bits of t.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -fmad=false
// (native/__init__.py::load_cuda). -fmad=false keeps every product and sum
// rounded as in the reference; the only fused operations are the explicit
// fmaf calls below.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// Must equal ops/octree.py::STACK_SIZE; build_octree checks that every tree
// fits (a walk pushes at most 7 entries per level beyond the one it pops).
constexpr int kStackSize = 128;
constexpr int kBlock = 128;

// gamma(n) = n*eps / (1 - n*eps) with eps = 2^-24, rounded once to float as
// ops/shapes.py::fp_gamma is when it meets a float32 array.
constexpr double kEps = 5.9604644775390625e-08;
__host__ __device__ constexpr float gamma_f(int n) {
  return static_cast<float>(n * kEps / (1.0 - n * kEps));
}

__device__ __forceinline__ float diff_of_products(float a, float b, float c,
                                                  float d) {
  float cd = c * d;
  float dop = fmaf(a, b, -cd);
  float err = fmaf(-c, d, cd);
  return dop + err;
}

__device__ __forceinline__ float pick(float x, float y, float z, int k) {
  return k == 0 ? x : (k == 1 ? y : z);
}

struct Ray {
  float ox, oy, oz;
  float dx, dy, dz;
  float ix, iy, iz;  // guarded reciprocal direction (slab test)
  int kx, ky, kz;    // watertight permutation
  float sx, sy, sz;  // watertight shear
};

__device__ __forceinline__ float safe_inv(float d) {
  if (fabsf(d) < 1e-20f) {
    float s = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
    d = s * 1e-20f + 1e-30f;
  }
  return 1.0f / d;
}

__device__ __forceinline__ bool slab(const Ray& r, const float* lo,
                                     const float* hi, float t_best,
                                     float* t_near_out) {
  constexpr float kFarScale = static_cast<float>(1.0 + 2.0 * (3 * kEps / (1.0 - 3 * kEps)));
  float t0x = (lo[0] - r.ox) * r.ix, t1x = (hi[0] - r.ox) * r.ix;
  float t0y = (lo[1] - r.oy) * r.iy, t1y = (hi[1] - r.oy) * r.iy;
  float t0z = (lo[2] - r.oz) * r.iz, t1z = (hi[2] - r.oz) * r.iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)) *
             kFarScale;
  *t_near_out = tn;
  return tn <= tf && tf > 0.0f && tn < t_best;
}

// Watertight test (ops/triangle.py::triangle_intersect). Returns true on a
// hit in (delta_t, t_max) and writes t, b1, b2.
__device__ __forceinline__ bool triangle(const Ray& r, const float* p0,
                                         const float* p1, const float* p2,
                                         float t_max, float* t_out,
                                         float* b1_out, float* b2_out) {
  float a0 = p0[0] - r.ox, a1 = p0[1] - r.oy, a2 = p0[2] - r.oz;
  float b0 = p1[0] - r.ox, b1 = p1[1] - r.oy, b2 = p1[2] - r.oz;
  float c0 = p2[0] - r.ox, c1 = p2[1] - r.oy, c2 = p2[2] - r.oz;
  float apx = pick(a0, a1, a2, r.kx), apy = pick(a0, a1, a2, r.ky),
        apz = pick(a0, a1, a2, r.kz);
  float bpx = pick(b0, b1, b2, r.kx), bpy = pick(b0, b1, b2, r.ky),
        bpz = pick(b0, b1, b2, r.kz);
  float cpx = pick(c0, c1, c2, r.kx), cpy = pick(c0, c1, c2, r.ky),
        cpz = pick(c0, c1, c2, r.kz);

  float ax = apx + r.sx * apz, ay = apy + r.sy * apz;
  float bx = bpx + r.sx * bpz, by = bpy + r.sy * bpz;
  float cx = cpx + r.sx * cpz, cy = cpy + r.sy * cpz;

  float e0 = diff_of_products(bx, cy, by, cx);
  float e1 = diff_of_products(cx, ay, cy, ax);
  float e2 = diff_of_products(ax, by, ay, bx);

  bool same_side = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
                   (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
  float det = e0 + e1 + e2;
  if (!same_side || det == 0.0f) return false;

  float az = r.sz * apz, bz = r.sz * bpz, cz = r.sz * cpz;
  float t_scaled = e0 * az + e1 * bz + e2 * cz;
  float ts = det < 0.0f ? -t_scaled : t_scaled;
  float dd = fabsf(det);
  if (!(ts > 0.0f && ts < t_max * dd)) return false;

  float inv_det = 1.0f / det;
  float t = t_scaled * inv_det;

  float max_z = fmaxf(fmaxf(fabsf(az), fabsf(bz)), fabsf(cz));
  float delta_z = gamma_f(3) * max_z;
  float max_x = fmaxf(fmaxf(fabsf(ax), fabsf(bx)), fabsf(cx));
  float max_y = fmaxf(fmaxf(fabsf(ay), fabsf(by)), fabsf(cy));
  float delta_x = gamma_f(5) * (max_x + max_z);
  float delta_y = gamma_f(5) * (max_y + max_z);
  float delta_e =
      2.0f * (gamma_f(2) * max_x * max_y + delta_y * max_x + delta_x * max_y);
  float max_e = fmaxf(fmaxf(fabsf(e0), fabsf(e1)), fabsf(e2));
  float delta_t = 3.0f *
                  (gamma_f(3) * max_e * max_z + delta_e * max_z +
                   delta_z * max_e) *
                  fabsf(inv_det);
  if (!(t > delta_t)) return false;
  *t_out = t;
  *b1_out = e1 * inv_det;
  *b2_out = e2 * inv_det;
  return true;
}

__global__ void __launch_bounds__(kBlock)
traverse_kernel(int64_t n, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ t_max,
                const float* __restrict__ node_lo,
                const float* __restrict__ node_hi,
                const int32_t* __restrict__ child0,
                const int32_t* __restrict__ leaf_id,
                const int32_t* __restrict__ leaf_tris, int64_t cap,
                const float* __restrict__ positions,
                const int32_t* __restrict__ indices,
                const bool* __restrict__ tri_mask, int anyhit,
                float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                float* __restrict__ b1_out, float* __restrict__ b2_out,
                int32_t* __restrict__ tests_out) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float t_best = t_max[i];
  int32_t tri_best = -1;
  float b1_best = 0.0f, b2_best = 0.0f;
  int32_t tests = 0;

  // A ray with t_max <= 0 (dead, or already known to be occluded) cannot
  // hit a triangle, whose test needs 0 < t < t_max.
  if (t_best > 0.0f) {
    Ray r;
    r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
    r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
    r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);
    float adx = fabsf(r.dx), ady = fabsf(r.dy), adz = fabsf(r.dz);
    r.kz = (adx >= ady && adx >= adz) ? 0 : (ady >= adz ? 1 : 2);
    r.kx = (r.kz + 1) % 3;
    r.ky = (r.kx + 1) % 3;
    float dpx = pick(r.dx, r.dy, r.dz, r.kx);
    float dpy = pick(r.dx, r.dy, r.dz, r.ky);
    float dpz = pick(r.dx, r.dy, r.dz, r.kz);
    float inv_dz = 1.0f / dpz;
    r.sx = -dpx * inv_dz;
    r.sy = -dpy * inv_dz;
    r.sz = inv_dz;
    // Children are numbered ix*4 + iy*2 + iz (lower half first), so
    // XOR with the direction's sign bits visits them front to back.
    int octant = (r.dx < 0.0f ? 4 : 0) | (r.dy < 0.0f ? 2 : 0) |
                 (r.dz < 0.0f ? 1 : 0);

    int32_t stack[kStackSize];
    float stack_t[kStackSize];
    int sp = 0;
    float tn;
    if (slab(r, node_lo, node_hi, t_best, &tn)) {
      stack[0] = 0;
      stack_t[0] = tn;
      sp = 1;
    }
    bool done = false;
    while (sp > 0 && !done) {
      --sp;
      if (!(stack_t[sp] < t_best)) continue;
      int32_t node = stack[sp];
      int32_t c0 = child0[node];
      if (c0 >= 0) {
        for (int k = 7; k >= 0; --k) {
          int32_t c = c0 + (k ^ octant);
          if (slab(r, node_lo + 3 * c, node_hi + 3 * c, t_best, &tn) &&
              sp < kStackSize) {
            stack[sp] = c;
            stack_t[sp] = tn;
            ++sp;
          }
        }
        continue;
      }
      const int32_t* lt = leaf_tris + static_cast<int64_t>(leaf_id[node]) * cap;
      for (int64_t k = 0; k < cap; ++k) {
        int32_t tri = lt[k];
        if (tri < 0) break;
        if (tri_mask != nullptr && !tri_mask[tri]) continue;
        ++tests;
        const int32_t* v = indices + 3 * static_cast<int64_t>(tri);
        float t, bb1, bb2;
        if (triangle(r, positions + 3 * static_cast<int64_t>(v[0]),
                     positions + 3 * static_cast<int64_t>(v[1]),
                     positions + 3 * static_cast<int64_t>(v[2]), t_best, &t,
                     &bb1, &bb2)) {
          t_best = t;
          tri_best = tri;
          b1_best = bb1;
          b2_best = bb2;
          if (anyhit) {
            done = true;
            break;
          }
        }
      }
    }
  }
  bool hit = tri_best >= 0 && isfinite(t_best);
  t_out[i] = hit ? t_best : INFINITY;
  tri_out[i] = hit ? tri_best : -1;
  b1_out[i] = b1_best;
  b2_out[i] = b2_best;
  tests_out[i] = tests;
}

ffi::Error TraverseImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> o,
                        ffi::Buffer<ffi::F32> d, ffi::Buffer<ffi::F32> t_max,
                        ffi::Buffer<ffi::F32> node_lo,
                        ffi::Buffer<ffi::F32> node_hi,
                        ffi::Buffer<ffi::S32> child0,
                        ffi::Buffer<ffi::S32> leaf_id,
                        ffi::Buffer<ffi::S32> leaf_tris,
                        ffi::Buffer<ffi::F32> positions,
                        ffi::Buffer<ffi::S32> indices,
                        ffi::Buffer<ffi::PRED> tri_mask,
                        ffi::ResultBuffer<ffi::F32> t_out,
                        ffi::ResultBuffer<ffi::S32> tri_out,
                        ffi::ResultBuffer<ffi::F32> b1_out,
                        ffi::ResultBuffer<ffi::F32> b2_out,
                        ffi::ResultBuffer<ffi::S32> tests_out,
                        int32_t anyhit) {
  int64_t n = static_cast<int64_t>(t_max.element_count());
  if (n == 0) return ffi::Error::Success();
  auto dims = leaf_tris.dimensions();
  if (dims.size() != 2) {
    return ffi::Error::InvalidArgument("leaf_tris must be (L, CAP)");
  }
  int64_t cap = dims[1];
  const bool* mask =
      tri_mask.element_count() == 0 ? nullptr : tri_mask.typed_data();
  int64_t blocks = (n + kBlock - 1) / kBlock;
  traverse_kernel<<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      n, o.typed_data(), d.typed_data(), t_max.typed_data(),
      node_lo.typed_data(), node_hi.typed_data(), child0.typed_data(),
      leaf_id.typed_data(), leaf_tris.typed_data(), cap,
      positions.typed_data(), indices.typed_data(), mask, anyhit,
      t_out->typed_data(), tri_out->typed_data(), b1_out->typed_data(),
      b2_out->typed_data(), tests_out->typed_data());
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(CrtOctreeTraverse, TraverseImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()   // o
                                  .Arg<ffi::Buffer<ffi::F32>>()   // d
                                  .Arg<ffi::Buffer<ffi::F32>>()   // t_max
                                  .Arg<ffi::Buffer<ffi::F32>>()   // node_lo
                                  .Arg<ffi::Buffer<ffi::F32>>()   // node_hi
                                  .Arg<ffi::Buffer<ffi::S32>>()   // node_child0
                                  .Arg<ffi::Buffer<ffi::S32>>()   // node_leaf_id
                                  .Arg<ffi::Buffer<ffi::S32>>()   // leaf_tris
                                  .Arg<ffi::Buffer<ffi::F32>>()   // positions
                                  .Arg<ffi::Buffer<ffi::S32>>()   // indices
                                  .Arg<ffi::Buffer<ffi::PRED>>()  // tri_mask
                                  .Ret<ffi::Buffer<ffi::F32>>()   // t
                                  .Ret<ffi::Buffer<ffi::S32>>()   // tri
                                  .Ret<ffi::Buffer<ffi::F32>>()   // b1
                                  .Ret<ffi::Buffer<ffi::F32>>()   // b2
                                  .Ret<ffi::Buffer<ffi::S32>>()   // tests
                                  .Attr<int32_t>("anyhit"));
