// Closest hit by per-ray BVH traversal, as an XLA FFI custom call for CUDA.
//
// One thread walks one ray through the linearized BVH of
// metalpathtracer_tpu/accel/bvh.py (node_a = leftFirst, node_b = +count for
// a leaf and -right for an internal node), the shape of the reference's
// `firstHitBVH` (MetalCpp Path Tracer/Renderer/Shaders/PathTracing.h:75-204).
// The walk is ordered: both children are slab-tested at the parent, the
// nearer is entered and the farther is pushed with its entry distance, and a
// popped node is skipped once the best hit is nearer than its entry.
//
// The arithmetic follows the plain routes in render/intersect.py (ray_aabb,
// ray_sphere, ray_triangle) term by term, so the two agree up to FMA
// contraction. Hits count when t_min < t < t_max, with t_max per ray (the
// reference passes `in.t` as tMax, PathTracing.h:100). Inactive rays and
// misses return (inf, -1).
//
// Build: make -C native gpu

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// Deepest BVH this build can walk: the Python wrapper refuses deeper scenes
// (render/hit_cuda.py MAX_DEPTH) and the handler checks again.
constexpr int kMaxStack = 64;
constexpr int kBlock = 128;
constexpr int kPrimSphere = 0;
constexpr int kPrimTriangle = 1;
constexpr float kTriParallelEps = 1e-5f;  // intersect.TRI_PARALLEL_EPS

struct Scene {
  const float* node_lo;
  const float* node_hi;
  const int32_t* node_a;
  const int32_t* node_b;
  const int32_t* prim_indices;
  const int32_t* prim_type;
  const float* p0;
  const float* p1;
  const float* p2;
};

__device__ __forceinline__ float3 load3(const float* p, int i) {
  return make_float3(__ldg(p + 3 * i), __ldg(p + 3 * i + 1),
                     __ldg(p + 3 * i + 2));
}

__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ float3 sub3(float3 a, float3 b) {
  return make_float3(a.x - b.x, a.y - b.y, a.z - b.z);
}

__device__ __forceinline__ float3 cross3(float3 a, float3 b) {
  return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                     a.x * b.y - a.y * b.x);
}

// One slab axis. A NaN (0 * inf: origin on the plane of an axis-parallel
// ray) leaves the axis unconstrained, as intersect.ray_aabb does.
__device__ __forceinline__ void slab_axis(float lo, float hi, float o,
                                          float inv, float& near,
                                          float& far) {
  float t0 = (lo - o) * inv;
  float t1 = (hi - o) * inv;
  if (isnan(t0) || isnan(t1)) {
    near = -INFINITY;
    far = INFINITY;
  } else {
    near = fminf(t0, t1);
    far = fmaxf(t0, t1);
  }
}

__device__ __forceinline__ bool hit_box(const Scene& s, int node, float3 o,
                                        float3 inv, float t_min, float t_max,
                                        float& enter) {
  float3 lo = load3(s.node_lo, node);
  float3 hi = load3(s.node_hi, node);
  float nx, fx, ny, fy, nz, fz;
  slab_axis(lo.x, hi.x, o.x, inv.x, nx, fx);
  slab_axis(lo.y, hi.y, o.y, inv.y, ny, fy);
  slab_axis(lo.z, hi.z, o.z, inv.z, nz, fz);
  enter = fmaxf(fmaxf(fmaxf(nx, ny), nz), t_min);
  float exit = fminf(fminf(fminf(fx, fy), fz), t_max);
  return exit > enter;
}

// intersect.ray_sphere with both roots and its radius-scaled far floor.
__device__ __forceinline__ float hit_sphere(float3 o, float3 d, float3 c,
                                            float r, float t_min) {
  float3 oc = sub3(o, c);
  float a = dot3(d, d);
  float b = dot3(oc, d);
  float cc = dot3(oc, oc) - r * r;
  float disc = b * b - a * cc;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t_near = (-b - sq) / a;
  float t_far = (-b + sq) / a;
  bool valid = disc > 0.0f;
  float far_floor = fmaxf(t_min, 3.0e-5f * r);
  if (valid && t_near > t_min) return t_near;
  if (valid && t_far > far_floor) return t_far;
  return INFINITY;
}

// intersect.ray_triangle (Moller-Trumbore).
__device__ __forceinline__ float hit_triangle(float3 o, float3 d, float3 v0,
                                              float3 v1, float3 v2,
                                              float t_min) {
  float3 e1 = sub3(v1, v0);
  float3 e2 = sub3(v2, v0);
  float3 h = cross3(d, e2);
  float a = dot3(e1, h);
  if (fabsf(a) <= kTriParallelEps) return INFINITY;
  float f = 1.0f / a;
  float3 s = sub3(o, v0);
  float u = f * dot3(s, h);
  float3 q = cross3(s, e1);
  float v = f * dot3(d, q);
  float t = f * dot3(e2, q);
  bool ok = u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
            t > t_min;
  return ok ? t : INFINITY;
}

__global__ void __launch_bounds__(kBlock)
    closest_hit_kernel(int64_t n, const float* __restrict__ ray_o,
                       const float* __restrict__ ray_d,
                       const bool* __restrict__ active,
                       const float* __restrict__ t_max, Scene s, float t_min,
                       float* __restrict__ out_t,
                       int32_t* __restrict__ out_idx) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best_t = INFINITY;
  int32_t best_i = -1;
  if (active[i]) {
    float3 o = load3(ray_o, static_cast<int>(i));
    float3 d = load3(ray_d, static_cast<int>(i));
    float3 inv = make_float3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
    best_t = t_max[i];

    int stack_node[kMaxStack];
    float stack_enter[kMaxStack];
    int sp = 0;
    int node = 0;
    float enter;
    bool go = hit_box(s, 0, o, inv, t_min, best_t, enter);
    while (go) {
      int32_t a = __ldg(s.node_a + node);
      int32_t b = __ldg(s.node_b + node);
      if (b > 0) {
        for (int k = 0; k < b; ++k) {
          int32_t p = __ldg(s.prim_indices + a + k);
          int32_t type = __ldg(s.prim_type + p);
          float t = INFINITY;
          if (type == kPrimSphere) {
            t = hit_sphere(o, d, load3(s.p0, p), __ldg(s.p1 + 3 * p), t_min);
          } else if (type == kPrimTriangle) {
            t = hit_triangle(o, d, load3(s.p0, p), load3(s.p1, p),
                             load3(s.p2, p), t_min);
          }
          if (t < best_t) {
            best_t = t;
            best_i = p;
          }
        }
      } else {
        int left = a;
        int right = -b;
        float t_left, t_right;
        bool h_left = hit_box(s, left, o, inv, t_min, best_t, t_left);
        bool h_right = hit_box(s, right, o, inv, t_min, best_t, t_right);
        if (h_left && h_right) {
          bool right_first = t_right < t_left;
          // depth <= kMaxStack is checked before launch, and the walk
          // pushes at most one node per level
          stack_node[sp] = right_first ? left : right;
          stack_enter[sp] = right_first ? t_left : t_right;
          ++sp;
          node = right_first ? right : left;
          continue;
        }
        if (h_left || h_right) {
          node = h_left ? left : right;
          continue;
        }
      }
      go = false;
      while (sp > 0) {
        --sp;
        if (stack_enter[sp] < best_t) {
          node = stack_node[sp];
          go = true;
          break;
        }
      }
    }
  }
  out_t[i] = best_i >= 0 ? best_t : INFINITY;
  out_idx[i] = best_i;
}

ffi::Error ClosestHitImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> ray_o,
                          ffi::Buffer<ffi::F32> ray_d,
                          ffi::Buffer<ffi::PRED> active,
                          ffi::Buffer<ffi::F32> t_max,
                          ffi::Buffer<ffi::F32> node_lo,
                          ffi::Buffer<ffi::F32> node_hi,
                          ffi::Buffer<ffi::S32> node_a,
                          ffi::Buffer<ffi::S32> node_b,
                          ffi::Buffer<ffi::S32> prim_indices,
                          ffi::Buffer<ffi::S32> prim_type,
                          ffi::Buffer<ffi::F32> p0, ffi::Buffer<ffi::F32> p1,
                          ffi::Buffer<ffi::F32> p2, float t_min,
                          int32_t max_depth,
                          ffi::ResultBuffer<ffi::F32> out_t,
                          ffi::ResultBuffer<ffi::S32> out_idx) {
  if (max_depth + 2 > kMaxStack) {
    return ffi::Error::InvalidArgument(
        "BVH deeper than the traversal stack of native/closest_hit.cu");
  }
  int64_t n = out_t->element_count();
  if (ray_o.element_count() != 3 * n || ray_d.element_count() != 3 * n ||
      active.element_count() != n || t_max.element_count() != n ||
      out_idx->element_count() != n) {
    return ffi::Error::InvalidArgument("ray arrays disagree on N");
  }
  if (n == 0) return ffi::Error::Success();
  Scene s{node_lo.typed_data(),      node_hi.typed_data(),
          node_a.typed_data(),       node_b.typed_data(),
          prim_indices.typed_data(), prim_type.typed_data(),
          p0.typed_data(),           p1.typed_data(),
          p2.typed_data()};
  int64_t blocks = (n + kBlock - 1) / kBlock;
  closest_hit_kernel<<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      n, ray_o.typed_data(), ray_d.typed_data(), active.typed_data(),
      t_max.typed_data(), s, t_min, out_t->typed_data(),
      out_idx->typed_data());
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(MptClosestHit, ClosestHitImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ray_o
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ray_d
                                  .Arg<ffi::Buffer<ffi::PRED>>()  // active
                                  .Arg<ffi::Buffer<ffi::F32>>()  // t_max
                                  .Arg<ffi::Buffer<ffi::F32>>()  // node_lo
                                  .Arg<ffi::Buffer<ffi::F32>>()  // node_hi
                                  .Arg<ffi::Buffer<ffi::S32>>()  // node_a
                                  .Arg<ffi::Buffer<ffi::S32>>()  // node_b
                                  .Arg<ffi::Buffer<ffi::S32>>()  // prim_indices
                                  .Arg<ffi::Buffer<ffi::S32>>()  // prim_type
                                  .Arg<ffi::Buffer<ffi::F32>>()  // p0
                                  .Arg<ffi::Buffer<ffi::F32>>()  // p1
                                  .Arg<ffi::Buffer<ffi::F32>>()  // p2
                                  .Attr<float>("t_min")
                                  .Attr<int32_t>("max_depth")
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::S32>>());  // idx
