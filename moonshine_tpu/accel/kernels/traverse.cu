// Per-thread BVH traversal for NVIDIA GPUs, called from JAX through the
// XLA FFI (accel/cuda.py builds and registers it).
//
// One thread walks one ray through the binary BVH in the stackless
// escape-link order of accel/traverse.py: the cursor, the best t and the
// hit stay in registers for the whole walk, and each thread stops when its
// own ray is done. Records are the ones accel/packed.py writes: a node is
// two int4 (min.xyz bits + link, max.xyz bits + escape), a triangle three
// float4 (v0, v1 - v0, v2 - v0). The slab and Moller-Trumbore arithmetic
// mirror traverse.py term for term.
//
// Handlers only enqueue a kernel on XLA's stream: no synchronisation and
// no allocation.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBlock = 128;
constexpr int kLeafCountBits = 4;
constexpr float kTiny = 1e-12f;

struct Ray {
  float ox, oy, oz;
  float dx, dy, dz;
  float ix, iy, iz;
};

__device__ __forceinline__ float safe_inv(float d) {
  const float s = d >= 0.f ? 1.f : -1.f;
  return 1.f / (fabsf(d) < kTiny ? s * kTiny : d);
}

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        int64_t i) {
  Ray r;
  r.ox = o[3 * i];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

__device__ __forceinline__ bool box_hit(const int4& a, const int4& b,
                                        const Ray& r, float t_best) {
  const float t0x = (__int_as_float(a.x) - r.ox) * r.ix;
  const float t1x = (__int_as_float(b.x) - r.ox) * r.ix;
  const float t0y = (__int_as_float(a.y) - r.oy) * r.iy;
  const float t1y = (__int_as_float(b.y) - r.oy) * r.iy;
  const float t0z = (__int_as_float(a.z) - r.oz) * r.iz;
  const float t1z = (__int_as_float(b.z) - r.oz) * r.iz;
  const float tnear =
      fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tfar =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tnear <= tfar && tfar >= 0.f && tnear <= t_best;
}

// Moller-Trumbore against triangle record s; true on a hit in (0, t_best).
__device__ __forceinline__ bool tri_hit(const float4* __restrict__ tris,
                                        int s, const Ray& r, float t_best,
                                        float& t, float& u, float& v) {
  const float4 v0 = __ldg(tris + 3 * s);
  const float4 e1 = __ldg(tris + 3 * s + 1);
  const float4 e2 = __ldg(tris + 3 * s + 2);
  const float px = r.dy * e2.z - r.dz * e2.y;
  const float py = r.dz * e2.x - r.dx * e2.z;
  const float pz = r.dx * e2.y - r.dy * e2.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  const float inv_det = 1.f / (fabsf(det) < kTiny ? kTiny : det);
  const float tx = r.ox - v0.x;
  const float ty = r.oy - v0.y;
  const float tz = r.oz - v0.z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1.z - tz * e1.y;
  const float qy = tz * e1.x - tx * e1.z;
  const float qz = tx * e1.y - ty * e1.x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
  return fabsf(det) > kTiny && u >= 0.f && v >= 0.f && u + v <= 1.f &&
         t > 0.f && t < t_best;
}

template <bool kAnyHit>
__device__ __forceinline__ void walk(const int4* __restrict__ nodes,
                                     const float4* __restrict__ tris,
                                     int num_tris, const Ray& r,
                                     float& t_best, int& best, float& bu,
                                     float& bv) {
  int cur = 0;
  while (cur >= 0) {
    const int4 a = __ldg(nodes + 2 * cur);
    const int4 b = __ldg(nodes + 2 * cur + 1);
    int next = b.w;  // escape link
    if (box_hit(a, b, r, t_best)) {
      if (a.w >= 0) {
        next = a.w;  // internal: descend into the left child
      } else {
        const int code = -1 - a.w;
        const int offset = code >> kLeafCountBits;
        const int count = code & ((1 << kLeafCountBits) - 1);
        for (int j = 0; j < count; ++j) {
          const int s = min(offset + j, num_tris - 1);
          float t, u, v;
          if (tri_hit(tris, s, r, t_best, t, u, v)) {
            best = s;
            if (kAnyHit) return;
            t_best = t;
            bu = u;
            bv = v;
          }
        }
      }
    }
    cur = next;
  }
}

__global__ void closest_kernel(const int4* __restrict__ nodes,
                               const float4* __restrict__ tris,
                               const int32_t* __restrict__ tri_order,
                               int num_tris, const float* __restrict__ o,
                               const float* __restrict__ d,
                               const float* __restrict__ t_max,
                               const bool* __restrict__ active, int64_t n,
                               float* __restrict__ t_out,
                               int32_t* __restrict__ tri_out,
                               float* __restrict__ u_out,
                               float* __restrict__ v_out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= n) return;
  float t_best = t_max[i];
  int best = -1;
  float bu = 0.f, bv = 0.f;
  if (active[i]) {
    const Ray r = load_ray(o, d, i);
    walk<false>(nodes, tris, num_tris, r, t_best, best, bu, bv);
  }
  t_out[i] = t_best;
  tri_out[i] = best >= 0 ? tri_order[best] : -1;
  u_out[i] = bu;
  v_out[i] = bv;
}

__global__ void any_kernel(const int4* __restrict__ nodes,
                           const float4* __restrict__ tris, int num_tris,
                           const float* __restrict__ o,
                           const float* __restrict__ d,
                           const float* __restrict__ t_max,
                           const bool* __restrict__ active, int64_t n,
                           bool* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= n) return;
  int best = -1;
  if (active[i]) {
    const Ray r = load_ray(o, d, i);
    float t_best = t_max[i], bu = 0.f, bv = 0.f;
    walk<true>(nodes, tris, num_tris, r, t_best, best, bu, bv);
  }
  out[i] = best >= 0;
}

unsigned int num_blocks(int64_t n) {
  return static_cast<unsigned int>((n + kBlock - 1) / kBlock);
}

ffi::Error launch_status() {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error ClosestHitImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> nodes,
                          ffi::Buffer<ffi::F32> tris,
                          ffi::Buffer<ffi::S32> tri_order,
                          ffi::Buffer<ffi::F32> o, ffi::Buffer<ffi::F32> d,
                          ffi::Buffer<ffi::F32> t_max,
                          ffi::Buffer<ffi::PRED> active,
                          ffi::ResultBuffer<ffi::F32> t,
                          ffi::ResultBuffer<ffi::S32> tri,
                          ffi::ResultBuffer<ffi::F32> u,
                          ffi::ResultBuffer<ffi::F32> v) {
  const int64_t n = static_cast<int64_t>(t_max.element_count());
  if (n == 0) return ffi::Error::Success();
  closest_kernel<<<num_blocks(n), kBlock, 0, stream>>>(
      reinterpret_cast<const int4*>(nodes.typed_data()),
      reinterpret_cast<const float4*>(tris.typed_data()),
      tri_order.typed_data(), static_cast<int>(tri_order.element_count()),
      o.typed_data(), d.typed_data(), t_max.typed_data(),
      active.typed_data(), n, t->typed_data(), tri->typed_data(),
      u->typed_data(), v->typed_data());
  return launch_status();
}

ffi::Error AnyHitImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> nodes,
                      ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> o,
                      ffi::Buffer<ffi::F32> d, ffi::Buffer<ffi::F32> t_max,
                      ffi::Buffer<ffi::PRED> active,
                      ffi::ResultBuffer<ffi::PRED> out) {
  const int64_t n = static_cast<int64_t>(t_max.element_count());
  if (n == 0) return ffi::Error::Success();
  any_kernel<<<num_blocks(n), kBlock, 0, stream>>>(
      reinterpret_cast<const int4*>(nodes.typed_data()),
      reinterpret_cast<const float4*>(tris.typed_data()),
      static_cast<int>(tris.element_count() / 12), o.typed_data(),
      d.typed_data(), t_max.typed_data(), active.typed_data(), n,
      out->typed_data());
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(MsnClosestHit, ClosestHitImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Arg<ffi::Buffer<ffi::S32>>()  // tri_order
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ray_o
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ray_d
                                  .Arg<ffi::Buffer<ffi::F32>>()  // t_max
                                  .Arg<ffi::Buffer<ffi::PRED>>()  // active
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::S32>>()  // tri
                                  .Ret<ffi::Buffer<ffi::F32>>()  // u
                                  .Ret<ffi::Buffer<ffi::F32>>());  // v

XLA_FFI_DEFINE_HANDLER_SYMBOL(MsnAnyHit, AnyHitImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ray_o
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ray_d
                                  .Arg<ffi::Buffer<ffi::F32>>()  // t_max
                                  .Arg<ffi::Buffer<ffi::PRED>>()  // active
                                  .Ret<ffi::Buffer<ffi::PRED>>());  // hit
