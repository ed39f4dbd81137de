// Fused RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * (1 + scale).
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py rmsnorm_kernel / rmsnorm_pallas.
//
// Bound on the card: bytes. Each element is read once and written once and
// costs a handful of fp32 operations, far below the ~295 operations per byte
// at which an H100 stops being limited by its 3.35 TB/s of device memory.
// Design: one block per row. The row is read once from device memory with
// 16-byte loads, kept in shared memory as fp32 while the sum of squares is
// reduced (warp shuffles, then one value per warp), and written once with
// 16-byte stores. The (1 + scale) convention and the fp32 core follow
// repro.models.layers.rms_norm. The Pallas kernel's (blk_rows, d) tiles map to
// one row per block here: 128 threads read a 3072-wide bf16 row in 3 loads each.

#include "common.cuh"

namespace {

using repro::bf16;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
               int d, float eps) {
  extern __shared__ float row[];  // d floats
  __shared__ float warp_part[kThreads / 32];
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = d / VEC;
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const uint4* xin = reinterpret_cast<const uint4*>(x + base);

  float ss = 0.f;
  for (int c = threadIdx.x; c < nvec; c += kThreads) {
    uint4 raw = xin[c];
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float f = repro::to_f32(v[i]);
      row[c * VEC + i] = f;
      ss += f * f;
    }
  }
  ss = repro::warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? warp_part[lane] : 0.f;
    t = repro::warp_sum(t);
    if (lane == 0) warp_part[0] = t;
  }
  __syncthreads();
  const float inv = rsqrtf(warp_part[0] / static_cast<float>(d) + eps);

  const uint4* sv4 = reinterpret_cast<const uint4*>(scale);
  uint4* o = reinterpret_cast<uint4*>(out + base);
  for (int c = threadIdx.x; c < nvec; c += kThreads) {
    uint4 sraw = sv4[c];
    const T* s = reinterpret_cast<const T*>(&sraw);
    uint4 oraw;
    T* ov = reinterpret_cast<T*>(&oraw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      ov[i] = repro::from_f32<T>(row[c * VEC + i] * inv * (1.f + repro::to_f32(s[i])));
    }
    o[c] = oraw;
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, long long rows, int d, float eps,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  cudaError_t err = repro::allow_smem(rmsnorm_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_kernel<T><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (rows, d) contiguous; scale: (d,). d * sizeof(T) must be a multiple
// of 16 and every pointer 16-byte aligned (the wrapper checks both).
extern "C" int rmsnorm_launch(int dtype, const void* x, const void* scale, void* out,
                              long long rows, int d, float eps, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch<bf16>(x, scale, out, rows, d, eps, s);
  if (dtype == kFloat32) return launch<float>(x, scale, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
