// RMSNorm for Hopper, one trip to memory per row, with the residual add fused:
//
//   rmsnorm_launch:      y = x * rsqrt(mean(x^2) + eps) * (1 + scale)
//   rmsnorm_add_launch:  s = x + r (rounded to x's dtype, as torch's add), y = rmsnorm(s)
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py rmsnorm_kernel / rmsnorm_pallas.
// The fused entry is the reference's `x = x + y; h = rms_norm(x, ...)`
// (src/repro/models/lm.py) in one launch instead of two.
//
// Bound on the card: bytes. Each element is read once and written once and
// costs a handful of fp32 operations, far below the ~295 operations per byte
// at which an H100 stops being limited by its 3.35 TB/s of device memory. At
// a decode step's rows, (4, 3072) bf16, those bytes take 16 ns, and the
// kernel is all latency: the launch, one round trip to memory, the
// reduction.
//
// Design: a row per group of `tpr` threads (a warp or a whole CTA; a CTA of
// several rows where a row needs fewer threads), V 16-byte vectors a thread,
// kept in registers. Each thread issues every load before any use, `scale`
// first (it does not depend on x), so a row costs one trip to memory; the sum
// of squares is reduced by warp shuffles and, where a row spans warps, one
// step through shared memory behind one barrier. The (1 + scale) convention
// and the fp32 core follow repro.models.layers.rms_norm. Both entries share
// the code and the plan (norm_plan in kernels/rmsnorm/ops.py), so the fused
// entry's y is bit-equal to rmsnorm_launch applied to its own s. The Pallas
// kernel's (blk_rows, d) tiles map to rows per CTA here.
//
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W (PERF.md holds
// every run): (4, 3072) bf16 about 0.0018 ms, the fused entry about 0.0021,
// against the card's per-launch floor of about 0.0013 ms (a one-element
// elementwise op); (256, 3072) about 0.0026 ms against a 0.00094 ms bound.
// A warp per row needs 12 vectors a thread at d = 3072 and spills; 128 and
// 256 threads per row time alike.

#include "common.cuh"

namespace {

using repro::bf16;

constexpr int MAX_THREADS = 512;

template <typename T>
__device__ __forceinline__ uint4 add_vec(const uint4& a, const uint4& b) {
  constexpr int PER = 16 / sizeof(T);
  uint4 o;
  const T* x = reinterpret_cast<const T*>(&a);
  const T* r = reinterpret_cast<const T*>(&b);
  T* s = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int i = 0; i < PER; ++i)
    s[i] = repro::from_f32<T>(repro::to_f32(x[i]) + repro::to_f32(r[i]));
  return o;
}

template <typename T, int V, bool ADD>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ scale,
               T* __restrict__ s_out, T* __restrict__ out, long long rows, int d, float eps,
               int tpr) {
  __shared__ float part[MAX_THREADS / 32];  // one sum per warp
  constexpr int PER = 16 / sizeof(T);
  const int nvec = d / PER;
  const int sub = threadIdx.x / tpr;  // the CTA's row this thread works on
  const int t = threadIdx.x - sub * tpr;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) + sub;
  const bool live = row < rows;
  const long long base = row * nvec;  // in vectors
  const uint4* sv4 = reinterpret_cast<const uint4*>(scale);
  const uint4* xv4 = reinterpret_cast<const uint4*>(x) + base;
  const uint4* rv4 = ADD ? reinterpret_cast<const uint4*>(r) + base : nullptr;

  uint4 sv[V], xv[V], rv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {  // every load issued before any use, scale first
    const int c = t + k * tpr;
    if (c < nvec) sv[k] = __ldg(sv4 + c);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = t + k * tpr;
    if (live && c < nvec) {
      xv[k] = xv4[c];
      if constexpr (ADD) rv[k] = rv4[c];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = t + k * tpr;
    if (live && c < nvec) {
      if constexpr (ADD) {
        xv[k] = add_vec<T>(xv[k], rv[k]);
        reinterpret_cast<uint4*>(s_out)[base + c] = xv[k];
      }
      const T* v = reinterpret_cast<const T*>(&xv[k]);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float f = repro::to_f32(v[i]);
        ss += f * f;
      }
    }
  }
  ss = repro::warp_sum(ss);
  if (tpr > 32) {  // the row spans warps: one step through shared memory
    const int warp = threadIdx.x / 32, wpr = tpr / 32;
    if (threadIdx.x % 32 == 0) part[warp] = ss;
    __syncthreads();
    ss = part[sub * wpr];
    for (int w = 1; w < wpr; ++w) ss += part[sub * wpr + w];
  }
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

  uint4* o = reinterpret_cast<uint4*>(out) + base;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = t + k * tpr;
    if (live && c < nvec) {
      const T* v = reinterpret_cast<const T*>(&xv[k]);
      const T* s = reinterpret_cast<const T*>(&sv[k]);
      uint4 oraw;
      T* ov = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int i = 0; i < PER; ++i)
        ov[i] = repro::from_f32<T>(repro::to_f32(v[i]) * inv * (1.f + repro::to_f32(s[i])));
      o[c] = oraw;
    }
  }
}

template <typename T, bool ADD>
int launch(const void* x, const void* r, const void* scale, void* s_out, void* out,
           long long rows, int d, float eps, int tpr, int rows_per_cta, int vectors,
           cudaStream_t stream) {
  using Kernel = void (*)(const T*, const T*, const T*, T*, T*, long long, int, float, int);
  Kernel kernel = nullptr;
  switch (vectors) {
    case 1: kernel = rmsnorm_kernel<T, 1, ADD>; break;
    case 2: kernel = rmsnorm_kernel<T, 2, ADD>; break;
    case 4: kernel = rmsnorm_kernel<T, 4, ADD>; break;
    case 8: kernel = rmsnorm_kernel<T, 8, ADD>; break;
    case 16: kernel = rmsnorm_kernel<T, 16, ADD>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned ctas = static_cast<unsigned>((rows + rows_per_cta - 1) / rows_per_cta);
  kernel<<<ctas, tpr * rows_per_cta, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(scale),
      static_cast<T*>(s_out), static_cast<T*>(out), rows, d, eps, tpr);
  return static_cast<int>(cudaGetLastError());
}

// The plan (threads per row, rows per CTA, vectors per thread) from
// norm_plan; the row must fit: tpr * vectors 16-byte vectors cover d.
int check_plan(int dtype, long long rows, int d, int tpr, int rows_per_cta, int vectors) {
  const int elt = dtype == kBFloat16 ? 2 : dtype == kFloat32 ? 4 : 0;
  if (elt == 0 || d < 1 || d * elt % 16 != 0 || tpr < 32 || tpr % 32 != 0 ||
      rows_per_cta < 1 || tpr * rows_per_cta > MAX_THREADS ||
      static_cast<long long>(tpr) * vectors * 16 < 1LL * d * elt ||
      (rows + rows_per_cta - 1) / rows_per_cta > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// x, r, s_out, out: (rows, d) contiguous; scale: (d,). d * sizeof(T) must be
// a multiple of 16 and every pointer 16-byte aligned (the wrapper checks both).
extern "C" int rmsnorm_launch(int dtype, const void* x, const void* scale, void* out,
                              long long rows, int d, float eps, int tpr, int rows_per_cta,
                              int vectors, void* stream) {
  if (int err = check_plan(dtype, rows, d, tpr, rows_per_cta, vectors)) return err;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<bf16, false>(x, nullptr, scale, nullptr, out, rows, d, eps, tpr, rows_per_cta,
                               vectors, s);
  return launch<float, false>(x, nullptr, scale, nullptr, out, rows, d, eps, tpr, rows_per_cta,
                              vectors, s);
}

extern "C" int rmsnorm_add_launch(int dtype, const void* x, const void* r, const void* scale,
                                  void* s_out, void* out, long long rows, int d, float eps,
                                  int tpr, int rows_per_cta, int vectors, void* stream) {
  if (int err = check_plan(dtype, rows, d, tpr, rows_per_cta, vectors)) return err;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<bf16, true>(x, r, scale, s_out, out, rows, d, eps, tpr, rows_per_cta, vectors,
                              s);
  return launch<float, true>(x, r, scale, s_out, out, rows, d, eps, tpr, rows_per_cta, vectors,
                             s);
}
