// RMSNorm for Hopper, one trip to memory per row, with the residual add fused:
//
//   rmsnorm_launch:      y = x * rsqrt(mean(x^2) + eps) * (1 + scale)
//   rmsnorm_add_launch:  s = x + r (rounded to x's dtype, as torch's add), y = rmsnorm(s)
//   rmsnorm_backward_launch: dx and dscale of either (below)
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

// ---------------------------------------------------------------------------
// Backward (no TPU counterpart: the reference differentiates its rms_norm
// with XLA), for both entries (rmsnorm_add's gs, the gradient reaching s
// directly, is added to dx):
//   rstd = rsqrt(mean(x^2) + eps), u = gy (1 + scale), x_hat = x rstd,
//   dx = rstd (u - x_hat mean(u x_hat)) (+ gs),  dscale = sum over rows of gy x_hat.
// The forward's plan places a row's vectors on `tpr` threads; the CTAs walk
// the row groups `ctas` apart, so each thread keeps the same columns on every
// row and sums gy x_hat over its rows in registers. Each (CTA, row slot)
// writes its sums to partial[slot][d] (fp32); a second kernel adds the slots
// in slot order. No atomics: the same inputs give the same bits.
// Bound on the card: bytes (x, gy, gs read and dx written once; the partials
// are a few MB more); a handful of fp32 operations per element. Measured by
// chip_smoke.py on an H100 80GB HBM3 at 700 W: 0.0292 ms at internvl2's
// training rows, (8192, 896) bf16 with gs, against a 0.0175 ms bound.

template <typename T, int V, bool GS>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ gy,
                   const T* __restrict__ gs, T* __restrict__ dx, float* __restrict__ partial,
                   long long rows, int d, float eps, int tpr) {
  __shared__ float part[2][MAX_THREADS / 32];  // two sums per warp
  constexpr int PER = 16 / sizeof(T);
  const int nvec = d / PER;
  const int rpc = blockDim.x / tpr;
  const int sub = threadIdx.x / tpr;
  const int t = threadIdx.x - sub * tpr;
  float w[V][PER], acc[V][PER];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = t + k * tpr;
    uint4 sv = make_uint4(0, 0, 0, 0);
    if (c < nvec) sv = __ldg(reinterpret_cast<const uint4*>(scale) + c);
    const T* se = reinterpret_cast<const T*>(&sv);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      w[k][i] = 1.f + repro::to_f32(se[i]);
      acc[k][i] = 0.f;
    }
  }
  for (long long grp = blockIdx.x; grp * rpc < rows; grp += gridDim.x) {
    const long long row = grp * rpc + sub;
    const bool live = row < rows;
    const long long base = row * nvec;
    uint4 xv[V], gv[V], sv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {  // every load issued before any use
      const int c = t + k * tpr;
      if (live && c < nvec) {
        xv[k] = reinterpret_cast<const uint4*>(x)[base + c];
        gv[k] = reinterpret_cast<const uint4*>(gy)[base + c];
        if constexpr (GS) sv[k] = reinterpret_cast<const uint4*>(gs)[base + c];
      }
    }
    float ss = 0.f, ux = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = t + k * tpr;
      if (live && c < nvec) {
        const T* xe = reinterpret_cast<const T*>(&xv[k]);
        const T* ge = reinterpret_cast<const T*>(&gv[k]);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const float xf = repro::to_f32(xe[i]);
          ss += xf * xf;
          ux += repro::to_f32(ge[i]) * w[k][i] * xf;
        }
      }
    }
    ss = repro::warp_sum(ss);
    ux = repro::warp_sum(ux);
    if (tpr > 32) {  // the row spans warps: one step through shared memory
      const int warp = threadIdx.x / 32, wpr = tpr / 32;
      if (threadIdx.x % 32 == 0) {
        part[0][warp] = ss;
        part[1][warp] = ux;
      }
      __syncthreads();
      ss = part[0][sub * wpr];
      ux = part[1][sub * wpr];
      for (int q = 1; q < wpr; ++q) {
        ss += part[0][sub * wpr + q];
        ux += part[1][sub * wpr + q];
      }
      __syncthreads();  // part is written again for the next row group
    }
    const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);
    const float m = rstd * ux / static_cast<float>(d);  // mean(u x_hat)
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = t + k * tpr;
      if (live && c < nvec) {
        const T* xe = reinterpret_cast<const T*>(&xv[k]);
        const T* ge = reinterpret_cast<const T*>(&gv[k]);
        const T* se = reinterpret_cast<const T*>(&sv[k]);
        uint4 oraw;
        T* oe = reinterpret_cast<T*>(&oraw);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const float xh = repro::to_f32(xe[i]) * rstd, g = repro::to_f32(ge[i]);
          float v = rstd * (g * w[k][i] - xh * m);
          if constexpr (GS) v += repro::to_f32(se[i]);
          oe[i] = repro::from_f32<T>(v);
          acc[k][i] += g * xh;
        }
        reinterpret_cast<uint4*>(dx)[base + c] = oraw;
      }
    }
  }
  float* out = partial + (static_cast<long long>(blockIdx.x) * rpc + sub) * d;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = t + k * tpr;
    if (c < nvec) {
#pragma unroll
      for (int i = 0; i < PER; ++i) out[c * PER + i] = acc[k][i];
    }
  }
}

// dscale[j] = sum over slots of partial[slot][j]: 32 columns a CTA, each
// summed by 16 lanes over every 16th slot, then the 16 sums in lane order
constexpr int SUM_LANES = 16;

template <typename T>
__global__ void __launch_bounds__(32 * SUM_LANES)
rmsnorm_bwd_dscale_kernel(const float* __restrict__ partial, T* __restrict__ dscale, int slots,
                          int d) {
  __shared__ float sums[SUM_LANES][32];
  const int col = blockIdx.x * 32 + threadIdx.x % 32, lane = threadIdx.x / 32;
  float acc = 0.f;
  if (col < d)
    for (int s = lane; s < slots; s += SUM_LANES) acc += partial[static_cast<long long>(s) * d + col];
  sums[lane][threadIdx.x % 32] = acc;
  __syncthreads();
  if (lane == 0 && col < d) {
    float total = sums[0][threadIdx.x];
    for (int q = 1; q < SUM_LANES; ++q) total += sums[q][threadIdx.x];
    dscale[col] = repro::from_f32<T>(total);
  }
}

template <typename T>
int launch_backward(const void* x, const void* scale, const void* gy, const void* gs, void* dx,
                    void* dscale, float* partial, long long rows, int d, float eps, int tpr,
                    int rows_per_cta, int vectors, int ctas, cudaStream_t stream) {
  using Kernel = void (*)(const T*, const T*, const T*, const T*, T*, float*, long long, int,
                          float, int);
  Kernel kernel = nullptr;
#define REPRO_NORM_BWD(VV)                                                                  \
  case VV:                                                                                  \
    kernel = gs ? rmsnorm_bwd_kernel<T, VV, true> : rmsnorm_bwd_kernel<T, VV, false>;       \
    break;
  switch (vectors) {
    REPRO_NORM_BWD(1)
    REPRO_NORM_BWD(2)
    REPRO_NORM_BWD(4)
    REPRO_NORM_BWD(8)
    REPRO_NORM_BWD(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_NORM_BWD
  if (ctas > 0)
    kernel<<<ctas, tpr * rows_per_cta, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(gy),
        static_cast<const T*>(gs), static_cast<T*>(dx), partial, rows, d, eps, tpr);
  rmsnorm_bwd_dscale_kernel<T><<<(d + 31) / 32, 32 * SUM_LANES, 0, stream>>>(
      partial, static_cast<T*>(dscale), ctas * rows_per_cta, d);
  return static_cast<int>(cudaGetLastError());
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

// The backward of both entries: dx (rows, d) and dscale (d,) in x's dtype from
// x (rmsnorm_add's s), scale, gy and, for rmsnorm_add, gs (null for rmsnorm);
// all contiguous. The plan as the forward's (tpr, rows_per_cta, vectors) and
// `ctas` CTAs walking the row groups (norm_backward_plan in
// kernels/rmsnorm/ops.py); partial is (ctas * rows_per_cta, d) fp32 scratch.
extern "C" int rmsnorm_backward_launch(int dtype, const void* x, const void* scale,
                                       const void* gy, const void* gs, void* dx, void* dscale,
                                       void* partial, long long rows, int d, float eps, int tpr,
                                       int rows_per_cta, int vectors, int ctas, void* stream) {
  if (int err = check_plan(dtype, rows, d, tpr, rows_per_cta, vectors)) return err;
  if (ctas < 0 || (rows > 0) != (ctas > 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (dtype == kBFloat16)
    return launch_backward<bf16>(x, scale, gy, gs, dx, dscale, part, rows, d, eps, tpr,
                                 rows_per_cta, vectors, ctas, s);
  return launch_backward<float>(x, scale, gy, gs, dx, dscale, part, rows, d, eps, tpr,
                                rows_per_cta, vectors, ctas, s);
}
