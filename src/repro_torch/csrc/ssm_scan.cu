// Selective scan (Mamba S6) for Hopper, fp32 state in registers.
//
// Replaces: src/repro/kernels/ssm_scan/ssm_scan.py ssm_scan_kernel /
// ssm_scan_pallas. For every batch row b and channel d:
//
//   h_t = exp(dt_t * A_d) * h_{t-1} + (dt_t * u_t) * B_t     (N states, fp32)
//   y_t = sum_n h_t[n] * C_t[n]                               (rounded once to u's dtype)
//
// from h0 (zeros when null), and the state after the last step goes out as
// h_final: the mamba mixer's prefill starts from zeros and hands its final
// state to decode, which starts from it. The TPU kernel had h0 = 0, no final
// state, and asserted T % blk_t == 0 and D % blk_d == 0; ragged T and D are
// masked here.
//
// Bound on the card: operations. Each (t, d, n) is one exponential and a few
// fp32 multiply-adds, against 2 x 2 bytes of dt and u and 2 bytes of y per
// (t, d) in bf16: at N = 16 the exponentials on the special-function units
// (16 per clock per SM) take about twice as long as moving the bytes.
//
// Design: one thread per (b, d) channel, its N <= 16 states and its row of A
// in registers, a sequential loop over T. The TPU kernel's grid axis over
// t-blocks, with the state carried in VMEM scratch, becomes that loop; its
// d-blocks become blocks of 128 channels. B_t and C_t are the same for every
// channel of a batch row, so a block stages a tile of TILE_T steps of both in
// shared memory, read through their strides (the model passes column slices
// of the x_proj output). Each thread stages its own column of the tile's dt
// and u in shared memory first (consecutive threads on consecutive d:
// coalesced, and the loads all in flight before the dependent chain starts),
// so the loop over the tile's steps stays a loop: a tile held in registers
// needs that loop unrolled, 32 steps x 16 states of straight-line code, which
// measured twice as slow at prefill. y is written the same way. expf, not
// __expf: the plain version's exp is the accurate one.
//
// Known limit, left for a later change: at prefill with B = 1 and D = 8192
// this is only 64 blocks of 128 threads on 132 SMs; splitting N across lanes
// (or T into chunks with a combine) would fill the card.

#include "common.cuh"

namespace {

using repro::bf16;

constexpr int kThreads = 128;  // channels per block
constexpr int TILE_T = 32;     // time steps staged per pass

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ dt, const T* __restrict__ Bc, const T* __restrict__ Cc,
                const T* __restrict__ u, const float* __restrict__ A,
                const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_out,
                int n_t, int n_d, int n_s, long long sbb, long long sbt, long long scb,
                long long sct) {
  __shared__ float s_b[TILE_T * NMAX];
  __shared__ float s_c[TILE_T * NMAX];
  __shared__ float s_dt[TILE_T * kThreads];  // [step][channel]: each thread its own column
  __shared__ float s_u[TILE_T * kThreads];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < n_d;

  float a[NMAX], h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    a[n] = 0.f;
    h[n] = 0.f;
    if (live && n < n_s) {
      a[n] = A[static_cast<long long>(d) * n_s + n];
      if (h0 != nullptr) h[n] = h0[(static_cast<long long>(b) * n_d + d) * n_s + n];
    }
  }

  const long long row = static_cast<long long>(b) * n_t;  // (b, t = 0) in dt, u and y
  const T* bc = Bc + b * sbb;
  const T* cc = Cc + b * scb;
  for (int t0 = 0; t0 < n_t; t0 += TILE_T) {
    const int steps = n_t - t0 < TILE_T ? n_t - t0 : TILE_T;
    for (int i = threadIdx.x; i < steps * n_s; i += kThreads) {
      const int tt = i / n_s, n = i - tt * n_s;
      s_b[tt * NMAX + n] = repro::to_f32(bc[(t0 + tt) * sbt + n]);
      s_c[tt * NMAX + n] = repro::to_f32(cc[(t0 + tt) * sct + n]);
    }
    if (live) {
#pragma unroll 8
      for (int tt = 0; tt < steps; ++tt) {  // independent loads, all in flight at once
        const long long at = (row + t0 + tt) * n_d + d;
        s_dt[tt * kThreads + threadIdx.x] = repro::to_f32(dt[at]);
        s_u[tt * kThreads + threadIdx.x] = repro::to_f32(u[at]);
      }
    }
    __syncthreads();
    if (live) {
      for (int tt = 0; tt < steps; ++tt) {
        const float dtf = s_dt[tt * kThreads + threadIdx.x];
        const float dtu = dtf * s_u[tt * kThreads + threadIdx.x];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n < n_s) {
            const float decay = expf(dtf * a[n]);
            h[n] = decay * h[n] + dtu * s_b[tt * NMAX + n];
            acc += h[n] * s_c[tt * NMAX + n];
          }
        }
        y[(row + t0 + tt) * n_d + d] = repro::from_f32<T>(acc);
      }
    }
    __syncthreads();  // the next tile overwrites the staged steps
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < n_s) h_out[(static_cast<long long>(b) * n_d + d) * n_s + n] = h[n];
    }
  }
}

template <typename T, int NMAX>
int launch(const void* dt, const void* Bc, const void* Cc, const void* u, const float* A,
           const float* h0, void* y, float* h_out, int n_b, int n_t, int n_d, int n_s,
           long long sbb, long long sbt, long long scb, long long sct, cudaStream_t stream) {
  const dim3 grid((n_d + kThreads - 1) / kThreads, n_b);
  ssm_scan_kernel<T, NMAX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(Bc), static_cast<const T*>(Cc),
      static_cast<const T*>(u), A, h0, static_cast<T*>(y), h_out, n_t, n_d, n_s, sbb, sbt,
      scb, sct);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* dt, const void* Bc, const void* Cc, const void* u, const float* A,
             const float* h0, void* y, float* h_out, int n_b, int n_t, int n_d, int n_s,
             long long sbb, long long sbt, long long scb, long long sct, cudaStream_t stream) {
  if (n_s <= 4)
    return launch<T, 4>(dt, Bc, Cc, u, A, h0, y, h_out, n_b, n_t, n_d, n_s, sbb, sbt, scb, sct,
                        stream);
  return launch<T, 16>(dt, Bc, Cc, u, A, h0, y, h_out, n_b, n_t, n_d, n_s, sbb, sbt, scb, sct,
                       stream);
}

}  // namespace

// dt, u, y: (B, T, D) contiguous; Bc, Cc: (B, T, N) with strides (sbb, sbt, 1)
// and (scb, sct, 1); A: (D, N) fp32 contiguous; h0 (null for zeros) and
// h_out: (B, D, N) fp32 contiguous; 1 <= N <= 16 (the wrapper checks all of it).
extern "C" int ssm_scan_launch(int dtype, const void* dt, const void* Bc, const void* Cc,
                               const void* u, const void* A, const void* h0, void* y,
                               void* h_out, int n_b, int n_t, int n_d, int n_s, long long sbb,
                               long long sbt, long long scb, long long sct, void* stream) {
  if (n_s < 1 || n_s > 16 || n_b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (n_b <= 0 || n_d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* hi = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(h_out);
  if (dtype == kBFloat16)
    return dispatch<bf16>(dt, Bc, Cc, u, a, hi, y, ho, n_b, n_t, n_d, n_s, sbb, sbt, scb, sct, s);
  if (dtype == kFloat32)
    return dispatch<float>(dt, Bc, Cc, u, a, hi, y, ho, n_b, n_t, n_d, n_s, sbb, sbt, scb, sct, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
