// Selective scan (Mamba S6) for Hopper: a channel's states spread across a
// group of lanes, tiles of the inputs double-buffered by cp.async.
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
// Bound on the card: at prefill operations, one exponential per (t, d, n) on
// the special-function units (16 per clock per SM), about twice the time of
// the bytes (2 x 2 bytes of dt and u in, 2 bytes of y out per (t, d) in
// bf16); at a decode step bytes, almost all of them A, h0 and h_final.
//
// Design. A channel's STATES = 16 states (N <= 16, padded with zeros) are
// spread over a group of G lanes (G in {4, 8, 16}), each holding 16 / G
// consecutive ones and the matching entries of A: a warp's loads of A and h0
// and its stores of h_final are contiguous (one 16-, 8- or 4-byte access a
// lane where N = 16); where B x D is small, a wider group fills the card. A
// CTA holds
// 128 / G channels of one batch row and walks T in tiles of tile_t steps:
// the tile's dt, u, B and C are copied into shared memory by cp.async, the
// next tile's copies in flight while this tile's recurrence runs (two raw
// stages); one pass converts a landed tile to fp32 ((dt, dt * u) per
// channel, (B, C) per state padded to 16) and the recurrence reads only that,
// one or two vector loads a step. Each lane keeps one FMA chain per state;
// its exponentials depend on dt alone, so they are issued ahead of the
// chain. y_t is a partial sum per lane, reduced across the group in one of
// two ways (the plan's `reduce`): log2 G shuffles a step (RED_SHUFFLE, a
// decode step's one step); or G steps at a time, then a reduce-scatter that
// leaves each lane one step's sum after G - 1 shuffles (RED_SCATTER,
// prefill). y is stored a tile at a time, coalesced. Inputs whose rows are
// not 16-byte aligned (odd widths, N * elt not a multiple of 16) take the
// same loop with plain loads in the convert pass instead of the cp.async
// stages. The plan (G, channels per
// CTA, tile_t, reduction) is made on the host: scan_plan in
// kernels/ssm_scan/ops.py, whose shared-memory size this entry recomputes
// and refuses if it differs.
//
// No chunking over T: at jamba's prefill the dependent chain is 241 steps
// of one FMA per state, a few microseconds, under the exponential bound.
// expf, as the plain version's exp is the accurate one.
//
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W (PERF.md holds
// every run): jamba's prefill (1, 241, 8192, 16) about 0.030 ms with G = 4
// and 64-step tiles (G = 8 within 4%, G = 16 1.7x), 4x its 0.0076 ms
// exponential bound. Its time follows the instructions a lane issues (expf
// alone 9 per state), not the exponential units or shared memory:
// ex2.approx, 7 instructions fewer per state, took about 0.025 ms but is
// not the accurate exp; (B, C) staged as bf16 pairs, half the shared-memory
// bytes and 2 more instructions per state, read 7% slower; y's partials
// summed from shared memory after the tile were slower than both kept
// reductions (0.031-0.059 ms). A decode step (4, 1, 8192, 16) with G = 4
// about 0.0037 ms: the card's per-launch floor (about 0.0013 ms) plus its
// 0.0015 ms of bytes.

#include "hopper.cuh"

namespace {

using repro::bf16;

constexpr int STATES = 16;      // a channel's states, N padded with zeros
constexpr int MAX_THREADS = 128;  // per CTA; 8 CTAs of them fill an SM (64 registers a thread)
// how y's partial sums are reduced across a channel's G lanes
enum { RED_SHUFFLE = 0, RED_SCATTER = 1 };

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) & ~15; }

// Byte offsets into the dynamic shared memory (kernels/ssm_scan/ops.py
// mirrors this in smem_bytes): two raw stages (dt, u, B, C as they are in
// memory), then the fp32 tile ((dt, dt * u) per step and channel, (B, C) per
// step and state, padded to STATES), then y's staging (one sum per step and
// channel).
struct Layout {
  int raw_u, raw_b, raw_c, raw_stage;
  int f_xw, f_bc, f_y, total;
};

__host__ __device__ inline Layout layout(int tile_t, int ch, int n_s, int elt) {
  Layout L{};
  const int row = round16(tile_t * ch * elt), bc = round16(tile_t * n_s * elt);
  L.raw_u = row;
  L.raw_b = 2 * row;
  L.raw_c = 2 * row + bc;
  L.raw_stage = 2 * row + 2 * bc;
  int o = 2 * L.raw_stage;
  L.f_xw = o;
  o += round16(tile_t * ch * 8);
  L.f_bc = o;
  o += tile_t * STATES * 8;
  L.f_y = o;
  o += round16(tile_t * ch * 4);
  L.total = o;
  return L;
}

struct Args {
  const void* dt;
  const void* bc;
  const void* cc;
  const void* u;
  const float* A;
  const float* h0;
  void* y;
  float* h_out;
  int n_t, n_d, n_s;
  long long sbb, sbt, scb, sct;
  int tile_t;
};

// v[s] = row[n0 + s] for n0 + s < n_s, else 0: one vector access where the
// channel's row is all 16 states and aligned
template <int SPL>
__device__ __forceinline__ void load_states(float (&v)[SPL], const float* row, int n0, int n_s,
                                            bool live) {
  if (live && n_s == STATES && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    if constexpr (SPL == 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + n0);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else if constexpr (SPL == 2) {
      const float2 q = *reinterpret_cast<const float2*>(row + n0);
      v[0] = q.x, v[1] = q.y;
    } else {
      v[0] = row[n0];
    }
  } else {
#pragma unroll
    for (int s = 0; s < SPL; ++s) v[s] = live && n0 + s < n_s ? row[n0 + s] : 0.f;
  }
}

template <int SPL>
__device__ __forceinline__ void store_states(const float (&v)[SPL], float* row, int n0, int n_s,
                                             bool live) {
  if (!live) return;
  if (n_s == STATES && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    if constexpr (SPL == 4) {
      *reinterpret_cast<float4*>(row + n0) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (SPL == 2) {
      *reinterpret_cast<float2*>(row + n0) = make_float2(v[0], v[1]);
    } else {
      row[n0] = v[0];
    }
  } else {
#pragma unroll
    for (int s = 0; s < SPL; ++s)
      if (n0 + s < n_s) row[n0 + s] = v[s];
  }
}

// K fp32 values from shared memory (aligned to K * 4 bytes, at most 16)
template <int K>
__device__ __forceinline__ void load_smem(float (&v)[K], const float* p) {
  static_assert(K == 2 || K == 4 || K == 8, "2, 4 or 8 values");
#pragma unroll
  for (int j = 0; j < K; j += 4) {
    if constexpr (K == 2) {
      const float2 q = *reinterpret_cast<const float2*>(p);
      v[0] = q.x, v[1] = q.y;
    } else {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
    }
  }
}

// One step of a lane's SPL states from the fp32 tile: (dt, dt * u) of its
// channel and (B, C) of its states; returns its partial of y_t.
template <int SPL>
__device__ __forceinline__ float scan_step(float (&h)[SPL], const float (&av)[SPL], float2 xw,
                                           const float2* bc) {
  float bc2[2 * SPL];
  load_smem<2 * SPL>(bc2, reinterpret_cast<const float*>(bc));
  float p = 0.f;
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    h[s] = fmaf(expf(xw.x * av[s]), h[s], xw.y * bc2[2 * s]);
    p = fmaf(h[s], bc2[2 * s + 1], p);
  }
  return p;
}

template <typename T, int G, int RED, bool ASYNC>
__global__ void __launch_bounds__(MAX_THREADS, 8)
ssm_scan_kernel(const Args a) {
  constexpr int SPL = STATES / G;  // states per lane
  constexpr int ELT = sizeof(T);
  constexpr int PER = 16 / ELT;    // elements per 16-byte chunk
  constexpr int ch = MAX_THREADS / G, nthreads = MAX_THREADS;  // channels per CTA
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(a.tile_t, ch, a.n_s, ELT);
  float2* f_xw = reinterpret_cast<float2*>(smem + L.f_xw);  // (dt, dt * u) [step][channel]
  float2* f_bc = reinterpret_cast<float2*>(smem + L.f_bc);  // (B, C) [step][state]
  float* f_y = reinterpret_cast<float*>(smem + L.f_y);

  const T* dt = static_cast<const T*>(a.dt);
  const T* u = static_cast<const T*>(a.u);
  const int tid = threadIdx.x;
  const int c = tid / G, lane = tid % G, n0 = lane * SPL;
  const int b = blockIdx.y, d0 = blockIdx.x * ch, d = d0 + c;
  const bool live = d < a.n_d;
  const long long row0 = static_cast<long long>(b) * a.n_t;  // (b, t = 0) in dt, u and y
  const T* bc = static_cast<const T*>(a.bc) + b * a.sbb;
  const T* cc = static_cast<const T*>(a.cc) + b * a.scb;
  const int n_tiles = (a.n_t + a.tile_t - 1) / a.tile_t;

  // tile k's raw copies into stage k & 1 (the cp.async route)
  auto issue = [&](int k) {
    unsigned char* st = smem + (k & 1) * L.raw_stage;
    const int t0 = k * a.tile_t, steps = min(a.tile_t, a.n_t - t0);
    const int cpr = ch / PER, left = a.n_d - d0;  // chunks per row; channels left in D
    for (int i = tid; i < steps * cpr; i += nthreads) {
      const int tt = i / cpr, e = (i - tt * cpr) * PER;
      const int bytes = max(0, min(PER, left - e)) * ELT;  // zero-fills past D
      const long long off = bytes ? (row0 + t0 + tt) * a.n_d + d0 + e : 0;
      const int dst = (tt * ch + e) * ELT;
      repro::cp_async16(repro::smem_u32(st + dst), dt + off, bytes);
      repro::cp_async16(repro::smem_u32(st + L.raw_u + dst), u + off, bytes);
    }
    const int cpn = a.n_s / PER;  // chunks per row of B or C
    for (int i = tid; i < steps * cpn; i += nthreads) {
      const int tt = i / cpn, e = (i - tt * cpn) * PER;
      const int dst = (tt * a.n_s + e) * ELT;
      repro::cp_async16(repro::smem_u32(st + L.raw_b + dst), bc + (t0 + tt) * a.sbt + e, 16);
      repro::cp_async16(repro::smem_u32(st + L.raw_c + dst), cc + (t0 + tt) * a.sct + e, 16);
    }
    repro::cp_async_commit();
  };

  // tile k in fp32: (dt, dt * u), and (B, C) padded with zeros to STATES;
  // RED_SCATTER reduces G steps at once, so the rows up to the next
  // multiple of G are zeros: dt = 0 leaves h as it is, and their y is never
  // stored
  auto convert = [&](int k) {
    const unsigned char* st = smem + (k & 1) * L.raw_stage;
    const int t0 = k * a.tile_t, steps = min(a.tile_t, a.n_t - t0);
    const int rows = RED == RED_SCATTER ? (steps + G - 1) / G * G : steps;
    for (int i = tid; i < rows * ch; i += nthreads) {
      const int tt = i / ch, e = i - tt * ch;
      float x = 0.f, w = 0.f;
      if (tt < steps) {
        if constexpr (ASYNC) {
          x = repro::to_f32(reinterpret_cast<const T*>(st)[i]);
          w = repro::to_f32(reinterpret_cast<const T*>(st + L.raw_u)[i]);
        } else if (d0 + e < a.n_d) {
          const long long off = (row0 + t0 + tt) * a.n_d + d0 + e;
          x = repro::to_f32(dt[off]);
          w = repro::to_f32(u[off]);
        }
      }
      f_xw[i] = make_float2(x, x * w);
    }
    for (int i = tid; i < rows * STATES; i += nthreads) {
      const int tt = i / STATES, n = i - tt * STATES;
      float bv = 0.f, cv = 0.f;
      if (n < a.n_s && tt < steps) {
        if constexpr (ASYNC) {
          bv = repro::to_f32(reinterpret_cast<const T*>(st + L.raw_b)[tt * a.n_s + n]);
          cv = repro::to_f32(reinterpret_cast<const T*>(st + L.raw_c)[tt * a.n_s + n]);
        } else {
          bv = repro::to_f32(bc[(t0 + tt) * a.sbt + n]);
          cv = repro::to_f32(cc[(t0 + tt) * a.sct + n]);
        }
      }
      f_bc[i] = make_float2(bv, cv);
    }
  };

  // tile k's y from its staging, a row of channels at a time
  auto store = [&](int k) {
    const int t0 = k * a.tile_t, steps = min(a.tile_t, a.n_t - t0);
    T* y = static_cast<T*>(a.y);
    for (int i = tid; i < steps * ch; i += nthreads) {
      const int tt = i / ch, e = i - tt * ch;
      if (d0 + e < a.n_d) y[(row0 + t0 + tt) * a.n_d + d0 + e] = repro::from_f32<T>(f_y[i]);
    }
  };

  if constexpr (ASYNC) issue(0);  // first, so that A and h0 load under it
  float av[SPL], h[SPL];
  load_states<SPL>(av, a.A + static_cast<long long>(d) * a.n_s, n0, a.n_s, live);
  const long long hrow = (static_cast<long long>(b) * a.n_d + d) * a.n_s;
  if (a.h0 != nullptr) {
    load_states<SPL>(h, a.h0 + hrow, n0, a.n_s, live);
  } else {
#pragma unroll
    for (int s = 0; s < SPL; ++s) h[s] = 0.f;
  }

  for (int k = 0; k < n_tiles; ++k) {
    if constexpr (ASYNC) repro::cp_async_wait<0>();
    __syncthreads();  // tile k has landed; tile k - 1's recurrence is done
    if constexpr (ASYNC) {
      if (k + 1 < n_tiles) issue(k + 1);  // into the stage tile k - 1 was converted from
    }
    if (k > 0) store(k - 1);
    convert(k);
    __syncthreads();
    const int steps = min(a.tile_t, a.n_t - k * a.tile_t);
    if constexpr (RED == RED_SCATTER) {
      // G steps at a time, then a reduce-scatter across the group: each
      // round a lane keeps half its sums and sends the other half to its
      // partner, so after log2 G rounds (G - 1 shuffles) lane l holds step l's
      for (int tb = 0; tb < steps; tb += G) {
        float part[G];
#pragma unroll
        for (int j = 0; j < G; ++j)
          part[j] = scan_step<SPL>(h, av, f_xw[(tb + j) * ch + c],
                                        f_bc + (tb + j) * STATES + n0);
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) {
          const bool up = lane & o;
#pragma unroll
          for (int i = 0; i < o; ++i) {
            const float send = up ? part[i] : part[i + o];
            const float keep = up ? part[i + o] : part[i];
            part[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        }
        f_y[(tb + lane) * ch + c] = part[0];  // rows past `steps` are never stored
      }
    } else {
#pragma unroll 4
      for (int tt = 0; tt < steps; ++tt) {
        float p = scan_step<SPL>(h, av, f_xw[tt * ch + c], f_bc + tt * STATES + n0);
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
        if (lane == 0) f_y[tt * ch + c] = p;
      }
    }
  }
  if (n_tiles > 0) {
    __syncthreads();
    store(n_tiles - 1);
  }
  store_states<SPL>(h, a.h_out + hrow, n0, a.n_s, live);
}

template <typename T, int G, int RED, bool ASYNC>
int launch(const Args& a, int n_b, int smem, cudaStream_t stream) {
  auto kernel = ssm_scan_kernel<T, G, RED, ASYNC>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.n_d + MAX_THREADS / G - 1) / (MAX_THREADS / G), n_b);
  kernel<<<grid, MAX_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, int RED>
int by_route(const Args& a, int n_b, int smem, bool async_copy, cudaStream_t s) {
  return async_copy ? launch<T, G, RED, true>(a, n_b, smem, s)
                    : launch<T, G, RED, false>(a, n_b, smem, s);
}

template <typename T, int G>
int by_reduction(const Args& a, int n_b, int reduce, int smem, bool async_copy, cudaStream_t s) {
  return reduce == RED_SHUFFLE ? by_route<T, G, RED_SHUFFLE>(a, n_b, smem, async_copy, s)
                               : by_route<T, G, RED_SCATTER>(a, n_b, smem, async_copy, s);
}

template <typename T>
int by_group(const Args& a, int n_b, int group, int reduce, int smem, bool async_copy,
             cudaStream_t s) {
  if (group == 4) return by_reduction<T, 4>(a, n_b, reduce, smem, async_copy, s);
  if (group == 8) return by_reduction<T, 8>(a, n_b, reduce, smem, async_copy, s);
  return by_reduction<T, 16>(a, n_b, reduce, smem, async_copy, s);
}

}  // namespace

// dt, u, y: (B, T, D) contiguous; Bc, Cc: (B, T, N) with strides (sbb, sbt, 1)
// and (scb, sct, 1); A: (D, N) fp32 contiguous; h0 (null for zeros) and
// h_out: (B, D, N) fp32 contiguous; 1 <= N <= 16. The plan (group lanes per
// channel, channels per CTA, tile_t steps per tile, y's reduction RED_*,
// smem bytes) comes from scan_plan; async_copy says that dt, u, Bc and Cc
// have 16-byte aligned rows (the wrapper checks it).
extern "C" int ssm_scan_launch(int dtype, const void* dt, const void* Bc, const void* Cc,
                               const void* u, const void* A, const void* h0, void* y,
                               void* h_out, int n_b, int n_t, int n_d, int n_s, long long sbb,
                               long long sbt, long long scb, long long sct, int group,
                               int channels, int tile_t, int reduce, int async_copy, int smem,
                               void* stream) {
  const int elt = dtype == kBFloat16 ? 2 : dtype == kFloat32 ? 4 : 0;
  if (elt == 0 || n_s < 1 || n_s > STATES || n_b > 65535 || n_t < 0 || tile_t < 1 ||
      tile_t > 64 || (group != 4 && group != 8 && group != 16) ||
      channels * group != MAX_THREADS || (reduce != RED_SHUFFLE && reduce != RED_SCATTER) ||
      (reduce == RED_SCATTER && tile_t % group != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (async_copy && (channels * elt % 16 != 0 || n_s * elt % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (layout(tile_t, channels, n_s, elt).total != smem)
    return static_cast<int>(cudaErrorInvalidValue);  // the host's plan and this layout disagree
  if (n_b <= 0 || n_d <= 0) return 0;
  Args a{dt, Bc, Cc, u, static_cast<const float*>(A), static_cast<const float*>(h0), y,
         static_cast<float*>(h_out), n_t, n_d, n_s, sbb, sbt, scb, sct, tile_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return by_group<bf16>(a, n_b, group, reduce, smem, async_copy, s);
  return by_group<float>(a, n_b, group, reduce, smem, async_copy, s);
}
