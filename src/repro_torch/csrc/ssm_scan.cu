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
// For training the forward also writes, where the caller passes a states
// buffer, the fp32 state before every chunk of CHUNK = 16 steps (its own
// instantiations; serving passes null and runs the kernel without them).
// ssm_scan_backward_launch (below) restarts from them. It replaces no TPU
// kernel: the reference differentiates its two-level lax.scan, the state
// checkpointed every 128 steps and each chunk recomputed
// (src/repro/models/ssm.py:89-110). Chunks of 16 here, because a backward
// lane keeps a whole chunk's h_{t-1} and decays of its states in registers
// (2 x 16 x 16 / G values); the saved states are then 1/16 of all of them
// (134 MB a layer at jamba's 1 x 4096).
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
constexpr int CHUNK = 16;  // steps a saved state covers (kernels/ssm_scan/ops.py: CHUNK)
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
  float* states;  // null, or (B, ceil(T / CHUNK), D, N): h before every chunk's first step
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

// h before step t where t starts a chunk and the caller asked for the states
// (the backward restarts from them)
template <int SPL>
__device__ __forceinline__ void save_chunk_state(const float (&h)[SPL], const Args& a, int b,
                                                 int d, int n0, bool live, int n_chunks, int t) {
  if (t % CHUNK == 0)
    store_states<SPL>(h, a.states + ((static_cast<long long>(b) * n_chunks + t / CHUNK) *
                                     a.n_d + d) * a.n_s, n0, a.n_s, live);
}

// SAVE: the caller passed a states buffer (training); serving's instantiations
// have no trace of it (a runtime branch in the loop slowed them)
template <typename T, int G, int RED, bool ASYNC, bool SAVE>
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
  const int n_chunks = (a.n_t + CHUNK - 1) / CHUNK;

  for (int k = 0; k < n_tiles; ++k) {
    if constexpr (ASYNC) repro::cp_async_wait<0>();
    __syncthreads();  // tile k has landed; tile k - 1's recurrence is done
    if constexpr (ASYNC) {
      if (k + 1 < n_tiles) issue(k + 1);  // into the stage tile k - 1 was converted from
    }
    if (k > 0) store(k - 1);
    convert(k);
    __syncthreads();
    const int t0 = k * a.tile_t, steps = min(a.tile_t, a.n_t - t0);
    if constexpr (RED == RED_SCATTER) {
      // G steps at a time, then a reduce-scatter across the group: each
      // round a lane keeps half its sums and sends the other half to its
      // partner, so after log2 G rounds (G - 1 shuffles) lane l holds step l's
      for (int tb = 0; tb < steps; tb += G) {
        if constexpr (SAVE) save_chunk_state<SPL>(h, a, b, d, n0, live, n_chunks, t0 + tb);
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
        if constexpr (SAVE) save_chunk_state<SPL>(h, a, b, d, n0, live, n_chunks, t0 + tt);
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

template <typename T, int G, int RED, bool ASYNC, bool SAVE>
int launch(const Args& a, int n_b, int smem, cudaStream_t stream) {
  auto kernel = ssm_scan_kernel<T, G, RED, ASYNC, SAVE>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.n_d + MAX_THREADS / G - 1) / (MAX_THREADS / G), n_b);
  kernel<<<grid, MAX_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, int RED, bool SAVE>
int by_route(const Args& a, int n_b, int smem, bool async_copy, cudaStream_t s) {
  return async_copy ? launch<T, G, RED, true, SAVE>(a, n_b, smem, s)
                    : launch<T, G, RED, false, SAVE>(a, n_b, smem, s);
}

template <typename T, int G, int RED>
int by_save(const Args& a, int n_b, int smem, bool async_copy, cudaStream_t s) {
  return a.states != nullptr ? by_route<T, G, RED, true>(a, n_b, smem, async_copy, s)
                             : by_route<T, G, RED, false>(a, n_b, smem, async_copy, s);
}

template <typename T, int G>
int by_reduction(const Args& a, int n_b, int reduce, int smem, bool async_copy, cudaStream_t s) {
  return reduce == RED_SHUFFLE ? by_save<T, G, RED_SHUFFLE>(a, n_b, smem, async_copy, s)
                               : by_save<T, G, RED_SCATTER>(a, n_b, smem, async_copy, s);
}

template <typename T>
int by_group(const Args& a, int n_b, int group, int reduce, int smem, bool async_copy,
             cudaStream_t s) {
  if (group == 4) return by_reduction<T, 4>(a, n_b, reduce, smem, async_copy, s);
  if (group == 8) return by_reduction<T, 8>(a, n_b, reduce, smem, async_copy, s);
  return by_reduction<T, 16>(a, n_b, reduce, smem, async_copy, s);
}

// ---------------------------------------------------------------------------
// The backward. For a_t = exp(dt_t A) and g_t the gradient reaching h_t,
// g_t = C_t dy_t + a_{t+1} g_{t+1} from g_T = dh_final, and
//
//   ddt_t = sum_n g_t (A a_t h_{t-1} + u_t B_t)   du_t = dt_t sum_n g_t B_t
//   dB_t  = sum_d g_t dt_t u_t                     dC_t = sum_d h_t dy_t
//   dA    = sum_{b,t} g_t dt_t a_t h_{t-1}         dh0 = a_0 g_0
//
// Bound: 22 fp32 operations per (t, d, n) and one exponential (the decays
// are kept for the walk back); at jamba's (1, 4096, 8192, 16) bf16 the
// operations (0.1763 ms on an NVIDIA H100 80GB HBM3 at 700.00 W) lie just
// above the bytes (0.1409 ms) and the exponentials (0.1284 ms), so the
// instructions a lane issues per (t, d, n) set the time.
//
// Design. A CTA holds BWD_CH = 32 channels of one batch row, BWD_G = 8
// lanes a channel, SPL = 2 states a lane, and walks the chunks of CHUNK
// steps from the last, g and dA in registers throughout:
//  - the chunk lives in registers: from the state the forward saved at its
//    start, each lane recomputes a_t h_{t-1} and a_t of its states for all
//    CHUNK steps (the loop unrolled), then walks them back; nothing per
//    (t, d, n) goes through shared memory;
//  - the inputs are staged ahead: chunk k - 3's dt, u, dy, B and C are
//    copied by cp.async (a ring of three stages) and chunk k - 1's converted
//    to an fp32 tile ((dt, dt u, u, dy) per step and channel, B and C per
//    step and state) while chunk k walks; rows off 16 bytes are read by
//    plain loads in the conversion instead;
//  - ddt and du are sums over a channel's lanes: G steps at a time, then a
//    reduce-scatter (G - 1 shuffles) leaves lane l step l's sums;
//  - dB and dC are sums over channels: each step a reduce-scatter over the
//    warp's 32 / G channels (2 SPL values a lane, one left), then the CTA's
//    warps' sums added in warp order through shared memory: one fp32 partial
//    per CTA and step, which ssm_scan_bwd_reduce adds in order (dA's batch
//    rows too);
//  - one barrier a chunk: chunk k + 1's ddt, du and dB / dC sums go out in
//    rounds spread over chunk k's steps, their latency under the walk's
//    arithmetic; every buffer they touch is double (the ring triple), so
//    none is overwritten before every thread has read it.
// No atomics and every sum in a fixed order: two calls are bit-equal. The
// plan (shared memory, partials) is made on the host: bwd_plan in
// kernels/ssm_scan/ops.py, whose layout this entry recomputes and refuses
// if it differs.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md
// holds every run and the times): at jamba's training shape the
// shared-memory design before this one took 1.9566 ms. With the phase work
// between two barriers a chunk, the SM idled through it; spread over the
// walk's steps, the dB / dC sums last (the walk holds fewest registers at
// its end), it hides. Each instance takes the 128 registers that two CTAs
// an SM leave it and spills a few bytes (chip_smoke.py's build phase prints
// ptxas's count); variants that spilled less were not faster. Measured and
// not kept: 4 lanes a channel, fewer instructions per state but 243-253
// registers and so 8 warps an SM; the CTAs' dB / dC sums added over a
// thread-block cluster through distributed shared memory, whose barrier
// compiles to a GPU-scope fence and an L1 invalidation and whose clusters
// of 4 or 8 do not all fit at once beside two CTAs an SM.

constexpr int BWD_CH = 32;            // channels per CTA (ops.py: BWD_CHANNELS)
constexpr int BWD_G = 8;              // lanes per channel (ops.py: BWD_GROUP)
constexpr int BWD_STEPS = CHUNK;      // steps a lane keeps in registers: one saved chunk
constexpr int BWD_VALS = 2 * STATES;  // a step's dB, then its dC, per state
// planted faults (ops.py: BWD_FAULTS), compiled into instances of their own
// that only chip_smoke.py's gate launches: g not carried into one chunk; the
// last warp's dB / dC share left out of the CTA's sum
enum { FAULT_NONE = 0, FAULT_G_DROPPED = 1, FAULT_WARP_DROPPED = 2 };

// Byte offsets of the backward's shared memory (ops.py: bwd_smem_bytes), two
// of each (chunks k and k + 1): the fp32 tile ((dt, dt u, u, dy) per step and
// channel, B and C per step and state), (ddt, du) per step and channel, each
// warp's dB / dC sums per step; then a ring of three raw stages of dt, u,
// dy, B and C as they lie in memory (raw_* are offsets inside a stage)
struct BwdLayout {
  int x, bc, out, red, raw, raw_stage, raw_u, raw_dy, raw_b, raw_c, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int n_s, int elt) {
  BwdLayout L{};
  int o = 0;
  L.x = o;
  o += 2 * BWD_STEPS * BWD_CH * 16;
  L.bc = o;
  o += 2 * BWD_STEPS * STATES * 8;  // B, then C: [step][state] each
  L.out = o;
  o += 2 * BWD_STEPS * BWD_CH * 8;
  L.red = o;
  o += 2 * BWD_G * BWD_STEPS * BWD_VALS * 4;
  const int row = round16(BWD_STEPS * BWD_CH * elt), bcr = round16(BWD_STEPS * n_s * elt);
  L.raw_u = row;
  L.raw_dy = 2 * row;
  L.raw_b = 3 * row;
  L.raw_c = 3 * row + bcr;
  L.raw_stage = 3 * row + 2 * bcr;
  L.raw = o;
  L.total = o + 3 * L.raw_stage;
  return L;
}

struct BwdArgs {
  const void* dt;
  const void* bc;
  const void* cc;
  const void* u;
  const void* dy;
  const float* A;
  const float* states;    // (B, ceil(T / CHUNK), D, N) from the forward
  const float* dh_final;  // (B, D, N) or null
  void* ddt;
  void* du;
  void* dbc;  // (B, T, N) contiguous
  void* dcc;
  float* dA;
  float* dh0;
  float* part_b;  // (n_part, B, T, N): each CTA's share of dB
  float* part_c;
  float* part_a;  // (B, D, N): each batch row's share of dA
  int n_b, n_t, n_d, n_s, n_part;
  long long sbb, sbt, scb, sct;
};

template <typename T, bool ASYNC, int FAULT>
__global__ void __launch_bounds__(BWD_CH * BWD_G, 2)
ssm_scan_bwd_kernel(const BwdArgs a) {
  constexpr int G = BWD_G;
  constexpr int SPL = STATES / G;  // states per lane
  constexpr int P = 32 / G;        // channels per warp
  constexpr int NT = BWD_CH * G;   // threads: G warps
  constexpr int R = BWD_STEPS;
  constexpr int NV = R * BWD_VALS;  // a chunk's dB and dC sums
  constexpr int NX = R * BWD_CH;    // a chunk's (step, channel) entries
  constexpr int ELT = sizeof(T), PER = 16 / ELT;
  constexpr int CPR = BWD_CH / PER;  // 16-byte copies per row of dt, u or dy
  static_assert(P == 2 * SPL, "the scatter over a warp's channels leaves one value a lane");
  static_assert(R % G == 0, "ddt and du are reduce-scattered G steps at a time");
  static_assert(NV % NT == 0 && NX % NT == 0 && R * CPR <= NT, "whole rounds of the phase work");
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L = bwd_layout(a.n_s, ELT);
  // each [chunk & 1] first
  float4* s_x = reinterpret_cast<float4*>(smem + L.x);    // (dt, dt u, u, dy) [step][channel]
  float* s_bc = reinterpret_cast<float*>(smem + L.bc);    // B, then C [step][state]
  float2* s_out = reinterpret_cast<float2*>(smem + L.out);  // (ddt, du) [step][channel]
  float* s_red = reinterpret_cast<float*>(smem + L.red);  // [warp][step][value]

  const T* dt = static_cast<const T*>(a.dt);
  const T* u = static_cast<const T*>(a.u);
  const T* dy = static_cast<const T*>(a.dy);
  const int tid = threadIdx.x, warp = tid / 32;
  const int cw = (tid % 32) / G, lane = tid % G, n0 = lane * SPL;
  const int c = warp * P + cw;  // this lane's channel in the CTA
  const int b = blockIdx.y, d0 = blockIdx.x * BWD_CH, d = d0 + c;
  const bool live = d < a.n_d;
  const long long row0 = static_cast<long long>(b) * a.n_t;
  const T* bc = static_cast<const T*>(a.bc) + b * a.sbb;
  const T* cc = static_cast<const T*>(a.cc) + b * a.scb;
  const long long hrow = (static_cast<long long>(b) * a.n_d + d) * a.n_s;
  const int n_chunks = (a.n_t + R - 1) / R;
  const long long n_tn = static_cast<long long>(a.n_t) * a.n_s;
  const long long part_row = (static_cast<long long>(blockIdx.x) * a.n_b + b) * n_tn;

  // This thread's raw copies, fixed across chunks: row piece (xt, xe) of dt,
  // u and dy (zeros past D), and piece (bt, be) of B and C. Every call
  // commits a group, empty where k < 0, so that a wait counts the same
  // groups on every path.
  const int xt = tid / CPR, xe = (tid % CPR) * PER;
  const int x_bytes = max(0, min(PER, a.n_d - d0 - xe)) * ELT;
  const long long x_src = x_bytes ? (row0 + xt) * a.n_d + d0 + xe : 0;
  const int cpn = a.n_s / PER;  // 16-byte copies per row of B or C (1, 2 or 4)
  const int bt = cpn ? tid / cpn : 0, be = cpn ? (tid - bt * cpn) * PER : 0;
  auto issue = [&](int k) {
    if (k >= 0) {
      unsigned char* raw = smem + L.raw + (k % 3) * L.raw_stage;
      const int t0 = k * R, steps = min(R, a.n_t - t0);
      if (tid < R * CPR && xt < steps) {
        const long long off = x_bytes ? x_src + static_cast<long long>(t0) * a.n_d : 0;
        const int dst = (xt * BWD_CH + xe) * ELT;
        repro::cp_async16(repro::smem_u32(raw + dst), dt + off, x_bytes);
        repro::cp_async16(repro::smem_u32(raw + L.raw_u + dst), u + off, x_bytes);
        repro::cp_async16(repro::smem_u32(raw + L.raw_dy + dst), dy + off, x_bytes);
      }
      if (tid < steps * cpn) {
        const int dst = (bt * a.n_s + be) * ELT;
        repro::cp_async16(repro::smem_u32(raw + L.raw_b + dst), bc + (t0 + bt) * a.sbt + be, 16);
        repro::cp_async16(repro::smem_u32(raw + L.raw_c + dst), cc + (t0 + bt) * a.sct + be, 16);
      }
    }
    repro::cp_async_commit();
  };

  // The phase work of iteration k, in rounds a thread takes one at a time:
  // chunk k + 1's ddt and du out; chunk k - 1's fp32 tile from its raw
  // copies (zeros past T, D and N: their terms vanish, dt = 0 leaving h and
  // g as they are); chunk k + 1's dB / dC, its warps' sums added in warp
  // order and stored as this CTA's partial (last: the walk's registers are
  // fewest at its end). None of it touches a buffer chunk k's walk reads or
  // writes.
  constexpr int W_OUT = NX / NT, W_CV = NX / NT, W_BC = (R * STATES + NT - 1) / NT;
  constexpr int W_TILE = W_CV + W_BC, W_SUM = NV / NT;
  constexpr int W_ALL = W_OUT + W_TILE + W_SUM;
  auto phase = [&](int k, int w) {
    if (w < W_OUT) {  // chunk k + 1's ddt and du
      const int kf = k + 1, i = tid + w * NT, tt = i / BWD_CH, e = i - tt * BWD_CH;
      if (kf < 0 || kf >= n_chunks || kf * R + tt >= a.n_t || d0 + e >= a.n_d) return;
      const float2 o = s_out[(kf & 1) * NX + i];
      const long long off = (row0 + kf * R + tt) * a.n_d + d0 + e;
      static_cast<T*>(a.ddt)[off] = repro::from_f32<T>(o.x);
      static_cast<T*>(a.du)[off] = repro::from_f32<T>(o.y);
      return;
    }
    w -= W_OUT;
    if (w >= W_TILE) {  // chunk k + 1's dB / dC over the warps
      const int kf = k + 1, v = tid + (w - W_TILE) * NT;
      const int tt = v / BWD_VALS, slot = v - tt * BWD_VALS, n = slot % STATES;
      if (kf < 0 || kf >= n_chunks || kf * R + tt >= a.n_t || n >= a.n_s) return;
      const float* red = s_red + (kf & 1) * G * NV + v;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < (FAULT == FAULT_WARP_DROPPED ? G - 1 : G); ++q) s += red[q * NV];
      (slot < STATES ? a.part_b : a.part_c)[part_row + (kf * R + tt) * a.n_s + n] = s;
      return;
    }
    const int kc = k - 1;  // chunk k - 1's tile
    if (kc < 0) return;
    const unsigned char* raw = smem + L.raw + (kc % 3) * L.raw_stage;
    const int t0 = kc * R, steps = min(R, a.n_t - t0);
    if (w < W_CV) {
      const int i = tid + w * NT, tt = i / BWD_CH, e = i - tt * BWD_CH;
      float x = 0.f, v = 0.f, gy = 0.f;
      if (tt < steps) {
        if constexpr (ASYNC) {
          x = repro::to_f32(reinterpret_cast<const T*>(raw)[i]);
          v = repro::to_f32(reinterpret_cast<const T*>(raw + L.raw_u)[i]);
          gy = repro::to_f32(reinterpret_cast<const T*>(raw + L.raw_dy)[i]);
        } else if (d0 + e < a.n_d) {
          const long long off = (row0 + t0 + tt) * a.n_d + d0 + e;
          x = repro::to_f32(dt[off]);
          v = repro::to_f32(u[off]);
          gy = repro::to_f32(dy[off]);
        }
      }
      s_x[(kc & 1) * NX + i] = make_float4(x, x * v, v, gy);
      return;
    }
    const int i = tid + (w - W_CV) * NT, tt = i / STATES, n = i - tt * STATES;
    if (i >= R * STATES) return;
    float bv = 0.f, cv = 0.f;
    if (tt < steps && n < a.n_s) {
      if constexpr (ASYNC) {
        bv = repro::to_f32(reinterpret_cast<const T*>(raw + L.raw_b)[tt * a.n_s + n]);
        cv = repro::to_f32(reinterpret_cast<const T*>(raw + L.raw_c)[tt * a.n_s + n]);
      } else {
        bv = repro::to_f32(bc[(t0 + tt) * a.sbt + n]);
        cv = repro::to_f32(cc[(t0 + tt) * a.sct + n]);
      }
    }
    float* b_k = s_bc + (kc & 1) * 2 * R * STATES;
    b_k[i] = bv;
    b_k[R * STATES + i] = cv;
  };

  float av[SPL], g[SPL], dA[SPL], hs[SPL];  // hs: the saved state of the next chunk to walk
  load_states<SPL>(av, a.A + static_cast<long long>(d) * a.n_s, n0, a.n_s, live);
  if (a.dh_final != nullptr) {
    load_states<SPL>(g, a.dh_final + hrow, n0, a.n_s, live);
  } else {
#pragma unroll
    for (int s = 0; s < SPL; ++s) g[s] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < SPL; ++s) dA[s] = 0.f;
  auto load_state = [&](int k) {
    load_states<SPL>(hs, a.states + ((static_cast<long long>(b) * n_chunks + k) * a.n_d + d) *
                     a.n_s, n0, a.n_s, live);
  };
  if (n_chunks > 0) load_state(n_chunks - 1);

  // The pipeline: while chunk k walks, chunk k + 1's sums go out, chunk
  // k - 1 is converted and chunk k - 3 copied, that work spread over the
  // walk's steps; one barrier a chunk. Every buffer is double (the tile, the
  // warps' sums, (ddt, du)) or, for the raw copies, a ring of three, so that
  // nothing is overwritten before every thread has read it.
  if constexpr (ASYNC) {
    issue(n_chunks - 1);
    issue(n_chunks - 2);
    repro::cp_async_wait<1>();
  }
  __syncthreads();
#pragma unroll
  for (int w = W_OUT; w < W_OUT + W_TILE; ++w) phase(n_chunks, w);  // chunk n - 1's tile
  if constexpr (ASYNC) {
    issue(n_chunks - 3);
    repro::cp_async_wait<1>();
  }
  __syncthreads();
  for (int k = n_chunks - 1; k >= -1; --k) {
    if (k >= 0) {
      // chunk k forward again from its saved state: a_t h_{t-1} and a_t per step
      const float4* x_k = s_x + (k & 1) * NX;
      const float* b_k = s_bc + (k & 1) * 2 * R * STATES;
      const float* c_k = b_k + R * STATES;
      float h[SPL], ah[R][SPL], ea[R][SPL];
#pragma unroll
      for (int s = 0; s < SPL; ++s) h[s] = hs[s];
      if (k > 0) load_state(k - 1);  // in flight while chunk k walks
      if constexpr (ASYNC) issue(k - 3);
      if constexpr (FAULT == FAULT_G_DROPPED) {
        if (k == (n_chunks - 1) / 2 && k + 1 < n_chunks) {
#pragma unroll
          for (int s = 0; s < SPL; ++s) g[s] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float2 x = reinterpret_cast<const float2*>(x_k + j * BWD_CH + c)[0];  // dt, dt u
        float bv[SPL];
        load_smem<SPL>(bv, b_k + j * STATES + n0);
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          ea[j][s] = expf(x.x * av[s]);
          ah[j][s] = ea[j][s] * h[s];
          h[s] = fmaf(x.y, bv[s], ah[j][s]);
        }
      }

      // and back: g from h_t to h_{t-1}, each step's terms
      float* red = s_red + (k & 1) * G * NV + warp * NV;
      float2* out = s_out + (k & 1) * NX;
#pragma unroll
      for (int jb = R / G - 1; jb >= 0; --jb) {
        float pd[G], pg[G];  // per step: sum_n A g a h and sum_n g B of this lane's states
#pragma unroll
        for (int jj = G - 1; jj >= 0; --jj) {
          const int j = jb * G + jj;
          const float4 x = x_k[j * BWD_CH + c];
          float bv[SPL], cv[SPL], v[P];
          load_smem<SPL>(bv, b_k + j * STATES + n0);
          load_smem<SPL>(cv, c_k + j * STATES + n0);
          const float xwdy = x.y * x.w;
          float pdt = 0.f, pgb = 0.f;
#pragma unroll
          for (int s = 0; s < SPL; ++s) {
            g[s] = fmaf(cv[s], x.w, g[s]);  // g_t
            const float q = g[s] * ah[j][s];
            dA[s] = fmaf(q, x.x, dA[s]);
            pdt = fmaf(av[s], q, pdt);
            pgb = fmaf(g[s], bv[s], pgb);
            v[s] = g[s] * x.y;                                 // dB's term, g dt u
            v[SPL + s] = fmaf(xwdy, bv[s], ah[j][s] * x.w);  // dC's term, h_t dy
            g[s] *= ea[j][s];                                  // a_t g_t, toward step t - 1
          }
          pd[jj] = pdt;
          pg[jj] = pgb;
          // over the warp's P channels: each round a lane keeps half its values
          // and sends the other half to its partner; lane cw ends with value cw
#pragma unroll
          for (int o = P / 2; o > 0; o >>= 1) {
            const bool up = cw & o;
#pragma unroll
            for (int i = 0; i < o; ++i) {
              const float send = up ? v[i] : v[i + o];
              const float keep = up ? v[i + o] : v[i];
              v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o * G);
            }
          }
          red[j * BWD_VALS + (cw < SPL ? 0 : STATES - SPL) + n0 + cw] = v[0];
          // this step's share of the phase work, its latency under the walk's
          const int step = R - 1 - j;
#pragma unroll
          for (int w = step * W_ALL / R; w < (step + 1) * W_ALL / R; ++w) phase(k, w);
        }
        // over the channel's G lanes, the same way: lane l ends with step jb G + l
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) {
          const bool up = lane & o;
#pragma unroll
          for (int i = 0; i < o; ++i) {
            const float sd = up ? pd[i] : pd[i + o], kd = up ? pd[i + o] : pd[i];
            const float sg = up ? pg[i] : pg[i + o], kg = up ? pg[i + o] : pg[i];
            pd[i] = kd + __shfl_xor_sync(0xffffffffu, sd, o);
            pg[i] = kg + __shfl_xor_sync(0xffffffffu, sg, o);
          }
        }
        const int j = jb * G + lane;
        const float4 x = x_k[j * BWD_CH + c];
        out[j * BWD_CH + c] = make_float2(fmaf(x.z, pg[0], pd[0]), x.x * pg[0]);  // ddt, du
      }
    } else {
      if constexpr (ASYNC) issue(k - 3);  // an empty group
#pragma unroll
      for (int w = 0; w < W_ALL; ++w) phase(k, w);
    }
    if constexpr (ASYNC) repro::cp_async_wait<1>();  // chunk k - 2 landed, k - 3 in flight
    __syncthreads();
  }
  store_states<SPL>(dA, a.part_a + hrow, n0, a.n_s, live);
  store_states<SPL>(g, a.dh0 + hrow, n0, a.n_s, live);
}

// dB and dC: the CTAs' partials summed in order; dA: the batch rows' shares
template <typename T>
__global__ void ssm_scan_bwd_reduce(const BwdArgs a) {
  const long long n_btn = static_cast<long long>(a.n_b) * a.n_t * a.n_s;
  const long long n_dn = static_cast<long long>(a.n_d) * a.n_s;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n_btn + n_dn; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < n_btn) {
      float sb = 0.f, sc = 0.f;
      for (int x = 0; x < a.n_part; ++x) {
        sb += a.part_b[x * n_btn + i];
        sc += a.part_c[x * n_btn + i];
      }
      static_cast<T*>(a.dbc)[i] = repro::from_f32<T>(sb);
      static_cast<T*>(a.dcc)[i] = repro::from_f32<T>(sc);
    } else {
      const long long j = i - n_btn;
      float s = 0.f;
      for (int x = 0; x < a.n_b; ++x) s += a.part_a[x * n_dn + j];
      a.dA[j] = s;
    }
  }
}

template <typename T, bool ASYNC, int FAULT>
int launch_bwd(const BwdArgs& a, int smem, cudaStream_t stream) {
  auto kernel = ssm_scan_bwd_kernel<T, ASYNC, FAULT>;
  const cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.n_part, a.n_b), BWD_CH * BWD_G, smem, stream>>>(a);
  const long long total = static_cast<long long>(a.n_b) * a.n_t * a.n_s +
                          static_cast<long long>(a.n_d) * a.n_s;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  ssm_scan_bwd_reduce<T><<<blocks, 256, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dt, u, y: (B, T, D) contiguous; Bc, Cc: (B, T, N) with strides (sbb, sbt, 1)
// and (scb, sct, 1); A: (D, N) fp32 contiguous; h0 (null for zeros) and
// h_out: (B, D, N) fp32 contiguous; 1 <= N <= 16. The plan (group lanes per
// channel, channels per CTA, tile_t steps per tile, y's reduction RED_*,
// smem bytes) comes from scan_plan; async_copy says that dt, u, Bc and Cc
// have 16-byte aligned rows (the wrapper checks it). states, when not null,
// takes (B, ceil(T / 16), D, N) fp32 contiguous: the state before every step
// t with t % 16 == 0 (a chunk is a whole number of any group's steps).
extern "C" int ssm_scan_launch(int dtype, const void* dt, const void* Bc, const void* Cc,
                               const void* u, const void* A, const void* h0, void* y,
                               void* h_out, int n_b, int n_t, int n_d, int n_s, long long sbb,
                               long long sbt, long long scb, long long sct, int group,
                               int channels, int tile_t, int reduce, int async_copy, int smem,
                               void* states, void* stream) {
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
         static_cast<float*>(h_out), static_cast<float*>(states), n_t, n_d, n_s, sbb, sbt, scb,
         sct, tile_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return by_group<bf16>(a, n_b, group, reduce, smem, async_copy, s);
  return by_group<float>(a, n_b, group, reduce, smem, async_copy, s);
}

// The backward of ssm_scan_launch. dt, u, dy, ddt, du: (B, T, D) contiguous
// in the input dtype; Bc, Cc read as the forward reads them; dBc, dCc: (B,
// T, N) contiguous in the input dtype; A, dA: (D, N) fp32; states: (B,
// ceil(T / 16), D, N) fp32 from the forward (chunk 16); dh_final (null for
// zeros) and dh0: (B, D, N) fp32; part_b, part_c: (n_part, B, T, N) fp32 and
// part_a (B, D, N) fp32, scratch. The plan (n_part CTAs along D, smem bytes)
// comes from ops.py's bwd_plan; async_copy says that dt, u, dy, Bc and Cc
// have 16-byte aligned rows (the wrapper checks it); fault is FAULT_NONE
// but in chip_smoke.py's planted faults, which run bf16 with async_copy
// only. Two launches: the walk, then the sums over CTAs.
extern "C" int ssm_scan_backward_launch(int dtype, const void* dt, const void* Bc,
                                        const void* Cc, const void* u, const void* dy,
                                        const void* A, const void* states, const void* dh_final,
                                        void* ddt, void* du, void* dBc, void* dCc, void* dA,
                                        void* dh0, void* part_b, void* part_c, void* part_a,
                                        int n_b, int n_t, int n_d, int n_s, long long sbb,
                                        long long sbt, long long scb, long long sct, int n_part,
                                        int async_copy, int smem, int fault, void* stream) {
  const int elt = dtype == kBFloat16 ? 2 : dtype == kFloat32 ? 4 : 0;
  if (elt == 0 || n_s < 1 || n_s > STATES || n_b > 65535 || n_t < 0 || fault < FAULT_NONE ||
      fault > FAULT_WARP_DROPPED || (fault != FAULT_NONE && (elt != 2 || !async_copy)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (async_copy && (n_d * elt % 16 != 0 || n_s * elt % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  // the host's plan and this layout disagree
  if (bwd_layout(n_s, elt).total != smem || n_part != (n_d + BWD_CH - 1) / BWD_CH)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_b <= 0 || n_d <= 0) return 0;
  BwdArgs a{dt, Bc, Cc, u, dy, static_cast<const float*>(A), static_cast<const float*>(states),
            static_cast<const float*>(dh_final), ddt, du, dBc, dCc, static_cast<float*>(dA),
            static_cast<float*>(dh0), static_cast<float*>(part_b), static_cast<float*>(part_c),
            static_cast<float*>(part_a), n_b, n_t, n_d, n_s, n_part, sbb, sbt, scb, sct};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fault == FAULT_G_DROPPED) return launch_bwd<bf16, true, FAULT_G_DROPPED>(a, smem, s);
  if (fault == FAULT_WARP_DROPPED) return launch_bwd<bf16, true, FAULT_WARP_DROPPED>(a, smem, s);
  if (dtype == kBFloat16)
    return async_copy ? launch_bwd<bf16, true, FAULT_NONE>(a, smem, s)
                      : launch_bwd<bf16, false, FAULT_NONE>(a, smem, s);
  return async_copy ? launch_bwd<float, true, FAULT_NONE>(a, smem, s)
                    : launch_bwd<float, false, FAULT_NONE>(a, smem, s);
}
