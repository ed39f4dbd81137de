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
// instantiations; serving passes null and runs the kernel without them). ssm_scan_backward_launch
// (below) restarts from them. It replaces no TPU kernel: the reference
// differentiates its two-level lax.scan, the state checkpointed every 128
// steps and each chunk recomputed (src/repro/models/ssm.py:89-110). Chunks
// of 16 here, because the backward holds a chunk's h_{t-1} and decays in
// shared memory (16 steps x 32 channels x 16 states x 8 bytes, 64 KB at G
// = 4); the saved states are then 1/16 of all of them (134 MB a layer at
// jamba's 1 x 4096). Its bound is that of the forward: one exponential per
// (t, d, n), the decays kept for the walk back, over the bytes of dt, u and
// dy in, ddt and du out and the saved states.
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
// A CTA holds the forward's channels and lanes (G lanes a channel, SPL
// states a lane, g carried in registers) and walks the chunks of CHUNK steps
// from the last: it stages the chunk's inputs in fp32, recomputes the chunk's
// h_{t-1} and a_t into shared memory from the state the forward saved at the
// chunk's start (one exponential per state and step, as the forward), then
// walks the chunk back. ddt and du are one sum over a channel's lanes
// (shuffles); dA stays in registers until the end. The walk overwrites each
// step's h_{t-1} and a_t, once read, with that step's dB and dC terms, and a
// pass over the chunk sums them over the CTA's channels, in order, into
// per-CTA partials; a second kernel sums the partials over the CTAs (and dA
// over the batch rows) in order: deterministic, no atomics.

// Byte offsets of the backward's shared memory (ops.py: bwd_smem_bytes):
// h_{t-1} and a_t per step, channel and state (then the dB and dC terms);
// (dt, dt u, u, dy) per step and channel; (B, C) per step and state; (ddt,
// du) per step and channel
struct BwdLayout {
  int h, a, x, bc, g, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int ch) {
  BwdLayout L{};
  L.h = 0;
  L.a = L.h + CHUNK * ch * STATES * 4;
  L.x = L.a + CHUNK * ch * STATES * 4;
  L.bc = L.x + CHUNK * ch * 16;
  L.g = L.bc + CHUNK * STATES * 8;
  L.total = L.g + CHUNK * ch * 8;
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
  float* part_b;  // (ceil(D / ch), B, T, N): each CTA's share of dB
  float* part_c;
  float* part_a;  // (B, D, N): each batch row's share of dA
  int n_b, n_t, n_d, n_s;
  long long sbb, sbt, scb, sct;
};

// K fp32 values to or from shared memory (aligned to K * 4 bytes)
template <int K>
__device__ __forceinline__ void lds(float (&v)[K], const float* p) {
  if constexpr (K == 1) {
    v[0] = p[0];
  } else {
    load_smem<K>(v, p);
  }
}

template <int K>
__device__ __forceinline__ void sts(float* p, const float (&v)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(MAX_THREADS)
ssm_scan_bwd_kernel(const BwdArgs a) {
  constexpr int SPL = STATES / G;
  constexpr int ch = MAX_THREADS / G;
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L = bwd_layout(ch);
  float* s_h = reinterpret_cast<float*>(smem + L.h);      // [step][channel][state]
  float* s_a = reinterpret_cast<float*>(smem + L.a);      // [step][channel][state]
  float4* s_x = reinterpret_cast<float4*>(smem + L.x);    // (dt, dt u, u, dy) [step][channel]
  float2* s_bc = reinterpret_cast<float2*>(smem + L.bc);  // (B, C) [step][state]
  float2* s_g = reinterpret_cast<float2*>(smem + L.g);    // (ddt, du) [step][channel]

  const T* dt = static_cast<const T*>(a.dt);
  const T* u = static_cast<const T*>(a.u);
  const T* dy = static_cast<const T*>(a.dy);
  const int tid = threadIdx.x;
  const int c = tid / G, lane = tid % G, n0 = lane * SPL;
  const int b = blockIdx.y, d0 = blockIdx.x * ch, d = d0 + c;
  const bool live = d < a.n_d;
  const long long row0 = static_cast<long long>(b) * a.n_t;
  const T* bc = static_cast<const T*>(a.bc) + b * a.sbb;
  const T* cc = static_cast<const T*>(a.cc) + b * a.scb;
  const long long hrow = (static_cast<long long>(b) * a.n_d + d) * a.n_s;
  const int n_chunks = (a.n_t + CHUNK - 1) / CHUNK;
  const int slot = c * STATES + n0;  // this lane's states in a step's row

  float av[SPL], g[SPL], dA[SPL];
  load_states<SPL>(av, a.A + static_cast<long long>(d) * a.n_s, n0, a.n_s, live);
  if (a.dh_final != nullptr) {
    load_states<SPL>(g, a.dh_final + hrow, n0, a.n_s, live);
  } else {
#pragma unroll
    for (int s = 0; s < SPL; ++s) g[s] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < SPL; ++s) dA[s] = 0.f;

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * CHUNK, steps = min(CHUNK, a.n_t - t0);
    __syncthreads();  // the later chunk's terms are summed
    for (int i = tid; i < steps * ch; i += MAX_THREADS) {
      const int j = i / ch, e = i - j * ch;
      float x = 0.f, w = 0.f, gy = 0.f;  // zeros past D: their terms are zeros
      if (d0 + e < a.n_d) {
        const long long off = (row0 + t0 + j) * a.n_d + d0 + e;
        x = repro::to_f32(dt[off]);
        w = repro::to_f32(u[off]);
        gy = repro::to_f32(dy[off]);
      }
      s_x[i] = make_float4(x, x * w, w, gy);
    }
    for (int i = tid; i < steps * STATES; i += MAX_THREADS) {
      const int j = i / STATES, n = i - j * STATES;
      float bv = 0.f, cv = 0.f;
      if (n < a.n_s) {
        bv = repro::to_f32(bc[(t0 + j) * a.sbt + n]);
        cv = repro::to_f32(cc[(t0 + j) * a.sct + n]);
      }
      s_bc[i] = make_float2(bv, cv);
    }
    __syncthreads();

    // the chunk forward again from its saved state: h_{t-1} and a_t per step
    float h[SPL];
    load_states<SPL>(h, a.states + ((static_cast<long long>(b) * n_chunks + k) * a.n_d + d) *
                     a.n_s, n0, a.n_s, live);
    for (int j = 0; j < steps; ++j) {
      const float4 xv = s_x[j * ch + c];
      float bcv[2 * SPL], e[SPL];
      load_smem<2 * SPL>(bcv, reinterpret_cast<const float*>(s_bc + j * STATES + n0));
#pragma unroll
      for (int s = 0; s < SPL; ++s) e[s] = expf(xv.x * av[s]);
      sts<SPL>(s_h + j * ch * STATES + slot, h);
      sts<SPL>(s_a + j * ch * STATES + slot, e);
#pragma unroll
      for (int s = 0; s < SPL; ++s) h[s] = fmaf(e[s], h[s], xv.y * bcv[2 * s]);
    }

    // and back: g from h_t to h_{t-1}, each step's terms
    for (int j = steps - 1; j >= 0; --j) {
      const float4 xv = s_x[j * ch + c];
      float bcv[2 * SPL], hp[SPL], e[SPL], wb[SPL], wc[SPL];
      load_smem<2 * SPL>(bcv, reinterpret_cast<const float*>(s_bc + j * STATES + n0));
      lds<SPL>(hp, s_h + j * ch * STATES + slot);
      lds<SPL>(e, s_a + j * ch * STATES + slot);
      float pdt = 0.f, pdu = 0.f;
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        const float bs = bcv[2 * s], cs = bcv[2 * s + 1];
        g[s] = fmaf(cs, xv.w, g[s]);  // g_t
        const float ah = e[s] * hp[s];  // a_t h_{t-1}
        pdt = fmaf(g[s], fmaf(av[s], ah, xv.z * bs), pdt);
        pdu = fmaf(g[s], bs, pdu);
        dA[s] = fmaf(g[s], xv.x * ah, dA[s]);
        wb[s] = g[s] * xv.y;               // dB's term, g dt u
        wc[s] = fmaf(xv.y, bs, ah) * xv.w;  // dC's term, h_t dy
        g[s] *= e[s];                      // a_t g_t, toward step t - 1
      }
      sts<SPL>(s_h + j * ch * STATES + slot, wb);  // h_{t-1}, a_t no longer needed
      sts<SPL>(s_a + j * ch * STATES + slot, wc);
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        pdt += __shfl_xor_sync(0xffffffffu, pdt, o);
        pdu += __shfl_xor_sync(0xffffffffu, pdu, o);
      }
      if (lane == 0) s_g[j * ch + c] = make_float2(pdt, xv.x * pdu);
    }
    __syncthreads();

    // ddt and du out, a row of channels at a time
    T* ddt = static_cast<T*>(a.ddt);
    T* du = static_cast<T*>(a.du);
    for (int i = tid; i < steps * ch; i += MAX_THREADS) {
      const int j = i / ch, e = i - j * ch;
      if (d0 + e < a.n_d) {
        const long long off = (row0 + t0 + j) * a.n_d + d0 + e;
        ddt[off] = repro::from_f32<T>(s_g[i].x);
        du[off] = repro::from_f32<T>(s_g[i].y);
      }
    }
    // this CTA's share of dB and dC: its channels summed in order
    for (int i = tid; i < steps * a.n_s; i += MAX_THREADS) {
      const int j = i / a.n_s, n = i - j * a.n_s;
      float sb = 0.f, sc = 0.f;
      for (int e = 0; e < ch; ++e) {
        sb += s_h[(j * ch + e) * STATES + n];
        sc += s_a[(j * ch + e) * STATES + n];
      }
      const long long o =
          ((static_cast<long long>(blockIdx.x) * a.n_b + b) * a.n_t + t0 + j) * a.n_s + n;
      a.part_b[o] = sb;
      a.part_c[o] = sc;
    }
  }
  store_states<SPL>(dA, a.part_a + hrow, n0, a.n_s, live);
  store_states<SPL>(g, a.dh0 + hrow, n0, a.n_s, live);
}

// dB and dC: the CTAs' partials summed in order; dA: the batch rows' shares
template <typename T>
__global__ void ssm_scan_bwd_reduce(const BwdArgs a, int n_cx) {
  const long long n_btn = static_cast<long long>(a.n_b) * a.n_t * a.n_s;
  const long long n_dn = static_cast<long long>(a.n_d) * a.n_s;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n_btn + n_dn; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < n_btn) {
      float sb = 0.f, sc = 0.f;
      for (int x = 0; x < n_cx; ++x) {
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

template <typename T, int G>
int launch_bwd(const BwdArgs& a, int smem, cudaStream_t stream) {
  constexpr int ch = MAX_THREADS / G;
  auto kernel = ssm_scan_bwd_kernel<T, G>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_cx = (a.n_d + ch - 1) / ch;
  kernel<<<dim3(n_cx, a.n_b), MAX_THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(a.n_b) * a.n_t * a.n_s +
                          static_cast<long long>(a.n_d) * a.n_s;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  ssm_scan_bwd_reduce<T><<<blocks, 256, 0, stream>>>(a, n_cx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_by_group(const BwdArgs& a, int group, int smem, cudaStream_t s) {
  if (group == 4) return launch_bwd<T, 4>(a, smem, s);
  if (group == 8) return launch_bwd<T, 8>(a, smem, s);
  return launch_bwd<T, 16>(a, smem, s);
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
// zeros) and dh0: (B, D, N) fp32; part_b, part_c: (ceil(D / channels), B, T,
// N) fp32 and part_a (B, D, N) fp32, scratch. group and channels as the
// forward's plan; smem from ops.py's bwd_smem_bytes. Two launches: the walk,
// then the sums over CTAs.
extern "C" int ssm_scan_backward_launch(int dtype, const void* dt, const void* Bc,
                                        const void* Cc, const void* u, const void* dy,
                                        const void* A, const void* states, const void* dh_final,
                                        void* ddt, void* du, void* dBc, void* dCc, void* dA,
                                        void* dh0, void* part_b, void* part_c, void* part_a,
                                        int n_b, int n_t, int n_d, int n_s, long long sbb,
                                        long long sbt, long long scb, long long sct, int group,
                                        int channels, int smem, void* stream) {
  const int elt = dtype == kBFloat16 ? 2 : dtype == kFloat32 ? 4 : 0;
  if (elt == 0 || n_s < 1 || n_s > STATES || n_b > 65535 || n_t < 0 ||
      (group != 4 && group != 8 && group != 16) || channels * group != MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bwd_layout(channels).total != smem)
    return static_cast<int>(cudaErrorInvalidValue);  // the host's plan and this layout disagree
  if (n_b <= 0 || n_d <= 0) return 0;
  BwdArgs a{dt, Bc, Cc, u, dy, static_cast<const float*>(A), static_cast<const float*>(states),
            static_cast<const float*>(dh_final), ddt, du, dBc, dCc, static_cast<float*>(dA),
            static_cast<float*>(dh0), static_cast<float*>(part_b), static_cast<float*>(part_c),
            static_cast<float*>(part_a), n_b, n_t, n_d, n_s, sbb, sbt, scb, sct};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return bwd_by_group<bf16>(a, group, smem, s);
  return bwd_by_group<float>(a, group, smem, s);
}
