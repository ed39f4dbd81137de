// GQA decode attention for Hopper: one new query token per sequence against
// the KV cache, keys 0..pos visible (one scalar pos for the whole batch),
// optional gemma2 soft-capping.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py
// decode_attention_kernel / decode_attention_pallas (its pallas_call at :131).
//
// Bound on the card: bytes. Every visible cache entry is read once and used
// for the G query heads of its kv head only, about G operations per byte,
// far below what the tensor cores need: 0.38 us for 4 slots of StarCoder2 at
// pos 300, 1.27 us at pos 1023. What is left to win is latency: enough
// bytes in flight on every SM, and a short chain of dependent steps.
//
// Design (split-KV on the tensor cores, then a merge pass):
// - The keys [0, n_valid) are split into nsplit runs of `chunk` keys per
//   (b, kv head) by the wrapper's split_plan (kernels/decode_attention/ops.py),
//   sized so that B * K * nsplit covers the card's SMs; one CTA per
//   (b * K + kv head, split). Only runs that hold keys <= pos exist, so the
//   bytes read grow with pos, not with the cache's capacity.
// - bf16: the CTA's four warps each take 16 keys of every 64-key sub-tile.
//   K and V arrive as bf16 through cp.async 16-byte copies into a two-stage
//   ring (no fp32 staging); keys past the run are zero-filled. The G query
//   heads of the kv head, padded to 16 rows, are mma.sync A fragments loaded
//   once; S = Q K^T is m16n8k16 with K through ldmatrix; scale, softcap and
//   the mask are applied in registers with an online softmax per row; P is
//   rounded to bf16 in registers (the plain version's rounding point,
//   ref.py: p.to(v.dtype)) and O += P V is m16n8k16 with V through
//   ldmatrix.trans. The warps merge their (max, sum, O) in shared memory.
//   G > 16 loops over 16-row tiles.
// - float32 keeps CUDA-core arithmetic (a TF32 product would miss the 1e-5
//   float32 tolerance): the same split plan and merge, one thread per
//   (head, key) score and per (head, dim) output over 32-key sub-tiles.
// - Merge, a second launch: with more than one run a CTA writes its run's
//   (max, sum, unnormalised O) to the wrapper's scratch, and pass 2 (one
//   block per (b, query head), groups of hd / 4 threads each merging a
//   slice of up to 16 runs, then one group merging the slices) merges them
//   with the log-sum-exp rescale, its loads all independent. Pass 2 is a
//   programmatic dependent launch: pass 1 lets it start at once and it waits
//   at griddepcontrol.wait, so its launch hides behind pass 1. With one run
//   the CTA writes the output directly and pass 2 does not run. A fused
//   merge (the last CTA of each (b, kv head), found by an atomic ticket,
//   merging its pair's runs) measured slower on the H100: 8.8-9.0 us at pos
//   300 and 13.7 us at pos 1023 against 6.7 and 8.9 us for two plain
//   launches (StarCoder2, 4 slots, CUDA-graph replay; PERF.md), since 8 CTAs
//   then read every partial while 124 SMs idle, behind a fence and an atomic.
// What the design it replaces lost time to: K and V converted to fp32 in
// shared memory (75 KB per block); scalar dot products, one thread per
// (head, key) over hd from shared memory, two shared loads per FMA; a fixed
// 64-key chunk (40 blocks on 132 SMs at pos 300); a merge pass whose
// threads walked the runs twice, one dependent load at a time.
// Registers and shared memory per CTA (ptxas -v, sm_90a, CUDA 12.9): the
// bf16 split pass at hd 128, 162 registers, no spills, 73,984 bytes of
// dynamic shared memory (Q 4,352, two 64-key stages of K and V 69,632; the
// warps' merge reuses the stages); at hd 256, 254 registers with 72 bytes
// of spills; the fp32 split pass 60-64 registers, (2 G hd + 64 (hd + 4) +
// 35 G) floats; the merge pass 133 registers and 16 KB of static shared
// memory for its slices.
//
// The kernel reads the model's (B, S, K, hd) cache through strides: the
// Pallas wrapper's swap to (B, K, S, hd) is not needed.

#include "hopper.cuh"

namespace {

using repro::bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int SUB = 16 * kWarps;  // keys per bf16 sub-tile (16 per warp)
constexpr int SUB32 = 32;         // keys per fp32 sub-tile
constexpr int NST = 2;            // stages of the bf16 K/V ring

struct CacheStrides {
  long long b, s, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* o_part;  // (B, H, nsplit, hd)
  float* m_part;  // (B, H, nsplit)
  float* l_part;
  int H, G, n_valid, chunk;
  long long q_sb, q_sh;
  CacheStrides ks, vs;
  float scale, softcap;
};

template <typename T>
__device__ __forceinline__ void store4(T* out, float4 v, float scale) {
  out[0] = repro::from_f32<T>(v.x * scale);
  out[1] = repro::from_f32<T>(v.y * scale);
  out[2] = repro::from_f32<T>(v.z * scale);
  out[3] = repro::from_f32<T>(v.w * scale);
}

// Row (b, h) of run `split` is done: its max M, sum L and unnormalised
// O[d .. d + 3]. With one run it is the output; else a partial.
template <typename T>
__device__ __forceinline__ void emit4(const Args& a, long long bh, int split, int nsplit, int hd,
                                      int d, float4 O, float M, float L) {
  if (nsplit == 1) {
    store4(static_cast<T*>(a.out) + bh * hd + d, O, 1.f / fmaxf(L, 1e-30f));
    return;
  }
  const long long slot = bh * nsplit + split;
  *reinterpret_cast<float4*>(a.o_part + slot * hd + d) = O;
  if (d == 0) {
    a.m_part[slot] = M;
    a.l_part[slot] = L;
  }
}

constexpr int CB = 16;         // runs a merge thread loads at once
constexpr int MAX_SLICES = 8;  // run slices per row in the merge pass

// A row's running merge: max, sum and unnormalised O of 4 dims.
struct Merged {
  float M, L;
  float4 O;
};

// Merge runs [s0, s1) of row bh, dims d .. d + 3: one pass with an online
// log-sum-exp rescale, the runs' max, sum and O loaded CB at a time with
// every load independent of the others.
__device__ Merged merge_runs(const Args& a, long long bh, int nsplit, int hd, int d, int s0,
                             int s1) {
  const float* m = a.m_part + bh * nsplit;
  const float* l = a.l_part + bh * nsplit;
  const float4* o = reinterpret_cast<const float4*>(a.o_part + bh * nsplit * hd + d);
  Merged r{-INFINITY, 0.f, make_float4(0.f, 0.f, 0.f, 0.f)};
  for (int c0 = s0; c0 < s1; c0 += CB) {
    float mv[CB], lv[CB];
    float4 ov[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j) {  // past the slice: reload its last run, weighted 0 below
      const int s = min(c0 + j, s1 - 1);
      mv[j] = __ldcg(m + s);
      lv[j] = __ldcg(l + s);
      ov[j] = __ldcg(o + static_cast<long long>(s) * (hd / 4));
    }
    float Mn = r.M;
#pragma unroll
    for (int j = 0; j < CB; ++j)
      if (c0 + j < s1) Mn = fmaxf(Mn, mv[j]);
    const float f = expf(r.M - Mn);  // 0 before the first run
    r.L *= f;
    r.O.x *= f;
    r.O.y *= f;
    r.O.z *= f;
    r.O.w *= f;
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      const float w = c0 + j < s1 ? expf(mv[j] - Mn) : 0.f;
      r.L += lv[j] * w;
      r.O.x += w * ov[j].x;
      r.O.y += w * ov[j].y;
      r.O.z += w * ov[j].z;
      r.O.w += w * ov[j].w;
    }
    r.M = Mn;
  }
  return r;
}

// Pass 2: grid B * H; per row, `slices` groups of hd / 4 threads, each
// group merging a slice of at most CB runs (more only past MAX_SLICES
// slices), then group 0 merges the slices and writes the output. It waits
// for pass 1 at griddepcontrol.wait, so it can be launched (programmatic
// dependent launch) while pass 1 still runs.
template <typename T>
__global__ void decode_merge_kernel(const Args a, int nsplit, int hd, int slices) {
  __shared__ Merged part[MAX_SLICES][64];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int t4 = hd / 4, slice = threadIdx.x / t4, i = threadIdx.x % t4;
  const int per = (nsplit + slices - 1) / slices;
  const int s0 = slice * per, s1 = min(nsplit, s0 + per);
  const long long bh = blockIdx.x;
  Merged r = s0 < s1 ? merge_runs(a, bh, nsplit, hd, 4 * i, s0, s1)
                     : Merged{-INFINITY, 0.f, make_float4(0.f, 0.f, 0.f, 0.f)};
  if (slices > 1) {
    part[slice][i] = r;
    __syncthreads();
    if (slice != 0) return;
    float M = r.M;
    for (int w = 1; w < slices; ++w) M = fmaxf(M, part[w][i].M);
    const float f = expf(r.M - M);
    r = Merged{M, r.L * f, make_float4(r.O.x * f, r.O.y * f, r.O.z * f, r.O.w * f)};
    for (int w = 1; w < slices; ++w) {
      const Merged& q = part[w][i];
      const float g = expf(q.M - M);  // 0 for an empty slice
      r.L += q.L * g;
      r.O.x += q.O.x * g;
      r.O.y += q.O.y * g;
      r.O.z += q.O.z * g;
      r.O.w += q.O.w * g;
    }
  }
  store4(static_cast<T*>(a.out) + bh * hd + 4 * i, r.O, 1.f / fmaxf(r.L, 1e-30f));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores

template <int HD>
struct Bf16Smem {
  static constexpr int LD = HD + 8;  // bf16 row stride: ldmatrix rows on distinct banks
  static constexpr int Q = 16 * LD * 2;
  static constexpr int STAGE = SUB * LD * 2;  // one K or V sub-tile
  static constexpr int RING = 2 * NST * STAGE;
  // per warp: O rows, max, sum; then per row the warps' weights, max, sum
  static constexpr int MERGE = (kWarps * 16 * (HD + 2) + 16 * (kWarps + 2)) * 4;
  static constexpr int BODY = RING > MERGE ? RING : MERGE;
};

template <int HD>
__device__ __forceinline__ void load_subtile(uint32_t sk, uint32_t sv, const Args& a, int b,
                                             int kvh, int j0, int j1) {
  using L = Bf16Smem<HD>;
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  for (int idx = threadIdx.x; idx < SUB * CH; idx += kThreads) {
    const int r = idx / CH, c = idx % CH;
    const int key = j0 + r;
    const bool ok = key < j1;
    const long long kr = ok ? key : j0;  // a valid address; zero-filled when !ok
    const uint32_t off = (r * L::LD + c * 8) * 2;
    repro::cp_async16(sk + off, k + b * a.ks.b + kr * a.ks.s + kvh * a.ks.h + c * 8, ok ? 16 : 0);
    repro::cp_async16(sv + off, v + b * a.vs.b + kr * a.vs.s + kvh * a.vs.h + c * 8, ok ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_bf16_kernel(const Args a) {
  using L = Bf16Smem<HD>;
  using namespace repro;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem);
  unsigned char* body = smem + L::Q;
  const uint32_t sRing = smem_u32(body);
  float* merge = reinterpret_cast<float*>(body);

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // pass 2 may start
  const int K = a.H / a.G;
  const int b = blockIdx.x / K, kvh = blockIdx.x % K;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int j0 = split * a.chunk, j1 = min(j0 + a.chunk, a.n_valid);  // j0 < j1
  const int nsub = (j1 - j0 + SUB - 1) / SUB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane / 4, qd = lane % 4;
  const bf16* q = static_cast<const bf16*>(a.q);

  for (int m0 = 0; m0 < a.G; m0 += 16) {  // 16-row tiles of the kv head's query heads
    const int rows = min(16, a.G - m0);
    for (int idx = threadIdx.x; idx < 16 * (HD / 8); idx += kThreads) {  // rows >= G: zeros
      const int r = idx / (HD / 8), c = idx % (HD / 8);
      const int head = kvh * a.G + m0 + (r < rows ? r : 0);
      cp_async16(sQ + (r * L::LD + c * 8) * 2, q + b * a.q_sb + head * a.q_sh + c * 8,
                 r < rows ? 16 : 0);
    }
    cp_async_commit();
    load_subtile<HD>(sRing, sRing + L::STAGE, a, b, kvh, j0, j1);
    cp_async_commit();
    cp_async_wait<1>();  // Q is in; the first sub-tile may still be landing
    __syncthreads();
    uint32_t qa[HD / 16][4];  // Q as m16n8k16 A fragments, loaded once
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int mi = lane / 8;
      ldmatrix_x4(qa[kk], sQ + (((mi & 1) * 8 + lane % 8) * L::LD + kk * 16 + (mi >> 1) * 8) * 2);
    }

    float o[HD / 8][4];
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

    for (int t = 0; t < nsub; ++t) {
      if (t + 1 < nsub) {
        const uint32_t nxt = sRing + ((t + 1) % NST) * 2 * L::STAGE;
        load_subtile<HD>(nxt, nxt + L::STAGE, a, b, kvh, j0 + (t + 1) * SUB, j1);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const uint32_t sk = sRing + (t % NST) * 2 * L::STAGE, sv = sk + L::STAGE;
      const int key0 = j0 + t * SUB + warp * 16;
      if (key0 < j1) {
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t kb[4];  // b0, b1 of keys 0-7, then of keys 8-15
          const int mi = lane / 8;
          ldmatrix_x4(kb, sk + ((warp * 16 + (mi >> 1) * 8 + lane % 8) * L::LD + kk * 16 +
                                (mi & 1) * 8) * 2);
          mma_bf16(s[0], qa[kk], kb[0], kb[1]);
          mma_bf16(s[1], qa[kk], kb[2], kb[3]);
        }
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x = s[nb][i] * a.scale;
            if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
            const int key = key0 + nb * 8 + 2 * qd + (i & 1);
            x = key < j1 ? x : -INFINITY;
            s[nb][i] = x;
            if (i & 2) mx_b = fmaxf(mx_b, x); else mx_a = fmaxf(mx_a, x);
          }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        // key0 < j1, so every row has a finite score in this sub-tile
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        l_a *= al_a;  // per-thread partial sums; the quad adds them at the end
        l_b *= al_b;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float e = expf(s[nb][i] - ((i & 2) ? mn_b : mn_a));
            s[nb][i] = e;
            if (i & 2) l_b += e; else l_a += e;
          }
        const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
        for (int nb = 0; nb < HD / 8; ++nb) {
          o[nb][0] *= al_a;
          o[nb][1] *= al_a;
          o[nb][2] *= al_b;
          o[nb][3] *= al_b;
        }
#pragma unroll
        for (int db = 0; db < HD / 16; ++db) {
          uint32_t vb[4];  // b0, b1 of dims 0-7, then of dims 8-15
          const int mi = lane / 8;
          ldmatrix_x4_trans(vb, sv + ((warp * 16 + (mi & 1) * 8 + lane % 8) * L::LD + db * 16 +
                                      (mi >> 1) * 8) * 2);
          mma_bf16(o[2 * db], pa, vb[0], vb[1]);
          mma_bf16(o[2 * db + 1], pa, vb[2], vb[3]);
        }
      }
      __syncthreads();  // the stage is free for the load two sub-tiles on
    }
    cp_async_wait<0>();

    // merge the four warps: per warp 16 rows of O, then max and sum
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    float* mw = merge + warp * 16 * (HD + 2);
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      const int d = nb * 8 + 2 * qd;
      mw[g4 * HD + d] = o[nb][0];
      mw[g4 * HD + d + 1] = o[nb][1];
      mw[(g4 + 8) * HD + d] = o[nb][2];
      mw[(g4 + 8) * HD + d + 1] = o[nb][3];
    }
    if (qd == 0) {
      mw[16 * HD + g4] = m_a;
      mw[16 * HD + g4 + 8] = m_b;
      mw[16 * HD + 16 + g4] = l_a;
      mw[16 * HD + 16 + g4 + 8] = l_b;
    }
    __syncthreads();
    float* wrow = merge + kWarps * 16 * (HD + 2);  // per row: each warp's weight, max, sum
    if (threadIdx.x < rows) {
      const int r = threadIdx.x;
      float M = -INFINITY, Lsum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, merge[w * 16 * (HD + 2) + 16 * HD + r]);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* mw2 = merge + w * 16 * (HD + 2);
        const float e = expf(mw2[16 * HD + r] - M);  // 0 for a warp that saw no key
        wrow[r * (kWarps + 2) + w] = e;
        Lsum += mw2[16 * HD + 16 + r] * e;
      }
      wrow[r * (kWarps + 2) + kWarps] = M;
      wrow[r * (kWarps + 2) + kWarps + 1] = Lsum;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * (HD / 4); idx += kThreads) {
      const int r = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
      const float* wr = wrow + r * (kWarps + 2);
      float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(merge + w * 16 * (HD + 2) + r * HD + d);
        O.x += wr[w] * x.x;
        O.y += wr[w] * x.y;
        O.z += wr[w] * x.z;
        O.w += wr[w] * x.w;
      }
      const long long bh = static_cast<long long>(b) * a.H + kvh * a.G + m0 + r;
      emit4<bf16>(a, bh, split, nsplit, HD, d, O, wr[kWarps], wr[kWarps + 1]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores

template <int HD>
struct F32Smem {
  static constexpr int LD = HD + 4;  // fp32 row stride (16-byte rows for cp.async)
  static long long bytes(int G) {
    return 4LL * (2LL * G * HD + 2LL * SUB32 * LD + G * SUB32 + 3LL * G);
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_f32_kernel(const Args a) {
  using L = F32Smem<HD>;
  using namespace repro;
  extern __shared__ __align__(16) float fsm[];
  const int G = a.G, K = a.H / G;
  float* sq = fsm;                   // (G, HD)
  float* acc = sq + G * HD;          // (G, HD)
  float* sk = acc + G * HD;          // (SUB32, LD)
  float* sv = sk + SUB32 * L::LD;    // (SUB32, LD)
  float* ss = sv + SUB32 * L::LD;    // (G, SUB32) scores, then probabilities
  float* sm = ss + G * SUB32;        // (G) running max, sum, rescale
  float* sl = sm + G;
  float* sa = sl + G;

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // pass 2 may start
  const int b = blockIdx.x / K, kvh = blockIdx.x % K;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int j0 = split * a.chunk, j1 = min(j0 + a.chunk, a.n_valid);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);

  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    sq[idx] = q[b * a.q_sb + (kvh * G + g) * a.q_sh + d];
    acc[idx] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    sm[g] = -INFINITY;
    sl[g] = 0.f;
  }
  for (int t0 = j0; t0 < j1; t0 += SUB32) {
    const int n = min(SUB32, j1 - t0);
    __syncthreads();  // the previous sub-tile is consumed
    constexpr int CH = HD / 4;
    for (int idx = threadIdx.x; idx < n * CH; idx += kThreads) {
      const int r = idx / CH, c = idx % CH;
      const long long key = t0 + r;
      cp_async16(smem_u32(sk + r * L::LD + c * 4), k + b * a.ks.b + key * a.ks.s + kvh * a.ks.h + c * 4, 16);
      cp_async16(smem_u32(sv + r * L::LD + c * 4), v + b * a.vs.b + key * a.vs.s + kvh * a.vs.h + c * 4, 16);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int idx = threadIdx.x; idx < G * SUB32; idx += kThreads) {
      const int g = idx / SUB32, j = idx % SUB32;
      float x = -INFINITY;
      if (j < n) {
        const float* qg = sq + g * HD;
        const float* kj = sk + j * L::LD;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot += qg[d] * kj[d];
        x = dot * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      }
      ss[idx] = x;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {  // one lane per key of the sub-tile
      const float x = ss[g * SUB32 + lane];
      const float m_new = fmaxf(sm[g], warp_max(x));  // finite: n >= 1
      const float e = lane < n ? expf(x - m_new) : 0.f;
      ss[g * SUB32 + lane] = e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float alpha = expf(sm[g] - m_new);
        sa[g] = alpha;
        sl[g] = sl[g] * alpha + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
      const int g = idx / HD, d = idx % HD;
      const float* pg = ss + g * SUB32;
      float o = acc[idx] * sa[g];
      for (int j = 0; j < n; ++j) o += pg[j] * sv[j * L::LD + d];
      acc[idx] = o;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * (HD / 4); idx += kThreads) {
    const int g = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
    emit4<float>(a, static_cast<long long>(b) * a.H + kvh * G + g, split, nsplit, HD, d,
                 *reinterpret_cast<const float4*>(acc + g * HD + d), sm[g], sl[g]);
  }
}

template <int HD>
int launch(int dtype, const Args& a, int B, int nsplit, cudaStream_t stream) {
  const int K = a.H / a.G;
  const dim3 grid(B * K, nsplit);
  cudaError_t err;
  if (dtype == kBFloat16) {
    using L = Bf16Smem<HD>;
    const size_t smem = L::Q + L::BODY;
    if ((err = repro::allow_smem(decode_bf16_kernel<HD>, smem)) != cudaSuccess)
      return static_cast<int>(err);
    decode_bf16_kernel<HD><<<grid, kThreads, smem, stream>>>(a);
  } else {
    using L = F32Smem<HD>;
    const size_t smem = static_cast<size_t>(L::bytes(a.G));
    if ((err = repro::allow_smem(decode_f32_kernel<HD>, smem)) != cudaSuccess)
      return static_cast<int>(err);
    decode_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(a);
  }
  if (nsplit > 1) {  // pass 2 merges the runs, launched while pass 1 runs
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int slices = nsplit > CB * MAX_SLICES ? MAX_SLICES : (nsplit + CB - 1) / CB;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * a.H);
    cfg.blockDim = dim3(HD / 4 * slices);
    cfg.stream = stream;
    cudaLaunchAttribute pdl[1];
    pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    pdl[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = pdl;
    cfg.numAttrs = 1;
    err = dtype == kBFloat16
              ? cudaLaunchKernelEx(&cfg, decode_merge_kernel<bf16>, a, nsplit, HD, slices)
              : cudaLaunchKernelEx(&cfg, decode_merge_kernel<float>, a, nsplit, HD, slices);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, H, hd) with strides q_sb, q_sh; k/v: (B, S, K, hd) caches with strides
// (b, s, k); out: (B, H, hd) contiguous. Keys 0..n_valid-1 are attended, in
// nsplit runs of `chunk` keys per (b, kv head) (the last one shorter). With
// nsplit > 1, scratch holds B * H * nsplit * (hd + 2) floats (the partial
// outputs, then the maxima, then the sums) and a second launch merges them.
extern "C" int decode_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                       void* out, void* scratch, int B, int H,
                                       int K, int n_valid, int chunk, int nsplit, int hd,
                                       long long q_sb, long long q_sh, long long k_sb,
                                       long long k_ss, long long k_sh, long long v_sb,
                                       long long v_ss, long long v_sh, float scale,
                                       float softcap, void* stream) {
  if (B <= 0 || n_valid <= 0 || chunk <= 0 || nsplit != (n_valid + chunk - 1) / chunk ||
      (dtype != kBFloat16 && dtype != kFloat32) || (nsplit > 1 && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * H * nsplit;
  float* o_part = static_cast<float*>(scratch);
  Args a{q, k, v, out, o_part, o_part ? o_part + rows * hd : nullptr,
         o_part ? o_part + rows * (hd + 1) : nullptr, H, H / K,
         n_valid, chunk, q_sb, q_sh, CacheStrides{k_sb, k_ss, k_sh},
         CacheStrides{v_sb, v_ss, v_sh}, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE_CASE(D) \
  case D:                    \
    return launch<D>(dtype, a, B, nsplit, s);
  switch (hd) {
    REPRO_DECODE_CASE(16)
    REPRO_DECODE_CASE(32)
    REPRO_DECODE_CASE(64)
    REPRO_DECODE_CASE(128)
    REPRO_DECODE_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE_CASE
}
