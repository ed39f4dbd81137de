// Flash attention (prefill) for Hopper: online-softmax GQA attention with
// causal and sliding-window masks and gemma2 score soft-capping.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py
// flash_attention_kernel / flash_attention_pallas (its pallas_call at :147).
//
// Bound on the card: operations at long sequences (4 * Sq * Skv * hd per head,
// halved by the causal mask, on the bf16 tensor cores: 6.5 us for one
// 1024-token StarCoder2 prompt), bytes at short ones (q, k, v and the output
// each touched once: 1.0 us at 256 tokens).
//
// Design (warp-specialised, wgmma + TMA):
// - One CTA per (q-head, 128-row query tile, b), taken by two consumer
//   warpgroups of 64 rows each; the grid is (H, tiles, B) with the tile
//   index reversed, so the heaviest causal tiles of every head launch first
//   and the light ones fill the tail. (64-row tiles on one warpgroup, two
//   CTAs per SM, spill the overlapped schedule below at 128 registers and
//   measured slower: PERF.md.)
// - A producer warp issues TMA loads: the Q tile once, then K and V tiles of
//   64 keys (32 at hd 256) into a two-stage ring. Each tile arrives on its
//   own mbarrier (K and V apart, so S = Q K^T starts before V lands); the
//   consumers free a stage on a third barrier. The producer warpgroup gives
//   up its registers (setmaxnreg 40) to the consumers (232).
// - Tensor maps are rank 4 over (hd, heads, S, B) with the tensors' own
//   strides, encoded per call on the host, so strided views (head slices of
//   one fused projection) load as they are. Rows are hd * 2 bytes: swizzle
//   32, 64 or 128 B; at hd >= 128 a tile is hd / 64 boxes of 64 columns,
//   which is wgmma's K-major 128-byte layout. TMA zero-fills rows past Sq
//   and Skv; the mask still sets keys >= Skv to -inf.
// - S = Q K^T is wgmma m64n64k16 with both operands in shared memory and
//   the fp32 accumulator in registers. Scale, softcap, mask and the online
//   softmax run on those registers (row max and sum over the quad of lanes
//   that share a row); the mask is evaluated only on tiles that cross the
//   diagonal, the window edge or the ragged end, and kv tiles wholly outside
//   the CTA's causal band or window are never loaded.
// - The two products overlap within the warpgroup: S(t) = Q K(t)^T is issued
//   before O += P(t-1) V(t-1), and the softmax of S(t) runs on the CUDA cores
//   while the tensor cores do that P V (one extra S in registers).
// - O += P V is wgmma with P as the A operand from registers, rounded to
//   bf16 as the plain version rounds p (ref.py: p.to(v.dtype)), and V read
//   from shared memory as the transposed (N-major) B operand. O stays in
//   registers for the whole kv sweep and is rescaled there.
// - Epilogue: O / max(l, 1e-30) in bf16 goes to the warpgroup's own rows of
//   the Q tile in shared memory (swizzled as TMA reads it) and leaves by a
//   TMA store, which clips rows >= Sq. Given an lse buffer (training), it also
//   writes each row's log-sum-exp, (m + log2 l) ln 2, for the backward; the
//   output's bits do not depend on it.
// What the WMMA design it replaces lost time to, and what this does about it:
// synchronous staging between block barriers (now TMA into a ring, loads in
// flight while the tensor cores work); scores, probabilities and the output
// accumulator round-tripping through shared memory (now registers); Ampere
// WMMA fed from padded tiles (now wgmma on swizzled tiles); 113 KB of shared
// memory per block at hd 128 (now 97 KB for twice the rows); the heaviest
// causal tiles launched last (now first).
// Registers and shared memory per CTA (ptxas -v, sm_90a, CUDA 12.9): 168
// registers per thread at 384 threads, no spills at hd <= 128 (128 bytes at
// hd 256); 99,384 bytes of dynamic shared memory at hd 128 (Q 32 KB, two
// stages of K and V 64 KB, barriers, 1 KB of alignment slack), 132,152 at
// hd 256.
//
// The second C entry, flash_attention_backward_launch, is the backward (below,
// namespace bwd), which the Pallas kernel does not have.
//
// Semantics follow the Pallas kernel: queries are the tail of the keys
// (q_offset = Skv - Sq), key k is visible to query q when k <= q (causal) and
// k > q - window (window > 0); scores are scaled, then soft-capped, then
// masked; the output is acc / max(l, 1e-30).

#include "hopper.cuh"

namespace {

using repro::bf16;

constexpr int NST = 2;   // stages of the K/V ring
constexpr int NWG = 2;   // consumer warpgroups, 64 query rows each
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct Cfg {
  static constexpr int BM = 64 * NWG;                // query rows per CTA
  // keys per kv tile: 64, or 32 at hd 256, where O alone is 128 fp32 per thread
  // and S and P must fit beside it
  static constexpr int BN = HD == 256 ? 32 : 64;
  static constexpr int BOXC = HD < 64 ? HD : 64;      // columns per TMA box
  static constexpr int RB = BOXC * 2;                 // bytes per box row = swizzle width
  static constexpr int KPB = RB / 32;                 // 16-column k-steps per box
  static constexpr int NCH = HD < 64 ? 1 : HD / 64;   // 64-column chunks of O
  static constexpr int ON = HD < 64 ? HD / 2 : 32;    // accumulator floats per chunk
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;        // one K or V tile
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + NST * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + NST * KV_BYTES;
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 3 * NST) + 1024;  // + alignment slack
  static constexpr int THREADS = 128 * (NWG + 1);
  // registers per thread after the hand-over: the producer warpgroup keeps 40,
  // the consumers take the rest of the CTA's launch allocation (168 per
  // thread at 384 threads)
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
};

struct Params {
  int Sq, Skv, G, causal, window, q_offset;
  float scale, softcap, inv_softcap;
  float* lse;  // (B, H, Sq) fp32 log-sum-exp of each row's scores, or null
};

// A consumer thread's rows: absolute positions of its two accumulator rows
// (c0/c1 and c2/c3 of every n8 block) and its warpgroup's first and last row.
struct Rows {
  int pos_a, pos_b, wpos_lo, wpos_hi, qd;
};

// Scale, softcap and mask S (log2 domain), then the online softmax: new row
// maxima, the rescale alphas of the old sums and O, and exp2(S - max) in sc.
template <class C>
__device__ __forceinline__ void softmax_tile(float (&sc)[C::BN / 2], const Params& p, int k0,
                                             const Rows& r, float& m_a, float& m_b, float& l_a,
                                             float& l_b, float& al_a, float& al_b) {
  // the mask only on tiles that cross the diagonal, the window edge or Skv
  const bool need_mask = k0 + C::BN > p.Skv || (p.causal && k0 + C::BN - 1 > r.wpos_lo) ||
                         (p.window > 0 && k0 <= r.wpos_hi - p.window);
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < C::BN / 2; ++j) {
    float x = sc[j] * p.scale;
    if (p.softcap > 0.f) x = p.softcap * tanhf(x * p.inv_softcap);
    x *= LOG2E;
    if (need_mask) {
      const int key = k0 + 8 * (j / 4) + 2 * r.qd + (j & 1);
      const int pos = (j & 2) ? r.pos_b : r.pos_a;
      const bool ok = key < p.Skv && (!p.causal || key <= pos) &&
                      (p.window <= 0 || key > pos - p.window);
      x = ok ? x : -INFINITY;
    }
    sc[j] = x;
    if (j & 2) mx_b = fmaxf(mx_b, x); else mx_a = fmaxf(mx_a, x);
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;  // rows with no key yet
  const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
  al_a = exp2f(m_a - mu_a);
  al_b = exp2f(m_b - mu_b);
  m_a = mn_a;
  m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < C::BN / 2; ++j) {
    const float e = exp2f(sc[j] - ((j & 2) ? mu_b : mu_a));
    sc[j] = e;
    if (j & 2) sum_b += e; else sum_a += e;
  }
  l_a = l_a * al_a + sum_a;  // per-thread partial sums; the quad adds them at the end
  l_b = l_b * al_b + sum_b;
}

// P in bf16 as wgmma's A fragments: S's accumulator layout is the A layout.
template <class C>
__device__ __forceinline__ void pack_p(const float (&sc)[C::BN / 2],
                                       uint32_t (&pa)[C::BN / 16][4]) {
  using repro::pack_bf16;
#pragma unroll
  for (int kk = 0; kk < C::BN / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// The warpgroup's two products on ring stage s, issued (not waited for).
template <int HD>
struct Tile {
  using C = Cfg<HD>;
  uint32_t sQ, sK, sV;
  int wg;

  __device__ __forceinline__ void issue_s(float (&sc)[C::BN / 2], int s) const {
    using namespace repro;
#pragma unroll
    for (int j = 0; j < C::BN / 2; ++j) sc[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int bx = kk / C::KPB, kin = kk % C::KPB;
      const uint64_t da = wgmma_desc(sQ + bx * C::BM * C::RB + wg * 64 * C::RB + kin * 32, 16,
                                     8 * C::RB, C::RB);
      const uint64_t db = wgmma_desc(sK + s * C::KV_BYTES + bx * C::BN * C::RB + kin * 32, 16,
                                     8 * C::RB, C::RB);
      wgmma_ss(sc, da, db, kk > 0);
    }
  }

  __device__ __forceinline__ void issue_pv(float (&o)[C::NCH][C::ON],
                                           const uint32_t (&pa)[C::BN / 16][4], int s) const {
    using namespace repro;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        const uint64_t dv = wgmma_desc(sV + s * C::KV_BYTES + c * C::BN * C::RB +
                                           kk * 16 * C::RB,
                                       C::BN * C::RB, 8 * C::RB, C::RB);
        wgmma_rs(o[c], pa[kk], dv);
      }
  }
};

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap, const Params p) {
  using C = Cfg<HD>;
  using namespace repro;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles sit on 1 KB boundaries
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + C::OFF_K, sV = base + C::OFF_V;
  const uint32_t q_full = base + C::OFF_BAR;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + NST + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * NST + s); };

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BM;  // heaviest causal tiles first
  const int kvh = h / p.G;
  const int qpos_lo = q0 + p.q_offset;
  const int qpos_hi = min(q0 + C::BM, p.Sq) - 1 + p.q_offset;
  const int kv_end = p.causal ? min(p.Skv, qpos_hi + 1) : p.Skv;
  const int kv_begin = p.window > 0 ? max(0, qpos_lo - p.window + 1) : 0;
  const int t_begin = kv_begin / C::BN, t_end = (kv_end + C::BN - 1) / C::BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), NWG * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int bx = 0; bx < HD / C::BOXC; ++bx)
        tma_load_4d(sQ + bx * C::BM * C::RB, &qmap, q_full, bx * C::BOXC, h, q0, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % NST;
        mbar_wait(empty(s), ((i / NST) & 1) ^ 1);
        mbar_expect_tx(k_full(s), C::KV_BYTES);
        for (int bx = 0; bx < HD / C::BOXC; ++bx)
          tma_load_4d(sK + s * C::KV_BYTES + bx * C::BN * C::RB, &kmap, k_full(s), bx * C::BOXC,
                      kvh, t * C::BN, b);
        mbar_expect_tx(v_full(s), C::KV_BYTES);
        for (int bx = 0; bx < HD / C::BOXC; ++bx)
          tma_load_4d(sV + s * C::KV_BYTES + bx * C::BN * C::RB, &vmap, v_full(s), bx * C::BOXC,
                      kvh, t * C::BN, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows r0 .. r0 + 63 ----
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int qd = lane % 4;
    const int r0 = q0 + wg * 64;
    const int pos_a = r0 + warp * 16 + lane / 4 + p.q_offset;  // rows of c0/c1; pos_a + 8: c2/c3
    const int pos_b = pos_a + 8;
    const int wpos_lo = r0 + p.q_offset;
    const int wpos_hi = min(r0 + 64, p.Sq) - 1 + p.q_offset;  // < wpos_lo: no real rows

    float o[C::NCH][C::ON];
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
#pragma unroll
      for (int i = 0; i < C::ON; ++i) o[c][i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f, al_a, al_b;
    float sc[C::BN / 2];
    uint32_t pa[C::BN / 16][4];
    Tile<HD> tile{sQ, sK, sV, wg};
    const Rows rows{pos_a, pos_b, wpos_lo, wpos_hi, qd};

    // S of the first tile, then per tile t: S(t) = Q K(t)^T is issued before
    // O += P(t-1) V(t-1), and the softmax of S(t) runs on the CUDA cores while
    // the tensor cores do that P V; O is rescaled once the P V has landed.
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    tile.issue_s(sc, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile<C>(sc, p, t_begin * C::BN, rows, m_a, m_b, l_a, l_b, al_a, al_b);
    pack_p<C>(sc, pa);
    for (int t = t_begin + 1, i = 1; t < t_end; ++t, ++i) {
      const int s = i % NST, sp = (i - 1) % NST;
      mbar_wait(k_full(s), (i / NST) & 1);
      tile.issue_s(sc, s);
      wgmma_commit();
      mbar_wait(v_full(sp), ((i - 1) / NST) & 1);
      tile.issue_pv(o, pa, sp);
      wgmma_commit();
      wgmma_wait<1>();  // S(t) has landed; P(t-1) V(t-1) may still run
      fence_regs(sc);
      softmax_tile<C>(sc, p, t * C::BN, rows, m_a, m_b, l_a, l_b, al_a, al_b);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) fence_regs(o[c]);
      fence_regs(pa);
      mbar_arrive(empty(sp));
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
#pragma unroll
        for (int j = 0; j < C::ON; ++j) o[c][j] *= (j & 2) ? al_b : al_a;
      pack_p<C>(sc, pa);
    }
    {
      const int i = t_end - 1 - t_begin, s = i % NST;
      mbar_wait(v_full(s), (i / NST) & 1);
      tile.issue_pv(o, pa, s);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) fence_regs(o[c]);
      mbar_arrive(empty(s));
    }

    // ---- epilogue: normalise, bf16 into this warpgroup's Q rows, TMA store ----
    if (wpos_hi >= wpos_lo) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
      const int row = warp * 16 + lane / 4;
      if (p.lse != nullptr && qd == 0) {  // m is in exp2 units: lse = (m + log2 l) ln 2
        float* lrow = p.lse + (static_cast<long long>(b) * gridDim.x + h) * p.Sq;
        if (r0 + row < p.Sq) lrow[r0 + row] = l_a > 0.f ? (m_a + log2f(l_a)) * LN2 : INFINITY;
        if (r0 + row + 8 < p.Sq)
          lrow[r0 + row + 8] = l_b > 0.f ? (m_b + log2f(l_b)) * LN2 : INFINITY;
      }
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        unsigned char* box = smem + c * C::BM * C::RB + wg * 64 * C::RB;
#pragma unroll
        for (int j = 0; j < C::ON / 4; ++j) {
          const uint32_t col = (8 * j + 2 * qd) * 2;
          *reinterpret_cast<uint32_t*>(box + swizzle(row * C::RB + col, C::RB)) =
              pack_bf16(o[c][4 * j] * inv_a, o[c][4 * j + 1] * inv_a);
          *reinterpret_cast<uint32_t*>(box + swizzle((row + 8) * C::RB + col, C::RB)) =
              pack_bf16(o[c][4 * j + 2] * inv_b, o[c][4 * j + 3] * inv_b);
        }
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (tid == 0) {
        for (int c = 0; c < C::NCH; ++c)
          tma_store_4d(&omap, sQ + c * C::BM * C::RB + wg * 64 * C::RB, c * C::BOXC, h, r0, b);
        tma_store_commit_and_wait();
      }
    }
  }
}

struct Strides {
  long long b, s, h;
};

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H,
           int K, int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap qm, km, vm, om;
  cudaError_t err;
  if ((err = repro::encode_bf16_map(&qm, q, HD, H, Sq, B, qs.h, qs.s, qs.b, C::BOXC, C::BM,
                                    C::RB)) != cudaSuccess ||
      (err = repro::encode_bf16_map(&km, k, HD, K, Skv, B, ks.h, ks.s, ks.b, C::BOXC, C::BN,
                                    C::RB)) != cudaSuccess ||
      (err = repro::encode_bf16_map(&vm, v, HD, K, Skv, B, vs.h, vs.s, vs.b, C::BOXC, C::BN,
                                    C::RB)) != cudaSuccess ||
      (err = repro::encode_bf16_map(&om, out, HD, H, Sq, B, os.h, os.s, os.b, C::BOXC, 64,
                                    C::RB)) != cudaSuccess)
    return static_cast<int>(err);
  err = repro::allow_smem(flash_attention_kernel<HD>, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{Sq, Skv, H / K, causal, window, Skv - Sq, scale, softcap,
                 softcap > 0.f ? 1.f / softcap : 0.f, lse};
  const dim3 grid(H, (Sq + C::BM - 1) / C::BM, B);
  flash_attention_kernel<HD><<<grid, C::THREADS, C::BYTES, stream>>>(qm, km, vm, om, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward (no TPU counterpart: the reference differentiates its attention
// with XLA). FlashAttention-2's split on the forward's Hopper machinery, with
// no atomics, so the same inputs give the same bits. Three launches, four
// where a kv head has several query heads:
// - stats: per (b, h, row) the pair (lse log2 e, D = rowsum(dO * O)) in fp32,
//   rows padded to STATS_PAD with (+inf, 0), so a query past Sq gets P = 0
//   whatever its (zero-filled) tile holds;
// - dK/dV: one CTA per (query head, 128-key tile, b, 64 of hd's columns),
//   heaviest causal tiles first. Two consumer warpgroups of 64 keys keep K
//   and V resident in shared memory; a producer warp streams the Q and dO
//   tiles of the query steps that see the key tile, with their stats, by TMA
//   (a bulk copy for the stats) into a ring of DST stages, and gives up its
//   registers (setmaxnreg 40). Per step S^T = K Q^T and dP^T = V dO^T (wgmma,
//   both operands in shared memory), P^T = exp2(S^T - lse) and dS^T = P^T
//   (dP^T - D) (the soft-cap's 1 - tanh^2 applied) on the accumulators, then
//   dV += P^T dO and dK += dS^T Q (wgmma, P^T and dS^T as bf16 register A
//   operands, dO and Q as transposed shared-memory B operands). dK and dV
//   stay in fp32 registers and are written once (dK times the scale): in bf16
//   where a kv head has one query head, else as that head's fp32 part, and a
//   further launch adds a kv head's G parts in head order;
// - dQ: one CTA per (query head, 128-query tile, b, 128 of hd's columns),
//   heaviest causal tiles first, the forward's layout: Q and dO resident, K
//   and V streamed through a ring; per step S = Q K^T and dP = dO V^T, P and
//   dS on the accumulators, dQ += dS K (dS as register A operand, K as the
//   transposed B operand); dQ stays in fp32 registers, written once.
// Tiles outside the causal band or the window are never loaded (the ranges
// are backward_plan's in kernels/flash_attention/ops.py, which the CPU tests
// hold; the C entry refuses a plan whose tiles differ); the mask runs only on
// tiles that cross an edge, as a second copy of the elementwise loop (a
// per-element mask test on every tile cost more than the products); keys
// past Skv are masked, rows past Sq read lse = +inf.
// What bounds it: operations, 5 products of 2 Sq Skv hd per head, halved by
// the causal mask (0.152 ms at internvl2's (2, 4096, 14 on 2, 64), 0.3475 ms
// at jamba's (1, 4096, 32 on 8, 128)). This design does 7 (S and dP again in
// the dQ kernel) and, at hd >= 128, S^T and dP^T once per 64-column split:
// a CTA of 384 threads gets 168 registers a thread, and ptxas allocates no
// more after setmaxnreg (a consumer holding dK and dV of 128 columns, 128
// fp32 registers, spilled and ptxas serialized its wgmma). Registers and
// shared memory (ptxas -v, sm_90a, CUDA 12.9): every dK/dV and dQ kernel 168
// registers, no spills at any head dim; dK/dV 23,120 / 43,600 / 84,560 /
// 166,480 / 198,200 bytes of shared memory at hd 16 / 32 / 64 / 128 / 256,
// dQ 17,464 / 33,848 / 66,616 / 132,152 / 197,688; one CTA an SM.
// dQ in a kernel of its own (design b) rather than folded into the dK/dV
// sweep with a fixed-order fp32 sum (design a, 5 products): a folded build
// (launch/flash_bwd_designs.py) was correct and bit-stable but 3.8-4x slower
// (2.197 against 0.553 ms at internvl2's shape, 4.798 against 1.278 ms at
// jamba's; H100 80GB HBM3, 700 W): each key tile waits in turn on the tile
// before it for every query step it shares, and the dS^T staging and the
// partial dQ overflow the 168 registers. PERF.md has the measurements.

namespace bwd {

constexpr int NWG = 2;  // consumer warpgroups of both kernels, 64 rows each
constexpr int THREADS = 128 * (NWG + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int STATS_PAD = 128;  // the stats' rows per (b, h) round up to this

template <int HD>
struct BCfg {
  static constexpr int BOXC = HD < 64 ? HD : 64;  // columns per TMA box (the forward's)
  static constexpr int RB = BOXC * 2;             // bytes per box row = swizzle width
  static constexpr int KPB = RB / 32;             // 16-column k-steps per box
  // dK/dV kernel: BN keys resident, BQ queries a step, HDO of dK/dV's columns:
  // 64 at most, so dK and dV take 64 fp32 registers a thread (a CTA at hd 128
  // holding all 128 columns spills at the 168 registers a 384-thread CTA
  // gets, and ptxas serializes its wgmma)
  static constexpr int BN = 64 * NWG;
  static constexpr int BQ = HD == 256 ? 32 : 64;
  static constexpr int HDO = HD > 64 ? 64 : HD;
  static constexpr int NSPLIT = HD / HDO;
  static constexpr int OFL = HDO / 2;                  // dK's, dV's accumulator floats
  static constexpr int DST = HD == 256 ? 2 : 3;        // ring stages
  static constexpr int KV_BYTES = BN * HD * 2;         // K or V
  static constexpr int QS_BYTES = BQ * HD * 2;         // a step's Q or dO
  static constexpr int ST_BYTES = BQ * 8;              // a step's (lse log2 e, D)
  static constexpr int D_OFF_V = KV_BYTES;
  static constexpr int D_OFF_Q = 2 * KV_BYTES;
  static constexpr int D_OFF_O = D_OFF_Q + DST * QS_BYTES;
  static constexpr int D_OFF_ST = D_OFF_O + DST * QS_BYTES;
  static constexpr int D_OFF_BAR = D_OFF_ST + DST * ST_BYTES;
  static constexpr int D_BYTES = D_OFF_BAR + 8 * (1 + 3 * DST) + 1024;  // + alignment slack
  // dQ kernel: BM queries resident, BKV keys a step (32 at hd 256, as the
  // forward), QHDO of dQ's columns (128 at most: 64 fp32 registers a thread)
  static constexpr int BM = 64 * NWG;
  static constexpr int BKV = HD == 256 ? 32 : 64;
  static constexpr int QHDO = HD > 128 ? 128 : HD;
  static constexpr int QSPLIT = HD / QHDO;
  static constexpr int QST = 2;  // ring stages
  static constexpr int QCH = QHDO < 64 ? 1 : QHDO / 64;  // 64-column chunks of dQ
  static constexpr int QFL = QHDO < 64 ? QHDO / 2 : 32;
  static constexpr int QT_BYTES = BM * HD * 2;
  static constexpr int KS_BYTES = BKV * HD * 2;
  static constexpr int Q_OFF_O = QT_BYTES;
  static constexpr int Q_OFF_K = 2 * QT_BYTES;
  static constexpr int Q_OFF_V = Q_OFF_K + QST * KS_BYTES;
  static constexpr int Q_OFF_BAR = Q_OFF_V + QST * KS_BYTES;
  static constexpr int Q_BYTES = Q_OFF_BAR + 8 * (1 + 3 * QST) + 1024;
  static_assert(STATS_PAD % BQ == 0 && STATS_PAD % BM == 0, "a step's stats stay in the pad");
  static_assert(D_BYTES <= 232448 && Q_BYTES <= 232448, "shared memory of one CTA");
};

struct BParams {
  const float2* stats;  // (B, H, sq_pad): (lse log2 e, D), (+inf, 0) past Sq
  bf16 *dq, *dk, *dv;   // contiguous (B, Sq, H, hd) and (B, Skv, K, hd)
  float *part_k, *part_v;  // G > 1: each query head's dK, dV, (B, Skv, H, hd) fp32
  int H, K, G, Sq, Skv, sq_pad, q_offset, causal, window;
  float scale, softcap, inv_softcap, scale_log2e, softcap_log2e;
};

// key `key` visible to query row `qi` (qi < Sq, key < Skv, the masks)
__device__ __forceinline__ bool visible(const BParams& p, int qi, int key) {
  const int pos = qi + p.q_offset;
  return qi < p.Sq && key < p.Skv && (!p.causal || key <= pos) &&
         (p.window <= 0 || key > pos - p.window);
}

// Must the pair of a key block [k_lo, k_end) and queries [q_lo, q_hi] be
// masked (a key past Skv, or a pair across the causal or the window edge)?
__device__ __forceinline__ bool block_masked(const BParams& p, int k_lo, int k_end, int q_lo,
                                             int q_hi) {
  return k_end > p.Skv || (p.causal && k_end - 1 > q_lo + p.q_offset) ||
         (p.window > 0 && k_lo <= q_hi + p.q_offset - p.window);
}

// From the score s (Q K^T, unscaled) and dP of one (query, key): P into s and
// dS = P (dP - D), with the soft-cap's derivative, into dp. The scale of dS
// is applied to dK and dQ once, in the epilogues.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void grad_entry(float& s, float& dp, float lse2, float d,
                                           const BParams& p, bool ok) {
  if (p.softcap > 0.f) {
    const float t = tanhf(s * p.scale * p.inv_softcap);
    const float pr = ok ? ex2(p.softcap_log2e * t - lse2) : 0.f;
    s = pr;
    dp = pr * (dp - d) * (1.f - t * t);
  } else {
    const float pr = ok ? ex2(s * p.scale_log2e - lse2) : 0.f;
    s = pr;
    dp = pr * (dp - d);
  }
}

// An m64nN accumulator in bf16 as wgmma's A fragments (N / 16 of them): the
// accumulator layout is the A layout.
template <int N>
__device__ __forceinline__ void pack_frags(const float (&c)[N], uint32_t (&a)[N / 8][4]) {
  using repro::pack_bf16;
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// acc (64 x N) = A (64 rows of a K-major tile at `a`, ROWS_A rows a box) times
// B^T (N rows of a K-major tile at `b`, ROWS_B rows a box), over HD: issued
// and committed, not waited for.
template <int HD, int ROWS_A, int ROWS_B, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N], uint32_t a, uint32_t b) {
  using C = BCfg<HD>;
  using namespace repro;
  zero(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int bx = kk / C::KPB, kin = kk % C::KPB;
    const uint64_t da = wgmma_desc(a + bx * ROWS_A * C::RB + kin * 32, 16, 8 * C::RB, C::RB);
    const uint64_t db = wgmma_desc(b + bx * ROWS_B * C::RB + kin * 32, 16, 8 * C::RB, C::RB);
    wgmma_ss(acc, da, db, kk > 0);
  }
  wgmma_commit();
}

// acc[c] (64 x 64 columns of chunk c) += A (registers, 64 x K) times B (K rows
// of a tile at `b`, ROWS_B rows a box, read as the transposed operand from
// box `box0` + c on): issued, not waited for.
template <int HD, int ROWS_B, int K, int NC, int FL>
__device__ __forceinline__ void issue_rs(float (&acc)[NC][FL], const uint32_t (&a)[K / 16][4],
                                         uint32_t b, int box0) {
  using C = BCfg<HD>;
  using namespace repro;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint64_t db = wgmma_desc(b + (box0 + c) * ROWS_B * C::RB + kk * 16 * C::RB,
                                     ROWS_B * C::RB, 8 * C::RB, C::RB);
      wgmma_rs(acc[c], a[kk], db);
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap omap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const BParams p) {
  using C = BCfg<HD>;
  using namespace repro;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles sit on 1 KB boundaries
  const float2* sst = reinterpret_cast<const float2*>(smem_raw + (base - raw) + C::D_OFF_ST);
  const uint32_t sK = base, sV = base + C::D_OFF_V, sQ = base + C::D_OFF_Q,
                 sO = base + C::D_OFF_O, sS = base + C::D_OFF_ST;
  const uint32_t kv_full = base + C::D_OFF_BAR;
  auto q_full = [&](int s) { return kv_full + 8u * (1 + s); };
  auto o_full = [&](int s) { return kv_full + 8u * (1 + C::DST + s); };
  auto empty = [&](int s) { return kv_full + 8u * (1 + 2 * C::DST + s); };

  const int split = blockIdx.x % C::NSPLIT, h = blockIdx.x / C::NSPLIT, kvh = h / p.G;
  const int k0 = blockIdx.y * C::BN, b = blockIdx.z;
  // the query steps that see a key of this tile (backward_plan's dkdv_steps)
  const int q_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int q_hi = p.window > 0 ? min(p.Sq, k0 + C::BN - 1 + p.window - p.q_offset) : p.Sq;
  const int qt0 = q_lo / C::BQ;
  const int steps = q_hi > q_lo ? (q_hi + C::BQ - 1) / C::BQ - qt0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::DST; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(o_full(s), 1);
      mbar_init(empty(s), NWG * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);  // uniform
  if (wg == NWG) {
    // ---- producer: K and V once, then each step's Q, dO and stats ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == NWG * 128 && steps > 0) {
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
      for (int bx = 0; bx < HD / C::BOXC; ++bx) {
        tma_load_4d(sK + bx * C::BN * C::RB, &kmap, kv_full, bx * C::BOXC, kvh, k0, b);
        tma_load_4d(sV + bx * C::BN * C::RB, &vmap, kv_full, bx * C::BOXC, kvh, k0, b);
      }
      const float2* st = p.stats + (static_cast<long long>(b) * p.H + h) * p.sq_pad;
      for (int i = 0; i < steps; ++i) {
        const int s = i % C::DST, q0 = (qt0 + i) * C::BQ;
        mbar_wait(empty(s), ((i / C::DST) & 1) ^ 1);
        mbar_expect_tx(q_full(s), C::QS_BYTES);
        for (int bx = 0; bx < HD / C::BOXC; ++bx)
          tma_load_4d(sQ + s * C::QS_BYTES + bx * C::BQ * C::RB, &qmap, q_full(s), bx * C::BOXC,
                      h, q0, b);
        mbar_expect_tx(o_full(s), C::QS_BYTES + C::ST_BYTES);
        for (int bx = 0; bx < HD / C::BOXC; ++bx)
          tma_load_4d(sO + s * C::QS_BYTES + bx * C::BQ * C::RB, &omap, o_full(s), bx * C::BOXC,
                      h, q0, b);
        bulk_load(sS + s * C::ST_BYTES, st + q0, C::ST_BYTES, o_full(s));
      }
    }
  } else {
    // ---- consumer warpgroup wg: keys kw_lo .. kw_lo + 63 ----
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, qd = lane % 4;
    const int kw_lo = k0 + wg * 64;
    const int key_a = kw_lo + warp * 16 + lane / 4;  // rows of c0/c1; key_a + 8: c2/c3
    float dk[1][C::OFL], dv[1][C::OFL];  // one 64-column chunk each (issue_rs's shape)
    zero(dk[0]);
    zero(dv[0]);
    if (steps > 0) mbar_wait(kv_full, 0);
    for (int i = 0; i < steps; ++i) {
      const int s = i % C::DST, q0 = (qt0 + i) * C::BQ;
      const uint32_t ph = (i / C::DST) & 1;
      float st[C::BQ / 2], dp[C::BQ / 2];
      mbar_wait(q_full(s), ph);
      issue_ss<HD, C::BN, C::BQ>(st, sK + wg * 64 * C::RB, sQ + s * C::QS_BYTES);
      mbar_wait(o_full(s), ph);
      issue_ss<HD, C::BN, C::BQ>(dp, sV + wg * 64 * C::RB, sO + s * C::QS_BYTES);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dp);
      const float2* ls = sst + s * C::BQ;
      auto grads = [&](bool mask) {  // inlined twice: the mask only where a tile needs it
#pragma unroll
        for (int j = 0; j < C::BQ / 2; ++j) {
          const int col = 8 * (j / 4) + 2 * qd + (j & 1);
          const float2 l = ls[col];
          grad_entry(st[j], dp[j], l.x, l.y, p,
                     !mask || visible(p, q0 + col, key_a + ((j & 2) ? 8 : 0)));
        }
      };
      if (block_masked(p, kw_lo, kw_lo + 64, q0, min(q0 + C::BQ, p.Sq) - 1))
        grads(true);
      else
        grads(false);
      uint32_t pa[C::BQ / 16][4], sa[C::BQ / 16][4];
      pack_frags(st, pa);
      pack_frags(dp, sa);
      fence_regs(pa);
      fence_regs(sa);
      fence_regs(dv[0]);
      fence_regs(dk[0]);
      wgmma_fence();
      const int box0 = split * C::HDO / C::BOXC;
      issue_rs<HD, C::BQ, C::BQ>(dv, pa, sO + s * C::QS_BYTES, box0);
      issue_rs<HD, C::BQ, C::BQ>(dk, sa, sQ + s * C::QS_BYTES, box0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv[0]);
      fence_regs(dk[0]);
      fence_regs(pa);
      fence_regs(sa);
      mbar_arrive(empty(s));
    }

    // ---- epilogue: this thread's two keys, its pairs of columns ----
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key_a + 8 * half;
      if (key >= p.Skv) continue;
      const long long row = static_cast<long long>(b) * p.Skv + key;
#pragma unroll
      for (int j = 2 * half; j < C::OFL; j += 4) {
        const int col = split * C::HDO + 8 * (j / 4) + 2 * qd;
        if (p.G == 1) {
          const long long off = (row * p.K + kvh) * HD + col;
          *reinterpret_cast<uint32_t*>(p.dk + off) =
              pack_bf16(dk[0][j] * p.scale, dk[0][j + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(p.dv + off) = pack_bf16(dv[0][j], dv[0][j + 1]);
        } else {
          const long long off = (row * p.H + h) * HD + col;
          *reinterpret_cast<float2*>(p.part_k + off) =
              make_float2(dk[0][j] * p.scale, dk[0][j + 1] * p.scale);
          *reinterpret_cast<float2*>(p.part_v + off) = make_float2(dv[0][j], dv[0][j + 1]);
        }
      }
    }
  }
}

// dK and dV of kv head j: the parts of its query heads j G .. j G + G - 1
// added in head order, in bf16; a thread per 4 columns of one row
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_sum_kernel(const BParams p, long long n4) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const long long row = i / (p.K * (HD / 4));  // (b, key)
  const int j = static_cast<int>(i / (HD / 4) % p.K), c = static_cast<int>(i % (HD / 4)) * 4;
  const long long src = (row * p.H + j * p.G) * HD + c;
  float4 k = *reinterpret_cast<const float4*>(p.part_k + src);
  float4 v = *reinterpret_cast<const float4*>(p.part_v + src);
  for (int g = 1; g < p.G; ++g) {
    const float4 kg = *reinterpret_cast<const float4*>(p.part_k + src + g * HD);
    const float4 vg = *reinterpret_cast<const float4*>(p.part_v + src + g * HD);
    k.x += kg.x, k.y += kg.y, k.z += kg.z, k.w += kg.w;
    v.x += vg.x, v.y += vg.y, v.z += vg.z, v.w += vg.w;
  }
  const long long dst = (row * p.K + j) * HD + c;
  *reinterpret_cast<uint2*>(p.dk + dst) =
      make_uint2(repro::pack_bf16(k.x, k.y), repro::pack_bf16(k.z, k.w));
  *reinterpret_cast<uint2*>(p.dv + dst) =
      make_uint2(repro::pack_bf16(v.x, v.y), repro::pack_bf16(v.z, v.w));
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap omap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const BParams p) {
  using C = BCfg<HD>;
  using namespace repro;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sO = base + C::Q_OFF_O, sK = base + C::Q_OFF_K,
                 sV = base + C::Q_OFF_V;
  const uint32_t qo_full = base + C::Q_OFF_BAR;
  auto k_full = [&](int s) { return qo_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return qo_full + 8u * (1 + C::QST + s); };
  auto empty = [&](int s) { return qo_full + 8u * (1 + 2 * C::QST + s); };

  const int split = blockIdx.x % C::QSPLIT, h = blockIdx.x / C::QSPLIT, b = blockIdx.z;
  const int kvh = h / p.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BM;  // heaviest causal tiles first
  // the key steps this query tile sees (backward_plan's dq_steps)
  const int qpos_lo = q0 + p.q_offset, qpos_hi = min(q0 + C::BM, p.Sq) - 1 + p.q_offset;
  const int kv_end = p.causal ? min(p.Skv, qpos_hi + 1) : p.Skv;
  const int kv_begin = p.window > 0 ? max(0, qpos_lo - p.window + 1) : 0;
  const int t0 = kv_begin / C::BKV;
  const int steps = kv_end > kv_begin ? (kv_end + C::BKV - 1) / C::BKV - t0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(qo_full, 1);
    for (int s = 0; s < C::QST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), NWG * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == NWG) {
    // ---- producer: Q and dO once, then each step's K and V ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == NWG * 128 && steps > 0) {
      mbar_expect_tx(qo_full, 2 * C::QT_BYTES);
      for (int bx = 0; bx < HD / C::BOXC; ++bx) {
        tma_load_4d(sQ + bx * C::BM * C::RB, &qmap, qo_full, bx * C::BOXC, h, q0, b);
        tma_load_4d(sO + bx * C::BM * C::RB, &omap, qo_full, bx * C::BOXC, h, q0, b);
      }
      for (int i = 0; i < steps; ++i) {
        const int s = i % C::QST, j0 = (t0 + i) * C::BKV;
        mbar_wait(empty(s), ((i / C::QST) & 1) ^ 1);
        mbar_expect_tx(k_full(s), C::KS_BYTES);
        for (int bx = 0; bx < HD / C::BOXC; ++bx)
          tma_load_4d(sK + s * C::KS_BYTES + bx * C::BKV * C::RB, &kmap, k_full(s),
                      bx * C::BOXC, kvh, j0, b);
        mbar_expect_tx(v_full(s), C::KS_BYTES);
        for (int bx = 0; bx < HD / C::BOXC; ++bx)
          tma_load_4d(sV + s * C::KS_BYTES + bx * C::BKV * C::RB, &vmap, v_full(s),
                      bx * C::BOXC, kvh, j0, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows r0 .. r0 + 63 ----
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, qd = lane % 4;
    const int r0 = q0 + wg * 64, r_last = min(r0 + 64, p.Sq) - 1;
    const int row_a = r0 + warp * 16 + lane / 4;  // rows of c0/c1; row_a + 8: c2/c3
    const float2* st = p.stats + (static_cast<long long>(b) * p.H + h) * p.sq_pad;
    const float2 la = st[row_a], lb = st[row_a + 8];  // (+inf, 0) past Sq
    float dq[C::QCH][C::QFL];
#pragma unroll
    for (int c = 0; c < C::QCH; ++c) zero(dq[c]);
    if (steps > 0) mbar_wait(qo_full, 0);
    for (int i = 0; i < steps; ++i) {
      const int s = i % C::QST, j0 = (t0 + i) * C::BKV;
      const uint32_t ph = (i / C::QST) & 1;
      float sc[C::BKV / 2], dp[C::BKV / 2];
      mbar_wait(k_full(s), ph);
      issue_ss<HD, C::BM, C::BKV>(sc, sQ + wg * 64 * C::RB, sK + s * C::KS_BYTES);
      mbar_wait(v_full(s), ph);
      issue_ss<HD, C::BM, C::BKV>(dp, sO + wg * 64 * C::RB, sV + s * C::KS_BYTES);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      auto grads = [&](bool mask) {  // as in dK/dV
#pragma unroll
        for (int j = 0; j < C::BKV / 2; ++j) {
          const bool hi = (j & 2) != 0;
          const float2 l = hi ? lb : la;
          const int key = j0 + 8 * (j / 4) + 2 * qd + (j & 1);
          grad_entry(sc[j], dp[j], l.x, l.y, p, !mask || visible(p, row_a + (hi ? 8 : 0), key));
        }
      };
      if (block_masked(p, j0, j0 + C::BKV, r0, r_last))
        grads(true);
      else
        grads(false);
      uint32_t sa[C::BKV / 16][4];
      pack_frags(dp, sa);
      fence_regs(sa);
#pragma unroll
      for (int c = 0; c < C::QCH; ++c) fence_regs(dq[c]);
      wgmma_fence();
      issue_rs<HD, C::BKV, C::BKV>(dq, sa, sK + s * C::KS_BYTES, split * C::QHDO / C::BOXC);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::QCH; ++c) fence_regs(dq[c]);
      fence_regs(sa);
      mbar_arrive(empty(s));
    }

    // ---- epilogue: this thread's two rows in bf16 ----
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = row_a + 8 * half;
      if (qi >= p.Sq) continue;
      const long long off = ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * HD +
                            split * C::QHDO;
#pragma unroll
      for (int c = 0; c < C::QCH; ++c)
#pragma unroll
        for (int j = 2 * half; j < C::QFL; j += 4)
          *reinterpret_cast<uint32_t*>(p.dq + off + c * 64 + 8 * (j / 4) + 2 * qd) =
              pack_bf16(dq[c][j] * p.scale, dq[c][j + 1] * p.scale);
    }
  }
}

// Per (b, h, row) of the padded rows: (lse log2 e, D = rowsum(dO * O)) in
// fp32, (+inf, 0) past Sq; hd / 8 lanes per row, 16 bytes each
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_stats_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, float2* __restrict__ stats, Strides os,
                       Strides ds, int H, int Sq, int sq_pad, long long rows) {
  constexpr int TPR = HD / 8;
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / TPR;
  const int c = threadIdx.x % TPR;
  const int i = static_cast<int>(row % sq_pad);
  const long long bh = row / sq_pad;
  float acc = 0.f;
  if (row < rows && i < Sq) {
    const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * os.b + i * os.s + h * os.h + c * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + b * ds.b + i * ds.s + h * ds.h + c * 8);
    const bf16* oe = reinterpret_cast<const bf16*>(&ov);
    const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += repro::to_f32(oe[k]) * repro::to_f32(de[k]);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0)
    stats[row] = i < Sq ? make_float2(lse[bh * Sq + i] * LOG2E, acc)
                        : make_float2(INFINITY, 0.f);
}

struct Tiles {  // backward_plan's tiles, as the wrapper passes them
  int key_tile, query_step, query_tile, key_step, stats_rows;
};

template <int HD>
int launch_backward(const void* q, const void* k, const void* v, const void* out,
                    const void* dout, const float* lse, BParams p, Strides qs, Strides ks,
                    Strides vs, Strides os, Strides ds, int B, const Tiles& t,
                    cudaStream_t stream) {
  using C = BCfg<HD>;
  const int sq_pad = (p.Sq + STATS_PAD - 1) / STATS_PAD * STATS_PAD;
  if (t.key_tile != C::BN || t.query_step != C::BQ || t.query_tile != C::BM ||
      t.key_step != C::BKV || t.stats_rows != sq_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  p.sq_pad = sq_pad;
  cudaError_t err;
  CUtensorMap q_step, o_step, k_tile, v_tile, q_tile, o_tile, k_step, v_step;
  using repro::encode_bf16_map;
  if ((err = encode_bf16_map(&q_step, q, HD, p.H, p.Sq, B, qs.h, qs.s, qs.b, C::BOXC, C::BQ,
                             C::RB)) != cudaSuccess ||
      (err = encode_bf16_map(&o_step, dout, HD, p.H, p.Sq, B, ds.h, ds.s, ds.b, C::BOXC, C::BQ,
                             C::RB)) != cudaSuccess ||
      (err = encode_bf16_map(&k_tile, k, HD, p.K, p.Skv, B, ks.h, ks.s, ks.b, C::BOXC, C::BN,
                             C::RB)) != cudaSuccess ||
      (err = encode_bf16_map(&v_tile, v, HD, p.K, p.Skv, B, vs.h, vs.s, vs.b, C::BOXC, C::BN,
                             C::RB)) != cudaSuccess ||
      (err = encode_bf16_map(&q_tile, q, HD, p.H, p.Sq, B, qs.h, qs.s, qs.b, C::BOXC, C::BM,
                             C::RB)) != cudaSuccess ||
      (err = encode_bf16_map(&o_tile, dout, HD, p.H, p.Sq, B, ds.h, ds.s, ds.b, C::BOXC, C::BM,
                             C::RB)) != cudaSuccess ||
      (err = encode_bf16_map(&k_step, k, HD, p.K, p.Skv, B, ks.h, ks.s, ks.b, C::BOXC, C::BKV,
                             C::RB)) != cudaSuccess ||
      (err = encode_bf16_map(&v_step, v, HD, p.K, p.Skv, B, vs.h, vs.s, vs.b, C::BOXC, C::BKV,
                             C::RB)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = repro::allow_smem(flash_bwd_dkdv_kernel<HD>, C::D_BYTES)) != cudaSuccess ||
      (err = repro::allow_smem(flash_bwd_dq_kernel<HD>, C::Q_BYTES)) != cudaSuccess)
    return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * p.H * sq_pad;
  const long long threads = rows * (HD / 8);
  flash_bwd_stats_kernel<HD><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse,
      const_cast<float2*>(p.stats), os, ds, p.H, p.Sq, sq_pad, rows);
  const dim3 kv_grid(p.H * C::NSPLIT, (p.Skv + C::BN - 1) / C::BN, B);
  flash_bwd_dkdv_kernel<HD><<<kv_grid, THREADS, C::D_BYTES, stream>>>(q_step, o_step, k_tile,
                                                                        v_tile, p);
  if (p.G > 1) {
    const long long n4 = static_cast<long long>(B) * p.Skv * p.K * (HD / 4);
    flash_bwd_dkdv_sum_kernel<HD><<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, stream>>>(
        p, n4);
  }
  const dim3 q_grid(p.H * C::QSPLIT, (p.Sq + C::BM - 1) / C::BM, B);
  flash_bwd_dq_kernel<HD><<<q_grid, THREADS, C::Q_BYTES, stream>>>(q_tile, o_tile, k_step,
                                                                     v_step, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd

}  // namespace

// q: (B, Sq, H, hd), k/v: (B, Skv, K, hd), out: (B, Sq, H, hd), all bf16 with
// unit stride on hd, 16-byte aligned; the other strides are in elements and
// multiples of 8. lse: (B, H, Sq) fp32, contiguous, or null (serving): each
// row's log-sum-exp of its scaled, capped, masked scores.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int B, int H, int K, int Sq, int Skv, int hd,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      long long o_sb, long long o_ss, long long o_sh,
                                      float scale, int causal, int window, float softcap,
                                      void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define REPRO_FLASH_CASE(D)                                                                     \
  case D:                                                                                       \
    return launch<D>(q, k, v, out, l, B, H, K, Sq, Skv, qs, ks, vs, os, scale, causal, window, \
                     softcap, s);
  switch (hd) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_CASE
}

// The backward of flash_attention_launch: dq (B, Sq, H, hd), dk and dv (B, Skv,
// K, hd), all bf16 and contiguous, from q, k, v, out and dout (the forward's
// layout rules; dout's strides as out's) and the forward's lse (B, H, Sq) fp32;
// stats is (B, H, stats_rows, 2) fp32 scratch; where H > K, part_k and part_v
// are (B, Skv, H, hd) fp32 scratch, else unread. key_tile .. stats_rows are
// backward_plan's (kernels/flash_attention/ops.py): a plan whose tiles differ
// from this file's is refused. Three launches on `stream`, four where H > K.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* stats, void* dq, void* dk, void* dv, void* part_k, void* part_v,
    int B, int H, int K, int Sq, int Skv, int hd, int key_tile, int query_step, int query_tile,
    int key_step, int stats_rows, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long d_sb, long long d_ss,
    long long d_sh, float scale, int causal, int window, float softcap, void* stream) {
  if (B <= 0) return 0;
  if (Skv <= 0 || Sq < 0 || K <= 0 || H % K != 0 || B > 65535 || (Skv + 127) / 128 > 65535 ||
      (Sq + 127) / 128 > 65535 || (H > K && (part_k == nullptr || part_v == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq == 0) {  // no query: dK = dV = 0
    const size_t bytes = static_cast<size_t>(B) * Skv * K * hd * 2;
    cudaMemsetAsync(dk, 0, bytes, s);
    cudaMemsetAsync(dv, 0, bytes, s);
    return static_cast<int>(cudaGetLastError());
  }
  const bwd::BParams p{static_cast<const float2*>(stats), static_cast<bf16*>(dq),
                       static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                       static_cast<float*>(part_k), static_cast<float*>(part_v),
                       H, K, H / K, Sq, Skv, 0, Skv - Sq, causal, window, scale, softcap,
                       softcap > 0.f ? 1.f / softcap : 0.f, scale * LOG2E,
                       softcap * LOG2E};
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh}, ds{d_sb, d_ss, d_sh};
  const bwd::Tiles t{key_tile, query_step, query_tile, key_step, stats_rows};
  const float* l = static_cast<const float*>(lse);
#define REPRO_FLASH_BWD_CASE(D) \
  case D:                       \
    return bwd::launch_backward<D>(q, k, v, out, dout, l, p, qs, ks, vs, os, ds, B, t, s);
  switch (hd) {
    REPRO_FLASH_BWD_CASE(16)
    REPRO_FLASH_BWD_CASE(32)
    REPRO_FLASH_BWD_CASE(64)
    REPRO_FLASH_BWD_CASE(128)
    REPRO_FLASH_BWD_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_BWD_CASE
}
