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
// with XLA). FlashAttention-2's split, with no atomics, so
// the same inputs give the same bits:
// - delta: D = rowsum(dO * O) in fp32, a group of hd / 8 lanes per row;
// - dK/dV: one CTA per (query head, 64-key tile, b) (and half of the head
//   dim at hd 256), heaviest causal tiles first; four warps of 16 keys each
//   sweep the query tiles that see the tile (cp.async, two stages). Per step
//   S^T = K Q^T and dP^T = V dO^T, P^T = exp(S^T - lse) from the forward's
//   log-sum-exp, dS^T = P^T (dP^T - D) (times the soft-cap's 1 - tanh^2 and
//   the scale), then dV += P^T dO and dK += dS^T Q with P and dS rounded to
//   bf16 as A operands straight from the accumulators. dK and dV stay in
//   fp32 registers and are written once: in bf16 where a kv head has one
//   query head, else as that head's fp32 part, and a fourth launch adds a
//   kv head's G parts in head order (a CTA per kv head looping over its
//   group would leave internvl2's training grid at 256 CTAs, all resident
//   and waiting on the heaviest causal tile's G x 64 steps);
// - dQ: one CTA per (q head, 64-query tile, b), heaviest causal tiles first;
//   four warps of 16 queries sweep the kv tiles the rows see (two stages):
//   S, dP and dS again, dQ += dS K in registers, written once.
// Every product is mma.sync m16n8k16 (bf16 operands through ldmatrix from
// padded rows, fp32 sums). Tiles outside the causal band or the window are
// never visited; masks run only on tiles that cross an edge. Rows past Sq
// and keys past Skv load as zeros and get P = 0.
// Bound on the card: operations, 5 products of 2 Sq Skv hd per head (halved
// by the causal mask), 0.152 ms at internvl2's (2, 4096, 14 on 2, 64); this
// design does 7 (S and dP twice) on mma.sync, below wgmma's rate. Measured by
// chip_smoke.py on an H100 80GB HBM3 at 700 W: 1.35 ms there, 2.84 ms at
// jamba's (1, 4096, 32 on 8, 128).

namespace bwd {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

template <int HD>
struct BCfg {
  static constexpr int LD = HD + 8;                 // row stride in shared memory (elements):
                                                    // ldmatrix rows on distinct banks
  static constexpr int KV_ROWS = 16 * WARPS;        // keys per dK/dV CTA
  static constexpr int BQ = HD >= 128 ? 32 : 64;    // queries per step of the dK/dV sweep
  static constexpr int HDO = HD > 128 ? 128 : HD;   // dK/dV columns per CTA (registers)
  static constexpr int NSPLIT = HD / HDO;
  static constexpr int Q_ROWS = 16 * WARPS;         // queries per dQ CTA
  static constexpr int BK = HD == 256 ? 32 : 64;    // keys per step of the dQ sweep
  static constexpr int KV_TILE = KV_ROWS * LD * 2;  // bytes
  static constexpr int QS_TILE = BQ * LD * 2;
  static constexpr int DKV_BYTES = 2 * KV_TILE + 4 * QS_TILE + 4 * BQ * 4;
  static constexpr int QT_TILE = Q_ROWS * LD * 2;
  static constexpr int KS_TILE = BK * LD * 2;
  static constexpr int DQ_BYTES = 2 * QT_TILE + 4 * KS_TILE + 2 * Q_ROWS * 4;
  // CTAs per SM the registers are capped for: 3 at hd <= 64 (168 registers a
  // thread, at most a 16-byte spill in ptxas' report, where uncapped the
  // dK/dV kernel held two CTAs an SM), else 1 (the accumulators need more
  // registers: capped, the wider head dims spill)
  static constexpr int MIN_CTAS = HD <= 64 ? 3 : 1;
};

struct BParams {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;  // (B, H, Sq)
  bf16 *dq, *dk, *dv;        // contiguous (B, Sq, H, hd) and (B, Skv, K, hd)
  float *part_k, *part_v;    // G > 1: each query head's dK, dV, (B, Skv, H, hd) fp32
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh;
  int H, K, G, Sq, Skv, q_offset, causal, window;
  float scale, softcap, inv_softcap;
};

// rows [row0, row0 + ROWS) of head `head` of a (B, S, heads, HD) tensor into a
// ROWS x LD tile, by cp.async; rows at or past S are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* base, long long sb,
                                          long long ss, long long sh, int b, int head, int row0,
                                          int S) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < S;
    const bf16* src = ok ? base + b * sb + (row0 + r) * ss + head * sh + c * 8 : base;
    repro::cp_async16(dst + (r * (HD + 8) + c * 8) * 2, src, ok ? 16 : 0);
  }
}

// lse (as exp2 units) and D of rows [q0, q0 + ROWS) of (b, h); +inf and 0 past Sq
template <int ROWS>
__device__ __forceinline__ void load_stats(float* sl, float* sd, const BParams& p, int b, int h,
                                           int q0) {
  constexpr float LOG2E_ = 1.4426950408889634f;
  const long long base = (static_cast<long long>(b) * p.H + h) * p.Sq;
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    const bool ok = q0 + i < p.Sq;
    sl[i] = ok ? p.lse[base + q0 + i] * LOG2E_ : INFINITY;
    sd[i] = ok ? p.delta[base + q0 + i] : 0.f;
  }
}

// A fragment (16 x 16) of rows row0.., columns col0.. of a row-major tile
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], uint32_t tile, int ld, int row0,
                                     int col0) {
  const int l = threadIdx.x % 32;
  repro::ldmatrix_x4(a, tile + ((row0 + l % 16) * ld + col0 + (l / 16) * 8) * 2);
}
// B fragments of two n8 blocks (n0.., n0 + 8..) over k0..k0 + 15 from a tile stored [n][k]
__device__ __forceinline__ void ld_b_nk(uint32_t (&b)[4], uint32_t tile, int ld, int n0,
                                        int k0) {
  const int l = threadIdx.x % 32, mi = l / 8;
  repro::ldmatrix_x4(b, tile + ((n0 + (mi >> 1) * 8 + l % 8) * ld + k0 + (mi & 1) * 8) * 2);
}
// the same from a tile stored [k][n] (transposed on the load)
__device__ __forceinline__ void ld_b_kn(uint32_t (&b)[4], uint32_t tile, int ld, int k0,
                                        int n0) {
  const int l = threadIdx.x % 32, mi = l / 8;
  repro::ldmatrix_x4_trans(b, tile + ((k0 + (mi & 1) * 8 + l % 8) * ld + n0 + (mi >> 1) * 8) * 2);
}
// accumulator n8 blocks 2j and 2j + 1 as the A fragment of k-chunk j, in bf16
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[N][4], int j) {
  a[0] = repro::pack_bf16(c[2 * j][0], c[2 * j][1]);
  a[1] = repro::pack_bf16(c[2 * j][2], c[2 * j][3]);
  a[2] = repro::pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = repro::pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// key `key` visible to query row `qi` (qi < Sq, key < Skv, the masks)
__device__ __forceinline__ bool visible(const BParams& p, int qi, int key) {
  const int pos = qi + p.q_offset;
  return qi < p.Sq && key < p.Skv && (!p.causal || key <= pos) &&
         (p.window <= 0 || key > pos - p.window);
}

// From the score s (Q K^T, unscaled) and dP of one (query, key): P into s and
// dS (the scale and the soft-cap's derivative applied) into dp.
__device__ __forceinline__ void grad_entry(float& s, float& dp, float lse2, float d,
                                           const BParams& p, bool ok) {
  constexpr float LOG2E_ = 1.4426950408889634f;
  float x = s * p.scale, t = 0.f;
  if (p.softcap > 0.f) {
    t = tanhf(x * p.inv_softcap);
    x = p.softcap * t;
  }
  const float pr = ok ? exp2f(x * LOG2E_ - lse2) : 0.f;
  float ds = pr * (dp - d);
  if (p.softcap > 0.f) ds *= 1.f - t * t;
  s = pr;
  dp = ds * p.scale;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, BCfg<HD>::MIN_CTAS)
flash_bwd_dkdv_kernel(const BParams p) {
  using C = BCfg<HD>;
  using namespace repro;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sK = smem_u32(smem), sV = sK + C::KV_TILE, sQ0 = sV + C::KV_TILE;
  float* rows0 = reinterpret_cast<float*>(smem + 2 * C::KV_TILE + 4 * C::QS_TILE);
  const int split = blockIdx.x % C::NSPLIT, h = blockIdx.x / C::NSPLIT, kvh = h / p.G;
  const int k0 = blockIdx.y * C::KV_ROWS, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  // the queries that see a key of this tile, in BQ-row tiles
  const int q_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int q_hi = p.window > 0 ? min(p.Sq, k0 + C::KV_ROWS - 1 + p.window - p.q_offset) : p.Sq;
  const int qt0 = q_lo / C::BQ;
  const int steps = q_hi > q_lo ? (q_hi + C::BQ - 1) / C::BQ - qt0 : 0;

  load_rows<HD, C::KV_ROWS>(sK, p.k, p.k_sb, p.k_ss, p.k_sh, b, kvh, k0, p.Skv);
  load_rows<HD, C::KV_ROWS>(sV, p.v, p.v_sb, p.v_ss, p.v_sh, b, kvh, k0, p.Skv);
  auto issue = [&](int i) {  // step i: query tile qt0 + i
    const int s = i & 1, q0 = (qt0 + i) * C::BQ;
    const uint32_t sq = sQ0 + s * 2 * C::QS_TILE;
    load_rows<HD, C::BQ>(sq, p.q, p.q_sb, p.q_ss, p.q_sh, b, h, q0, p.Sq);
    load_rows<HD, C::BQ>(sq + C::QS_TILE, p.dout, p.d_sb, p.d_ss, p.d_sh, b, h, q0, p.Sq);
    load_stats<C::BQ>(rows0 + s * 2 * C::BQ, rows0 + s * 2 * C::BQ + C::BQ, p, b, h, q0);
  };
  if (steps > 0) issue(0);
  cp_async_commit();

  float dk[C::HDO / 8][4], dv[C::HDO / 8][4];
#pragma unroll
  for (int n = 0; n < C::HDO / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int key_a = k0 + warp * 16 + g;  // this thread's keys: key_a (c0, c1), key_a + 8 (c2, c3)

  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int s = i & 1, q0 = (qt0 + i) * C::BQ;
    const uint32_t sQ = sQ0 + s * 2 * C::QS_TILE, sO = sQ + C::QS_TILE;
    const float* sl = rows0 + s * 2 * C::BQ;
    const float* sd = sl + C::BQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
    float st[C::BQ / 8][4], dp[C::BQ / 8][4];
#pragma unroll
    for (int n = 0; n < C::BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ak[4], av[4];
      ld_a(ak, sK, C::LD, warp * 16, kk * 16);
      ld_a(av, sV, C::LD, warp * 16, kk * 16);
#pragma unroll
      for (int np = 0; np < C::BQ / 16; ++np) {
        uint32_t bq[4], bo[4];
        ld_b_nk(bq, sQ, C::LD, np * 16, kk * 16);
        ld_b_nk(bo, sO, C::LD, np * 16, kk * 16);
        mma_bf16(st[2 * np], ak, bq[0], bq[1]);
        mma_bf16(st[2 * np + 1], ak, bq[2], bq[3]);
        mma_bf16(dp[2 * np], av, bo[0], bo[1]);
        mma_bf16(dp[2 * np + 1], av, bo[2], bo[3]);
      }
    }
    // P^T and dS^T; the mask only where the tile pair crosses an edge
    const bool need_mask = q0 + C::BQ > p.Sq || k0 + C::KV_ROWS > p.Skv ||
                           (p.causal && k0 + C::KV_ROWS - 1 > q0 + p.q_offset) ||
                           (p.window > 0 && k0 <= q0 + C::BQ - 1 + p.q_offset - p.window);
#pragma unroll
    for (int n = 0; n < C::BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1);
        const bool ok = !need_mask || visible(p, q0 + ql, key_a + 8 * (e >> 1));
        grad_entry(st[n][e], dp[n][e], sl[ql], sd[ql], p, ok);
      }
    // dV += P^T dO and dK += dS^T Q over the BQ queries, this CTA's columns
#pragma unroll
    for (int j = 0; j < C::BQ / 16; ++j) {
      uint32_t ap[4], as[4];
      acc_to_a(ap, st, j);
      acc_to_a(as, dp, j);
#pragma unroll
      for (int cp = 0; cp < C::HDO / 16; ++cp) {
        uint32_t bo[4], bq[4];
        const int col = split * C::HDO + cp * 16;
        ld_b_kn(bo, sO, C::LD, j * 16, col);
        ld_b_kn(bq, sQ, C::LD, j * 16, col);
        mma_bf16(dv[2 * cp], ap, bo[0], bo[1]);
        mma_bf16(dv[2 * cp + 1], ap, bo[2], bo[3]);
        mma_bf16(dk[2 * cp], as, bq[0], bq[1]);
        mma_bf16(dk[2 * cp + 1], as, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage is reloaded by the next step's issue
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_a + 8 * half;
    if (key >= p.Skv) continue;
    const long long row = static_cast<long long>(b) * p.Skv + key;
    if (p.G == 1) {
      const long long off = (row * p.K + kvh) * HD + split * C::HDO + 2 * t;
#pragma unroll
      for (int n = 0; n < C::HDO / 8; ++n) {
        *reinterpret_cast<uint32_t*>(p.dk + off + n * 8) =
            pack_bf16(dk[n][2 * half], dk[n][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(p.dv + off + n * 8) =
            pack_bf16(dv[n][2 * half], dv[n][2 * half + 1]);
      }
    } else {
      const long long off = (row * p.H + h) * HD + split * C::HDO + 2 * t;
#pragma unroll
      for (int n = 0; n < C::HDO / 8; ++n) {
        *reinterpret_cast<float2*>(p.part_k + off + n * 8) =
            make_float2(dk[n][2 * half], dk[n][2 * half + 1]);
        *reinterpret_cast<float2*>(p.part_v + off + n * 8) =
            make_float2(dv[n][2 * half], dv[n][2 * half + 1]);
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
__global__ void __launch_bounds__(THREADS, BCfg<HD>::MIN_CTAS)
flash_bwd_dq_kernel(const BParams p) {
  using C = BCfg<HD>;
  using namespace repro;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem), sO = sQ + C::QT_TILE, sK0 = sO + C::QT_TILE;
  float* sl = reinterpret_cast<float*>(smem + 2 * C::QT_TILE + 4 * C::KS_TILE);
  float* sd = sl + C::Q_ROWS;
  const int h = blockIdx.x, b = blockIdx.z, kvh = h / p.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::Q_ROWS;  // heaviest causal tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  const int qpos_lo = q0 + p.q_offset, qpos_hi = min(q0 + C::Q_ROWS, p.Sq) - 1 + p.q_offset;
  const int kv_end = p.causal ? min(p.Skv, qpos_hi + 1) : p.Skv;
  const int kv_begin = p.window > 0 ? max(0, qpos_lo - p.window + 1) : 0;
  const int kt0 = kv_begin / C::BK;
  const int steps = kv_end > kv_begin ? (kv_end + C::BK - 1) / C::BK - kt0 : 0;

  load_rows<HD, C::Q_ROWS>(sQ, p.q, p.q_sb, p.q_ss, p.q_sh, b, h, q0, p.Sq);
  load_rows<HD, C::Q_ROWS>(sO, p.dout, p.d_sb, p.d_ss, p.d_sh, b, h, q0, p.Sq);
  load_stats<C::Q_ROWS>(sl, sd, p, b, h, q0);
  auto issue = [&](int i) {
    const uint32_t sk = sK0 + (i & 1) * 2 * C::KS_TILE;
    const int j0 = (kt0 + i) * C::BK;
    load_rows<HD, C::BK>(sk, p.k, p.k_sb, p.k_ss, p.k_sh, b, kvh, j0, p.Skv);
    load_rows<HD, C::BK>(sk + C::KS_TILE, p.v, p.v_sb, p.v_ss, p.v_sh, b, kvh, j0, p.Skv);
  };
  if (steps > 0) issue(0);
  cp_async_commit();

  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const int row_a = warp * 16 + g;  // this thread's rows: row_a (c0, c1), row_a + 8 (c2, c3)

  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int j0 = (kt0 + i) * C::BK;
    const uint32_t sK = sK0 + (i & 1) * 2 * C::KS_TILE, sV = sK + C::KS_TILE;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x BK keys
    float sc[C::BK / 8][4], dp[C::BK / 8][4];
#pragma unroll
    for (int n = 0; n < C::BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ld_a(aq, sQ, C::LD, warp * 16, kk * 16);
      ld_a(ao, sO, C::LD, warp * 16, kk * 16);
#pragma unroll
      for (int np = 0; np < C::BK / 16; ++np) {
        uint32_t bk[4], bv[4];
        ld_b_nk(bk, sK, C::LD, np * 16, kk * 16);
        ld_b_nk(bv, sV, C::LD, np * 16, kk * 16);
        mma_bf16(sc[2 * np], aq, bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * np], ao, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }
    const bool need_mask = j0 + C::BK > p.Skv || q0 + C::Q_ROWS > p.Sq ||
                           (p.causal && j0 + C::BK - 1 > qpos_lo) ||
                           (p.window > 0 && j0 <= qpos_hi - p.window);
    const float l_a = sl[row_a], l_b = sl[row_a + 8], d_a = sd[row_a], d_b = sd[row_a + 8];
#pragma unroll
    for (int n = 0; n < C::BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const bool ok = !need_mask || visible(p, q0 + row_a + 8 * hi, j0 + n * 8 + 2 * t + (e & 1));
        grad_entry(sc[n][e], dp[n][e], hi ? l_b : l_a, hi ? d_b : d_a, p, ok);
      }
    // dQ += dS K over the BK keys
#pragma unroll
    for (int j = 0; j < C::BK / 16; ++j) {
      uint32_t as[4];
      acc_to_a(as, dp, j);
#pragma unroll
      for (int cp = 0; cp < HD / 16; ++cp) {
        uint32_t bk[4];
        ld_b_kn(bk, sK, C::LD, j * 16, cp * 16);
        mma_bf16(dq[2 * cp], as, bk[0], bk[1]);
        mma_bf16(dq[2 * cp + 1], as, bk[2], bk[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + row_a + 8 * half;
    if (qi >= p.Sq) continue;
    const long long off = ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(p.dq + off + n * 8) =
          pack_bf16(dq[n][2 * half], dq[n][2 * half + 1]);
  }
}

// D = rowsum(dO * O) per (b, h, row) in fp32: hd / 8 lanes per row, 16 bytes each
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, Strides os, Strides ds, int H, int Sq,
                       long long rows) {
  constexpr int TPR = HD / 8;
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / TPR;
  const int c = threadIdx.x % TPR;
  float acc = 0.f;
  if (row < rows) {
    const int i = static_cast<int>(row % Sq);
    const long long bh = row / Sq;
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
  if (row < rows && c == 0) delta[row] = acc;
}

template <int HD>
int launch_backward(const BParams& p, const void* out, Strides os, Strides ds, float* delta,
                    int B, cudaStream_t stream) {
  using C = BCfg<HD>;
  cudaError_t err;
  if ((err = repro::allow_smem(flash_bwd_dkdv_kernel<HD>, C::DKV_BYTES)) != cudaSuccess ||
      (err = repro::allow_smem(flash_bwd_dq_kernel<HD>, C::DQ_BYTES)) != cudaSuccess)
    return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * p.H * p.Sq;
  if (rows > 0) {
    const long long threads = rows * (HD / 8);
    flash_bwd_delta_kernel<HD><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
        static_cast<const bf16*>(out), p.dout, delta, os, ds, p.H, p.Sq, rows);
  }
  const dim3 kv_grid(p.H * C::NSPLIT, (p.Skv + C::KV_ROWS - 1) / C::KV_ROWS, B);
  flash_bwd_dkdv_kernel<HD><<<kv_grid, THREADS, C::DKV_BYTES, stream>>>(p);
  if (p.G > 1) {
    const long long n4 = static_cast<long long>(B) * p.Skv * p.K * (HD / 4);
    flash_bwd_dkdv_sum_kernel<HD><<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, stream>>>(
        p, n4);
  }
  if (p.Sq > 0) {
    const dim3 q_grid(p.H, (p.Sq + C::Q_ROWS - 1) / C::Q_ROWS, B);
    flash_bwd_dq_kernel<HD><<<q_grid, THREADS, C::DQ_BYTES, stream>>>(p);
  }
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
// delta is (B, H, Sq) fp32 scratch; where H > K, part_k and part_v are (B,
// Skv, H, hd) fp32 scratch, else unread. Three launches on `stream`, four
// where H > K.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, void* part_k, void* part_v,
    int B, int H, int K, int Sq,
    int Skv, int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long d_sb, long long d_ss,
    long long d_sh, float scale, int causal, int window, float softcap, void* stream) {
  if (B <= 0) return 0;
  if (Skv <= 0 || Sq < 0 || K <= 0 || H % K != 0 || B > 65535 || (Skv + 63) / 64 > 65535 ||
      (Sq + 63) / 64 > 65535 || (H > K && (part_k == nullptr || part_v == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bwd::BParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                       static_cast<const float*>(lse), static_cast<const float*>(delta),
                       static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                       static_cast<float*>(part_k), static_cast<float*>(part_v),
                       q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh,
                       H, K, H / K, Sq, Skv, Skv - Sq, causal, window, scale, softcap,
                       softcap > 0.f ? 1.f / softcap : 0.f};
  const Strides os{o_sb, o_ss, o_sh}, ds{d_sb, d_ss, d_sh};
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return bwd::launch_backward<16>(p, out, os, ds, dl, B, s);
    case 32: return bwd::launch_backward<32>(p, out, os, ds, dl, B, s);
    case 64: return bwd::launch_backward<64>(p, out, os, ds, dl, B, s);
    case 128: return bwd::launch_backward<128>(p, out, os, ds, dl, B, s);
    case 256: return bwd::launch_backward<256>(p, out, os, ds, dl, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
