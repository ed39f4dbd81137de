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
//   TMA store, which clips rows >= Sq.
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
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int K, int Sq,
           int Skv, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
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
                 softcap > 0.f ? 1.f / softcap : 0.f};
  const dim3 grid(H, (Sq + C::BM - 1) / C::BM, B);
  flash_attention_kernel<HD><<<grid, C::THREADS, C::BYTES, stream>>>(qm, km, vm, om, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Sq, H, hd), k/v: (B, Skv, K, hd), out: (B, Sq, H, hd), all bf16 with
// unit stride on hd, 16-byte aligned; the other strides are in elements and
// multiples of 8.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int K, int Sq, int Skv, int hd,
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
#define REPRO_FLASH_CASE(D)                                                                   \
  case D:                                                                                     \
    return launch<D>(q, k, v, out, B, H, K, Sq, Skv, qs, ks, vs, os, scale, causal, window, \
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
