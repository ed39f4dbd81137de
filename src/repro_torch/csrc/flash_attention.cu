// Flash attention (prefill) for Hopper: online-softmax GQA attention with
// causal and sliding-window masks and gemma2 score soft-capping.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py
// flash_attention_kernel / flash_attention_pallas.
//
// Bound on the card: operations at long sequences (4 * Sq * Skv * hd per head,
// halved by the causal mask, on the bf16 tensor cores), bytes at short ones
// (q, k, v and the output are each touched once). Design: one block of four
// warps per (b, q-head, 64-query tile). The block walks the kv tiles of 64
// keys that its causal / window band reaches; K and V tiles are staged in
// shared memory, S = Q K^T and O += P V run on the tensor cores (WMMA, bf16 in,
// fp32 accumulate), and each warp keeps the running max, sum and fp32 output
// of its own 16 query rows in shared memory, so only the K/V staging needs
// block-wide barriers. Where the Pallas kernel carried m, l and acc in VMEM
// across sequential grid steps, the kv sweep here is a loop inside the block.
// GQA reads kv head h / G. The kernel reads the model's (B, S, heads, hd)
// layout through strides (no transposes) and masks ragged tails itself, so
// prompt lengths need not be multiples of the tile.
// Semantics follow the Pallas kernel: queries are the tail of the keys
// (q_offset = Skv - Sq), key k is visible to query q when k <= q (causal) and
// k > q - window (window > 0); scores are scaled, then soft-capped, then
// masked; the output is acc / max(l, 1e-30). Masked scores contribute exactly
// zero probability here, which equals the Pallas result whenever a row sees
// at least one key (always, for Sq <= Skv).

#include <mma.h>

#include "common.cuh"

namespace {

using repro::bf16;
using namespace nvcuda;

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BK = 64;        // keys per kv tile
constexpr int kThreads = 128;
constexpr int LDS = BK + 4;   // fp32 score row stride
constexpr int LDP = BK + 8;   // bf16 probability row stride

template <int HD>
struct Smem {
  static constexpr int LDQ = HD + 8;  // bf16 row stride of the Q/K/V tiles
  static constexpr int LDO = HD + 4;  // fp32 row stride of the output accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * BQ * LDQ;
  static constexpr size_t v = k + sizeof(bf16) * BK * LDQ;
  static constexpr size_t s = v + sizeof(bf16) * BK * LDQ;
  static constexpr size_t p = s + sizeof(float) * BQ * LDS;
  static constexpr size_t o = p + sizeof(bf16) * BQ * LDP;
  static constexpr size_t m = o + sizeof(float) * BQ * LDO;
  static constexpr size_t l = m + sizeof(float) * BQ;
  static constexpr size_t bytes = l + sizeof(float) * BQ;
};

struct Strides {
  long long b, s, h;
};

// Stage `rows` rows of HD bf16 starting at sequence index `row0` into a
// shared tile with row stride ld; rows at or past `limit` are zero-filled.
template <int HD>
__device__ __forceinline__ void stage_tile(bf16* tile, int ld, const bf16* src, Strides st,
                                           int b, int head, int row0, int rows, int limit) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * CH; idx += kThreads) {
    const int r = idx / CH, c = idx % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit) {
      val = *reinterpret_cast<const uint4*>(src + b * st.b + (row0 + r) * st.s + head * st.h +
                                            c * 8);
    }
    *reinterpret_cast<uint4*>(tile + r * ld + c * 8) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int Sq, int Skv,
                       int G, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                       int causal, int window, float softcap) {
  using L = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sk = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  bf16* sp = reinterpret_cast<bf16*>(smem + L::p);
  float* so = reinterpret_cast<float*>(smem + L::o);
  float* sm = reinterpret_cast<float*>(smem + L::m);
  float* sl = reinterpret_cast<float*>(smem + L::l);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_offset = Skv - Sq;

  stage_tile<HD>(sq, L::LDQ, q, qs, b, h, q0, BQ, Sq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += kThreads) so[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    sm[i] = -INFINITY;
    sl[i] = 0.f;
  }

  // kv range this tile's rows can see (block-level skipping of dead tiles)
  const int qpos_lo = q0 + q_offset;
  const int qpos_hi = min(q0 + BQ, Sq) - 1 + q_offset;
  const int kv_end = causal ? min(Skv, qpos_hi + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, qpos_lo - window + 1) : 0;

  // softmax ownership: lane pair (2r, 2r+1) owns row warp*16 + r, one half of its keys each
  const int row = warp * 16 + lane / 2;
  const int hsel = lane % 2;
  const int q_pos = q0 + row + q_offset;

  for (int kt = kv_begin / BK; kt * BK < kv_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_tile<HD>(sk, L::LDQ, k, ks, b, kvh, k0, BK, Skv);
    stage_tile<HD>(sv, L::LDQ, v, vs, b, kvh, k0, BK, Skv);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int nb = 0; nb < BK / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, sq + warp * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::load_matrix_sync(bt, sk + nb * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(ss + warp * 16 * LDS + nb * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on the warp's rows
    float* srow = ss + row * LDS;
    float tile_max = -INFINITY;
    for (int jj = 0; jj < BK / 2; ++jj) {
      const int j = hsel * (BK / 2) + jj;
      const int key = k0 + j;
      float s = srow[j] * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      bool ok = key < Skv;
      if (causal) ok = ok && key <= q_pos;
      if (window > 0) ok = ok && key > q_pos - window;
      s = ok ? s : -INFINITY;
      srow[j] = s;
      tile_max = fmaxf(tile_max, s);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_old = sm[row];
    const float m_new = fmaxf(m_old, tile_max);
    const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
    float psum = 0.f;
    for (int jj = 0; jj < BK / 2; ++jj) {
      const int j = hsel * (BK / 2) + jj;
      const float s = srow[j];
      const float p = s == -INFINITY ? 0.f : expf(s - m_new);
      sp[row * LDP + j] = __float2bfloat16(p);
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    float* orow = so + row * L::LDO;
    for (int d = hsel * (HD / 2); d < (hsel + 1) * (HD / 2); ++d) orow[d] *= alpha;
    __syncwarp();
    if (hsel == 0) {
      sm[row] = m_new;
      sl[row] = sl[row] * alpha + psum;
    }
    __syncwarp();

    // O += P V for this warp's rows
#pragma unroll
    for (int nb = 0; nb < HD / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, so + warp * 16 * L::LDO + nb * 16, L::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sp + warp * 16 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(bv, sv + kk * 16 * L::LDQ + nb * 16, L::LDQ);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(so + warp * 16 * L::LDO + nb * 16, acc, L::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // epilogue: each warp writes its own rows, 8 bf16 per 16-byte store
  constexpr int CH = HD / 8;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = warp * 16 + idx / CH, c = idx % CH;
    if (q0 + r >= Sq) continue;
    const float inv = 1.f / fmaxf(sl[r], 1e-30f);
    uint4 packed;
    bf16* pv = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int i = 0; i < 8; ++i) pv[i] = __float2bfloat16(so[r * L::LDO + c * 8 + i] * inv);
    *reinterpret_cast<uint4*>(out + b * os.b + (q0 + r) * os.s + h * os.h + c * 8) = packed;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int K, int Sq,
           int Skv, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
  const size_t smem = Smem<HD>::bytes;
  cudaError_t err = repro::allow_smem(flash_attention_kernel<HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Sq, Skv, H / K, qs, ks, vs, os, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Sq, H, hd), k/v: (B, Skv, K, hd), out: (B, Sq, H, hd), all bf16 with
// unit stride on hd; the other strides are in elements and multiples of 8.
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
