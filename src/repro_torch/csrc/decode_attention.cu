// GQA decode attention for Hopper: one new query token per sequence against
// the KV cache, keys 0..pos visible (one scalar pos for the whole batch),
// optional gemma2 soft-capping.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py
// decode_attention_kernel / decode_attention_pallas.
//
// Bound on the card: bytes. Every visible cache entry is read once and used
// for G query heads only, so the kernel does about G operations per byte,
// far below what the tensor cores need. With batch 4 and 2 kv heads a design
// with one block per (b, kv head) would keep 8 of the 132 SMs busy, so the
// keys are split across blocks (flash-decoding): pass 1 runs one block per
// (b, kv head, 64-key chunk), stages the chunk's K and V in shared memory as
// fp32, scores it for the G query heads of that kv head and writes a partial
// (max, sum, unnormalised output); pass 2 merges the partials of each
// (b, head) with the usual log-sum-exp rescaling. Only the chunks that hold
// keys <= pos are launched, so the bytes read grow with pos and not with the
// cache's capacity. The kernel reads the model's (B, S, K, hd) cache through
// strides: the Pallas wrapper's swap to (B, K, S, hd), which copied every
// layer's cache on every step, is gone.

#include "common.cuh"

namespace {

using repro::bf16;

constexpr int CHUNK = 64;  // keys per block in pass 1
constexpr int kThreads = 128;

template <int HD>
__host__ __device__ constexpr int ldk() { return HD + 1; }  // conflict-free fp32 rows

// Shared memory of pass 1 in bytes: q (G, hd), K and V chunks, scores (G, CHUNK).
long long partial_smem(int G, int hd) {
  return static_cast<long long>(sizeof(float)) *
         (static_cast<long long>(G) * hd + 2LL * CHUNK * (hd + 1) + static_cast<long long>(G) * CHUNK);
}

struct CacheStrides {
  long long b, s, h;
};

template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* tile, const T* src, CacheStrides st, int b,
                                           int kvh, int j0, int nj) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = HD / VEC;
  for (int idx = threadIdx.x; idx < nj * CH; idx += kThreads) {
    const int j = idx / CH, c = idx % CH;
    uint4 raw =
        *reinterpret_cast<const uint4*>(src + b * st.b + (j0 + j) * st.s + kvh * st.h + c * VEC);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) tile[j * ldk<HD>() + c * VEC + i] = repro::to_f32(e[i]);
  }
}

// Pass 1. grid = (B * K, nsplit). Partials are indexed by ((b*H + h) * nsplit + split).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      float* __restrict__ o_part, float* __restrict__ m_part,
                      float* __restrict__ l_part, int H, int G, int n_valid, long long q_sb,
                      long long q_sh, CacheStrides ks, CacheStrides vs, float scale,
                      float softcap) {
  extern __shared__ __align__(16) float smem_f[];
  const int K = H / G;
  const int b = blockIdx.x / K, kvh = blockIdx.x % K;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int j0 = split * CHUNK;
  const int nj = min(CHUNK, n_valid - j0);  // >= 1 by construction of the grid

  float* sq = smem_f;                       // (G, HD)
  float* sk = sq + G * HD;                  // (CHUNK, HD + 1)
  float* sv = sk + CHUNK * ldk<HD>();       // (CHUNK, HD + 1)
  float* ss = sv + CHUNK * ldk<HD>();       // (G, CHUNK) scores, then probabilities

  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    sq[idx] = repro::to_f32(q[b * q_sb + (kvh * G + g) * q_sh + d]);
  }
  stage_rows<T, HD>(sk, k, ks, b, kvh, j0, nj);
  stage_rows<T, HD>(sv, v, vs, b, kvh, j0, nj);
  __syncthreads();

  // scores: consecutive threads take consecutive keys of one query head
  for (int idx = threadIdx.x; idx < G * CHUNK; idx += kThreads) {
    const int g = idx / CHUNK, j = idx % CHUNK;
    float s = -INFINITY;
    if (j < nj) {
      const float* qg = sq + g * HD;
      const float* kj = sk + j * ldk<HD>();
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += qg[d] * kj[d];
      s = dot * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
    }
    ss[idx] = s;
  }
  __syncthreads();

  // partial softmax: one warp per query head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += kThreads / 32) {
    float* sg = ss + g * CHUNK;
    float m = -INFINITY;
    for (int j = lane; j < CHUNK; j += 32) m = fmaxf(m, sg[j]);
    m = repro::warp_max(m);  // finite: the chunk holds at least one key
    float sum = 0.f;
    for (int j = lane; j < CHUNK; j += 32) {
      const float p = j < nj ? expf(sg[j] - m) : 0.f;
      sg[j] = p;
      sum += p;
    }
    sum = repro::warp_sum(sum);
    if (lane == 0) {
      const long long slot = (static_cast<long long>(b) * H + kvh * G + g) * nsplit + split;
      m_part[slot] = m;
      l_part[slot] = sum;
    }
  }
  __syncthreads();

  // unnormalised partial output: consecutive threads take consecutive dims
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    const float* pg = ss + g * CHUNK;
    float acc = 0.f;
    for (int j = 0; j < nj; ++j) acc += pg[j] * sv[j * ldk<HD>() + d];
    const long long slot = (static_cast<long long>(b) * H + kvh * G + g) * nsplit + split;
    o_part[slot * HD + d] = acc;
  }
}

// Pass 2. grid = B * H, block = HD threads; out is (B, H, HD) contiguous.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ o_part,
                                      const float* __restrict__ m_part,
                                      const float* __restrict__ l_part, T* __restrict__ out,
                                      int HD, int nsplit) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* m = m_part + bh * nsplit;
  const float* l = l_part + bh * nsplit;
  float M = -INFINITY;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, m[s]);
  float L = 0.f, acc = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(m[s] - M);
    L += l[s] * w;
    acc += o_part[(bh * nsplit + s) * HD + d] * w;
  }
  out[bh * HD + d] = repro::from_f32<T>(acc / fmaxf(L, 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* scratch, int B,
           int H, int K, int n_valid, long long q_sb, long long q_sh, CacheStrides ks,
           CacheStrides vs, float scale, float softcap, cudaStream_t stream) {
  const int G = H / K;
  const int nsplit = (n_valid + CHUNK - 1) / CHUNK;
  const long long rows = static_cast<long long>(B) * H * nsplit;
  float* o_part = scratch;
  float* m_part = o_part + rows * HD;
  float* l_part = m_part + rows;
  const size_t smem = static_cast<size_t>(partial_smem(G, HD));
  cudaError_t err = repro::allow_smem(decode_partial_kernel<T, HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_partial_kernel<T, HD><<<dim3(B * K, nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), o_part,
      m_part, l_part, H, G, n_valid, q_sb, q_sh, ks, vs, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<B * H, HD, 0, stream>>>(o_part, m_part, l_part,
                                                     static_cast<T*>(out), HD, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out, float* scratch,
             int B, int H, int K, int n_valid, long long q_sb, long long q_sh, CacheStrides ks,
             CacheStrides vs, float scale, float softcap, cudaStream_t s) {
#define REPRO_DECODE_CASE(D) \
  case D:                    \
    return launch<T, D>(q, k, v, out, scratch, B, H, K, n_valid, q_sb, q_sh, ks, vs, scale, softcap, s);
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

}  // namespace

// Keys per pass-1 block. A call on n_valid keys runs nsplit = ceil(n_valid /
// CHUNK) blocks per (b, kv head) and needs B * H * nsplit * (hd + 2) floats of
// scratch from the wrapper: the partial outputs, then the maxima, then the sums.
extern "C" int decode_attention_chunk() { return CHUNK; }

// Shared memory of pass 1 in bytes (the wrapper refuses shapes above the
// card's 227 KB per block).
extern "C" long long decode_attention_smem(int G, int hd) { return partial_smem(G, hd); }

// q: (B, H, hd) with strides q_sb, q_sh; k/v: (B, S, K, hd) caches with strides
// (b, s, k); out: (B, H, hd) contiguous. Keys 0..n_valid-1 are attended.
extern "C" int decode_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                       void* out, void* scratch, int B, int H, int K,
                                       int n_valid, int hd, long long q_sb, long long q_sh,
                                       long long k_sb, long long k_ss, long long k_sh,
                                       long long v_sb, long long v_ss, long long v_sh,
                                       float scale, float softcap, void* stream) {
  if (B <= 0 || n_valid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const CacheStrides ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (dtype == kBFloat16)
    return dispatch<bf16>(hd, q, k, v, out, sc, B, H, K, n_valid, q_sb, q_sh, ks, vs, scale,
                          softcap, s);
  if (dtype == kFloat32)
    return dispatch<float>(hd, q, k, v, out, sc, B, H, K, n_valid, q_sb, q_sh, ks, vs, scale,
                           softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
