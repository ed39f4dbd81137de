// Staggered-cohort offload decisions over epochs for Hopper.
//
// Replaces: src/repro/kernels/decision_scan/decision_scan.py decision_scan_kernel /
// decision_scan_pallas, and with it the per-epoch decide step of
// src/repro/fleet/cluster.py (_decide_vec followed by the cohort gate).
//
// Per client i and epoch t, with g = t0 + t and column 0 the on-device cost:
//   choice = argmin_j costs[t, i, j] - 1   (the first NaN if a column is NaN, else the
//            first of equal minima; an all-+inf row gives column 0, on-device)
//   best   = min_j costs[t, i, j]           (NaN if a column is NaN)
//   prev_c = costs[t, i, prev + 1]          (the previous target's CURRENT cost)
//   keep   = g >= stagger && h > 0 && choice != prev && isfinite(prev_c)
//            && best > (1 - h) * prev_c     ((1 - h) taken in double, rounded once
//                                            to the cost type, as the reference does)
//   prev   = cohort[i] == g % stagger ? (keep ? prev : choice) : prev
//   out[t, i] = prev
// from prev = the caller's previous choices, or ON_DEVICE (-1).
//
// Bound on the card: bytes. Each cost is read once and takes one compare; the
// work is reading T * N * (E+1) costs and writing T * N int32 choices. The
// recursion is sequential in t through prev alone and independent across
// clients, so a group of G lanes (the power of two >= E+1, at most 32) owns one
// client for the whole sweep, prev in a register of every lane of the group.
// The (T, N, E+1) layout is read as it is (the TPU kernel's transpose to
// target-major is gone): at each epoch the rows of the warp's clients are
// adjacent in memory, so consecutive lanes read consecutive addresses; each
// lane keeps the best (value, index) of its columns, and shuffles within the
// group combine them. The combine is a minimum under one total order (NaN
// first, then the smaller value, then the lower index), so it gives the first
// NaN or the first of equal minima whatever the order of the reduction, which
// is what torch.argmin and jnp.argmin return. The TPU kernel's (blk_n, 1)
// VMEM carry across sequential t-blocks becomes the register loop; ragged N
// is masked in the kernel and nothing is padded or copied.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int ON_DEVICE = -1;

// true when (va, ia) comes before (vb, ib): NaN first, then the smaller value,
// then the lower index
template <typename T>
__device__ __forceinline__ bool before(T va, int ia, T vb, int ib) {
  const bool na = va != va, nb = vb != vb;
  if (na != nb) return na;
  if (!na && va != vb) return va < vb;
  return ia < ib;
}

template <typename T>
__device__ __forceinline__ bool finite(T x) {
  return x == x && x != static_cast<T>(INFINITY) && x != -static_cast<T>(INFINITY);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
decision_kernel(const T* __restrict__ costs, const int* __restrict__ cohort,
                const int* __restrict__ prev_in, int* __restrict__ out, long long n_epochs,
                long long n, int e1, long long t0, double h, int stagger, int g) {
  const int sub = threadIdx.x & (g - 1);  // lane within the client's group
  const long long client = (static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x) / g;
  const bool active = client < n;
  int prev = ON_DEVICE;
  long long coh = 0;
  if (active) {
    if (prev_in != nullptr) prev = prev_in[client];
    coh = cohort[client];
  }
  const bool hyst = h > 0.0;
  const T factor = static_cast<T>(1.0 - h);
  const long long step = n * e1;
  const T* row = costs + (active ? client * e1 : 0);

  for (long long t = 0; t < n_epochs; ++t, row += step) {
    T best = static_cast<T>(INFINITY);
    int best_j = INT_MAX;  // loses to every real column
    if (active) {
#pragma unroll 4
      for (int j = sub; j < e1; j += g) {
        const T v = row[j];
        if (before(v, j, best, best_j)) {
          best = v;
          best_j = j;
        }
      }
    }
    // every lane of the warp takes part in the shuffles; offsets below g stay
    // inside the group
    for (int o = g >> 1; o > 0; o >>= 1) {
      const T ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oj = __shfl_xor_sync(0xffffffffu, best_j, o);
      if (before(ov, oj, best, best_j)) {
        best = ov;
        best_j = oj;
      }
    }
    if (!active) continue;
    const long long gt = t0 + t;
    if (coh == gt % stagger) {
      const int choice = best_j - 1;
      bool keep = false;
      if (hyst && gt >= stagger && choice != prev) {
        // the wrapper refuses prev outside [-1, E); the guard only keeps a
        // bad argument from reading past the row
        const unsigned col = static_cast<unsigned>(prev + 1);
        if (col < static_cast<unsigned>(e1)) {
          const T pc = row[col];
          keep = finite(pc) && best > factor * pc;
        }
      }
      if (!keep) prev = choice;
    }
    if (sub == 0) out[t * n + client] = prev;
  }
}

template <typename T>
int launch(const void* costs, const void* cohort, const void* prev, void* out, long long n_epochs,
           long long n, int e1, long long t0, double h, int stagger, cudaStream_t stream) {
  int g = 1;
  while (g < e1 && g < 32) g <<= 1;
  const long long blocks = (n * g + BLOCK - 1) / BLOCK;
  decision_kernel<T><<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(
      static_cast<const T*>(costs), static_cast<const int*>(cohort),
      static_cast<const int*>(prev), static_cast<int*>(out), n_epochs, n, e1, t0, h, stagger, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// costs: (n_epochs, n, e1) contiguous, column 0 on-device; cohort, prev (or
// NULL for all ON_DEVICE): (n,) int32; out: (n_epochs, n) int32.
extern "C" int decision_scan_launch(int dtype, const void* costs, const void* cohort,
                                    const void* prev, void* out, long long n_epochs, long long n,
                                    int e1, long long t0, double h, int stagger, void* stream) {
  if (n_epochs <= 0 || n <= 0) return 0;
  if (e1 < 1 || stagger < 1 || t0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat64) return launch<double>(costs, cohort, prev, out, n_epochs, n, e1, t0, h,
                                               stagger, s);
  if (dtype == kFloat32) return launch<float>(costs, cohort, prev, out, n_epochs, n, e1, t0, h,
                                              stagger, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
