// Batched FCFS station departures (Lindley recursion) for Hopper.
//
// Replaces: src/repro/kernels/lindley_scan/lindley_scan.py lindley_scan_kernel /
// lindley_scan_pallas (k = 1), and the k-server scan of
// src/repro/fleet/sim_vec.py _lindley_station_jit, which no Pallas kernel covers.
//
//   k = 1:      dep_i = max(arr_i, dep_{i-1}) + svc_i, the clock starting at -inf;
//   k servers:  each job starts on the first free server of lowest index
//               (argmin over the row's k_max free times, +inf for slots >= k_row),
//               at max(arr_i, free), and that server is then free at its departure.
//
// Bound on the card: bytes. Each job is one max and one add, so the work is
// reading arrivals and services once and writing departures once: 3 * B * T
// elements over 3.35 TB/s. The recursion is sequential along T and
// independent across rows, so the design is one thread per scenario row with
// its clock (or its k_max free times, in local memory) in registers for the
// whole sweep. A thread reading its own row column by column would make a
// warp touch 32 rows at once, 32 separate segments per load; instead a warp
// owns 32 rows and stages (32, TILE) tiles of arrivals and services in shared
// memory, loading each row's columns with consecutive lanes on consecutive
// addresses, and writes the departures back the same way. The row stride in
// shared memory is TILE + 1 elements, so the 32 lanes reading "their" column
// hit distinct banks. Ragged B and T are masked in the kernel: nothing is
// padded or copied. The TPU kernel's (blk_b, 1) clock carried across
// sequential t-blocks becomes the register clock of a loop inside the block.
// The max propagates NaN like torch.maximum, so the kernel and the plain
// version agree bit for bit on every input.

#include "common.cuh"

namespace {

constexpr int ROWS = 32;   // one warp per block, one thread per row
constexpr int TILE = 128;  // columns staged per pass
constexpr int LD = TILE + 1;
constexpr int KMAX = 64;   // most servers a k-server row may have

template <typename T>
__device__ __forceinline__ T max_nan(T a, T c) {
  return (a > c || a != a) ? a : c;
}

template <typename T>
size_t smem_bytes() {
  return 3 * static_cast<size_t>(ROWS) * LD * sizeof(T);
}

template <typename T, bool KSERVER>
__global__ void __launch_bounds__(ROWS)
lindley_kernel(const T* __restrict__ arr, const T* __restrict__ svc, const int* __restrict__ k,
               T* __restrict__ dep, long long B, long long n, int k_max) {
  extern __shared__ unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* ss = sa + ROWS * LD;
  T* sd = ss + ROWS * LD;
  const int lane = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(B - row0 < ROWS ? B - row0 : ROWS);

  T clk = static_cast<T>(-INFINITY);
  T free_at[KSERVER ? KMAX : 1];
  if (KSERVER) {
    const int kr = lane < rows ? k[row0 + lane] : 0;
    for (int q = 0; q < k_max; ++q) free_at[q] = q < kr ? T(0) : static_cast<T>(INFINITY);
  }

  for (long long t0 = 0; t0 < n; t0 += TILE) {
    const int cols = static_cast<int>(n - t0 < TILE ? n - t0 : TILE);
    for (int r = 0; r < rows; ++r) {
      const long long base = (row0 + r) * n + t0;
#pragma unroll 4
      for (int c = lane; c < cols; c += ROWS) {
        sa[r * LD + c] = arr[base + c];
        ss[r * LD + c] = svc[base + c];
      }
    }
    __syncwarp();
    if (lane < rows) {
      const T* a = sa + lane * LD;
      const T* s = ss + lane * LD;
      T* d = sd + lane * LD;
      for (int c = 0; c < cols; ++c) {
        if (KSERVER) {
          int idx = 0;
          T best = free_at[0];
          for (int q = 1; q < k_max; ++q) {
            if (free_at[q] < best) {
              best = free_at[q];
              idx = q;
            }
          }
          const T out = max_nan(a[c], best) + s[c];
          free_at[idx] = out;
          d[c] = out;
        } else {
          clk = max_nan(a[c], clk) + s[c];
          d[c] = clk;
        }
      }
    }
    __syncwarp();
    for (int r = 0; r < rows; ++r) {
      const long long base = (row0 + r) * n + t0;
#pragma unroll 4
      for (int c = lane; c < cols; c += ROWS) dep[base + c] = sd[r * LD + c];
    }
    __syncwarp();
  }
}

template <typename T, bool KSERVER>
int launch(const void* arr, const void* svc, const void* k, void* dep, long long B, long long n,
           int k_max, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = repro::allow_smem(lindley_kernel<T, KSERVER>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (B + ROWS - 1) / ROWS;
  lindley_kernel<T, KSERVER><<<static_cast<unsigned>(blocks), ROWS, smem, stream>>>(
      static_cast<const T*>(arr), static_cast<const T*>(svc), static_cast<const int*>(k),
      static_cast<T*>(dep), B, n, k_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lindley_kmax() { return KMAX; }

// arr, svc, dep: (B, n) contiguous rows of one dtype (the wrapper checks).
extern "C" int lindley_scan_launch(int dtype, const void* arr, const void* svc, void* dep,
                                   long long B, long long n, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat64) return launch<double, false>(arr, svc, nullptr, dep, B, n, 1, s);
  if (dtype == kFloat32) return launch<float, false>(arr, svc, nullptr, dep, B, n, 1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// k: (B,) int32 server counts; slots >= min(k_row, k_max) never serve.
extern "C" int lindley_kserver_launch(int dtype, const void* arr, const void* svc, const void* k,
                                      void* dep, long long B, long long n, int k_max,
                                      void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (k_max < 1 || k_max > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat64) return launch<double, true>(arr, svc, k, dep, B, n, k_max, s);
  if (dtype == kFloat32) return launch<float, true>(arr, svc, k, dep, B, n, k_max, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
