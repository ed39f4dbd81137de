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
// independent across rows, and a max-plus scan chunked along T would
// reassociate the sums, so one thread runs each row's recursion, its clock
// (or its servers' free times) in registers for the whole sweep. The chain
// of dependent compare-select-adds is far shorter than the byte bound; what
// held the first design back was that one warp loaded a tile, ran the chain
// and stored the tile in turn, so nothing was in flight while the chain ran.
//
// This design: a CTA owns 32 rows. One consumer warp (a lane per row) runs
// the recursion out of a ring of STAGES stages of (32, TILE) arrival and
// service tiles in shared memory; two producer warps (a thread per column of
// a tile) keep the next stages' loads in flight with cp.async, each thread
// arriving on the stage's `full` mbarrier once its copies land, and write
// finished departures back, coalesced (a warp stores 32 consecutive columns
// of one row). The consumer writes each departure over the arrival it has
// just read, arrives on the stage's `done` mbarrier, and goes on with the
// next stage; the producers store that stage and refill it. The row stride in
// shared memory is TILE + 1 elements, so the 32 consumer lanes reading "their"
// column hit distinct banks; the copies are therefore single elements (4 or
// 8 bytes), which also takes rows of any length, aligned or not. Ragged B and
// T are masked in the kernel: nothing is padded or copied.
//
// The k-server free times stay in registers for k_max <= 8 (the fleet path
// uses k_max <= 4): the kernel is instantiated for 4 and 8 slots with the
// argmin over them fully unrolled, the first of equal minima winning as in
// the strict scan below; larger k_max, up to KMAX, keeps them in local
// memory. The max propagates NaN like torch.maximum, so the kernels and the
// plain versions agree bit for bit.

#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int ROWS = 32;           // one consumer lane per row
constexpr int TILE = 64;           // columns per stage
constexpr int LD = TILE + 1;       // odd row stride: no bank conflicts for the consumer
constexpr int STAGES = 4;          // the ring
constexpr int PRODUCERS = TILE;    // one producer thread per column: two warps
constexpr int THREADS = ROWS + PRODUCERS;
constexpr int KMAX = 64;           // most servers a k-server row may have
static_assert((STAGES & (STAGES - 1)) == 0, "the ring index is i & (STAGES - 1)");

template <typename T>
__device__ __forceinline__ T max_nan(T a, T c) {
  return (a > c || a != a) ? a : c;
}

template <typename T>
struct Ring {
  T arr[STAGES][ROWS * LD];  // arrivals in, departures out
  T svc[STAGES][ROWS * LD];
  uint64_t full[STAGES];     // a stage's tiles have landed (PRODUCERS arrivals)
  uint64_t done[STAGES];     // the consumer has finished a stage (ROWS arrivals)
};

// One row's servers. KB > 1: KB free times in registers, the argmin fully
// unrolled; slots >= k_row start, and stay, at +inf.
template <typename T, int KB>
struct Servers {
  T f[KB];
  __device__ __forceinline__ void init(int k_row, int) {
#pragma unroll
    for (int q = 0; q < KB; ++q) f[q] = q < k_row ? T(0) : static_cast<T>(INFINITY);
  }
  __device__ __forceinline__ T step(T a, T s) {
    int idx = 0;
    T best = f[0];
#pragma unroll
    for (int q = 1; q < KB; ++q) {
      if (f[q] < best) {
        best = f[q];
        idx = q;
      }
    }
    const T out = max_nan(a, best) + s;
#pragma unroll
    for (int q = 0; q < KB; ++q) f[q] = q == idx ? out : f[q];
    return out;
  }
};

// k = 1: the clock, from -inf
template <typename T>
struct Servers<T, 1> {
  T clk;
  __device__ __forceinline__ void init(int, int) { clk = static_cast<T>(-INFINITY); }
  __device__ __forceinline__ T step(T a, T s) { return clk = max_nan(a, clk) + s; }
};

// k_max > 8: the free times in local memory, k_max of them scanned per job
template <typename T>
struct Servers<T, 0> {
  T f[KMAX];
  int k_max;
  __device__ __forceinline__ void init(int k_row, int km) {
    k_max = km;
    for (int q = 0; q < k_max; ++q) f[q] = q < k_row ? T(0) : static_cast<T>(INFINITY);
  }
  __device__ __forceinline__ T step(T a, T s) {
    int idx = 0;
    T best = f[0];
    for (int q = 1; q < k_max; ++q) {
      if (f[q] < best) {
        best = f[q];
        idx = q;
      }
    }
    const T out = max_nan(a, best) + s;
    f[idx] = out;
    return out;
  }
};

template <typename T, int KB>
__global__ void __launch_bounds__(THREADS)
lindley_kernel(const T* __restrict__ arr, const T* __restrict__ svc, const int* __restrict__ k,
               T* __restrict__ dep, long long B, long long n, int k_max) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ring<T>& ring = *reinterpret_cast<Ring<T>*>(smem_raw);
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(B - row0 < ROWS ? B - row0 : ROWS);
  const long long tiles = (n + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      repro::mbar_init(repro::smem_u32(&ring.full[s]), PRODUCERS);
      repro::mbar_init(repro::smem_u32(&ring.done[s]), ROWS);
    }
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < ROWS) {  // the consumer warp: lane r runs row r's recursion
    const int lane = threadIdx.x;
    Servers<T, KB> sv;
    sv.init(KB != 1 && lane < rows ? k[row0 + lane] : 1, k_max);
    for (long long i = 0; i < tiles; ++i) {
      const int b = static_cast<int>(i & (STAGES - 1));
      repro::mbar_wait(repro::smem_u32(&ring.full[b]), static_cast<uint32_t>(i / STAGES) & 1);
      if (lane < rows) {
        T* a = ring.arr[b] + lane * LD;
        const T* s = ring.svc[b] + lane * LD;
        const long long left = n - i * TILE;
        if (left >= TILE) {
#pragma unroll 16
          for (int c = 0; c < TILE; ++c) a[c] = sv.step(a[c], s[c]);
        } else {
          for (int c = 0; c < left; ++c) a[c] = sv.step(a[c], s[c]);
        }
      }
      repro::mbar_arrive(repro::smem_u32(&ring.done[b]));
    }
    return;
  }

  // the producers: thread c moves column c of every tile, in and out
  const int c = threadIdx.x - ROWS;
  for (long long i = 0; i < tiles + STAGES; ++i) {
    const int b = static_cast<int>(i & (STAGES - 1));
    const long long j = i - STAGES;  // the tile this stage held before
    if (j >= 0) {
      repro::mbar_wait(repro::smem_u32(&ring.done[b]), static_cast<uint32_t>(j / STAGES) & 1);
      const long long col = j * TILE + c;
      if (col < n) {
        for (int r = 0; r < rows; ++r) dep[(row0 + r) * n + col] = ring.arr[b][r * LD + c];
      }
    }
    if (i < tiles) {
      const long long col = i * TILE + c;
      if (col < n) {
        for (int r = 0; r < rows; ++r) {
          const long long g = (row0 + r) * n + col;
          repro::cp_async_small<sizeof(T)>(repro::smem_u32(&ring.arr[b][r * LD + c]), arr + g);
          repro::cp_async_small<sizeof(T)>(repro::smem_u32(&ring.svc[b][r * LD + c]), svc + g);
        }
      }
      repro::cp_async_mbar_arrive(repro::smem_u32(&ring.full[b]));
    }
  }
}

// The chain floor, for measurement: the consumer's k = 1 recursion alone,
// over one (32, TILE) tile staged once and read again and again from shared
// memory, with no loads or stores in flight. Only each row's last clock is
// written (to its last departure).
template <typename T>
__global__ void __launch_bounds__(ROWS)
lindley_chain_kernel(const T* __restrict__ arr, const T* __restrict__ svc, T* __restrict__ dep,
                     long long B, long long n) {
  __shared__ T sa[ROWS * LD], ss[ROWS * LD];
  const int lane = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(B - row0 < ROWS ? B - row0 : ROWS);
  const int cols = static_cast<int>(n < TILE ? n : TILE);
  for (int r = 0; r < rows; ++r) {
    for (int c = lane; c < cols; c += ROWS) {
      sa[r * LD + c] = arr[(row0 + r) * n + c];
      ss[r * LD + c] = svc[(row0 + r) * n + c];
    }
  }
  __syncwarp();
  if (lane >= rows) return;
  Servers<T, 1> sv;
  sv.init(1, 1);
  T* a = sa + lane * LD;
  const T* s = ss + lane * LD;
  for (long long t0 = 0; t0 < n; t0 += TILE) {
    const long long left = n - t0;
    if (left >= TILE) {
#pragma unroll 16
      for (int c = 0; c < TILE; ++c) a[c] = sv.step(a[c], s[c]);
    } else {
      for (int c = 0; c < left; ++c) a[c] = sv.step(a[c], s[c]);
    }
  }
  dep[(row0 + lane) * n + n - 1] = sv.clk;
}

template <typename T, int KB>
int launch(const void* arr, const void* svc, const void* k, void* dep, long long B, long long n,
           int k_max, cudaStream_t stream) {
  const size_t smem = sizeof(Ring<T>);
  cudaError_t err = repro::allow_smem(lindley_kernel<T, KB>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (B + ROWS - 1) / ROWS;
  lindley_kernel<T, KB><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(arr), static_cast<const T*>(svc), static_cast<const int*>(k),
      static_cast<T*>(dep), B, n, k_max);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_kserver(const void* arr, const void* svc, const void* k, void* dep, long long B,
                   long long n, int k_max, cudaStream_t stream) {
  if (k_max <= 4) return launch<T, 4>(arr, svc, k, dep, B, n, k_max, stream);
  if (k_max <= 8) return launch<T, 8>(arr, svc, k, dep, B, n, k_max, stream);
  return launch<T, 0>(arr, svc, k, dep, B, n, k_max, stream);
}

template <typename T>
int launch_chain(const void* arr, const void* svc, void* dep, long long B, long long n,
                 cudaStream_t stream) {
  const long long blocks = (B + ROWS - 1) / ROWS;
  lindley_chain_kernel<T><<<static_cast<unsigned>(blocks), ROWS, 0, stream>>>(
      static_cast<const T*>(arr), static_cast<const T*>(svc), static_cast<T*>(dep), B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lindley_kmax() { return KMAX; }

// arr, svc, dep: (B, n) contiguous rows of one dtype (the wrapper checks).
extern "C" int lindley_scan_launch(int dtype, const void* arr, const void* svc, void* dep,
                                   long long B, long long n, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat64) return launch<double, 1>(arr, svc, nullptr, dep, B, n, 1, s);
  if (dtype == kFloat32) return launch<float, 1>(arr, svc, nullptr, dep, B, n, 1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// k: (B,) int32 server counts; slots >= min(k_row, k_max) never serve.
extern "C" int lindley_kserver_launch(int dtype, const void* arr, const void* svc, const void* k,
                                      void* dep, long long B, long long n, int k_max,
                                      void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (k_max < 1 || k_max > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat64) return launch_kserver<double>(arr, svc, k, dep, B, n, k_max, s);
  if (dtype == kFloat32) return launch_kserver<float>(arr, svc, k, dep, B, n, k_max, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The chain floor (measurement only; no wrapper, no path): writes each row's
// final clock to dep[row, n - 1] and nothing else.
extern "C" int lindley_chain_floor_launch(int dtype, const void* arr, const void* svc, void* dep,
                                          long long B, long long n, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat64) return launch_chain<double>(arr, svc, dep, B, n, s);
  if (dtype == kFloat32) return launch_chain<float>(arr, svc, dep, B, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
