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
// clients. What kept the first design (one group of 32 lanes per client,
// loads straight into registers, one epoch after the other) far from the
// bound was latency: each epoch's loads, five rounds of shuffles and the gate
// ran in series, with one epoch's row in flight per warp.
//
// This design: a CTA owns a block of C contiguous clients for the whole
// sweep. In the (T, N, E+1) layout, the block's rows at epoch t are one
// contiguous span of C * (E+1) costs. A ring of STAGES such spans in shared
// memory is filled ahead by one thread: one bulk copy (cp.async.bulk,
// counted in bytes on the stage's mbarrier) for the span's 16-byte-aligned
// middle, and single-element cp.async copies, which arrive on the same
// mbarrier, for the 4- or 8-byte ends that odd N * (E+1) leaves off 16
// bytes. Each stage is placed so that shared and global addresses agree
// modulo 16, so nothing is padded or copied on the host.
//
// The argmin of an epoch does not depend on prev; only the gate does. So a
// step takes STEP epochs from the ring at once while the next STAGES - STEP
// are in flight: their argmins run interleaved, and then their gates run in
// epoch order through prev, which stays in a register. A group of G lanes
// per client scans its columns in order, each new column coming first if it
// is NaN or strictly smaller while the best so far is no NaN; shuffles then
// combine the groups' bests under one total order (NaN first, then the
// smaller value, then the lower index), which gives the first NaN or the
// first of equal minima whatever the order of the reduction, as torch.argmin
// and jnp.argmin do. The hysteresis read of column prev + 1 comes from the
// same stage; the cohort's turn is a counter, not a 64-bit modulo per epoch.
// One __syncthreads per step hands its stages back to the copies. Ragged N
// (the last CTA's short span) is masked in the kernel.
//
// The host plans the launch (scan_plan in kernels/decision_scan/ops.py):
// about two CTAs per SM, G the fewest lanes that leave a lane 16 columns or
// fewer, STEP 4 where T has 4 epochs and 1 below (the closed loop launches
// one epoch at a time), the ring within shared memory. Measured on the H100
// at (600, 2048, 129) float64, the reduction's latency and not the ring's
// depth set the time: 8 stages read no faster than 4 at one epoch a step,
// and 4 epochs a step took about a quarter off.

#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int STAGES = 8;  // the ring: epochs in shared memory (kernels/decision_scan/ops.py)
constexpr int MAX_THREADS = 512;
constexpr int ON_DEVICE = -1;
static_assert((STAGES & (STAGES - 1)) == 0, "the ring index is t & (STAGES - 1)");
// bytes before the ring: one mbarrier per stage, rounded to keep the ring 16-aligned
__host__ __device__ constexpr int barrier_bytes(int stages) { return (8 * stages + 15) / 16 * 16; }

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

// One thread fills a stage: `elems` costs from src into shared memory at
// dst, where dst and src agree modulo 16. The 16-byte-aligned middle goes by
// one bulk copy, the ends element by element; both complete on `bar`
// (initialised for two arrivals: the ends' and the bulk copy's byte count).
template <typename T>
__device__ __forceinline__ void fill_stage(uint32_t dst, const T* src, long long elems,
                                           uint32_t bar) {
  constexpr int E = sizeof(T);
  const uintptr_t gs = reinterpret_cast<uintptr_t>(src);
  const uintptr_t ge = gs + static_cast<uintptr_t>(elems) * E;
  const uintptr_t up = (gs + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t down = ge & ~static_cast<uintptr_t>(15);
  const uintptr_t head_end = ge < up ? ge : up;
  const uintptr_t body_end = down > head_end ? down : head_end;
  for (uintptr_t a = gs; a < head_end; a += E)
    repro::cp_async_small<E>(dst + static_cast<uint32_t>(a - gs), reinterpret_cast<const void*>(a));
  for (uintptr_t a = body_end; a < ge; a += E)
    repro::cp_async_small<E>(dst + static_cast<uint32_t>(a - gs), reinterpret_cast<const void*>(a));
  repro::cp_async_mbar_arrive(bar);
  const uint32_t body = static_cast<uint32_t>(body_end - head_end);
  repro::mbar_expect_tx(bar, body);
  if (body) {
    repro::bulk_load(dst + static_cast<uint32_t>(head_end - gs),
                     reinterpret_cast<const void*>(head_end), body, bar);
  }
}

template <typename T, int STEP>
__global__ void __launch_bounds__(MAX_THREADS)
decision_kernel(const T* __restrict__ costs, const int* __restrict__ cohort,
                const int* __restrict__ prev_in, int* __restrict__ out, long long n_epochs,
                long long n, int e1, long long t0, double h, int stagger, int g, int clients,
                int stage_bytes) {
  static_assert(STAGES % STEP == 0 && STAGES > STEP, "a step takes whole stages, some stay ahead");
  constexpr int BARRIERS = barrier_bytes(STAGES);
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // a stage's costs have landed
  const long long c0 = static_cast<long long>(blockIdx.x) * clients;
  const int cnt = static_cast<int>(n - c0 < clients ? n - c0 : clients);
  const long long span = static_cast<long long>(cnt) * e1;  // the block's costs per epoch
  const long long step = n * e1;
  const T* first = costs + c0 * e1;
  const uint32_t ring_u32 = repro::smem_u32(smem + BARRIERS);

  const int q = threadIdx.x / g;  // this lane's client within the block
  const int sub = threadIdx.x & (g - 1);
  const bool active = q < cnt;
  const long long client = c0 + q;
  int prev = ON_DEVICE;
  int coh = 0;
  if (active) {
    if (prev_in != nullptr) prev = prev_in[client];
    coh = cohort[client];
  }
  const bool hyst = h > 0.0;
  const T factor = static_cast<T>(1.0 - h);
  int turn = static_cast<int>(t0 % stagger);  // the cohort whose epoch it is

  // stage of epoch te, shifted so that shared and global addresses agree mod 16
  auto stage_off = [&](long long te) -> uint32_t {
    return static_cast<uint32_t>(te & (STAGES - 1)) * stage_bytes +
           static_cast<uint32_t>(reinterpret_cast<uintptr_t>(first + te * step) & 15);
  };
  auto issue = [&](long long te) {  // thread 0 only
    if (te < n_epochs) {
      fill_stage(ring_u32 + stage_off(te), first + te * step, span,
                 repro::smem_u32(&full[te & (STAGES - 1)]));
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) repro::mbar_init(repro::smem_u32(&full[s]), 2);
    repro::mbar_fence_init();
    for (int s = 0; s < STAGES - STEP; ++s) issue(s);
  }
  __syncthreads();
  for (long long t = 0; t < n_epochs; t += STEP) {
    if (threadIdx.x == 0) {  // into the stages freed at the end of the last step
      for (int k = 0; k < STEP; ++k) issue(t + STAGES - STEP + k);
    }
    const int kk = static_cast<int>(n_epochs - t < STEP ? n_epochs - t : STEP);
    const T* row[STEP];
#pragma unroll
    for (int k = 0; k < STEP; ++k) {
      if (k < kk) {
        repro::mbar_wait(repro::smem_u32(&full[(t + k) & (STAGES - 1)]),
                         static_cast<uint32_t>((t + k) / STAGES) & 1);
        row[k] = reinterpret_cast<const T*>(smem + BARRIERS + stage_off(t + k)) +
                 (active ? q * e1 : 0);
      } else {
        row[k] = row[0];  // past the last epoch: reduced again, never used
      }
    }

    // the argmins of STEP epochs at once: they do not depend on prev
    T best[STEP];
    int best_j[STEP];
#pragma unroll
    for (int k = 0; k < STEP; ++k) {
      best[k] = static_cast<T>(INFINITY);
      best_j[k] = INT_MAX;  // loses to every real column
    }
    if (active && sub < e1) {
#pragma unroll
      for (int k = 0; k < STEP; ++k) {
        best[k] = row[k][sub];
        best_j[k] = sub;
      }
      for (int j = sub + g; j < e1; j += g) {
#pragma unroll
        for (int k = 0; k < STEP; ++k) {
          // j is past every column this lane has seen: it comes first if the
          // best so far is no NaN and it is NaN or strictly smaller
          const T v = row[k][j];
          if (best[k] == best[k] && !(v >= best[k])) {
            best[k] = v;
            best_j[k] = j;
          }
        }
      }
    }
    // every lane of the warp takes part in the shuffles; offsets below g stay
    // inside the group
    for (int o = g >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < STEP; ++k) {
        const T ov = __shfl_xor_sync(0xffffffffu, best[k], o);
        const int oj = __shfl_xor_sync(0xffffffffu, best_j[k], o);
        if (before(ov, oj, best[k], best_j[k])) {
          best[k] = ov;
          best_j[k] = oj;
        }
      }
    }

    // the gates, in epoch order through prev
#pragma unroll
    for (int k = 0; k < STEP; ++k) {
      if (k < kk) {
        if (active && coh == turn) {
          const int choice = best_j[k] - 1;
          bool keep = false;
          if (hyst && t0 + t + k >= stagger && choice != prev) {
            // the wrapper refuses prev outside [-1, E); the guard only keeps
            // a bad argument from reading past the row
            const unsigned col = static_cast<unsigned>(prev + 1);
            if (col < static_cast<unsigned>(e1)) {
              const T pc = row[k][col];
              keep = finite(pc) && best[k] > factor * pc;
            }
          }
          if (!keep) prev = choice;
        }
        if (active && sub == 0) out[(t + k) * n + client] = prev;
        if (++turn == stagger) turn = 0;
      }
    }
    __syncthreads();  // the stages of this step are free
  }
}

template <typename T, int STEP>
int launch(const void* costs, const void* cohort, const void* prev, void* out, long long n_epochs,
           long long n, int e1, long long t0, double h, int stagger, int g, int clients,
           int threads, cudaStream_t stream) {
  if (g < 1 || g > 32 || (g & (g - 1)) || clients < 1 || threads % 32 != 0 ||
      threads > MAX_THREADS || static_cast<long long>(clients) * g > threads)
    return static_cast<int>(cudaErrorInvalidValue);
  // a stage: the span rounded up to 16 bytes, and 16 more for its shift
  const long long span_bytes = static_cast<long long>(clients) * e1 * sizeof(T);
  const long long stage_bytes = (span_bytes + 15) / 16 * 16 + 16;
  const long long smem = barrier_bytes(STAGES) + STAGES * stage_bytes;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decision_kernel<T, STEP>;
  cudaError_t err = repro::allow_smem(kernel, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + clients - 1) / clients;
  kernel<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(costs), static_cast<const int*>(cohort),
      static_cast<const int*>(prev), static_cast<int*>(out), n_epochs, n, e1, t0, h, stagger, g,
      clients, static_cast<int>(stage_bytes));
  return static_cast<int>(cudaGetLastError());
}

template <int STEP>
int launch_step(int dtype, const void* costs, const void* cohort, const void* prev, void* out,
                long long n_epochs, long long n, int e1, long long t0, double h, int stagger,
                int g, int clients, int threads, cudaStream_t stream) {
  if (dtype == kFloat64) return launch<double, STEP>(
      costs, cohort, prev, out, n_epochs, n, e1, t0, h, stagger, g, clients, threads, stream);
  if (dtype == kFloat32) return launch<float, STEP>(
      costs, cohort, prev, out, n_epochs, n, e1, t0, h, stagger, g, clients, threads, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// costs: (n_epochs, n, e1) contiguous, column 0 on-device; cohort, prev (or
// NULL for all ON_DEVICE): (n,) int32; out: (n_epochs, n) int32. Lanes per
// client (a power of two up to 32), clients and threads per CTA, the ring's
// stages (this build's STAGES) and the epochs per step (1 or 4) come from
// the host's plan (scan_plan).
extern "C" int decision_scan_launch(int dtype, const void* costs, const void* cohort,
                                    const void* prev, void* out, long long n_epochs, long long n,
                                    int e1, long long t0, double h, int stagger, int group,
                                    int clients, int threads, int stages, int epochs_per_step,
                                    void* stream) {
  if (n_epochs <= 0 || n <= 0) return 0;
  if (e1 < 1 || stagger < 1 || t0 < 0 || stages != STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epochs_per_step == 1) return launch_step<1>(dtype, costs, cohort, prev, out, n_epochs, n,
                                                  e1, t0, h, stagger, group, clients, threads, s);
  if (epochs_per_step == 4) return launch_step<4>(dtype, costs, cohort, prev, out, n_epochs, n,
                                                  e1, t0, h, stagger, group, clients, threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
