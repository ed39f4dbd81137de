"""The flash backward's two dQ designs, built side by side and timed on the card.

``csrc/flash_attention.cu`` computes dQ in a kernel of its own (design b:
S and dP computed again there, 7 products per tile pair, no order between
CTAs). Design (a) folds dQ into the dK/dV sweep instead (5 products): each
warpgroup stores its dS^T tile in shared memory, multiplies it by its K rows
on wgmma (both operands in shared memory, transposed) and adds the fp32
partial into a (B, Sq, H, hd) buffer in a fixed order, key tile by key tile,
each waiting on a counter per (b, head, split, query step) that the tile
before it raised; a short pass then writes bf16 dQ. This module builds (a)
as edits of a copy of the source (``FOLD_EDITS``; they refuse a source whose
anchors moved), builds (b) from the source as it is, holds both against the
plain fp32 backward (rel-L2, and bit-equal on a second call) and times both
by CUDA-graph replay at internvl2's and jamba's training shapes, with each
design's kernels split out by ``torch.profiler``. PERF.md's choice of (b)
rests on its output.

Design (a) here takes head dims 64 and 128 (64-query steps, 64 of dK/dV's
columns a CTA) and no window (its order starts at key tile 0); it allocates
its buffer and counters with ``cudaMallocAsync`` inside the C entry.

    PYTHONPATH=src python -m repro_torch.launch.flash_bwd_designs
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels.flash_attention import ops as fa
from ..kernels.flash_attention.ref import flash_attention_backward_reference

# (B, Sq, Skv, H, K, hd): checked; the two training shapes are also timed
SHAPES = [(1, 1024, 1024, 14, 2, 64), (1, 300, 400, 32, 8, 128), (2, 37, 300, 16, 16, 64),
          (2, 4096, 4096, 14, 2, 64), (1, 4096, 4096, 32, 8, 128)]
TIMED = {(2, 4096, 4096, 14, 2, 64): "internvl2", (1, 4096, 4096, 32, 8, 128): "jamba"}

FOLD_EDITS = [
    # a dS^T buffer per warpgroup, before the stats
    ("  static constexpr int D_OFF_ST = D_OFF_O + DST * QS_BYTES;",
     "  static constexpr int D_OFF_DS = D_OFF_O + DST * QS_BYTES;\n"
     "  static constexpr int D_OFF_ST = D_OFF_DS + NWG * 64 * BQ * 2;"),
    # the fp32 dQ buffer, the counters, the transposed-operand wgmma, an
    # acquire load and the conversion pass
    ("  float scale, softcap, inv_softcap, scale_log2e, softcap_log2e;\n};",
     r'''  float scale, softcap, inv_softcap, scale_log2e, softcap_log2e;
  float* dqacc = nullptr;
  unsigned* ctr = nullptr;
  int nqs = 0;
};
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__global__ void __launch_bounds__(256) dq_convert_kernel(const float* acc, bf16* dq, float scale,
                                                         long long n2) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n2) {
    const float2 v = reinterpret_cast<const float2*>(acc)[i];
    reinterpret_cast<uint32_t*>(dq)[i] = repro::pack_bf16(v.x * scale, v.y * scale);
  }
}'''),
    # per step: dS^T to shared memory, dQ's partial on wgmma, the ordered add
    ('''      fence_regs(pa);
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
      mbar_arrive(empty(s));''', r'''      fence_regs(pa);
      fence_regs(sa);
      {  // dS^T (64 keys x 64 queries) into this warpgroup's buffer, 128-byte swizzled rows
        unsigned char* box = smem_raw + (base - raw) + C::D_OFF_DS + wg * 64 * 128;
        const int r = warp * 16 + lane / 4;
#pragma unroll
        for (int kk = 0; kk < C::BQ / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r + ((e & 1) ? 8 : 0), col = 16 * kk + ((e & 2) ? 8 : 0) + 2 * qd;
            *reinterpret_cast<uint32_t*>(box + swizzle(row * 128 + col * 2, 128)) = sa[kk][e];
          }
        fence_proxy_async();
        named_barrier(1 + wg, 128);
      }
      float dqp[32];
      zero(dqp);
      fence_regs(dv[0]);
      fence_regs(dk[0]);
      wgmma_fence();
      const int box0 = split * C::HDO / C::BOXC;
      issue_rs<HD, C::BQ, C::BQ>(dv, pa, sO + s * C::QS_BYTES, box0);
      issue_rs<HD, C::BQ, C::BQ>(dk, sa, sQ + s * C::QS_BYTES, box0);
      {
        const uint32_t sds = base + C::D_OFF_DS + wg * 64 * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = wgmma_desc(sds + kk * 16 * 128, 64 * 128, 8 * 128, 128);
          const uint64_t db = wgmma_desc(sK + box0 * C::BN * C::RB + wg * 64 * C::RB +
                                             kk * 16 * C::RB, C::BN * C::RB, 8 * C::RB, C::RB);
          wgmma_ss_tt(dqp, da, db, kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv[0]);
      fence_regs(dk[0]);
      fence_regs(pa);
      fence_regs(sa);
      fence_regs(dqp);
      mbar_arrive(empty(s));
      {  // this (key tile, warpgroup)'s dQ part, added in key order
        unsigned* ctr = p.ctr + ((static_cast<long long>(b) * p.H + h) * C::NSPLIT + split) *
                        p.nqs + qt0 + i;
        const unsigned rank = 2u * blockIdx.y + wg;
        if (tid == 0) {
          const long long t0 = clock64();
          while (ld_acquire(ctr) != rank)
            if (clock64() - t0 > (1LL << 33)) __trap();
        }
        named_barrier(1 + wg, 128);
        const int r = q0 + warp * 16 + lane / 4;
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const int q = r + ((j & 2) ? 8 : 0);
          if (q < p.Sq) {
            float2* a = reinterpret_cast<float2*>(
                p.dqacc + ((static_cast<long long>(b) * p.Sq + q) * p.H + h) * HD + split * 64 +
                8 * (j / 4) + 2 * qd);
            const float2 old = __ldcg(a);
            __stcg(a, make_float2(old.x + dqp[j], old.y + dqp[j + 1]));
          }
        }
        __threadfence();
        named_barrier(1 + wg, 128);
        if (tid == 0) atomicAdd(ctr, 1u);
      }'''),
    ("  const dim3 kv_grid(p.H * C::NSPLIT, (p.Skv + C::BN - 1) / C::BN, B);",
     '''  const long long nacc = static_cast<long long>(B) * p.Sq * p.H * HD;
  p.nqs = (p.Sq + C::BQ - 1) / C::BQ;
  const long long nctr = static_cast<long long>(B) * p.H * C::NSPLIT * p.nqs;
  cudaMallocAsync(reinterpret_cast<void**>(&p.dqacc), nacc * 4, stream);
  cudaMallocAsync(reinterpret_cast<void**>(&p.ctr), nctr * 4, stream);
  cudaMemsetAsync(p.dqacc, 0, nacc * 4, stream);
  cudaMemsetAsync(p.ctr, 0, nctr * 4, stream);
  const dim3 kv_grid(p.H * C::NSPLIT, (p.Skv + C::BN - 1) / C::BN, B);'''),
    # the conversion pass in place of the dQ kernel
    ('''  const dim3 q_grid(p.H * C::QSPLIT, (p.Sq + C::BM - 1) / C::BM, B);
  flash_bwd_dq_kernel<HD><<<q_grid, THREADS, C::Q_BYTES, stream>>>(q_tile, o_tile, k_step,
                                                                     v_step, p);''',
     '''  dq_convert_kernel<<<static_cast<unsigned>((nacc / 2 + 255) / 256), 256, 0, stream>>>(
      p.dqacc, p.dq, p.scale, nacc / 2);
  cudaFreeAsync(p.dqacc, stream);
  cudaFreeAsync(p.ctr, stream);'''),
]


def _build_design(name: str, edits, out: Path):
    text = (_build.CSRC / "flash_attention.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"design {name}: the anchor {old[:60]!r}... is not in the source "
                               "once; the edits follow the source of the commit that wrote them")
        text = text.replace(old, new)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"design {name}: nvcc exited {proc.returncode}\n{proc.stdout}"
                           f"{proc.stderr}")
    fn = ctypes.CDLL(str(so)).flash_attention_backward_launch
    fn.argtypes, fn.restype = list(fa._BWD_ARGTYPES), ctypes.c_int
    return fn


def _backward(fn, q, k, v, o, do, lse):
    """The wrapper's ``_launch_backward`` on another build of the C entry."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    plan = fa.backward_plan(B, Sq, Skv, H, K, hd)
    dq = torch.empty_like(q)
    dk = torch.empty((B, Skv, K, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    stats = torch.empty(plan.stats_shape, dtype=torch.float32, device=q.device)
    parts = ([torch.empty(plan.parts_shape, dtype=torch.float32, device=q.device)
              for _ in range(2)] if plan.parts_shape else [None, None])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
              lse.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              *(None if t is None else t.data_ptr() for t in parts), B, H, K, Sq, Skv, hd,
              plan.key_tile, plan.query_step, plan.query_tile, plan.key_step,
              plan.stats_rows, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
              *do.stride()[:3], hd**-0.5, 1, 0, 0.0, _build.stream_handle())
    _build.check(code, "flash_attention")
    return dq, dk, dv


def _device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (calls * replays)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_designs runs on a CUDA card")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        futures = {name: pool.submit(_build_design, name, edits, Path(tmp))
                   for name, edits in (("b_separate_dq", []), ("a_folded_dq", FOLD_EDITS))}
        designs = {name: f.result() for name, f in futures.items()}
        print(f"built both designs in {time.perf_counter() - t0:.1f} s on "
              f"{torch.cuda.get_device_name(0)}", flush=True)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(33)
        rows = []
        for B, Sq, Skv, H, K, hd in SHAPES:
            def randn(*shape):
                return torch.randn(shape, generator=gen, device="cuda").bfloat16()

            q, k, v, do = randn(B, Sq, H, hd), randn(B, Skv, K, hd), randn(B, Skv, K, hd), \
                randn(B, Sq, H, hd)
            o, lse = fa._launch(q, k, v, causal=True, window=0, softcap=0.0, return_lse=True)
            want = flash_attention_backward_reference(*(t.float() for t in (q, k, v, o, do)),
                                                      causal=True, window=0, softcap=0.0,
                                                      chunk=512)
            for name, fn in designs.items():
                got = _backward(fn, q, k, v, o, do, lse)
                again = _backward(fn, q, k, v, o, do, lse)
                rel = max(float((g.float() - w).norm() / w.norm()) for g, w in zip(got, want))
                row = dict(design=name, shape=(B, Sq, Skv, H, K, hd), rel_l2=rel,
                           bit_equal=all(torch.equal(a, b) for a, b in zip(got, again)))
                if (B, Sq, Skv, H, K, hd) in TIMED:
                    call = lambda fn=fn: _backward(fn, q, k, v, o, do, lse)  # noqa: E731
                    row.update(cell=TIMED[(B, Sq, Skv, H, K, hd)], ms=_device_ms(call))
                    from torch.profiler import ProfilerActivity, profile
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(5):
                            call()
                        torch.cuda.synchronize()
                    row["kernels_ms"] = {e.key.split("<")[0].split("::")[-1]:
                                         e.device_time_total / 5e3 for e in prof.key_averages()
                                         if e.device_time_total > 0}
                print(json.dumps(row), flush=True)
                rows.append(row)
            del q, k, v, do, o, lse, want
            torch.cuda.empty_cache()
    bad = [r for r in rows if not (r["rel_l2"] <= 1e-2 and r["bit_equal"])]
    print(json.dumps({"ok": not bad, "device": torch.cuda.get_device_name(0)}))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
