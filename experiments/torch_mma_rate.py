"""The tensor cores' mma.sync rate on the card, for tf32 and bf16 operands,
and the special-function units' rate of exponentials and logarithms.

    python3 experiments/torch_mma_rate.py [--out DIR]

Builds a small CUDA kernel (nvcc, sm_90a) whose warps issue chains of
``mma.sync`` m16n8k8 tf32 (or m16n8k16 bf16) products into eight
independent accumulators, launches it at 128, 256 and 512 threads a CTA
(4 CTAs an SM), and prints the rate in TFLOP/s and in products a clock per
SM at the card's boost clock: the ceiling of the split-TF32 scan kernels
(csrc/tf32_tiles.cuh), which issue mma.sync, beside the data sheet's TF32
rate (495 TFLOP/s), reached only by wgmma. The same launches time eight
independent chains of ``ex2.approx.f32`` (what ``__expf`` issues, after
one multiply) and of ``lg2.approx.f32`` (``__logf``'s) a thread, in
operations a second and a clock per SM: the rate that bounds the scans'
decays (chip_smoke.py's SFU_OPS_PER_S). Writes OUT/mma_rate.json (OUT:
build/mma_rate unless --out).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int KIND>
__global__ void bench(float* out, int iters, uint32_t seed) {
  float acc[8][4] = {};
  uint32_t a0 = seed ^ threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7,
           b0 = a0 * 11, b1 = a0 * 13;
  a0 &= 0x3f7fe000; a1 &= 0x3f7fe000; a2 &= 0x3f7fe000; a3 &= 0x3f7fe000;
  b0 &= 0x3f7fe000; b1 &= 0x3f7fe000;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (KIND == 0)
        asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]),
              "+f"(acc[n][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]),
              "+f"(acc[n][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0;
  for (int n = 0; n < 8; ++n)
    for (int e = 0; e < 4; ++e) s += acc[n][e];
  if (s == 1.2345f) out[threadIdx.x] = s;   // keeps the products alive
}
template <int KIND>
__global__ void sfu(float* out, int iters) {
  float x[8];
  for (int n = 0; n < 8; ++n) x[n] = -1e-3f * (threadIdx.x + n);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (KIND == 0)
        asm volatile("ex2.approx.f32 %0, %0;\n" : "+f"(x[n]));
      else
        asm volatile("lg2.approx.f32 %0, %0;\n" : "+f"(x[n]));
    }
  }
  float s = 0;
  for (int n = 0; n < 8; ++n) s += x[n];
  if (s == 1.2345f) out[threadIdx.x] = s;
}
extern "C" int run_bench(int kind, float* out, int blocks, int threads,
                         int iters) {
  if (kind == 0) bench<0><<<blocks, threads>>>(out, iters, 1234);
  else if (kind == 1) bench<1><<<blocks, threads>>>(out, iters, 1234);
  else if (kind == 2) sfu<0><<<blocks, threads>>>(out, iters);
  else sfu<1><<<blocks, threads>>>(out, iters);
  return cudaGetLastError();
}
"""
BOOST_GHZ = 1.755      # H100 SXM's max SM clock under load


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "mma_rate")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_mma_rate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = Path(tmp) / "mma_rate.cu", Path(tmp) / "mma_rate.so"
        src.write_text(SOURCE)
        subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                        str(lib), str(src)], check=True)
        fn = ctypes.CDLL(str(lib)).run_bench
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
    out = torch.zeros(1024, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for kind, name, flop in ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8),
                             (1, "bf16 m16n8k16", 2 * 16 * 8 * 16),
                             (2, "ex2.approx.f32", 1),
                             (3, "lg2.approx.f32", 1)):
        for threads in (128, 256, 512):
            blocks, iters = sms * 4, 2000
            fn(kind, out.data_ptr(), blocks, threads, 10)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn(kind, out.data_ptr(), blocks, threads, iters)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            # a warp's instruction: one product, or 32 lanes' operations
            n = blocks * threads // 32 * iters * 8 * (32 if kind >= 2 else 1)
            row = {"product": name, "threads": threads, "ms": ms,
                   "tflops": n * flop / ms / 1e9,
                   "per_clock_per_sm": n / sms / (ms * 1e-3 * BOOST_GHZ * 1e9)}
            if kind >= 2:
                row["ops_per_s"] = n / (ms * 1e-3)
            rows.append(row)
            rate = (f"{row['ops_per_s']:.4g} a second" if kind >= 2
                    else f"{row['tflops']:.1f} TFLOP/s")
            print(f"{name} threads {threads}: {ms:.3f} ms, {rate}, "
                  f"{row['per_clock_per_sm']:.3f} a clock per SM", flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "mma_rate.json").write_text(json.dumps(
        {"card": torch.cuda.get_device_name(0), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
