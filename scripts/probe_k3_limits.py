"""Measure the two rates that bound K3 (pair_transfer) on the card: the f64
MMA rate shape by shape, and the cost of a warp's 16-byte shared-memory load
by the pattern of addresses its lanes read.

    python scripts/probe_k3_limits.py [--iters 2048]

One CUDA source (below) is compiled with nvcc for sm_90a into
``build/probe_k3_limits/`` and run. The MMA kernels keep 8 independent
accumulator tiles per warp in registers (no memory traffic in the loop) at
8, 16 and 32 warps an SM: ``mma.sync.aligned.m8n8k4`` (what K3's f64 body
issues), the m16n8k4 / m16n8k8 / m16n8k16 f64 shapes PTX has for sm_90,
and plain DFMA; one JSON line each with milliseconds and TFLOP/s (2 m n k
flops per MMA, 2 per FMA). A configuration the card refuses (too many
registers for the block) prints its launch error. The load kernel runs 64
warps an SM, each lane reading 16 bytes (LDS.128) at a chunk index given
by a pattern of its lane, 8 loads to an address update; one JSON line per
pattern with SM clocks per warp-wide load (the clock from the device's
rated SM clock). The patterns are those of K3's f32 products: 8 distinct
chunks per quarter-warp, the same in every quarter (an X fragment), one
chunk per quarter (a Y fragment), and others. The first line is the card's
name and power limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>

__global__ void m8n8k4(double* out, int iters) {
  double a = threadIdx.x * 1e-3, b = 1.0 + threadIdx.x * 1e-4;
  double c[8][2] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                   "{%0, %1}, {%2}, {%3}, {%4, %5};\n"
                   : "=d"(c[k][0]), "=d"(c[k][1])
                   : "d"(a), "d"(b), "d"(c[k][0]), "d"(c[k][1]));
  }
  double s = 0;
  for (int k = 0; k < 8; ++k) s += c[k][0] + c[k][1];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void m16n8k4(double* out, int iters) {
  double a = threadIdx.x * 1e-3, b = 1.0 + threadIdx.x * 1e-4;
  double c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                   "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
                   : "=d"(c[k][0]), "=d"(c[k][1]), "=d"(c[k][2]),
                     "=d"(c[k][3])
                   : "d"(a), "d"(b), "d"(b), "d"(c[k][0]), "d"(c[k][1]),
                     "d"(c[k][2]), "d"(c[k][3]));
  }
  double s = 0;
  for (int k = 0; k < 8; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void m16n8k8(double* out, int iters) {
  double a = threadIdx.x * 1e-3, b = 1.0 + threadIdx.x * 1e-4;
  double c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                   "{%10, %11, %12, %13};\n"
                   : "=d"(c[k][0]), "=d"(c[k][1]), "=d"(c[k][2]),
                     "=d"(c[k][3])
                   : "d"(a), "d"(b), "d"(a), "d"(b), "d"(b), "d"(a),
                     "d"(c[k][0]), "d"(c[k][1]), "d"(c[k][2]), "d"(c[k][3]));
  }
  double s = 0;
  for (int k = 0; k < 8; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void m16n8k16(double* out, int iters) {
  double a = threadIdx.x * 1e-3, b = 1.0 + threadIdx.x * 1e-4;
  double c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
                   "{%12, %13, %14, %15}, {%16, %17, %18, %19};\n"
                   : "=d"(c[k][0]), "=d"(c[k][1]), "=d"(c[k][2]),
                     "=d"(c[k][3])
                   : "d"(a), "d"(b), "d"(a), "d"(b), "d"(a), "d"(b),
                     "d"(a), "d"(b), "d"(b), "d"(a), "d"(b), "d"(a),
                     "d"(c[k][0]), "d"(c[k][1]), "d"(c[k][2]), "d"(c[k][3]));
  }
  double s = 0;
  for (int k = 0; k < 8; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__device__ int pattern(int p, int lane) {
  switch (p) {
    case 0: return lane;                           // 32 distinct chunks
    case 1: return lane & 7;                       // 8 per quarter, shared
    case 2: return lane >> 3;                      // 1 per quarter
    case 3: return 0;                              // 1 for the warp
    case 4: return 2 * (lane >> 3) + (lane & 1);   // 2 per quarter
    case 5: return 4 * (lane >> 3) + (lane & 3);   // 4 per quarter
    default: return (lane & 1) * 8 + (lane >> 3);  // 2 per quarter, 1 bank
  }
}
const char* pattern_name(int p) {
  const char* names[] = {"32 distinct", "8 per quarter, shared (X)",
                         "1 per quarter (Y)", "1 for the warp",
                         "2 per quarter", "4 per quarter",
                         "2 per quarter in one bank group"};
  return names[p];
}
constexpr int kPatterns = 7;

__global__ void lds128(unsigned* out, int p, int iters) {
  __shared__ uint4 s[2048];
  const int t = threadIdx.x;
  for (int i = t; i < 2048; i += blockDim.x)
    s[i] = make_uint4(i, i * 3, i * 5, i * 7);
  __syncthreads();
  const int idx = pattern(p, t & 31);
  unsigned a0 = 0, a1 = 0;
  for (int i = 0; i < iters; i += 8) {
    const uint4* q = s + idx + ((i >> 3) & 3) * 256;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 v = q[j * 32];
      a0 ^= v.x ^ v.y ^ v.z;
      a1 ^= v.w;
    }
  }
  out[blockIdx.x * blockDim.x + t] = a0 + a1;
}

__global__ void dfma(double* out, int iters) {
  double a = threadIdx.x * 1e-3, b = 1.0 + threadIdx.x * 1e-4;
  double c[16] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 16; ++k) c[k] = fma(a, b, c[k]);
  }
  double s = 0;
  for (int k = 0; k < 16; ++k) s += c[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

typedef void (*Kernel)(double*, int);

int main(int argc, char** argv) {
  const int iters = argc > 1 ? atoi(argv[1]) : 2048;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  double* out;
  cudaMalloc(&out, size_t(sms) * 2 * 1024 * sizeof(double));
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  struct { const char* name; Kernel k; double flops_per_warp_iter; } ks[] = {
      {"mma.m8n8k4.f64", m8n8k4, 8 * 2.0 * 8 * 8 * 4},
      {"mma.m16n8k4.f64", m16n8k4, 8 * 2.0 * 16 * 8 * 4},
      {"mma.m16n8k8.f64", m16n8k8, 8 * 2.0 * 16 * 8 * 8},
      {"mma.m16n8k16.f64", m16n8k16, 8 * 2.0 * 16 * 8 * 16},
      {"dfma", dfma, 32 * 16 * 2.0}};
  for (auto& k : ks)
    for (int warps = 8; warps <= 32; warps *= 2) {
      k.k<<<sms, warps * 32>>>(out, iters);
      cudaEventRecord(t0);
      k.k<<<sms, warps * 32>>>(out, iters);
      cudaEventRecord(t1);
      cudaError_t err = cudaGetLastError();
      if (err == cudaSuccess) err = cudaEventSynchronize(t1);
      float ms = 0;
      cudaEventElapsedTime(&ms, t0, t1);
      const double flops =
          k.flops_per_warp_iter * iters * warps * double(sms);
      printf("{\"kernel\": \"%s\", \"warps_per_sm\": %d, \"ms\": %.5f, "
             "\"tflops\": %.3f, \"error\": \"%s\"}\n",
             k.name, warps, ms,
             err == cudaSuccess ? flops / (ms * 1e-3) / 1e12 : 0.0,
             cudaGetErrorString(err));
    }
  int clk_khz = 0;
  cudaDeviceGetAttribute(&clk_khz, cudaDevAttrClockRate, 0);
  const int lds_iters = 8192;
  for (int p = 0; p < kPatterns; ++p) {
    unsigned* u = reinterpret_cast<unsigned*>(out);
    lds128<<<sms * 2, 1024>>>(u, p, lds_iters);
    cudaEventRecord(t0);
    lds128<<<sms * 2, 1024>>>(u, p, lds_iters);
    cudaEventRecord(t1);
    cudaEventSynchronize(t1);
    float ms = 0;
    cudaEventElapsedTime(&ms, t0, t1);
    const double loads_per_sm = 64.0 * lds_iters;
    printf("{\"kernel\": \"lds128\", \"pattern\": \"%s\", \"ms\": %.5f, "
           "\"sm_clocks_per_warp_load\": %.3f, \"clock_MHz\": %.0f}\n",
           pattern_name(p), ms, clk_khz * 1e3 * ms * 1e-3 / loads_per_sm,
           clk_khz / 1e3);
  }
  return 0;
}
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2048)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from peps_tpu_torch.kernels._build import _nvcc
    out = ROOT / "build" / "probe_k3_limits"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(SOURCE)
    proc = subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                           "-O3", "-o", str(out / "probe"), str(out / "probe.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    run = subprocess.run([str(out / "probe"), str(args.iters)],
                         capture_output=True, text=True,
                         timeout=600)
    for line in run.stdout.splitlines():
        print(json.dumps(json.loads(line)), flush=True)
    if run.returncode != 0:
        sys.exit(f"probe failed ({run.returncode}): {run.stderr}")


if __name__ == "__main__":
    main()
