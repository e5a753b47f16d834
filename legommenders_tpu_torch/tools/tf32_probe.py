#!/usr/bin/env python3
"""The error of a 3xTF32 tensor-core product at the f32 attention's tile
shapes, on one card:

    python3 legommenders_tpu_torch/tools/tf32_probe.py [--out FILE]

A (120 x 64) by (64 x 120) f32 product, the scores of one head of
bert-naml's training page (q . k^T over dh 64, T 120), and a (120 x 120) by
(120 x 64) one (p . v over the keys), computed five ways on the card:
mma.sync.m16n8k8 with TF32 operands, once (hi . hi) and three times
(lo . hi + hi . lo + hi . hi, hi = rna_tf32(x), lo = rna_tf32(x - hi)),
accumulating in the tensor core's f32 accumulator; the three products
with a fresh accumulator per k step of 8, added to the sum by f32 adds
(tf32x3_fadd_per_k); the two small products in an accumulator of their
own (tf32x3_small_apart); and f32 FMA in order of k. Each is held against
the same product in f64 on the host. The inputs are standard normal (the
scores' operands) and softmax rows (p), from a seed. Then the rate of
mma.sync.m16n8k8 with TF32 operands (and, beside it, m16n8k16 with bf16
ones) when nothing else is issued: 4 CTAs of 8 warps an SM, each warp 8
independent accumulators, timed with CUDA events ("rate": products a
clock an SM at the card's clock rate, and TFLOP/s). Prints one JSON object
with each way's largest absolute error and the rates (and writes it to
--out).
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C (M x N) = A (M x K, row-major) . B (K x N, row-major); M, N, K
// multiples of 16, 8, 8; one warp per 16 rows; mode 1: one TF32 product,
// 3: three
__global__ void probe_mma(const float* A, const float* B, float* C, int M,
                          int N, int K, int mode) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32);
  if (m0 >= M) return;
  for (int n0 = 0; n0 < N; n0 += 8) {
    float d[4] = {0.f, 0.f, 0.f, 0.f}, e[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += 8) {
      const float a[4] = {A[(m0 + g) * K + k0 + t], A[(m0 + g + 8) * K + k0 + t],
                          A[(m0 + g) * K + k0 + t + 4],
                          A[(m0 + g + 8) * K + k0 + t + 4]};
      const float b[2] = {B[(k0 + t) * N + n0 + g], B[(k0 + t + 4) * N + n0 + g]};
      uint32_t ah[4], al[4], bh[2], bl[2];
      for (int e = 0; e < 4; ++e) {
        ah[e] = tf32(a[e]);
        al[e] = tf32(a[e] - __uint_as_float(ah[e]));
      }
      for (int e = 0; e < 2; ++e) {
        bh[e] = tf32(b[e]);
        bl[e] = tf32(b[e] - __uint_as_float(bh[e]));
      }
      if (mode == 4) {
        // a fresh accumulator per k step, added in f32
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        mma(t, al, bh);
        mma(t, ah, bl);
        mma(t, ah, bh);
        for (int x = 0; x < 4; ++x) d[x] += t[x];
        continue;
      }
      if (mode == 5) {
        // the small products in an accumulator of their own
        mma(e, al, bh);
        mma(e, ah, bl);
        mma(d, ah, bh);
        continue;
      }
      if (mode == 3) {
        mma(d, al, bh);
        mma(d, ah, bl);
      }
      mma(d, ah, bh);
    }
    for (int x = 0; x < 4; ++x) d[x] += e[x];
    C[(m0 + g) * N + n0 + 2 * t] = d[0];
    C[(m0 + g) * N + n0 + 2 * t + 1] = d[1];
    C[(m0 + g + 8) * N + n0 + 2 * t] = d[2];
    C[(m0 + g + 8) * N + n0 + 2 * t + 1] = d[3];
  }
}

// `iters` rounds of 8 independent products a warp (TF32 m16n8k8, or bf16
// m16n8k16 where BF16), with nothing else in the loop
template <bool BF16>
__global__ void probe_rate(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 7 + i;
  b[0] = threadIdx.x;
  b[1] = threadIdx.x * 3;
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if constexpr (BF16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else
        mma(d[c], a, b);
    }
  }
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// products a clock an SM and TFLOP/s of probe_rate
extern "C" int rate(float* out, int bf16, double* per_clk, double* tflops) {
  int sms = 0, khz = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const int ctas = 4 * sms, threads = 256, iters = 4096;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  if (bf16)
    probe_rate<true><<<ctas, threads>>>(out, 16);
  else
    probe_rate<false><<<ctas, threads>>>(out, 16);
  cudaEventRecord(e0);
  if (bf16)
    probe_rate<true><<<ctas, threads>>>(out, iters);
  else
    probe_rate<false><<<ctas, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaError_t e = cudaEventSynchronize(e1);
  if (e != cudaSuccess) return e;
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = (double)ctas * (threads / 32) * iters * 8;
  *per_clk = mmas / sms / (ms * 1e-3 * khz * 1e3);
  *tflops = mmas * (bf16 ? 4096.0 : 2048.0) / (ms * 1e-3) / 1e12;
  return cudaGetLastError();
}

__global__ void probe_fma(const float* A, const float* B, float* C, int M,
                          int N, int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  const int r = i / N, c = i - r * N;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s = fmaf(A[r * K + k], B[k * N + c], s);
  C[i] = s;
}

extern "C" int probe(const float* A, const float* B, float* C, int M, int N,
                     int K, int mode) {
  if (mode == 0)
    probe_fma<<<(M * N + 127) / 128, 128>>>(A, B, C, M, N, K);
  else
    probe_mma<<<(M / 16 + 3) / 4, 128>>>(A, B, C, M, N, K, mode);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return cudaDeviceSynchronize();
}
"""


def _library():
    from legommenders_tpu_torch.ops import build

    os.makedirs(build.BUILD, exist_ok=True)
    src = os.path.join(build.BUILD, "tf32_probe.cu")
    lib = os.path.join(build.BUILD, "libtf32_probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    so.probe.argtypes = [p, p, p, i, i, i, i]
    so.probe.restype = i
    so.rate.argtypes = [p, i, p, p]
    so.rate.restype = i
    return so


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("tf32_probe: no CUDA device", file=sys.stderr)
        return 1
    so = _library()
    rng = np.random.default_rng(0)
    T, dh, Tp = 120, 64, 128  # Tp: T padded to the 16-row tile
    q = rng.standard_normal((T, dh)).astype(np.float32)
    k = rng.standard_normal((T, dh)).astype(np.float32)
    s = rng.standard_normal((T, T)) * 2.0
    p = np.exp(s - s.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    v = rng.standard_normal((T, dh)).astype(np.float32)
    res = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()}
    for name, a, b in (("q.k^T (120x64 . 64x120)", q, k.T.copy()),
                       ("p.v (120x120 . 120x64)", p, v)):
        M, K = a.shape
        N = b.shape[1]
        Kp = -(-K // 8) * 8
        ap_ = np.zeros((Tp, Kp), np.float32)
        ap_[:M, :K] = a
        bp = np.zeros((Kp, N), np.float32)
        bp[:K] = b
        exact = a.astype(np.float64) @ b.astype(np.float64)
        A = torch.from_numpy(ap_).cuda()
        B = torch.from_numpy(bp).cuda()
        row = {"max_abs": float(np.abs(exact).max())}
        for label, mode in (("fma_f32", 0), ("tf32x1", 1), ("tf32x3", 3),
                            ("tf32x3_fadd_per_k", 4),
                            ("tf32x3_small_apart", 5)):
            C = torch.zeros((Tp if mode else M, N), device="cuda")
            err = so.probe(A.data_ptr(), B.data_ptr(), C.data_ptr(),
                           Tp if mode else M, N, Kp, mode)
            if err:
                raise RuntimeError(f"probe mode {mode}: cudaError {err}")
            got = C[:M].cpu().numpy().astype(np.float64)
            row[label] = float(np.abs(got - exact).max())
        res[name] = row
    out = torch.zeros(4 * 132 * 256 * 4, device="cuda")
    res["rate"] = {}
    for label, bf16 in (("tf32 m16n8k8", 0), ("bf16 m16n8k16", 1)):
        per_clk, tflops = ctypes.c_double(), ctypes.c_double()
        err = so.rate(out.data_ptr(), bf16, ctypes.byref(per_clk),
                      ctypes.byref(tflops))
        if err:
            raise RuntimeError(f"rate {label}: cudaError {err}")
        res["rate"][label] = {"per_clock_per_sm": per_clk.value,
                              "tflops": tflops.value}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
