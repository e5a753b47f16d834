// Additive-attention pooling, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of the JAX package's
// ops/pallas_additive.py (launched by `_forward_pallas`). For each item n:
//     h[l, j] = tanh(sum_d x[n, l, d] * W1[d, j] + b1[j])
//     s[l]    = sum_j h[l, j] * w2[j]
//     a       = masked softmax of s over l: masked scores are -FLT_MAX, a
//               row max below -FLT_MAX/2 is replaced by 0 (all-masked items
//               pool to exactly 0), the denominator adds EPS = 1e-8
//     out[n]  = sum_l a[l] * x[n, l, :]
// x is f32 or bf16, mask/W1/b1/w2 are f32, out has x's type; all sums are
// taken in f32. Three kernels; the wrapper picks one by x's type and widths
// (ops/additive.py `pool_kernel`), and a failure of any raises.
//
// additive_pool_tc: bf16 x with D = 64, H a multiple of 64 up to 256 and
// L <= 128 -- every shape the models run (L 31, 34, 40 or 50, H 256).
//   What bounds it. Per position it reads 128 bytes of x and computes H
//   tanh. The 65,000 x 31 item catalog moves 274 MB (82 us at 3.35 TB/s)
//   and needs 516 M tanh: at the 16 special-function results per clock of
//   an SM (CUDA C++ Programming Guide, throughput table, compute capability
//   9.0), 132 SMs at 1.98 GHz, that is 123 us. x.W1 (66 GFLOP) needs 67 us
//   of the bf16 tensor cores. So the tanh bounds it, then the bytes: the
//   design keeps the tanh units fed while the loads, the products and the
//   softmax run beside them. Measured on an NVIDIA H100 80GB HBM3 at 700 W
//   (PERF.md, section 6): ~252 us for the catalog, ~4,300 clocks a tile in the
//   scoring warpgroups against the tanh's 2,048; a copy without the tanh
//   is no faster, one without the whole epilogue takes ~235 us, so neither
//   bound holds it yet.
//   Design.
//    * Whole items per tile: G = 128 / L items, the G*L rows of x seen as
//      (N*L, 64), padded to 128 rows (two 64-row wgmma tiles). An item's
//      softmax and weighted sum stay in the CTA; rows past G*L are zero
//      and never read as scores.
//    * Persistent: min(tiles, SMs) CTAs of 384 threads, CTA b taking tiles
//      b, b + grid, ...; three warpgroups with their own roles, chained by
//      mbarriers over a four-stage ring, so that one tile is loaded, the
//      next scored and the one before pooled at once.
//    * Loads: one thread of warpgroup 2 issues per tile one TMA load of x (a
//      2-D map, boxes of 64 x G*L, 128-byte swizzle: the K-major A operand
//      as wgmma reads it; rows past N*L are TMA's zero fill) and one of the
//      mask (a 1-D map, 132 floats from the 16-byte boundary at or below
//      the tile's first position: TMA starts the innermost dimension on 16
//      bytes), completed on the stage's `full` mbarrier. It refills a stage
//      as soon as its warpgroup has pooled the stage's tile.
//    * W1 arrives once per CTA by bulk copy, as the f32 the wrapper passes,
//      and is staged as bf16 W1^T (H rows of 64, 128-byte swizzle: the
//      K-major B operand). On the models' paths W1 holds bf16 values
//      already (AdditiveAttention.pool_weights rounds proj_kernel to the
//      compute dtype), so the rounding is exact there; a caller's f32 W1 is
//      rounded once, at most 2^-9 of each weight, inside the bf16 gate (the
//      card tests hold a W1 that is not bf16-exact).
//    * Scores, warpgroups 0 and 1 (setmaxnreg 208): warpgroup g multiplies
//      rows 64g..64g+63 by all H columns on wgmma (f32 accumulators), as
//      H/64 groups of m64n64k16, committed one group per 64 columns. The
//      epilogue stays in registers: + b1[j], tanh.approx.f32 (one
//      special-function instruction, relative error about 2^-11), x w2[j],
//      summed along each thread's two rows, then a quad shuffle and one
//      shared-memory slot per row. As each 64-column group's epilogue frees
//      its accumulators, the same group of the next tile is issued into
//      them, so the tensor cores run ahead of the tanh. A warp skips the
//      8-row halves that lie wholly past G*L.
//    * Pooling, warpgroup 2 (setmaxnreg 80): warp w takes items w, w + 4,
//      ... of a scored tile; its lanes run the masked softmax over the
//      positions, then each 8-lane group sums every fourth position of the
//      bf16 x tile still in shared memory (16 bytes a lane, through the
//      swizzle) in f32; one 128-byte store per item.
//
// additive_pool_kernel: f32 x, where the parity gate is 1e-5 absolute,
// which neither TF32 nor tanh.approx meets, and every shape the
// tensor-core kernel does not take; on the CUDA cores in f32. Persistent
// blocks of 256 threads; block b walks items n = b, b + gridDim.x, ... .
// W1 (D x H, f32) is staged in shared memory once per block. For each item:
//   1. its x rows are staged in shared memory as f32 (positions L..Lp-1
//      are zero, Lp = L rounded up to the register tile LT);
//   2. thread t owns hidden units j = t, t + 256, ...; it keeps LT
//      accumulators in registers, so each W1 value read from shared memory
//      feeds LT FMAs while x is read as broadcast float4s;
//   3. tanhf(.) * w2[j] is summed over each warp with shuffles and over the
//      eight warps through shared memory;
//   4. warp 0 runs the masked softmax with the reference's guards;
//   5. threads d < D write sum_l a[l] * x[l, d].
//
// additive_pool_long: every L > 128 (the flattened histories of the
// flatten user operators: L 495 and 1,023 at D 64, H 64), f32 or bf16 x.
// The Pallas kernel holds a whole item in VMEM; additive_pool_kernel keeps
// all of an item's x in shared memory, which at L 1,023, D 64 is more than
// a block may have. This one streams an item's positions in chunks of 64
// through shared memory with an online softmax (running max, sum and
// weighted sum, the reference's EPS and all-masked rule kept), so its
// shared memory does not grow with L. What bounds it: the N*L*H tanh and
// the N*L*D*H products of the scores on the CUDA cores (f32, as
// additive_pool_kernel); its bytes (N*L*D once) take less time.
//
// The device queries and the shared-memory attributes are set once by the
// prepare entry points, not on every launch. The C entry points return a
// cudaError_t; a launch is checked with cudaGetLastError() and never
// synchronises.

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float kEps = 1e-8f;

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// CUDA-core kernel (f32, and the shapes the tensor-core kernel does not take)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLT = 8;  // sequence positions per register tile

// shared memory, in floats: W1[D*H] | x[Lp*D] | partial s[Lp*kWarps] | a[Lp]
__host__ __device__ inline size_t smem_floats(int L, int D, int H) {
  const size_t Lp = round_up(L, kLT);
  return (size_t)D * H + Lp * D + Lp * kWarps + Lp;
}

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Scores of Lp staged positions (Lp a multiple of kLT), summed per warp:
// part[l * kWarps + w] = sum over the hidden units j of warp w of
// tanh(x[l] . W1[:, j] + b1[j]) * w2[j]. With G = 1 thread t owns j = t,
// t + 256, ... for every position; with G > 1 (H = 256 / G, a multiple of
// 32) the threads form G groups of H, group g taking the register tiles
// g, g + G, ... and thread t of a group hidden unit t, so that every
// thread scores at H < 256; only the warps of a tile's group write its
// part entries (group_warps). A thread keeps kLT accumulators, so each W1
// value read from shared memory feeds kLT FMAs while x is read as
// broadcast float4s.
__device__ inline void score_rows(const float* __restrict__ xs,
                                  const float* __restrict__ w1s,
                                  const float* __restrict__ b1,
                                  const float* __restrict__ w2,
                                  float* __restrict__ part, int Lp, int D,
                                  int H, int G = 1) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hs = kThreads / G, g = tid / hs, j0 = tid - g * hs;
  // scores: s[l] = sum_j tanh(x[l] . W1[:, j] + b1[j]) * w2[j]
  for (int l0 = g * kLT; l0 < Lp; l0 += G * kLT) {
    float p[kLT];
#pragma unroll
    for (int t = 0; t < kLT; ++t) p[t] = 0.f;
    for (int j = j0; j < H; j += hs) {
      float acc[kLT];
      const float bj = b1[j];
#pragma unroll
      for (int t = 0; t < kLT; ++t) acc[t] = 0.f;
      for (int d = 0; d < D; d += 4) {
        const float wa = w1s[(d + 0) * H + j];
        const float wb = w1s[(d + 1) * H + j];
        const float wc = w1s[(d + 2) * H + j];
        const float wd = w1s[(d + 3) * H + j];
#pragma unroll
        for (int t = 0; t < kLT; ++t) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + (l0 + t) * D + d);
          acc[t] = fmaf(xv.x, wa, acc[t]);
          acc[t] = fmaf(xv.y, wb, acc[t]);
          acc[t] = fmaf(xv.z, wc, acc[t]);
          acc[t] = fmaf(xv.w, wd, acc[t]);
        }
      }
      const float qj = w2[j];
#pragma unroll
      for (int t = 0; t < kLT; ++t) p[t] = fmaf(tanhf(acc[t] + bj), qj, p[t]);
    }
#pragma unroll
    for (int t = 0; t < kLT; ++t) {
      const float v = warp_sum(p[t]);
      if (lane == 0) part[(l0 + t) * kWarps + warp] = v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
additive_pool_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, T* __restrict__ out,
                     int N, int L, int D, int H) {
  extern __shared__ __align__(16) float smem[];
  const int Lp = round_up(L, kLT);
  float* w1s = smem;
  float* xs = w1s + (size_t)D * H;
  float* part = xs + (size_t)Lp * D;
  float* as = part + (size_t)Lp * kWarps;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < D * H; i += kThreads) w1s[i] = w1[i];
  // the padding positions are never written again
  for (int i = L * D + tid; i < Lp * D; i += kThreads) xs[i] = 0.f;

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const T* xr = x + (size_t)n * L * D;
    for (int i = tid; i < L * D; i += kThreads) xs[i] = to_f32(xr[i]);
    __syncthreads();

    score_rows(xs, w1s, b1, w2, part, Lp, D, H);
    __syncthreads();

    // masked softmax over l; lane k owns positions k, k + 32, ...
    if (warp == 0) {
      const float neg = -FLT_MAX;
      const float* mr = mask + (size_t)n * L;
      float m = neg;
      for (int l = lane; l < L; l += 32) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += part[l * kWarps + w];
        s = mr[l] > 0.f ? s : neg;
        as[l] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      m = m > neg * 0.5f ? m : 0.f;
      float sum = 0.f;
      for (int l = lane; l < L; l += 32) {
        const float e = expf(as[l] - m) * mr[l];
        as[l] = e;
        sum += e;
      }
      const float denom = warp_sum(sum) + kEps;
      for (int l = lane; l < L; l += 32) as[l] = as[l] / denom;
    }
    __syncthreads();

    for (int d = tid; d < D; d += kThreads) {
      float o = 0.f;
      for (int l = 0; l < L; ++l) o = fmaf(as[l], xs[l * D + d], o);
      store(out + (size_t)n * D + d, o);
    }
    __syncthreads();  // xs and as are rewritten by the next item
  }
}

// Lets the kernel use the device's opt-in shared memory and sets *blocks to
// the persistent blocks that fit on the device at once at these widths.
template <typename T>
cudaError_t prepare(int L, int D, int H, int device, int* blocks) {
  auto kernel = additive_pool_kernel<T>;
  const size_t smem = smem_floats(L, D, H) * sizeof(float);
  int sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <typename T>
int launch(const void* x, const void* mask, const void* w1, const void* b1,
           const void* w2, void* out, int N, int L, int D, int H, int blocks,
           cudaStream_t stream) {
  const size_t smem = smem_floats(L, D, H) * sizeof(float);
  const int grid = N < blocks ? N : blocks;
  additive_pool_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<T*>(out), N, L, D, H);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Long-sequence kernel (L > 128: the flattened histories), f32 or bf16 x
// ---------------------------------------------------------------------------

constexpr int kChunk = 64;  // positions staged at once

// shared memory, in floats: W1[D*H] | x[kChunk*D] | partial s[kChunk*kWarps]
// | e[kChunk] | mask[kChunk] | acc[D] | the chunk's rescale factor and the
// denominator: independent of L
__host__ __device__ inline size_t long_smem_floats(int D, int H) {
  return (size_t)D * H + (size_t)kChunk * D + kChunk * kWarps +
         2 * kChunk + D + 2;
}

// The thread groups of the long kernel's scores: 256 / H where H is a
// multiple of 32 below 256, else 1 (score_rows).
__host__ __device__ inline int long_groups(int H) {
  return H % 32 == 0 && H < kThreads && kThreads % H == 0 ? kThreads / H : 1;
}

// Persistent blocks of 256 threads; block b walks items n = b, b +
// gridDim.x, ... . W1 is staged once per block. An item's positions are
// streamed in chunks of kChunk: each chunk (16-byte loads where x's rows
// allow) and its mask are staged in shared memory as f32, scored as
// additive_pool_kernel scores (score_rows, every thread busy at H 64:
// long_groups), and folded into
// an online softmax: warp 0 keeps the running max m of the masked scores
// (-FLT_MAX for masked positions) and the running sum of e = exp(s - m') *
// mask, where m' is m, or 0 while every position so far is masked (the
// reference's all-masked rule); each chunk rescales the sum and the
// running weighted sum acc[d] (thread d) by exp(m'_old - m'_new) (0 while
// nothing was summed) before adding its own terms. out = acc / (sum +
// EPS): the reference's a = e / (sum + EPS), summed in another order; an
// all-masked item gives exactly 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
additive_pool_long(const T* __restrict__ x, const float* __restrict__ mask,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, T* __restrict__ out, int N,
                   int L, int D, int H, int G) {
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;
  float* xs = w1s + (size_t)D * H;
  float* part = xs + (size_t)kChunk * D;
  float* es = part + kChunk * kWarps;
  float* ms = es + kChunk;
  float* acc = ms + kChunk;
  float* stat = acc + D;  // [0] rescale, [1] denominator

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float neg = -FLT_MAX;
  // a tile's partial scores come from the warps of its group
  const int wpg = kWarps / G;
  // 16-byte loads of x where its rows are 16-byte multiples
  constexpr int V = 16 / sizeof(T);
  const bool vec = (D * (int)sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  for (int i = tid; i < D * H; i += kThreads) w1s[i] = w1[i];

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const T* xr = x + (size_t)n * L * D;
    const float* mr = mask + (size_t)n * L;
    float m_run = neg, sum_run = 0.f;  // warp 0's
    for (int d = tid; d < D; d += kThreads) acc[d] = 0.f;
    for (int c0 = 0; c0 < L; c0 += kChunk) {
      const int nc = min(kChunk, L - c0), ncp = round_up(nc, kLT);
      const T* xc = xr + (size_t)c0 * D;
      if (vec) {
        for (int i = tid * V; i < ncp * D; i += kThreads * V) {
          if (i < nc * D) {
            const uint4 u = *reinterpret_cast<const uint4*>(xc + i);
            const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
            for (int k = 0; k < V; ++k) xs[i + k] = to_f32(e[k]);
          } else {
#pragma unroll
            for (int k = 0; k < V; ++k) xs[i + k] = 0.f;
          }
        }
      } else {
        for (int i = tid; i < ncp * D; i += kThreads)
          xs[i] = i < nc * D ? to_f32(xc[i]) : 0.f;
      }
      if (tid < nc) ms[tid] = mr[c0 + tid];
      __syncthreads();
      score_rows(xs, w1s, b1, w2, part, ncp, D, H, G);
      __syncthreads();
      if (warp == 0) {
        float cm = neg;
        for (int l = lane; l < nc; l += 32) {
          const int w0 = ((l / kLT) % G) * wpg;
          float s = 0.f;
          for (int w = w0; w < w0 + wpg; ++w) s += part[l * kWarps + w];
          s = ms[l] > 0.f ? s : neg;
          es[l] = s;
          cm = fmaxf(cm, s);
        }
        const float m_new = fmaxf(m_run, warp_max(cm));
        const float m_eff = m_new > neg * 0.5f ? m_new : 0.f;
        const float scale = m_run > neg * 0.5f ? expf(m_run - m_eff) : 0.f;
        float sum = 0.f;
        for (int l = lane; l < nc; l += 32) {
          const float e = expf(es[l] - m_eff) * ms[l];
          es[l] = e;
          sum += e;
        }
        sum_run = fmaf(sum_run, scale, warp_sum(sum));
        m_run = m_new;
        if (lane == 0) stat[0] = scale;
      }
      __syncthreads();
      const float scale = stat[0];
      for (int d = tid; d < D; d += kThreads) {
        float o = acc[d] * scale;
        for (int l = 0; l < nc; ++l) o = fmaf(es[l], xs[l * D + d], o);
        acc[d] = o;
      }
      __syncthreads();  // xs, es and ms are rewritten by the next chunk
    }
    if (tid == 0) stat[1] = sum_run + kEps;
    __syncthreads();
    const float denom = stat[1];
    for (int d = tid; d < D; d += kThreads)
      store(out + (size_t)n * D + d, acc[d] / denom);
    __syncthreads();  // acc and stat are rewritten by the next item
  }
}

template <typename T>
cudaError_t prepare_long(int D, int H, int device, int* blocks) {
  auto kernel = additive_pool_long<T>;
  const size_t smem = long_smem_floats(D, H) * sizeof(float);
  int sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <typename T>
int launch_long(const void* x, const void* mask, const void* w1,
                const void* b1, const void* w2, void* out, int N, int L, int D,
                int H, int blocks, cudaStream_t stream) {
  const size_t smem = long_smem_floats(D, H) * sizeof(float);
  const int grid = N < blocks ? N : blocks;
  additive_pool_long<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<T*>(out), N, L, D, H,
      long_groups(H));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core kernel: bf16 x, D = 64, H = 64 * NCH (NCH <= 4), G*L <= 128
// ---------------------------------------------------------------------------

constexpr int kTcD = 64;
constexpr int kRowBytes = kTcD * 2;  // one 128-byte swizzled row per position
constexpr int kTileRows = 128;
constexpr int kMaxH = 256;
constexpr int kStages = 4;
constexpr int kScoreThreads = 256;  // warpgroups 0 and 1
constexpr int kPoolWarps = 4;       // warpgroup 2
constexpr int kTcThreads = kScoreThreads + 32 * kPoolWarps;
constexpr int kScoreRegs = 208, kPoolRegs = 80;
constexpr int kXBytes = kTileRows * kRowBytes;  // one stage of x
constexpr int kW1Piece = 16384;                 // bytes of f32 W1 per bulk copy
constexpr int kSwizzle = hopper::swizzle_layout(kRowBytes);
// the mask box: a tile's positions and up to 3 before them, from a 16-byte
// boundary; a stage of it, rounded up to the 128 bytes a TMA destination
// is aligned to
constexpr int kMaskBox = kTileRows + 4;
constexpr int kMaskStage = kTileRows + 32;

// Shared memory, byte offsets from the 1024-byte aligned base: W1^T (bf16,
// up to 256 rows) | W1 as copied (f32, D x H) | x stages | mask stages |
// score stages | {b1, w2} pairs | full and scored mbarriers per stage, and
// W1's; plus the alignment slack.
constexpr int kOffW1 = kMaxH * kRowBytes;
constexpr int kOffX = kOffW1 + kTcD * kMaxH * 4;
constexpr int kOffMask = kOffX + kStages * kXBytes;
constexpr int kOffScore = kOffMask + kStages * kMaskStage * 4;
constexpr int kOffBW = kOffScore + kStages * kTileRows * 4;
constexpr int kOffBars = kOffBW + kMaxH / 2 * 16;
constexpr int kTcSmemBytes = kOffBars + (2 * kStages + 1) * 8 + 1024;

// The K-major wgmma descriptor of 64 rows from row0 of a tile of 128-byte
// swizzled rows (an x stage or W1^T), k-step k (columns 16k..16k+15)
__device__ __forceinline__ uint64_t kdesc(const unsigned char* t, int row0,
                                          int k) {
  return hopper::make_desc(t + row0 * kRowBytes + k * 32, 16, 8 * kRowBytes,
                           kSwizzle);
}

__device__ __forceinline__ float tanh_approx(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// acc = rows 64wg..64wg+63 of the x stage xt times W1 columns 64c..64c+63,
// issued as one committed group
__device__ __forceinline__ void issue_group(float (&acc)[32],
                                            const unsigned char* xt,
                                            const unsigned char* w1t, int wg,
                                            int c) {
  hopper::wgmma_fence();  // acc was read since its last product
#pragma unroll
  for (int k = 0; k < kTcD / 16; ++k)
    hopper::wgmma_ss<0, 0>(acc, kdesc(xt, 64 * wg, k), kdesc(w1t, 64 * c, k),
                           k);
  hopper::wgmma_commit();
  hopper::fence_regs(acc);
}

template <int NCH>
__global__ void __launch_bounds__(kTcThreads, 1)
additive_pool_tc(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tm,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, __nv_bfloat16* __restrict__ out,
                 int N, int L, int G, int n_tiles) {
  constexpr int H = 64 * NCH;
  extern __shared__ unsigned char smem_raw[];
  // the 1024-byte aligned base, as an offset into smem_raw so that the
  // compiler keeps every access below in the shared space (ld.shared, not
  // generic loads)
  unsigned char* smem =
      smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* w1t = smem;
  const float* w1s = reinterpret_cast<const float*>(smem + kOffW1);
  unsigned char* xs = smem + kOffX;
  float* ms = reinterpret_cast<float*>(smem + kOffMask);
  float* sc = reinterpret_cast<float*>(smem + kOffScore);
  float4* bw = reinterpret_cast<float4*>(smem + kOffBW);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBars);
  uint64_t* scored = full + kStages;
  uint64_t* w1bar = scored + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = G * L;  // the rows of a tile that hold items
  // the loading thread: warpgroup 2's first
  const bool loader = threadIdx.x == kScoreThreads;
  // tile t as the k-th of this CTA: x and mask into stage k % kStages
  auto load = [&](int k, int t) {
    const int s = k % kStages;
    hopper::mbar_arrive_expect_tx(&full[s], rows * kRowBytes + kMaskBox * 4);
    hopper::tma_load_2d(xs + s * kXBytes, &tx, &full[s], 0, t * rows);
    hopper::tma_load_1d(ms + s * kMaskStage, &tm, &full[s], (t * rows) & ~3);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);  // the loader's expect_tx
      hopper::mbar_init(&scored[s], kScoreThreads);
    }
    hopper::mbar_init(w1bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (loader) {
    hopper::prefetch_tensor_map(&tx);
    hopper::prefetch_tensor_map(&tm);
    hopper::mbar_arrive_expect_tx(w1bar, kTcD * H * 4);
    for (int p = 0; p < kTcD * H * 4 / kW1Piece; ++p)
      hopper::bulk_load(smem + kOffW1 + p * kW1Piece,
                        reinterpret_cast<const unsigned char*>(w1) + p * kW1Piece,
                        kW1Piece, w1bar);
    for (int k = 0; k < kStages; ++k) {
      const int t = blockIdx.x + k * gridDim.x;
      if (t < n_tiles) load(k, t);
    }
  }

  // ---- all: b1 and w2, the pad rows of every stage, then W1^T ----------
  for (int j = threadIdx.x; j < H / 2; j += kTcThreads)
    bw[j] = make_float4(b1[2 * j], b1[2 * j + 1], w2[2 * j], w2[2 * j + 1]);
  for (int i = rows * kRowBytes / 16 + threadIdx.x; i < kXBytes / 16;
       i += kTcThreads)
    for (int s = 0; s < kStages; ++s)
      reinterpret_cast<uint4*>(xs + s * kXBytes)[i] = make_uint4(0, 0, 0, 0);
  hopper::mbar_wait(w1bar, 0);
  // W1^T[j, 8q..8q+7]: eight f32 of column j (consecutive threads,
  // consecutive columns: no bank conflict), one 16-byte store (eight
  // consecutive rows of one 16-byte column: distinct banks under the
  // swizzle)
#pragma unroll 2
  for (int u = threadIdx.x; u < (kTcD / 8) * H; u += kTcThreads) {
    const int q = u / H, j = u - q * H;
    const float* col = w1s + 8 * q * H + j;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(col[(2 * i) * H], col[(2 * i + 1) * H]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(
        w1t + hopper::swizzled(j * kRowBytes + q * 16, kRowBytes)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  hopper::fence_proxy_async();  // before wgmma reads them
  __syncthreads();

  if (warp >= kScoreThreads / 32) {
    // ---- warpgroup 2: pool each scored tile's items, refill its stage ---
    hopper::setmaxnreg_dec<kPoolRegs>();
    const int pw = warp - kScoreThreads / 32;
    const int grp = lane >> 3, c8 = (lane & 7) * 8;  // positions, 8 columns
    int k = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++k) {
      const int s = k % kStages;
      const uint32_t phase = (k / kStages) & 1;
      hopper::mbar_wait(&full[s], phase);  // x and mask, seen by this thread
      hopper::mbar_wait(&scored[s], phase);
      const unsigned char* xt = xs + s * kXBytes;
      float* st = sc + s * kTileRows;
      const float* mt = ms + s * kMaskStage + ((t * rows) & 3);
      for (int i = pw; i < G; i += kPoolWarps) {
        const int n = t * G + i;
        if (n >= N) break;
        float* si = st + i * L;
        const float* mi = mt + i * L;
        float m = -FLT_MAX;
        for (int l = lane; l < L; l += 32)
          m = fmaxf(m, mi[l] > 0.f ? si[l] : -FLT_MAX);
        m = warp_max(m);
        m = m > -0.5f * FLT_MAX ? m : 0.f;
        float sum = 0.f;
        for (int l = lane; l < L; l += 32) {
          const float e = __expf((mi[l] > 0.f ? si[l] : -FLT_MAX) - m) * mi[l];
          si[l] = e;
          sum += e;
        }
        const float inv = 1.f / (warp_sum(sum) + kEps);
        __syncwarp();
        float o[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) o[q] = 0.f;
#pragma unroll 2
        for (int l = grp; l < L; l += 4) {
          const float e = si[l];
          const uint4 v = *reinterpret_cast<const uint4*>(
              xt + hopper::swizzled((i * L + l) * kRowBytes + c8 * 2, kRowBytes));
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&w[q]));
            o[2 * q] = fmaf(e, f.x, o[2 * q]);
            o[2 * q + 1] = fmaf(e, f.y, o[2 * q + 1]);
          }
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          o[q] += __shfl_xor_sync(0xffffffffu, o[q], 8);
          o[q] += __shfl_xor_sync(0xffffffffu, o[q], 16);
        }
        if (grp == 0) {
          uint32_t w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const __nv_bfloat162 h =
                __floats2bfloat162_rn(o[2 * q] * inv, o[2 * q + 1] * inv);
            w[q] = *reinterpret_cast<const uint32_t*>(&h);
          }
          *reinterpret_cast<uint4*>(out + (size_t)n * kTcD + c8) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      // every pool warp is done with the stage: the loader refills it
      hopper::named_barrier_sync(1, 32 * kPoolWarps);
      if (loader && t + kStages * gridDim.x < n_tiles)
        load(k + kStages, t + kStages * gridDim.x);
    }
    return;
  }

  // ---- warpgroups 0 and 1: the scores of each tile ----------------------
  hopper::setmaxnreg_inc<kScoreRegs>();
  const int wg = warp >> 2, wl = warp & 3;
  const int r0 = 64 * wg + 16 * wl + (lane >> 2);  // this thread's rows r0, r0 + 8
  const int pair = lane & 3;  // columns 8c + 2 pair, + 1 of each 8-column chunk
  // whether the warp's first and second 8-row half hold any item row
  const bool live0 = 64 * wg + 16 * wl < rows;
  const bool live1 = 64 * wg + 16 * wl + 8 < rows;
  float acc[NCH][32];
  hopper::mbar_wait(&full[0], 0);
#pragma unroll
  for (int c = 0; c < NCH; ++c) issue_group(acc[c], xs, w1t, wg, c);
  hopper::wgmma_wait<0>();
  int k = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++k) {
    const int s = k % kStages;
    const bool next = t + gridDim.x < n_tiles;
    // the stage of the next tile; past the last tile, this one's again (a
    // product nobody reads), so that every tile runs the same wgmma
    // sequence
    const int sn = next ? (k + 1) % kStages : s;
    // s[r] = sum_j tanh(acc[r, j] + b1[j]) * w2[j], group by group; each
    // group, once read, takes the next tile's product. No product is in
    // flight across iterations: ptxas serialises every wgmma of a loop
    // that carries one.
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      hopper::fence_regs(acc[c]);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const float4 p = bw[32 * c + 4 * cc + pair];
        if (live0) {
          s0 = fmaf(tanh_approx(acc[c][4 * cc + 0] + p.x), p.z, s0);
          s0 = fmaf(tanh_approx(acc[c][4 * cc + 1] + p.y), p.w, s0);
        }
        if (live1) {
          s1 = fmaf(tanh_approx(acc[c][4 * cc + 2] + p.x), p.z, s1);
          s1 = fmaf(tanh_approx(acc[c][4 * cc + 3] + p.y), p.w, s1);
        }
      }
      if (c == 0 && next) hopper::mbar_wait(&full[sn], ((k + 1) / kStages) & 1);
      issue_group(acc[c], xs + sn * kXBytes, w1t, wg, c);
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (pair == 0) {
      sc[s * kTileRows + r0] = s0;
      sc[s * kTileRows + r0 + 8] = s1;
    }
    hopper::mbar_arrive(&scored[s]);
    hopper::wgmma_wait<0>();
  }
}

// box > 0: x as (rows, 64) bf16 in boxes of 64 x `box` rows, 128-byte
// swizzle; box == 0: the mask as `rows` f32 in boxes of kMaskBox. Parts of
// a box past the tensor are zero-filled.
bool tile_map(CUtensorMap* map, const void* p, long long rows, int box) {
  if (box) {
    const cuuint64_t dims[2] = {(cuuint64_t)kTcD, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)kRowBytes};
    const cuuint32_t boxd[2] = {(cuuint32_t)kTcD, (cuuint32_t)box};
    return hopper::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p,
                              dims, strides, boxd, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  }
  const cuuint64_t dims[1] = {(cuuint64_t)rows};
  const cuuint64_t strides[1] = {4};  // a rank-1 map reads none
  const cuuint32_t boxd[1] = {(cuuint32_t)kMaskBox};
  return hopper::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, p, dims,
                            strides, boxd, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE);
}

template <int NCH>
int launch_tc(const CUtensorMap& mx, const CUtensorMap& mm, const void* w1,
              const void* b1, const void* w2, void* out, int N, int L, int G,
              int n_tiles, int grid, cudaStream_t st) {
  additive_pool_tc<NCH><<<grid, kTcThreads, kTcSmemBytes, st>>>(
      mx, mm, static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<__nv_bfloat16*>(out), N, L,
      G, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the CUDA-core kernel needs at these
// widths.
size_t additive_pool_smem_bytes(int L, int D, int H) {
  return smem_floats(L, D, H) * sizeof(float);
}

// Readies the CUDA-core kernel for x of this type at these widths on
// `device`, once: sets *blocks to the persistent grid that
// additive_pool_forward takes. Returns a cudaError_t.
int additive_pool_prepare(int L, int D, int H, int x_is_bf16, int device,
                          int* blocks) {
  if (x_is_bf16) return prepare<__nv_bfloat16>(L, D, H, device, blocks);
  return prepare<float>(L, D, H, device, blocks);
}

// The CUDA-core kernel. x (N, L, D) f32 or bf16 (x_is_bf16), mask (N, L)
// f32, w1 (D, H) f32, b1 (H) f32, w2 (H) f32 -> out (N, D) of x's type. All
// contiguous, all on `device`; D % 4 == 0; `blocks` from
// additive_pool_prepare at the same widths, type and device. Enqueued on
// `stream`; queries nothing and returns a cudaError_t.
int additive_pool_forward(const void* x, const void* mask, const void* w1,
                          const void* b1, const void* w2, void* out, int N,
                          int L, int D, int H, int x_is_bf16, int blocks,
                          int device, void* stream) {
  if (N == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch<__nv_bfloat16>(x, mask, w1, b1, w2, out, N, L, D, H, blocks,
                                 st);
  return launch<float>(x, mask, w1, b1, w2, out, N, L, D, H, blocks, st);
}

// Readies the tensor-core kernel for hidden width H on `device`, once: lets
// it use its shared memory and sets *blocks to the device's SM count (its
// persistent grid). Returns a cudaError_t.
int additive_pool_tc_prepare(int H, int device, int* blocks) {
  if (H < 64 || H > kMaxH || H % 64) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (!hopper::encode_tiled()) return cudaErrorNotSupported;
  const void* kernels[4] = {
      reinterpret_cast<const void*>(additive_pool_tc<1>),
      reinterpret_cast<const void*>(additive_pool_tc<2>),
      reinterpret_cast<const void*>(additive_pool_tc<3>),
      reinterpret_cast<const void*>(additive_pool_tc<4>)};
  err = cudaFuncSetAttribute(kernels[H / 64 - 1],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTcSmemBytes);
  if (err != cudaSuccess) return err;
  *blocks = sms;
  return cudaSuccess;
}

// The tensor-core kernel. x (N, L, 64) bf16, mask (N, L) f32 and w1 (64, H)
// f32, contiguous and 16-byte aligned; b1 (H) f32, w2 (H) f32 contiguous;
// out (N, 64) bf16, 16-byte aligned. H = 64, 128, 192 or 256; G items per tile
// with G * L <= 128; `blocks` from additive_pool_tc_prepare at the same H
// and device. Enqueued on `stream`; returns a cudaError_t.
int additive_pool_tc_forward(const void* x, const void* mask, const void* w1,
                             const void* b1, const void* w2, void* out, int N,
                             int L, int H, int G, int blocks, int device,
                             void* stream) {
  if (N == 0) return cudaSuccess;
  if (L < 1 || G < 1 || G * L > kTileRows || H < 64 || H > kMaxH || H % 64 ||
      reinterpret_cast<uintptr_t>(w1) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  CUtensorMap mx, mm;
  const long long positions = (long long)N * L;
  if (!tile_map(&mx, x, positions, G * L) || !tile_map(&mm, mask, positions, 0))
    return cudaErrorInvalidValue;
  const int n_tiles = (N + G - 1) / G;
  const int grid = n_tiles < blocks ? n_tiles : blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / 64) {
    case 1: return launch_tc<1>(mx, mm, w1, b1, w2, out, N, L, G, n_tiles, grid, st);
    case 2: return launch_tc<2>(mx, mm, w1, b1, w2, out, N, L, G, n_tiles, grid, st);
    case 3: return launch_tc<3>(mx, mm, w1, b1, w2, out, N, L, G, n_tiles, grid, st);
    default: return launch_tc<4>(mx, mm, w1, b1, w2, out, N, L, G, n_tiles, grid, st);
  }
}

// Dynamic shared memory one block of the long-sequence kernel needs at
// these widths, whatever L.
size_t additive_pool_long_smem_bytes(int D, int H) {
  return long_smem_floats(D, H) * sizeof(float);
}

// Readies the long-sequence kernel as additive_pool_prepare readies the
// CUDA-core one.
int additive_pool_long_prepare(int D, int H, int x_is_bf16, int device,
                               int* blocks) {
  if (x_is_bf16) return prepare_long<__nv_bfloat16>(D, H, device, blocks);
  return prepare_long<float>(D, H, device, blocks);
}

// The long-sequence kernel, any L >= 1: the arguments of
// additive_pool_forward, `blocks` from additive_pool_long_prepare.
int additive_pool_long_forward(const void* x, const void* mask,
                               const void* w1, const void* b1, const void* w2,
                               void* out, int N, int L, int D, int H,
                               int x_is_bf16, int blocks, int device,
                               void* stream) {
  if (N == 0) return cudaSuccess;
  if (L < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_long<__nv_bfloat16>(x, mask, w1, b1, w2, out, N, L, D, H,
                                      blocks, st);
  return launch_long<float>(x, mask, w1, b1, w2, out, N, L, D, H, blocks, st);
}

const char* additive_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
