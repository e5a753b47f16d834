// Packed-block multi-head attention for Hopper (sm_90a): the forward with
// attention dropout, the backward, and the dropout keep mask.
//
// Replaces the three TPU kernels of the JAX package's
// ops/pallas_attention.py: `_fwd_kernel` (launched by `_call_fwd`),
// `_bwd_kernel` (launched by `_call_bwd`) and `_bits_kernel` (launched by
// `dropout_keep_mask`). For each row b and head h (columns h*dh .. h*dh+dh-1
// of D = H*dh):
//     s  = (q_h . k_h^T) * scale + bias[b]    (T x T, f32; scale = 1/sqrt(dh))
//     p  = exp(s - rowmax(s)) / rowsum(...)   (f32)
//     pd = keep ? p / (1 - dropout) : 0       (keep: see "Dropout bits")
//     o_h = round(pd to v's type) . v_h       (f32 sums, rounded once)
// and the backward, which recomputes p from q, k and the bias and draws the
// same bits (only q, k, v, bias and the seed are kept between the two):
//     dv_h = round(pd)^T . g_h
//     dp   = (round(g_h) . v_h^T) * keep / (1 - dropout)
//     ds   = round(p * (dp - rowsum(dp * p)) * scale)     (to q's type)
//     dq_h = ds . k_h ;  dk_h = ds^T . q_h
// q, k, v, g and the outputs are (B, T, D), f32 or bf16, contiguous; bias is
// (B, T, T) in f32 or bf16 with element strides (sb, sq, 1), so a broadcast
// view is read as it is. Any T <= 128: no padding of T in device memory. A
// key whose bias is the type's lowest value gets exactly zero weight.
//
// Dropout bits. One Philox4x32-10 draw (counter-based) gives four 32-bit
// words; the bits of element (i, j) of head h of row b are a pure function
// of (seed, b, h, i, j):
//     counter (j / 2, i with bit 3 cleared, h, b), key (seed, 0),
//     word (i >> 3 & 1) * 2 + (j & 1)
// so the four words of one draw are exactly the elements (i, j), (i, j+1),
// (i+8, j), (i+8, j+1) that one lane holds in the m16n8 accumulator layout
// of mma.sync. The forward, the backward and the mask kernel call the same
// `dropout_bits4`, so they agree whatever their grid or block shape. An
// element is kept iff its bits >= floor(dropout * 2^32), as in the TPU
// kernels (`_keep_threshold`); the TPU's own draws (seeded per program)
// cannot be reproduced and are not: the contract is that the same keep
// mask gives the same output. The seed is read from device memory.
//
// What bounds them. The LM item encoder's training page gives one call
// B = 171 packed rows, T = 120 (3 items of 40 tokens), D = 768, 12 heads,
// bf16. The forward moves q, k, v, out (4 * 171*120*768 * 2 B) and the bias
// (171*120*120 * 2 B): 131 MB, 39 us at 3.35 TB/s, against 4*B*T^2*D =
// 7.6 GFLOP, 7.7 us on the bf16 tensor cores. The backward reads q, k, v, g
// and the bias and writes dq, dk, dv (7 * 31.5 MB + 4.9 MB = 226 MB, 67 us)
// for 8*B*T^2*D = 15.1 GFLOP plus the recompute (19 GFLOP, 19 us). Both are
// bound by bytes only if the products run on the tensor cores, and the
// Philox draws (10 rounds of two 32-bit multiplies per four elements) must
// stay off the critical path.
//
// Design. One block per (b, h); 1-D grid, b-major, so the blocks of one row
// run together and read its bias from L2.
//  * forward, bf16, dh in {16, 32, 64, 128} (the main path): attention_mma.
//    8 warps. Q_h, K_h and V_h (Tp x dh, Tp = T rounded up to 16, zero rows
//    past T) are staged in shared memory with cp.async, all copies in flight
//    at once, rows padded by 16 B so ldmatrix is free of bank conflicts.
//    Warp w owns query rows 16w..16w+15: S = Q.K^T with mma.sync m16n8k16
//    (bf16 in, f32 accumulate) into registers, scale + bias (read from
//    device memory, two neighbouring columns per load when the strides
//    allow), row max and sum across each quad of lanes with shuffles, p =
//    e / sum, the dropout applied in registers (one Philox draw per four
//    elements, template parameter DROP so the eval path carries none of
//    it), rounded to bf16 and packed in place as the A operand of O = P.V.
//    Nothing of (T, T) leaves registers. exp is __expf and each row divides
//    by one reciprocal: within a few f32 ulps, below the bf16 rounding of p.
//  * backward, bf16: attention_bwd_mma, 8 warps, one block per SM (up to
//    209 KB of shared memory at dh = 128). Q, K, V and g staged as in the
//    forward. Phase 1, warp w on query rows 16w..16w+15: S and P as in the
//    forward, dPd = g.V^T with the same mma loop, dp, the row sums, dS; dS
//    and round(pd) go to shared memory (Tp x Tp bf16 each), then dQ = dS.K
//    for the warp's own rows. Phase 2, after one barrier, warp w on key
//    rows 16w..16w+15: dK = dS^T.Q and dV = round(pd)^T.g, the transposed
//    A operands read with ldmatrix.trans. Each output row is written once
//    by one warp: no atomics.
//  * f32 (forward and backward): attention_simt / attention_bwd_simt on the
//    CUDA cores, with the reference's exact expf and division. 4 warps; a
//    warp takes one query row at a time (lane j owns keys j, j+32, j+64,
//    j+96), then, in the backward, one key row at a time for dK and dV. K
//    and V are staged with rows padded to dh + 1 floats, so that both the
//    lane-per-key and the lane-per-column reads are free of bank conflicts.
//  * keep mask: dropout_mask, one block per (b, h), one Philox draw per
//    four elements, the mask written as bytes.
// wgmma and TMA are left for a later version. The C entry points return a
// cudaError_t; a launch is checked with cudaGetLastError() and never
// synchronises. packed_attention_prepare sets the shared-memory attributes
// once per device.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxT = 128;
constexpr int kSimtWarps = 4;
constexpr int kSimtThreads = 32 * kSimtWarps;
constexpr int kMmaThreads = 256;  // 8 warps x 16 query rows = kMaxT
constexpr int kMaskThreads = 256;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ inline float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ inline float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

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
// Dropout bits: Philox4x32-10 as a pure function of (seed, b, h, i, j)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// The bits of (i, j), (i, j+1), (i+8, j), (i+8, j+1) for i with bit 3 clear
// and j even (the words of one draw).
__device__ __forceinline__ uint4 dropout_bits4(uint32_t seed, int b, int h,
                                               int i, int j) {
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(j) >> 1, static_cast<uint32_t>(i & ~8),
                 static_cast<uint32_t>(h), static_cast<uint32_t>(b)),
      make_uint2(seed, 0u));
}

// The bits of one element (i, j).
__device__ __forceinline__ uint32_t dropout_bits(uint32_t seed, int b, int h,
                                                 int i, int j) {
  const uint4 r = dropout_bits4(seed, b, h, i, j);
  const int w = ((i >> 3) & 1) * 2 + (j & 1);
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

// the dropout of one probability: kept (scaled) or zero
__device__ __forceinline__ float drop(float p, uint32_t bits, uint32_t thresh,
                                      float keep_scale) {
  return bits >= thresh ? p * keep_scale : 0.f;
}

__global__ void __launch_bounds__(kMaskThreads)
dropout_mask(const int* __restrict__ seed_ptr, uint8_t* __restrict__ out,
             int Tn, int H, uint32_t thresh) {
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  uint8_t* o = out + (size_t)blockIdx.x * Tn * Tn;
  // one work item per draw: rows i with bit 3 clear, columns j even
  const int n_i = ((Tn + 15) / 16) * 8, n_j = (Tn + 1) / 2;
  for (int w = threadIdx.x; w < n_i * n_j; w += kMaskThreads) {
    const int ig = w / n_j, j = 2 * (w - ig * n_j);
    const int i = (ig >> 3) * 16 + (ig & 7);
    if (i >= Tn) continue;
    const uint4 r = dropout_bits4(seed, b, h, i, j);
    o[i * Tn + j] = r.x >= thresh;
    if (j + 1 < Tn) o[i * Tn + j + 1] = r.y >= thresh;
    if (i + 8 < Tn) {
      o[(i + 8) * Tn + j] = r.z >= thresh;
      if (j + 1 < Tn) o[(i + 8) * Tn + j + 1] = r.w >= thresh;
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core kernels (f32)
// ---------------------------------------------------------------------------

// shared memory, in floats: K^T[dh][T] | V[T][dh] | q[warps][dh] | p[warps][kMaxT]
__host__ __device__ inline size_t simt_smem_bytes(int T, int dh) {
  return ((size_t)2 * T * dh + (size_t)kSimtWarps * (dh + kMaxT)) * sizeof(float);
}

__global__ void __launch_bounds__(kSimtThreads)
attention_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               float* __restrict__ out, int Tn, int H, int dh, float scale,
               long long sb, long long sq, const int* __restrict__ seed_ptr,
               uint32_t thresh, float keep_scale, int dropout) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                        // [dh][Tn]
  float* vs = kt + (size_t)dh * Tn;        // [Tn][dh]
  float* qs = vs + (size_t)Tn * dh;        // [kSimtWarps][dh]
  float* ps = qs + kSimtWarps * dh;        // [kSimtWarps][kMaxT]

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int D = H * dh;
  const size_t base = (size_t)b * Tn * D + (size_t)h * dh;
  const uint32_t seed = dropout ? static_cast<uint32_t>(*seed_ptr) : 0u;
  for (int i = threadIdx.x; i < Tn * dh; i += kSimtThreads) {
    const int j = i / dh, d = i - j * dh;
    const size_t g = base + (size_t)j * D + d;
    kt[d * Tn + j] = k[g];
    vs[i] = v[g];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* qw = qs + warp * dh;
  float* pw = ps + warp * kMaxT;
  const float* bb = bias + b * sb;
  for (int i = warp; i < Tn; i += kSimtWarps) {
    for (int d = lane; d < dh; d += 32) qw[d] = q[base + (size_t)i * D + d];
    __syncwarp();
    // scores: lane j owns keys j, j+32, j+64, j+96, four independent
    // chains, each summed over d in order
    float s[kMaxT / 32];
#pragma unroll
    for (int c = 0; c < kMaxT / 32; ++c) s[c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < dh; ++d) {
      const float qd = qw[d];
      const float* kr = kt + d * Tn + lane;
#pragma unroll
      for (int c = 0; c < kMaxT / 32; ++c)
        if (lane + 32 * c < Tn) s[c] = fmaf(qd, kr[32 * c], s[c]);
    }
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxT / 32; ++c) {
      const int j = lane + 32 * c;
      s[c] = j < Tn ? s[c] * scale + bb[i * sq + j] : -INFINITY;
      m = fmaxf(m, s[c]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxT / 32; ++c) {
      const float e = lane + 32 * c < Tn ? expf(s[c] - m) : 0.f;
      s[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int c = 0; c < kMaxT / 32; ++c) {
      const int j = lane + 32 * c;
      if (j < Tn) {
        float p = s[c] / sum;
        if (dropout) p = drop(p, dropout_bits(seed, b, h, i, j), thresh, keep_scale);
        pw[j] = p;
      }
    }
    __syncwarp();
    // output: lane d owns columns d, d+32, d+64, d+96 of each 128
    for (int d0 = lane; d0 < dh; d0 += 128) {
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int j = 0; j < Tn; ++j) {
        const float pj = pw[j];
        const float* vr = vs + j * dh + d0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (d0 + 32 * c < dh) o[c] = fmaf(pj, vr[32 * c], o[c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (d0 + 32 * c < dh) out[base + (size_t)i * D + d0 + 32 * c] = o[c];
    }
    __syncwarp();  // qw and pw are rewritten by the next row
  }
}

// shared memory, in floats: phase 1 K[T][dh+1] | V[T][dh+1] (phase 2 reuses
// the space for Q[T][dh] | g[T][dh]) | dS[T][T] | pd[T][T] |
// q and g rows [warps][2 dh]
__host__ __device__ inline size_t bwd_simt_smem_bytes(int T, int dh) {
  return ((size_t)2 * T * (dh + 1) + (size_t)2 * T * T +
          (size_t)kSimtWarps * 2 * dh) * sizeof(float);
}

__global__ void __launch_bounds__(kSimtThreads)
attention_bwd_simt(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ g, float* __restrict__ dq,
                   float* __restrict__ dk, float* __restrict__ dv, int Tn,
                   int H, int dh, float scale, long long sb, long long sq,
                   const int* __restrict__ seed_ptr, uint32_t thresh,
                   float keep_scale, int dropout) {
  extern __shared__ __align__(16) float smem[];
  const int KS = dh + 1;
  float* ks = smem;                            // [Tn][KS]
  float* vs = ks + (size_t)Tn * KS;            // [Tn][KS]
  float* qs = smem;                            // phase 2: [Tn][dh]
  float* gs = smem + (size_t)Tn * dh;          // phase 2: [Tn][dh]
  float* dss = smem + (size_t)2 * Tn * KS;     // [Tn][Tn]
  float* pds = dss + (size_t)Tn * Tn;          // [Tn][Tn]
  float* rows = pds + (size_t)Tn * Tn;         // [kSimtWarps][2 dh]

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int D = H * dh;
  const size_t base = (size_t)b * Tn * D + (size_t)h * dh;
  const uint32_t seed = dropout ? static_cast<uint32_t>(*seed_ptr) : 0u;
  for (int i = threadIdx.x; i < Tn * dh; i += kSimtThreads) {
    const int j = i / dh, d = i - j * dh;
    const size_t gi = base + (size_t)j * D + d;
    ks[j * KS + d] = k[gi];
    vs[j * KS + d] = v[gi];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* qw = rows + warp * 2 * dh;
  float* gw = qw + dh;
  const float* bb = bias + b * sb;
  // phase 1: one query row per warp at a time
  for (int i = warp; i < Tn; i += kSimtWarps) {
    for (int d = lane; d < dh; d += 32) {
      qw[d] = q[base + (size_t)i * D + d];
      gw[d] = g[base + (size_t)i * D + d];
    }
    __syncwarp();
    float s[kMaxT / 32], dpd[kMaxT / 32];
#pragma unroll
    for (int c = 0; c < kMaxT / 32; ++c) s[c] = dpd[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      const float qd = qw[d], gd = gw[d];
#pragma unroll
      for (int c = 0; c < kMaxT / 32; ++c) {
        const int j = lane + 32 * c;
        if (j < Tn) {
          s[c] = fmaf(qd, ks[j * KS + d], s[c]);
          dpd[c] = fmaf(gd, vs[j * KS + d], dpd[c]);
        }
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxT / 32; ++c) {
      const int j = lane + 32 * c;
      s[c] = j < Tn ? s[c] * scale + bb[i * sq + j] : -INFINITY;
      m = fmaxf(m, s[c]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxT / 32; ++c) {
      const float e = lane + 32 * c < Tn ? expf(s[c] - m) : 0.f;
      s[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxT / 32; ++c) {
      const int j = lane + 32 * c;
      if (j < Tn) {
        s[c] = s[c] / sum;                     // p
        float kf = 1.f;
        if (dropout)
          kf = dropout_bits(seed, b, h, i, j) >= thresh ? keep_scale : 0.f;
        pds[i * Tn + j] = s[c] * kf;           // pd
        dpd[c] *= kf;                          // dp
        rs += dpd[c] * s[c];
      }
    }
    rs = warp_sum(rs);
#pragma unroll
    for (int c = 0; c < kMaxT / 32; ++c) {
      const int j = lane + 32 * c;
      if (j < Tn) dss[i * Tn + j] = s[c] * (dpd[c] - rs) * scale;
    }
    __syncwarp();
    // dQ row i: lane d owns columns d, d+32, d+64, d+96 of each 128
    for (int d0 = lane; d0 < dh; d0 += 128) {
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int j = 0; j < Tn; ++j) {
        const float dsj = dss[i * Tn + j];
        const float* kr = ks + j * KS + d0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (d0 + 32 * c < dh) o[c] = fmaf(dsj, kr[32 * c], o[c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (d0 + 32 * c < dh) dq[base + (size_t)i * D + d0 + 32 * c] = o[c];
    }
    __syncwarp();  // qw and gw are rewritten by the next row
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Tn * dh; i += kSimtThreads) {
    const int j = i / dh, d = i - j * dh;
    const size_t gi = base + (size_t)j * D + d;
    qs[i] = q[gi];
    gs[i] = g[gi];
  }
  __syncthreads();
  // phase 2: one key row per warp at a time
  for (int j = warp; j < Tn; j += kSimtWarps) {
    for (int d0 = lane; d0 < dh; d0 += 128) {
      float ok[4] = {0.f, 0.f, 0.f, 0.f}, ov[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int i = 0; i < Tn; ++i) {
        const float dsi = dss[i * Tn + j], pdi = pds[i * Tn + j];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (d0 + 32 * c < dh) {
            ok[c] = fmaf(dsi, qs[i * dh + d0 + 32 * c], ok[c]);
            ov[c] = fmaf(pdi, gs[i * dh + d0 + 32 * c], ov[c]);
          }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (d0 + 32 * c < dh) {
          dk[base + (size_t)j * D + d0 + 32 * c] = ok[c];
          dv[base + (size_t)j * D + d0 + 32 * c] = ov[c];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernels (bf16, dh a multiple of 16 up to 128)
// ---------------------------------------------------------------------------

// 16 bytes global -> shared without registers; src_bytes = 0 writes zeros
__device__ inline void cp_async16(bf16* dst, const bf16* src, int src_bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(src_bytes));
}

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a . b for one m16n8k16 tile: bf16 inputs, f32 accumulators
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stages rows 0..Tp-1 of head h of row b of each of the n (B, T, D) arrays
// `src` into `dst` (Tp x LD bf16 each), every copy in flight at once; rows
// Tn..Tp-1 are zero-filled.
template <int DH, int N>
__device__ inline void stage_rows(bf16* const (&dst)[N],
                                  const bf16* const (&src)[N], size_t base,
                                  int Tn, int Tp, int D) {
  constexpr int LD = DH + 8, CH = DH / 8;
  for (int i = threadIdx.x; i < Tp * CH; i += kMmaThreads) {
    const int j = i / CH, c = (i - j * CH) * 8;
    const size_t gi = j < Tn ? base + (size_t)j * D + c : base;
    const int n = j < Tn ? 16 : 0;
#pragma unroll
    for (int a = 0; a < N; ++a) cp_async16(dst[a] + j * LD + c, src[a] + gi, n);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// acc[nt] = A_w . B^T for the warp's 16 rows of `as` and all Tp rows of
// `bs` (both Tp x LD, row-major, the product over DH): the S = Q.K^T loop
template <int DH>
__device__ inline void rows_times_rows_t(float (&acc)[kMaxT / 8][4],
                                         const bf16* as, const bf16* bs,
                                         int row0, int Tp, int lane) {
  constexpr int LD = DH + 8;
  const int mat = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and its row
#pragma unroll
  for (int nt = 0; nt < kMaxT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, as + (row0 + (mat & 1) * 8 + mr) * LD + kk * 16 + (mat >> 1) * 8);
#pragma unroll
    for (int np = 0; np < kMaxT / 16; ++np) {
      if (np * 16 < Tp) {
        uint32_t bk[4];
        ldmatrix_x4(bk, bs + (np * 16 + (mat >> 1) * 8 + mr) * LD + kk * 16 + (mat & 1) * 8);
        mma_bf16(acc[2 * np], a, bk[0], bk[1]);
        mma_bf16(acc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
  }
}

// scale + bias and the softmax of the warp's rows, in place in `sacc`
// (this lane holds rows r0 = row0 + lane/4 and r1 = r0 + 8, columns
// nt*8 + qc and nt*8 + qc + 1 of every tile nt): on return sacc holds the
// exponentials and (i0, i1) the reciprocals of their row sums
template <typename TB>
__device__ inline void softmax_rows(float (&sacc)[kMaxT / 8][4],
                                    const TB* __restrict__ bias, int b,
                                    long long sb, long long sq, int Tn, int Tp,
                                    float scale, int bias_pairs, int r0,
                                    int qc, float& i0, float& i1) {
  const int r1 = r0 + 8;
  const TB* b0 = bias + b * sb + (long long)r0 * sq;
  const TB* b1 = bias + b * sb + (long long)r1 * sq;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kMaxT / 8; ++nt) {
    if (nt * 8 < Tp) {
      // bias at columns col, col + 1 of rows r0, r1: rows past T are
      // padding (any finite bias will do), columns past T are masked
      const int col = nt * 8 + qc;
      float2 c0, c1;
      if (bias_pairs && col + 1 < Tn) {
        c0 = r0 < Tn ? load2(b0 + col) : make_float2(0.f, 0.f);
        c1 = r1 < Tn ? load2(b1 + col) : make_float2(0.f, 0.f);
      } else {
        c0.x = col < Tn ? (r0 < Tn ? to_f32(b0[col]) : 0.f) : -INFINITY;
        c0.y = col + 1 < Tn ? (r0 < Tn ? to_f32(b0[col + 1]) : 0.f) : -INFINITY;
        c1.x = col < Tn ? (r1 < Tn ? to_f32(b1[col]) : 0.f) : -INFINITY;
        c1.y = col + 1 < Tn ? (r1 < Tn ? to_f32(b1[col + 1]) : 0.f) : -INFINITY;
      }
      sacc[nt][0] = sacc[nt][0] * scale + c0.x;
      sacc[nt][1] = sacc[nt][1] * scale + c0.y;
      sacc[nt][2] = sacc[nt][2] * scale + c1.x;
      sacc[nt][3] = sacc[nt][3] * scale + c1.y;
      m0 = fmaxf(m0, fmaxf(sacc[nt][0], sacc[nt][1]));
      m1 = fmaxf(m1, fmaxf(sacc[nt][2], sacc[nt][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kMaxT / 8; ++nt) {
    if (nt * 8 < Tp) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sacc[nt][e] = __expf(sacc[nt][e] - m0);
        sacc[nt][2 + e] = __expf(sacc[nt][2 + e] - m1);
        l0 += sacc[nt][e];
        l1 += sacc[nt][2 + e];
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  i0 = 1.f / l0;
  i1 = 1.f / l1;
}

template <int DH>
__host__ __device__ inline size_t mma_smem_bytes(int T) {
  return (size_t)3 * ((T + 15) & ~15) * (DH + 8) * sizeof(bf16);
}

template <int DH, typename TB, bool DROP>
__global__ void __launch_bounds__(kMmaThreads, DH <= 64 ? 3 : 1)
attention_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const TB* __restrict__ bias,
              bf16* __restrict__ out, int Tn, int H, float scale,
              long long sb, long long sq, int bias_pairs,
              const int* __restrict__ seed_ptr, uint32_t thresh,
              float keep_scale) {
  constexpr int LD = DH + 8;   // shared row stride, in elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Tp = (Tn + 15) & ~15;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + Tp * LD;
  bf16* vs = ks + Tp * LD;

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int D = H * DH;
  const size_t base = (size_t)b * Tn * D + (size_t)h * DH;
  {
    bf16* const dst[3] = {qs, ks, vs};
    const bf16* const src[3] = {q, k, v};
    stage_rows<DH, 3>(dst, src, base, Tn, Tp, D);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  if (row0 >= Tn) return;
  const int mat = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and its row

  // S = Q_h . K_h^T for query rows row0..row0+15, all Tp keys
  float sacc[kMaxT / 8][4];
  rows_times_rows_t<DH>(sacc, qs, ks, row0, Tp, lane);
  const int qc = (lane & 3) * 2;
  const int r0 = row0 + (lane >> 2);
  float i0, i1;
  softmax_rows<TB>(sacc, bias, b, sb, sq, Tn, Tp, scale, bias_pairs, r0, qc,
                   i0, i1);
  const uint32_t seed = DROP ? static_cast<uint32_t>(*seed_ptr) : 0u;

  // P (with its dropout) rounded to bf16 and packed as the A operand of
  // P.V, so the f32 scores die here; 16 keys per k-step
  uint32_t pa[kMaxT / 16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxT / 16; ++kk) {
    float p[2][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int nt = 2 * kk + hf;
      p[hf][0] = sacc[nt][0] * i0;
      p[hf][1] = sacc[nt][1] * i0;
      p[hf][2] = sacc[nt][2] * i1;
      p[hf][3] = sacc[nt][3] * i1;
      if (DROP && nt * 8 < Tp) {
        const uint4 r = dropout_bits4(seed, b, h, r0, nt * 8 + qc);
        p[hf][0] = drop(p[hf][0], r.x, thresh, keep_scale);
        p[hf][1] = drop(p[hf][1], r.y, thresh, keep_scale);
        p[hf][2] = drop(p[hf][2], r.z, thresh, keep_scale);
        p[hf][3] = drop(p[hf][3], r.w, thresh, keep_scale);
      }
    }
    pa[kk][0] = pack_bf16(p[0][0], p[0][1]);
    pa[kk][1] = pack_bf16(p[0][2], p[0][3]);
    pa[kk][2] = pack_bf16(p[1][0], p[1][1]);
    pa[kk][3] = pack_bf16(p[1][2], p[1][3]);
  }

  // O = round(P) . V_h
  float oacc[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxT / 16; ++kk) {
    if (kk * 16 < Tp) {
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + (mat & 1) * 8 + mr) * LD + dp * 16 + (mat >> 1) * 8);
        mma_bf16(oacc[2 * dp], pa[kk], bv[0], bv[1]);
        mma_bf16(oacc[2 * dp + 1], pa[kk], bv[2], bv[3]);
      }
    }
  }

  const int r1 = r0 + 8;
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int col = nt * 8 + qc;
    if (r0 < Tn)
      *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)r0 * D + col) =
          __floats2bfloat162_rn(oacc[nt][0], oacc[nt][1]);
    if (r1 < Tn)
      *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)r1 * D + col) =
          __floats2bfloat162_rn(oacc[nt][2], oacc[nt][3]);
  }
}

// (dS or round(pd))^T . X for the warp's 16 key rows j0..j0+15: the A
// operand is read transposed from `ps` (Tp x LDT, rows = queries), X from
// `xs` (Tp x LD, rows = queries); the result is written to rows j0.. of
// head h of `out`
template <int DH>
__device__ inline void keys_product(const bf16* ps, int LDT, const bf16* xs,
                                    bf16* __restrict__ out, size_t base,
                                    int j0, int Tn, int Tp, int D, int lane) {
  constexpr int LD = DH + 8;
  const int mat = lane >> 3, mr = lane & 7;
  float acc[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxT / 16; ++kk) {
    if (kk * 16 < Tp) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, ps + (kk * 16 + (mat >> 1) * 8 + mr) * LDT + j0 + (mat & 1) * 8);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t bx[4];
        ldmatrix_x4_trans(bx, xs + (kk * 16 + (mat & 1) * 8 + mr) * LD + dp * 16 + (mat >> 1) * 8);
        mma_bf16(acc[2 * dp], a, bx[0], bx[1]);
        mma_bf16(acc[2 * dp + 1], a, bx[2], bx[3]);
      }
    }
  }
  const int qc = (lane & 3) * 2, r0 = j0 + (lane >> 2), r1 = r0 + 8;
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int col = nt * 8 + qc;
    if (r0 < Tn)
      *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)r0 * D + col) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (r1 < Tn)
      *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)r1 * D + col) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

// shared memory: Q | K | V | g (Tp x (DH+8) bf16 each) | dS | round(pd)
// (Tp x (Tp+8) bf16 each; the row stride is an odd multiple of 16 B, free
// of ldmatrix bank conflicts)
template <int DH>
__host__ __device__ inline size_t bwd_mma_smem_bytes(int T) {
  const size_t Tp = (T + 15) & ~15;
  return (4 * Tp * (DH + 8) + 2 * Tp * (Tp + 8)) * sizeof(bf16);
}

template <int DH, typename TB>
__global__ void __launch_bounds__(kMmaThreads, 1)
attention_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const TB* __restrict__ bias,
                  const bf16* __restrict__ g, bf16* __restrict__ dq,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int Tn, int H,
                  float scale, long long sb, long long sq, int bias_pairs,
                  const int* __restrict__ seed_ptr, uint32_t thresh,
                  float keep_scale, int dropout) {
  constexpr int LD = DH + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Tp = (Tn + 15) & ~15;
  const int LDT = Tp + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + Tp * LD;
  bf16* vs = ks + Tp * LD;
  bf16* gs = vs + Tp * LD;
  bf16* dss = gs + Tp * LD;     // [Tp][LDT]: dS, rows = queries
  bf16* pds = dss + Tp * LDT;   // [Tp][LDT]: round(pd), rows = queries

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int D = H * DH;
  const size_t base = (size_t)b * Tn * D + (size_t)h * DH;
  {
    bf16* const dst[4] = {qs, ks, vs, gs};
    const bf16* const src[4] = {q, k, v, g};
    stage_rows<DH, 4>(dst, src, base, Tn, Tp, D);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const int mat = lane >> 3, mr = lane & 7;
  const int qc = (lane & 3) * 2;
  const int r0 = row0 + (lane >> 2), r1 = r0 + 8;
  if (row0 < Tn) {
    // phase 1, query rows row0..row0+15: P recomputed as in the forward
    float sacc[kMaxT / 8][4];
    rows_times_rows_t<DH>(sacc, qs, ks, row0, Tp, lane);
    float i0, i1;
    softmax_rows<TB>(sacc, bias, b, sb, sq, Tn, Tp, scale, bias_pairs, r0,
                     qc, i0, i1);
    // dPd = round(g) . V^T
    float dacc[kMaxT / 8][4];
    rows_times_rows_t<DH>(dacc, gs, vs, row0, Tp, lane);
    const uint32_t seed = dropout ? static_cast<uint32_t>(*seed_ptr) : 0u;
    // p and the keep factors; dp = dPd * keep; row sums of dp * p
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kMaxT / 8; ++nt) {
      if (nt * 8 < Tp) {
        float kf[4] = {1.f, 1.f, 1.f, 1.f};
        if (dropout) {
          const uint4 r = dropout_bits4(seed, b, h, r0, nt * 8 + qc);
          kf[0] = r.x >= thresh ? keep_scale : 0.f;
          kf[1] = r.y >= thresh ? keep_scale : 0.f;
          kf[2] = r.z >= thresh ? keep_scale : 0.f;
          kf[3] = r.w >= thresh ? keep_scale : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = sacc[nt][e] * (e < 2 ? i0 : i1);
          sacc[nt][e] = p;
          dacc[nt][e] *= kf[e];
          // round(pd) for dV, in place of dP's keep factor once used
          kf[e] *= p;
        }
        rs0 += dacc[nt][0] * sacc[nt][0] + dacc[nt][1] * sacc[nt][1];
        rs1 += dacc[nt][2] * sacc[nt][2] + dacc[nt][3] * sacc[nt][3];
        const int col = nt * 8 + qc;
        *reinterpret_cast<uint32_t*>(pds + r0 * LDT + col) = pack_bf16(kf[0], kf[1]);
        *reinterpret_cast<uint32_t*>(pds + r1 * LDT + col) = pack_bf16(kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
    }
    // dS = round(p * (dp - rowsum) * scale)
#pragma unroll
    for (int nt = 0; nt < kMaxT / 8; ++nt) {
      if (nt * 8 < Tp) {
        const int col = nt * 8 + qc;
        *reinterpret_cast<uint32_t*>(dss + r0 * LDT + col) = pack_bf16(
            sacc[nt][0] * (dacc[nt][0] - rs0) * scale,
            sacc[nt][1] * (dacc[nt][1] - rs0) * scale);
        *reinterpret_cast<uint32_t*>(dss + r1 * LDT + col) = pack_bf16(
            sacc[nt][2] * (dacc[nt][2] - rs1) * scale,
            sacc[nt][3] * (dacc[nt][3] - rs1) * scale);
      }
    }
    __syncwarp();
    // dQ = dS . K_h for the warp's rows (A from its own rows of dS)
    float oacc[DH / 8][4];
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxT / 16; ++kk) {
      if (kk * 16 < Tp) {
        uint32_t a[4];
        ldmatrix_x4(a, dss + (row0 + (mat & 1) * 8 + mr) * LDT + kk * 16 + (mat >> 1) * 8);
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, ks + (kk * 16 + (mat & 1) * 8 + mr) * LD + dp * 16 + (mat >> 1) * 8);
          mma_bf16(oacc[2 * dp], a, bk[0], bk[1]);
          mma_bf16(oacc[2 * dp + 1], a, bk[2], bk[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      const int col = nt * 8 + qc;
      if (r0 < Tn)
        *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)r0 * D + col) =
            __floats2bfloat162_rn(oacc[nt][0], oacc[nt][1]);
      if (r1 < Tn)
        *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)r1 * D + col) =
            __floats2bfloat162_rn(oacc[nt][2], oacc[nt][3]);
    }
  }
  __syncthreads();
  // phase 2, key rows row0..row0+15: dK = dS^T . Q, dV = round(pd)^T . g
  if (row0 < Tn) {
    keys_product<DH>(dss, LDT, qs, dk, base, row0, Tn, Tp, D, lane);
    keys_product<DH>(pds, LDT, gs, dv, base, row0, Tn, Tp, D, lane);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_optin_smem(K kernel, int optin) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin);
}

struct Drop {
  const int* seed;
  uint32_t thresh;
  float keep_scale;
  int on;
};

// two neighbouring bias elements are read as one when every row starts on
// a pair boundary
template <typename TB>
int bias_pairs(const void* bias, long long sb, long long sq) {
  return sb % 2 == 0 && sq % 2 == 0 &&
         reinterpret_cast<uintptr_t>(bias) % (2 * sizeof(TB)) == 0;
}

template <int DH, typename TB>
int launch_mma(const void* q, const void* k, const void* v, const void* bias,
               void* out, int B, int T_, int H, float scale, long long sb,
               long long sq, Drop dr, cudaStream_t st) {
  const int pairs = bias_pairs<TB>(bias, sb, sq);
  const size_t smem = mma_smem_bytes<DH>(T_);
  if (dr.on)
    attention_mma<DH, TB, true><<<B * H, kMmaThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const TB*>(bias),
        static_cast<bf16*>(out), T_, H, scale, sb, sq, pairs, dr.seed,
        dr.thresh, dr.keep_scale);
  else
    attention_mma<DH, TB, false><<<B * H, kMmaThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const TB*>(bias),
        static_cast<bf16*>(out), T_, H, scale, sb, sq, pairs, dr.seed,
        dr.thresh, dr.keep_scale);
  return cudaGetLastError();
}

template <int DH, typename TB>
int launch_bwd_mma(const void* q, const void* k, const void* v,
                   const void* bias, const void* g, void* dq, void* dk,
                   void* dv, int B, int T_, int H, float scale, long long sb,
                   long long sq, Drop dr, cudaStream_t st) {
  attention_bwd_mma<DH, TB><<<B * H, kMmaThreads, bwd_mma_smem_bytes<DH>(T_), st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const TB*>(bias),
      static_cast<const bf16*>(g), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T_, H, scale, sb, sq,
      bias_pairs<TB>(bias, sb, sq), dr.seed, dr.thresh, dr.keep_scale, dr.on);
  return cudaGetLastError();
}

template <typename TB>
int dispatch_fwd_bf16(const void* q, const void* k, const void* v,
                      const void* bias, void* out, int B, int T_, int H,
                      int dh, float scale, long long sb, long long sq, Drop dr,
                      cudaStream_t st) {
  switch (dh) {
    case 16: return launch_mma<16, TB>(q, k, v, bias, out, B, T_, H, scale, sb, sq, dr, st);
    case 32: return launch_mma<32, TB>(q, k, v, bias, out, B, T_, H, scale, sb, sq, dr, st);
    case 64: return launch_mma<64, TB>(q, k, v, bias, out, B, T_, H, scale, sb, sq, dr, st);
    case 128: return launch_mma<128, TB>(q, k, v, bias, out, B, T_, H, scale, sb, sq, dr, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TB>
int dispatch_bwd_bf16(const void* q, const void* k, const void* v,
                      const void* bias, const void* g, void* dq, void* dk,
                      void* dv, int B, int T_, int H, int dh, float scale,
                      long long sb, long long sq, Drop dr, cudaStream_t st) {
  switch (dh) {
    case 16: return launch_bwd_mma<16, TB>(q, k, v, bias, g, dq, dk, dv, B, T_, H, scale, sb, sq, dr, st);
    case 32: return launch_bwd_mma<32, TB>(q, k, v, bias, g, dq, dk, dv, B, T_, H, scale, sb, sq, dr, st);
    case 64: return launch_bwd_mma<64, TB>(q, k, v, bias, g, dq, dk, dv, B, T_, H, scale, sb, sq, dr, st);
    case 128: return launch_bwd_mma<128, TB>(q, k, v, bias, g, dq, dk, dv, B, T_, H, scale, sb, sq, dr, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int DH>
cudaError_t allow_optin_dh(int optin) {
  const cudaError_t errs[] = {
      allow_optin_smem(attention_mma<DH, float, false>, optin),
      allow_optin_smem(attention_mma<DH, float, true>, optin),
      allow_optin_smem(attention_mma<DH, bf16, false>, optin),
      allow_optin_smem(attention_mma<DH, bf16, true>, optin),
      allow_optin_smem(attention_bwd_mma<DH, float>, optin),
      allow_optin_smem(attention_bwd_mma<DH, bf16>, optin),
  };
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Dynamic shared memory a block of the forward (backward = 0) or the
// backward (backward = 1) needs for this head width, length and type (0
// for a bf16 head width the tensor-core kernels do not take).
size_t packed_attention_smem_bytes(int T, int dh, int qkv_is_bf16,
                                   int backward) {
  if (!qkv_is_bf16)
    return backward ? bwd_simt_smem_bytes(T, dh) : simt_smem_bytes(T, dh);
  switch (dh) {
    case 16: return backward ? bwd_mma_smem_bytes<16>(T) : mma_smem_bytes<16>(T);
    case 32: return backward ? bwd_mma_smem_bytes<32>(T) : mma_smem_bytes<32>(T);
    case 64: return backward ? bwd_mma_smem_bytes<64>(T) : mma_smem_bytes<64>(T);
    case 128: return backward ? bwd_mma_smem_bytes<128>(T) : mma_smem_bytes<128>(T);
    default: return 0;
  }
}

// Lets every kernel of this library use the device's opt-in shared memory.
// Once per device; returns a cudaError_t.
int packed_attention_prepare(int device) {
  int optin = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  const cudaError_t errs[] = {
      allow_optin_smem(attention_simt, optin),
      allow_optin_smem(attention_bwd_simt, optin),
      allow_optin_dh<16>(optin),
      allow_optin_dh<32>(optin),
      allow_optin_dh<64>(optin),
      allow_optin_dh<128>(optin),
  };
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

// q, k, v, out (B, T, H*dh) contiguous, all bf16 (qkv_is_bf16; dh 16, 32,
// 64 or 128) or all f32; bias (B, T, T) with element strides (sb, sq, 1),
// bf16 (bias_is_bf16) or f32 (f32 when q is); T <= 128; q, k, v, out
// 16-byte aligned; with `dropout`, `seed` points to one int32 on the device
// and an element is kept iff its bits >= thresh, then scaled by keep_scale;
// enough shared memory (packed_attention_smem_bytes) and
// packed_attention_prepare called on `device`. Enqueued on `stream`;
// returns a cudaError_t.
int packed_attention_forward(const void* q, const void* k, const void* v,
                             const void* bias, void* out, int B, int T, int H,
                             int dh, float scale, long long sb, long long sq,
                             int qkv_is_bf16, int bias_is_bf16,
                             const void* seed, unsigned int thresh,
                             float keep_scale, int dropout, int device,
                             void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (T > kMaxT || (!qkv_is_bf16 && bias_is_bf16) || (dropout && !seed))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop dr = {static_cast<const int*>(seed), thresh, keep_scale, dropout};
  if (!qkv_is_bf16) {
    attention_simt<<<B * H, kSimtThreads, simt_smem_bytes(T, dh), st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(bias),
        static_cast<float*>(out), T, H, dh, scale, sb, sq, dr.seed, thresh,
        keep_scale, dropout);
    return cudaGetLastError();
  }
  if (bias_is_bf16)
    return dispatch_fwd_bf16<bf16>(q, k, v, bias, out, B, T, H, dh, scale, sb, sq, dr, st);
  return dispatch_fwd_bf16<float>(q, k, v, bias, out, B, T, H, dh, scale, sb, sq, dr, st);
}

// The backward of packed_attention_forward with the same arguments: g, dq,
// dk, dv (B, T, H*dh) contiguous in q's type, 16-byte aligned; enough
// shared memory (packed_attention_smem_bytes with backward = 1). Enqueued
// on `stream`; returns a cudaError_t.
int packed_attention_backward(const void* q, const void* k, const void* v,
                              const void* bias, const void* g, void* dq,
                              void* dk, void* dv, int B, int T, int H, int dh,
                              float scale, long long sb, long long sq,
                              int qkv_is_bf16, int bias_is_bf16,
                              const void* seed, unsigned int thresh,
                              float keep_scale, int dropout, int device,
                              void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (T > kMaxT || (!qkv_is_bf16 && bias_is_bf16) || (dropout && !seed))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop dr = {static_cast<const int*>(seed), thresh, keep_scale, dropout};
  if (!qkv_is_bf16) {
    attention_bwd_simt<<<B * H, kSimtThreads, bwd_simt_smem_bytes(T, dh), st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(bias),
        static_cast<const float*>(g), static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), T, H, dh, scale,
        sb, sq, dr.seed, thresh, keep_scale, dropout);
    return cudaGetLastError();
  }
  if (bias_is_bf16)
    return dispatch_bwd_bf16<bf16>(q, k, v, bias, g, dq, dk, dv, B, T, H, dh, scale, sb, sq, dr, st);
  return dispatch_bwd_bf16<float>(q, k, v, bias, g, dq, dk, dv, B, T, H, dh, scale, sb, sq, dr, st);
}

// The (B, H, T, T) keep mask (one byte per element, 1 = kept) that the
// forward and the backward draw for the int32 at `seed` and `thresh`.
// Enqueued on `stream`; returns a cudaError_t.
int packed_attention_keep_mask(const void* seed, void* out, int B, int T,
                               int H, unsigned int thresh, int device,
                               void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  dropout_mask<<<B * H, kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seed), static_cast<uint8_t*>(out), T, H, thresh);
  return cudaGetLastError();
}

const char* packed_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
