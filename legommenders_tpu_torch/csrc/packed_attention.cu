// Packed-block multi-head attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package's
// ops/pallas_attention.py (launched by `_call_fwd`) at dropout 0. For each
// row b and head h (columns h*dh .. h*dh+dh-1 of D = H*dh):
//     s = (q_h . k_h^T) * scale + bias[b]     (T x T, f32; scale = 1/sqrt(dh))
//     p = exp(s - rowmax(s)) / rowsum(...)    (f32)
//     o_h = round(p to v's type) . v_h        (f32 sums, rounded once)
// q, k, v and out are (B, T, D), f32 or bf16, contiguous; bias is (B, T, T)
// in f32 or bf16 with element strides (sb, sq, 1), so a broadcast view is
// read as it is. Any T <= 128: no padding of T in device memory. A key whose
// bias is the type's lowest value gets exactly zero weight (exp underflows).
//
// What bounds it. The LM item encoder gives it one 512-item page per call:
// B = 171 packed rows, T = 102 (3 items of 34 tokens), D = 768, 12 heads,
// bf16. It must move q, k, v, out (4 * 171*102*768 * 2 B) and the bias
// (171*102*102 * 2 B), about 110.7 MB: 33 us at 3.35 TB/s. It does
// 4*B*T^2*D = 5.47 GFLOP: 5.5 us on the bf16 tensor cores at 989 TFLOP/s,
// but 82 us on the f32 CUDA cores at 67 TFLOP/s. So the bytes bound it
// only if both products run on the tensor cores.
//
// Design. One block per (b, h); 1-D grid, b-major, so the blocks of one row
// run together and read its bias from L2.
//  * bf16, dh in {16, 32, 64, 128} (the main path): attention_mma. 8 warps.
//    Q_h, K_h and V_h (Tp x dh, Tp = T rounded up to 16, zero rows past T)
//    are staged in shared memory with cp.async, all copies in flight at
//    once, rows padded by 16 B so ldmatrix is free of bank conflicts. Warp
//    w owns query rows 16w..16w+15: S = Q.K^T with mma.sync m16n8k16 (bf16
//    in, f32 accumulate) into registers, scale + bias (read from device
//    memory here, two neighbouring columns per load when the strides
//    allow; staging it in shared memory first measured slower), row max
//    and sum across each quad of lanes with shuffles, p = e / sum rounded
//    to bf16
//    and packed in place as the A operand of O = P.V (the m16n8 accumulator
//    layout is the m16n8k16 A layout), V read with ldmatrix.trans. Nothing
//    of (T, T) leaves registers. exp is __expf (ex2.approx) and each row
//    divides by one reciprocal: within a few f32 ulps, far below the bf16
//    rounding of p. At dh <= 64 a block asks for 3 blocks per SM (80
//    registers; ptxas spills a little at dh = 64, which measured faster
//    than 2 blocks per SM without spills).
//  * f32: attention_simt, on the CUDA cores, with the reference's exact
//    expf and division. 4 warps; K_h^T and V_h staged in shared memory; a
//    warp takes one query row at a time: lane j owns keys j, j+32, j+64,
//    j+96 for the scores and the softmax, then lane d output columns d,
//    d+32, d+64, d+96 (four independent sums each).
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
// CUDA-core kernel (f32)
// ---------------------------------------------------------------------------

// shared memory, in floats: K^T[dh][T] | V[T][dh] | q[warps][dh] | p[warps][kMaxT]
__host__ __device__ inline size_t simt_smem_bytes(int T, int dh) {
  return ((size_t)2 * T * dh + (size_t)kSimtWarps * (dh + kMaxT)) * sizeof(float);
}

__global__ void __launch_bounds__(kSimtThreads)
attention_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               float* __restrict__ out, int Tn, int H, int dh, float scale,
               long long sb, long long sq) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                        // [dh][Tn]
  float* vs = kt + (size_t)dh * Tn;        // [Tn][dh]
  float* qs = vs + (size_t)Tn * dh;        // [kSimtWarps][dh]
  float* ps = qs + kSimtWarps * dh;        // [kSimtWarps][kMaxT]

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int D = H * dh;
  const size_t base = (size_t)b * Tn * D + (size_t)h * dh;
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
      if (j < Tn) pw[j] = s[c] / sum;
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

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, dh a multiple of 16 up to 128)
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

template <int DH>
__host__ __device__ inline size_t mma_smem_bytes(int T) {
  return (size_t)3 * ((T + 15) & ~15) * (DH + 8) * sizeof(bf16);
}

template <int DH, typename TB>
__global__ void __launch_bounds__(kMmaThreads, DH <= 64 ? 3 : 1)
attention_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const TB* __restrict__ bias,
              bf16* __restrict__ out, int Tn, int H, float scale,
              long long sb, long long sq, int bias_pairs) {
  constexpr int LD = DH + 8;   // shared row stride, in elements
  constexpr int CH = DH / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Tp = (Tn + 15) & ~15;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + Tp * LD;
  bf16* vs = ks + Tp * LD;

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int D = H * DH;
  const size_t base = (size_t)b * Tn * D + (size_t)h * DH;
  // every copy in flight at once; rows Tn..Tp-1 are zero-filled
  for (int i = threadIdx.x; i < Tp * CH; i += kMmaThreads) {
    const int j = i / CH, c = (i - j * CH) * 8;
    const size_t g = j < Tn ? base + (size_t)j * D + c : base;
    const int n = j < Tn ? 16 : 0;
    cp_async16(qs + j * LD + c, q + g, n);
    cp_async16(ks + j * LD + c, k + g, n);
    cp_async16(vs + j * LD + c, v + g, n);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  if (row0 >= Tn) return;
  const int mat = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and its row

  // S = Q_h . K_h^T for query rows row0..row0+15, all Tp keys
  float sacc[kMaxT / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMaxT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, qs + (row0 + (mat & 1) * 8 + mr) * LD + kk * 16 + (mat >> 1) * 8);
#pragma unroll
    for (int np = 0; np < kMaxT / 16; ++np) {
      if (np * 16 < Tp) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (np * 16 + (mat >> 1) * 8 + mr) * LD + kk * 16 + (mat & 1) * 8);
        mma_bf16(sacc[2 * np], a, bk[0], bk[1]);
        mma_bf16(sacc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
  }

  // scale + bias, softmax over the keys; this lane holds rows r0 and r1,
  // columns nt*8 + qc and nt*8 + qc + 1 of every tile nt
  const int qc = (lane & 3) * 2;
  const int r0 = row0 + (lane >> 2), r1 = r0 + 8;
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

  // P rounded to bf16 and packed as the A operand of P.V, so the f32
  // scores die here; 16 keys per k-step
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  uint32_t pa[kMaxT / 16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxT / 16; ++kk) {
    pa[kk][0] = pack_bf16(sacc[2 * kk][0] * i0, sacc[2 * kk][1] * i0);
    pa[kk][1] = pack_bf16(sacc[2 * kk][2] * i1, sacc[2 * kk][3] * i1);
    pa[kk][2] = pack_bf16(sacc[2 * kk + 1][0] * i0, sacc[2 * kk + 1][1] * i0);
    pa[kk][3] = pack_bf16(sacc[2 * kk + 1][2] * i1, sacc[2 * kk + 1][3] * i1);
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

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_optin_smem(K kernel, int optin) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin);
}

int launch_simt(const void* q, const void* k, const void* v, const void* bias,
                void* out, int B, int T_, int H, int dh, float scale,
                long long sb, long long sq, cudaStream_t st) {
  attention_simt<<<B * H, kSimtThreads, simt_smem_bytes(T_, dh), st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(out), T_, H, dh, scale, sb, sq);
  return cudaGetLastError();
}

template <int DH, typename TB>
int launch_mma(const void* q, const void* k, const void* v, const void* bias,
               void* out, int B, int T_, int H, float scale, long long sb,
               long long sq, cudaStream_t st) {
  // two neighbouring bias elements are read as one when every row starts
  // on a pair boundary
  const int pairs = sb % 2 == 0 && sq % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(bias) % (2 * sizeof(TB)) == 0;
  attention_mma<DH, TB><<<B * H, kMmaThreads, mma_smem_bytes<DH>(T_), st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const TB*>(bias),
      static_cast<bf16*>(out), T_, H, scale, sb, sq, pairs);
  return cudaGetLastError();
}

template <typename TB>
int dispatch_bf16(const void* q, const void* k, const void* v,
                  const void* bias, void* out, int B, int T_, int H, int dh,
                  float scale, long long sb, long long sq, cudaStream_t st) {
  switch (dh) {
    case 16: return launch_mma<16, TB>(q, k, v, bias, out, B, T_, H, scale, sb, sq, st);
    case 32: return launch_mma<32, TB>(q, k, v, bias, out, B, T_, H, scale, sb, sq, st);
    case 64: return launch_mma<64, TB>(q, k, v, bias, out, B, T_, H, scale, sb, sq, st);
    case 128: return launch_mma<128, TB>(q, k, v, bias, out, B, T_, H, scale, sb, sq, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory a block needs for this head width, length and type
// (0 for a bf16 head width the tensor-core kernel does not take).
size_t packed_attention_smem_bytes(int T, int dh, int qkv_is_bf16) {
  if (!qkv_is_bf16) return simt_smem_bytes(T, dh);
  switch (dh) {
    case 16: return mma_smem_bytes<16>(T);
    case 32: return mma_smem_bytes<32>(T);
    case 64: return mma_smem_bytes<64>(T);
    case 128: return mma_smem_bytes<128>(T);
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
      allow_optin_smem(attention_mma<16, float>, optin),
      allow_optin_smem(attention_mma<16, bf16>, optin),
      allow_optin_smem(attention_mma<32, float>, optin),
      allow_optin_smem(attention_mma<32, bf16>, optin),
      allow_optin_smem(attention_mma<64, float>, optin),
      allow_optin_smem(attention_mma<64, bf16>, optin),
      allow_optin_smem(attention_mma<128, float>, optin),
      allow_optin_smem(attention_mma<128, bf16>, optin),
  };
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

// q, k, v, out (B, T, H*dh) contiguous, all bf16 (qkv_is_bf16; dh 16, 32,
// 64 or 128) or all f32; bias (B, T, T) with element strides (sb, sq, 1),
// bf16 (bias_is_bf16) or f32 (f32 when q is); T <= 128; q, k, v, out
// 16-byte aligned; enough
// shared memory (packed_attention_smem_bytes) and packed_attention_prepare
// called on `device`. Enqueued on `stream`; returns a cudaError_t.
int packed_attention_forward(const void* q, const void* k, const void* v,
                             const void* bias, void* out, int B, int T, int H,
                             int dh, float scale, long long sb, long long sq,
                             int qkv_is_bf16, int bias_is_bf16, int device,
                             void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (T > kMaxT || (!qkv_is_bf16 && bias_is_bf16)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!qkv_is_bf16)
    return launch_simt(q, k, v, bias, out, B, T, H, dh, scale, sb, sq, st);
  if (bias_is_bf16)
    return dispatch_bf16<bf16>(q, k, v, bias, out, B, T, H, dh, scale, sb, sq, st);
  return dispatch_bf16<float>(q, k, v, bias, out, B, T, H, dh, scale, sb, sq, st);
}

const char* packed_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
