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
// taken in f32. Three kernels, all scoring on the tensor cores; the wrapper
// picks one by x's type and widths (ops/additive.py `pool_kernel`), and a
// failure of any raises.
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
// additive_pool_kernel and additive_pool_long: every other shape. The
// first takes L <= 128 (f32 x: its 1e-5 gate, which tanh.approx does not
// meet; bf16 x at widths additive_pool_tc does not take, any D that is a
// multiple of 4 and any H), the second L > 128 of either type (the
// flattened histories of the flatten user operators: L 495 and 1,023 at
// D 64, H 64). Both score bf16 x as exactly as f32 x (16 bits of W1, the
// accurate tanh), as the CUDA-core kernels they replace did: a flatten
// user pool's bf16 gradients are held against the sequence-parallel
// pool's, which computes in f32 (chip_smoke.py phase 15).
//   What bounds them. At f32 the products: 2 N L D H FLOP at 3xTF32's
//   165 TFLOP/s (the f32 catalog, 65,000 x 31 at H 256: 408 us), then the
//   tanh (123 us at one special-function instruction each; this one takes
//   two), then the bytes (154 us). The flatten pools at D 64, H 64 move
//   more bytes than they compute: N 8,192 x L 495 reads 519 MB in bf16
//   (155 us at 3.35 TB/s; the tanh 62 us, the products 33 us), 1.04 GB in
//   f32 (310 us; the products 200 us). Measured, both sit at 3-6x their
//   bound, held by the issue of the products' instructions (3xTF32: ~22
//   a product of 16 x 8 x 8, most of them splitting W1's fragments anew
//   in every warp) and, in bf16, by the tiles' epilogues and barriers.
//   Design (PERF.md section 6 has the times). One device routine scores a
//   tile of up to 128 consecutive positions of x seen as (N*L, D); the two
//   kernels differ only in what they do with the scores.
//    * Persistent CTAs of 256 threads, 2 an SM where the tiles allow. A
//      tile of additive_pool_kernel holds G = R // L whole items (R <= 128
//      rows), fewer where N items would not fill the grid; CTA b takes
//      tiles b, b + grid, ... . additive_pool_long cuts
//      an item into tiles of R = 128 positions and spreads it over c CTAs
//      (c <= its tiles), each taking every c-th tile: c = 1 where the items
//      alone fill the card (N 512 at L 1,023, N >= 2,048 at L 495), else
//      the c that fills it best (N 128 at L 1,023: 2), so that the card
//      does not wait on a few long items.
//    * Loads: cp.async of 16 bytes (8 where a bf16 row is not a multiple
//      of 16 bytes) into a ring of up to 4 stages, so that the next tiles
//      load while one is scored; the mask beside each tile.
//    * W1 is staged once a CTA as W1^T in the route's operand type (f32,
//      or for bf16 x two bf16 planes, hi = bf16(W1) and lo = bf16(W1 -
//      hi)), rows of round_up(D, k) + pad elements: the k padding is zero
//      and every fragment read of a warp hits 32 banks. H is padded to
//      whole groups of 64 columns with w2 = 0, so odd widths score on the
//      same path.
//    * Scores: warp w multiplies rows 16w..16w+15 of the tile by W1 on
//      mma.sync, 64 columns at a time: bf16 m16n8k16 against hi and lo,
//      or f32 as three TF32 products a k step of 8 (3xTF32, hopper.cuh's
//      mma3). The epilogue stays in registers: + b1, tanh as 1 - 2 /
//      (e^{2v} + 1) by ex2.approx and a fast division (within 1e-6), x
//      w2, summed along the row, then a quad shuffle and one shared-memory
//      slot a row.
//    * additive_pool_kernel: one warp an item, every warp of the CTA: the
//      masked softmax over the item's scores, then each lane sums a column
//      pair over the positions still in shared memory.
//    * additive_pool_long: every warp takes the tile's masked max m_t;
//      warp w sums e = exp(s - m_t') * mask and e * x over its 16 rows
//      (m_t' = m_t, or 0 where the tile has no valid position: the
//      reference's rule); the warps' sums, added in a fixed order, fold
//      into the CTA's running (m, sum, acc[D]) by an online softmax, a
//      tile with no valid position scaled by exactly 0. With c = 1 the CTA
//      writes out = acc / (sum + EPS). Else it writes its share's partial
//      to a workspace the wrapper allocates, and the CTA that adds the
//      item's last ticket (a per-item counter it resets to 0, so the next
//      launch needs no memset) combines the shares in share order: out =
//      sum_j f_j acc_j / (sum_j f_j sum_j + EPS), f_j = e^{m_j - M'}, M'
//      the reference's guarded max. One launch a call; two calls are
//      bit-equal.
//
// The device queries and the shared-memory attributes are set once by the
// prepare entry points, not on every launch. The C entry points return a
// cudaError_t; a launch is checked with cudaGetLastError() and never
// synchronises.

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <type_traits>
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

__device__ __forceinline__ float tanh_approx(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// tanh v = 1 - 2 / (e^{2v} + 1): ex2.approx and rcp.approx, within 1e-6
// absolute (+-1 where e^{2v} overflows or vanishes)
__device__ __forceinline__ float tanh_f32(float v) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * 2.8853900817779268f));
  return 1.f - __fdividef(2.f, e + 1.f);
}

// ---------------------------------------------------------------------------
// Tile kernels: additive_pool_kernel (whole items) and additive_pool_long
// (an item's positions over several CTAs), mma.sync in bf16 or 3xTF32
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16 * kWarps;  // a warp scores 16 rows of a tile
constexpr int kMaxStages = 4;
constexpr int kGroupTiles = 8;   // 8-column tiles of W1 a warp holds at once
constexpr int kStageLoads = 16;  // W1 loads a thread has in flight
// the shared memory a CTA may take for two to share an SM (228 KB, 1 KB
// of it reserved for each CTA)
constexpr int kHalfSm = 113 * 1024;

// The route of x's type: the k of one product (kStep), and the padding of
// an operand row in elements (kPad): with rows of round_up(D, kStep) +
// kPad elements (an odd multiple of 4 words), a warp's fragment read (8
// rows x 4 words) hits 32 distinct banks.
template <typename T>
struct Route;
template <>
struct Route<float> {
  static constexpr int kStep = 8, kPad = 4;
};
template <>
struct Route<__nv_bfloat16> {
  static constexpr int kStep = 16, kPad = 8;
};

// Shared memory of a CTA, byte offsets: x stages (S x R rows of ld) | W1^T
// (Hp rows of ld, H padded to whole groups of 64 columns; bf16: a plane of
// hi = bf16(W1) and one of lo = bf16(W1 - hi)) | mask stages
// (S x R) | {b1, w2} pairs (Hp / 2 float4) | scores (R) | e (R) | the
// warps' running weighted sums (kWarps x Dp), maxima and sums (kWarps
// each), the combine flag
struct Layout {
  int Dp, ld, Hp, R, S;
  int w1t, mask, bw, sc, es, red, bytes;
  __host__ __device__ Layout(int D, int H, int R_, int S_, int step, int pad,
                             int eb)
      : Dp(round_up(D, step)), ld(Dp + pad),
        Hp(round_up(H, 8 * kGroupTiles)), R(R_), S(S_) {
    w1t = S * R * ld * eb;
    mask = w1t + Hp * ld * 4;  // f32, or two bf16 planes
    bw = mask + S * R * 4;
    sc = bw + Hp * 8;
    es = sc + R * 4;
    red = es + R * 4;
    bytes = round_up(red + (kWarps * Dp + 2 * kWarps + 4) * 4, 16);
  }
};

template <typename T>
__host__ __device__ inline Layout layout_of(int D, int H, int R, int S) {
  return Layout(D, H, R, S, Route<T>::kStep, Route<T>::kPad, (int)sizeof(T));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The CTA's shared memory, carved by its Layout
template <typename T>
struct Tiles {
  Layout lo;
  T* x;
  T* w1t;
  float* mask;
  float4* bw;
  float* sc;
  float* es;
  float* red;
  __device__ Tiles(unsigned char* smem, int D, int H, int R, int S)
      : lo(layout_of<T>(D, H, R, S)),
        x(reinterpret_cast<T*>(smem)),
        w1t(reinterpret_cast<T*>(smem + lo.w1t)),
        mask(reinterpret_cast<float*>(smem + lo.mask)),
        bw(reinterpret_cast<float4*>(smem + lo.bw)),
        sc(reinterpret_cast<float*>(smem + lo.sc)),
        es(reinterpret_cast<float*>(smem + lo.es)),
        red(reinterpret_cast<float*>(smem + lo.red)) {}
  // the stage of this CTA's k-th tile
  __device__ T* xs(int k) const { return x + (k % lo.S) * lo.R * lo.ld; }
  __device__ float* ms(int k) const { return mask + (k % lo.S) * lo.R; }
};

// W1^T in the route's type (zero past D and H), the {b1, w2} pairs (w2 = 0
// past H), and the zero columns D..Dp-1 of every x stage (cp.async writes
// only columns below D)
template <typename T>
__device__ void stage_weights(const Tiles<T>& s, const float* __restrict__ w1,
                              const float* __restrict__ b1,
                              const float* __restrict__ w2, int D, int H) {
  const Layout& lo = s.lo;
  // kStageLoads loads in flight a thread before their stores: a CTA of
  // one or two tiles waits on this staging, not on its tiles
  const int total = lo.Dp * lo.Hp;
  for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kStageLoads) {
    float v[kStageLoads];
#pragma unroll
    for (int b = 0; b < kStageLoads; ++b) {
      const int i = i0 + b * kThreads, d = i / lo.Hp, j = i - d * lo.Hp;
      v[b] = i < total && d < D && j < H ? w1[(size_t)d * H + j] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kStageLoads; ++b) {
      const int i = i0 + b * kThreads, d = i / lo.Hp, j = i - d * lo.Hp;
      if (i >= total) continue;
      T* w = s.w1t + j * lo.ld + d;  // j fastest
      if constexpr (std::is_same<T, float>::value) {
        *w = v[b];
      } else {
        const T hi = __float2bfloat16(v[b]);
        w[0] = hi;
        w[lo.Hp * lo.ld] = __float2bfloat16(v[b] - __bfloat162float(hi));
      }
    }
  }
  for (int p = threadIdx.x; p < lo.Hp / 2; p += kThreads) {
    const int a = 2 * p, b = a + 1;
    s.bw[p] = make_float4(a < H ? b1[a] : 0.f, b < H ? b1[b] : 0.f,
                          a < H ? w2[a] : 0.f, b < H ? w2[b] : 0.f);
  }
  const int pad = lo.Dp - D;
  for (int i = threadIdx.x; i < lo.S * lo.R * pad; i += kThreads) {
    const int r = i / pad;
    s.x[r * lo.ld + D + i - r * pad] = T(0.f);
  }
}

// Positions p0 .. p0 + rows - 1 of x, seen as (N * L, D), into a tile of
// rows of ld elements by cp.async of cb bytes, and their mask values;
// committed by the caller
template <typename T>
__device__ __forceinline__ void load_tile(T* xt, float* mt,
                                          const T* __restrict__ x,
                                          const float* __restrict__ mask,
                                          long long p0, int rows, int D,
                                          int ld, int cb) {
  const int rb = D * (int)sizeof(T), per = rb / cb, lb = ld * (int)sizeof(T);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(x + p0 * D);
  unsigned char* dst = reinterpret_cast<unsigned char*>(xt);
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, c = (i - r * per) * cb;
    if (cb == 16)
      hopper::cp_async<16>(dst + r * lb + c, src + (size_t)r * rb + c);
    else
      hopper::cp_async<8>(dst + r * lb + c, src + (size_t)r * rb + c);
  }
  for (int r = threadIdx.x; r < rows; r += kThreads)
    hopper::cp_async<4>(mt + r, mask + p0 + r);
}

__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: hopper::cp_async_wait<0>(); break;
    case 1: hopper::cp_async_wait<1>(); break;
    case 2: hopper::cp_async_wait<2>(); break;
    default: hopper::cp_async_wait<3>(); break;
  }
}

// sc[r] = sum_j tanh(xt[r] . W1[:, j] + b1[j]) * w2[j] for the rows r of
// the tile's 16-row slabs that hold any of its `rows` rows; warp w takes
// rows 16w..16w+15 (its rows past `rows` are scored from whatever the
// stage holds, and never read)
template <typename T>
__device__ __forceinline__ void score_tile(const T* __restrict__ xt,
                                           const T* __restrict__ w1t,
                                           const float4* __restrict__ bw,
                                           float* __restrict__ sc, int rows,
                                           const Layout& lo) {
  constexpr int kStep = Route<T>::kStep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp, ld = lo.ld;
  if (r0 >= rows) return;
  const T* xa = xt + (r0 + g) * ld;
  float s0 = 0.f, s1 = 0.f;  // rows r0 + g, r0 + g + 8
  for (int j0 = 0; j0 < lo.Hp; j0 += 8 * kGroupTiles) {
    const T* wb = w1t + (j0 + g) * ld;
    float acc[kGroupTiles][4];
#pragma unroll
    for (int q = 0; q < kGroupTiles; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < lo.Dp; k0 += kStep) {
      if constexpr (std::is_same<T, float>::value) {
        const float av[4] = {xa[k0 + t], xa[8 * ld + k0 + t], xa[k0 + t + 4],
                             xa[8 * ld + k0 + t + 4]};
        const hopper::Split<4> a(av);
#pragma unroll
        for (int q = 0; q < kGroupTiles; ++q) {
          const float* p = wb + 8 * q * ld + k0 + t;
          const float bv[2] = {p[0], p[4]};
          hopper::mma3(acc[q], a, hopper::Split<2>(bv));
        }
      } else {
        const int c = k0 + 2 * t;
        const uint32_t a[4] = {word(xa + c), word(xa + 8 * ld + c),
                               word(xa + c + 8), word(xa + 8 * ld + c + 8)};
#pragma unroll
        for (int q = 0; q < kGroupTiles; ++q) {
          const T* p = wb + 8 * q * ld + c;
          const T* pl = p + lo.Hp * ld;  // W1 - bf16(W1)
          const uint32_t b[2] = {word(p), word(p + 8)};
          const uint32_t bl[2] = {word(pl), word(pl + 8)};
          hopper::mma_bf16(acc[q], a, b);
          hopper::mma_bf16(acc[q], a, bl);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kGroupTiles; ++q) {
      // columns j0 + 8q + 2t and + 1
      const float4 p = bw[(j0 >> 1) + 4 * q + t];
      s0 = fmaf(tanh_f32(acc[q][0] + p.x), p.z, s0);
      s0 = fmaf(tanh_f32(acc[q][1] + p.y), p.w, s0);
      s1 = fmaf(tanh_f32(acc[q][2] + p.x), p.z, s1);
      s1 = fmaf(tanh_f32(acc[q][3] + p.y), p.w, s1);
    }
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  if (t == 0) {
    sc[r0 + g] = s0;
    sc[r0 + g + 8] = s1;
  }
}

// dst[c] = scale * sum_l e[l] * xt[l, c] over `rows` rows of the tile, in
// f32, c < D; the calling warp's lane takes column pairs lane, lane + 32,
// ...
template <typename T>
__device__ __forceinline__ void weighted_sum(const T* __restrict__ xt,
                                             const float* __restrict__ e,
                                             int rows, int D, int ld,
                                             float scale, T* __restrict__ dst) {
  for (int p = threadIdx.x & 31; 2 * p < D; p += 32) {
    float2 a = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int l = 0; l < rows; ++l) {
      const float2 v = load_pair(xt + l * ld + 2 * p);
      a.x = fmaf(e[l], v.x, a.x);
      a.y = fmaf(e[l], v.y, a.y);
    }
    store_pair(dst + 2 * p, a.x * scale, a.y * scale);
  }
}

// The ring over this CTA's tiles, which a cursor walks (valid(), p0(),
// rows(), next()): each loaded S - 1 tiles ahead, scored into s.sc (each
// warp its own rows), then handed to epi(cursor, x stage, mask stage),
// which every thread calls and which syncs the CTA itself where it reads
// another warp's scores. One CTA barrier a tile where S >= 2: it makes
// the tile's copies visible, and it frees the stage the previous tile
// held, which is refilled right after it.
template <typename T, typename Cursor, typename Epi>
__device__ __forceinline__ void run_tiles(const Tiles<T>& s,
                                          const T* __restrict__ x,
                                          const float* __restrict__ mask,
                                          int D, int cb, Cursor cur, Epi epi) {
  const int S = s.lo.S;
  Cursor ahead = cur;
  auto issue = [&](int k) {
    if (ahead.valid()) {
      load_tile(s.xs(k), s.ms(k), x, mask, ahead.p0(), ahead.rows(), D,
                s.lo.ld, cb);
      ahead.next();
    }
    hopper::cp_async_commit();  // a group per tile, empty or not
  };
  for (int k = 0; k + 1 < S; ++k) issue(k);
  for (int k = 0; cur.valid(); ++k, cur.next()) {
    if (S == 1) {
      __syncthreads();  // the previous tile is done with the one stage
      issue(k);
    }
    cp_async_wait_upto(S == 1 ? 0 : S - 2);  // this tile's copies
    __syncthreads();
    if (S > 1) issue(k + S - 1);  // into the stage the previous tile freed
    score_tile<T>(s.xs(k), s.w1t, s.bw, s.sc, cur.rows(), s.lo);
    epi(cur, s.xs(k), s.ms(k));
  }
}

// additive_pool_kernel's tiles: unit u holds items uG .. uG + G - 1
struct ItemTiles {
  int u, N, L, G, units;
  __device__ bool valid() const { return u < units; }
  __device__ long long p0() const { return (long long)u * G * L; }
  __device__ int items() const { return min(G, N - u * G); }
  __device__ int rows() const { return items() * L; }
  __device__ void next() { u += gridDim.x; }
};

// Whole items: warp w pools items w, w + kWarps, ... of each tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
additive_pool_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, T* __restrict__ out, int N,
                     int L, int D, int H, int G, int R, int S, int cb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<T> s(smem, D, H, R, S);
  stage_weights(s, w1, b1, w2, D, H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const ItemTiles first = {(int)blockIdx.x, N, L, G, (N + G - 1) / G};
  run_tiles(s, x, mask, D, cb, first,
            [&](const ItemTiles& c, const T* xt, const float* mt) {
    __syncthreads();  // every warp's scores
    for (int i = warp; i < c.items(); i += kWarps) {
      float* si = s.sc + i * L;
      const float* mi = mt + i * L;
      float m = -FLT_MAX;
      for (int l = lane; l < L; l += 32)
        m = fmaxf(m, mi[l] > 0.f ? si[l] : -FLT_MAX);
      m = warp_max(m);
      m = m > -0.5f * FLT_MAX ? m : 0.f;
      float sum = 0.f;
      for (int l = lane; l < L; l += 32) {
        const float e = mi[l] > 0.f ? expf(si[l] - m) * mi[l] : 0.f;
        si[l] = e;
        sum += e;
      }
      const float inv = 1.f / (warp_sum(sum) + kEps);
      __syncwarp();
      weighted_sum(xt + i * L * s.lo.ld, si, L, D, s.lo.ld, inv,
                   out + (size_t)(c.u * G + i) * D);
    }
  });
}

// additive_pool_long's tiles: unit u is share j = u % c of item n = u / c,
// its tiles t = j, j + c, ... of R positions
struct ShareTiles {
  int u, i, c, nt, L, R, units;
  __device__ bool valid() const { return u < units; }
  __device__ int tile() const { return u % c + i * c; }
  __device__ long long p0() const {
    return (long long)(u / c) * L + (long long)tile() * R;
  }
  __device__ int rows() const { return min(R, L - tile() * R); }
  __device__ bool last() const { return tile() + c >= nt; }
  __device__ void next() {
    if (last()) {
      u += gridDim.x;
      i = 0;
    } else {
      ++i;
    }
  }
};

__device__ __forceinline__ float guarded(float m) {
  return m > -0.5f * FLT_MAX ? m : 0.f;
}

// An item's positions over c CTAs (c = 1 where the items alone fill the
// card; additive_pool_long_split). Warp w folds rows 16w..16w+15 of each
// tile of its CTA's share into a running (m_w, z_w, acc_w) by an online
// softmax: m_w the raw masked max, z_w = sum e and acc_w = sum e x, e =
// exp(s - m_w') * mask, m_w' = guarded(m_w); a fold with nothing valid so
// far scales by exactly 0. At the share's last tile the warps' states
// combine in warp order; with c = 1 the CTA writes out = acc / (z + EPS),
// else part[u] = (m, z, acc[D]), and the CTA that adds the item's last
// ticket combines the c shares in share order.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
additive_pool_long(const T* __restrict__ x, const float* __restrict__ mask,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, T* __restrict__ out,
                   float* __restrict__ part, int* __restrict__ tickets, int N,
                   int L, int D, int H, int R, int S, int c, int cb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<T> s(smem, D, H, R, S);
  stage_weights(s, w1, b1, w2, D, H);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = (L + R - 1) / R, Dp = s.lo.Dp;
  float* acc_w = s.red + warp * Dp;  // this warp's, by column pairs
  float* wm = s.red + kWarps * Dp;   // the warps' m_w, then z_w
  float* wz = wm + kWarps;
  int* last = reinterpret_cast<int*>(wz + kWarps);
  float m_w = -FLT_MAX, z_w = 0.f;  // alike in the warp's lanes
  const ShareTiles first = {(int)blockIdx.x, 0, c, nt, L, R, N * c};
  run_tiles(s, x, mask, D, cb, first,
            [&](const ShareTiles& cur, const T* xt, const float* mt) {
    __syncwarp();  // this warp's scores
    const int r0 = 16 * warp, nr = max(0, min(16, cur.rows() - r0));
    float v = -FLT_MAX, mk = 0.f;
    if (lane < nr) {
      mk = mt[r0 + lane];
      v = mk > 0.f ? s.sc[r0 + lane] : -FLT_MAX;
    }
    const float mn = fmaxf(m_w, warp_max(v)), gn = guarded(mn);
    const float su = m_w > -0.5f * FLT_MAX ? expf(guarded(m_w) - gn) : 0.f;
    const float e = lane < nr && mk > 0.f ? expf(v - gn) * mk : 0.f;
    z_w = z_w * su + warp_sum(e);
    m_w = mn;
    if (lane < nr) s.es[r0 + lane] = e;
    __syncwarp();
    // acc_w = acc_w * su + sum_l e_l x_l (acc_w = 0 at a share's first tile)
    const bool fresh = cur.i == 0;
    for (int p = lane; 2 * p < D; p += 32) {
      float2 a = fresh ? make_float2(0.f, 0.f)
                       : make_float2(acc_w[2 * p] * su, acc_w[2 * p + 1] * su);
      for (int l = 0; l < nr; ++l) {
        const float el = s.es[r0 + l];
        const float2 xv = load_pair(xt + (r0 + l) * s.lo.ld + 2 * p);
        a.x = fmaf(el, xv.x, a.x);
        a.y = fmaf(el, xv.y, a.y);
      }
      acc_w[2 * p] = a.x;
      acc_w[2 * p + 1] = a.y;
    }
    if (!cur.last()) return;
    // the share's end: the warps' states, in warp order
    if (lane == 0) {
      wm[warp] = m_w;
      wz[warp] = z_w;
    }
    m_w = -FLT_MAX;
    z_w = 0.f;
    __syncthreads();
    float M = -FLT_MAX;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w]);
    const float Mg = guarded(M);
    float z = 0.f;
    for (int w = 0; w < kWarps; ++w)
      if (wm[w] > -0.5f * FLT_MAX) z = fmaf(expf(wm[w] - Mg), wz[w], z);
    const int n = cur.u / c;
    float* pu = part + (size_t)cur.u * (D + 2);
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.f;
      for (int w = 0; w < kWarps; ++w)
        if (wm[w] > -0.5f * FLT_MAX)
          a = fmaf(expf(wm[w] - Mg), s.red[w * Dp + d], a);
      if (c == 1)
        store(out + (size_t)n * D + d, a / (z + kEps));
      else
        pu[2 + d] = a;
    }
    if (c == 1) return;
    if (tid == 0) {
      pu[0] = M;
      pu[1] = z;
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();  // this CTA's partials, before its ticket
      *last = atomicAdd(tickets + n, 1) == c - 1;
      __threadfence();
    }
    __syncthreads();
    if (!*last) return;
    const float* pn = part + (size_t)n * c * (D + 2);
    float Ms = -FLT_MAX;
    for (int j = 0; j < c; ++j) Ms = fmaxf(Ms, __ldcg(pn + (size_t)j * (D + 2)));
    const float Msg = guarded(Ms);
    for (int d = tid; d < D; d += kThreads) {
      float o = 0.f, den = 0.f;
#pragma unroll 4
      for (int j = 0; j < c; ++j) {
        const float* pj = pn + (size_t)j * (D + 2);
        const float mj = __ldcg(pj), zj = __ldcg(pj + 1);
        const float aj = __ldcg(pj + 2 + d);
        // a share with no valid position adds exactly 0 (its e^{m - M'}
        // could be inf, its sums are 0)
        if (mj > -0.5f * FLT_MAX) {
          const float f = expf(mj - Msg);
          den = fmaf(f, zj, den);
          o = fmaf(f, aj, o);
        }
      }
      store(out + (size_t)n * D + d, o / (den + kEps));
    }
    if (tid == 0) tickets[n] = 0;
  });
}

// A launch's shape: tile rows R, ring stages S, items a tile G (whole
// items; 1 for the long kernel) and the shared memory of a CTA
struct Plan {
  int R, S, G, bytes;
};

// The tile rows: whole items' largest packing (G = 128 // L), or 128
// positions; fewer where one stage of them does not fit `budget`. Then the
// stages, up to kMaxStages: as many as fit half an SM where one does (two
// CTAs an SM: one scores while the other waits, which beat one CTA with
// four stages at f32, H 256), else as many as fit the budget. false where
// not even the smallest tile fits.
template <typename T>
bool plan_of(bool long_seq, int L, int D, int H, int budget, Plan* p) {
  int R = 0, G = 1;
  for (int k = 0;; ++k) {
    if (long_seq) {
      R = kMaxRows - 16 * k;
      if (R < 16) return false;
    } else {
      G = kMaxRows / L - k;
      if (G < 1) return false;
      R = round_up(G * L, 16);
    }
    if (layout_of<T>(D, H, R, 1).bytes <= budget) break;
  }
  int S = 1;
  while (S < kMaxStages && layout_of<T>(D, H, R, S + 1).bytes <= kHalfSm) ++S;
  if (layout_of<T>(D, H, R, 1).bytes > kHalfSm)
    while (S < kMaxStages && layout_of<T>(D, H, R, S + 1).bytes <= budget) ++S;
  *p = {R, S, long_seq ? 1 : G, layout_of<T>(D, H, R, S).bytes};
  return true;
}

template <typename T>
const void* tile_kernel(bool long_seq) {
  return long_seq ? reinterpret_cast<const void*>(additive_pool_long<T>)
                  : reinterpret_cast<const void*>(additive_pool_kernel<T>);
}

// Lets the kernel use the device's opt-in shared memory and fills cfg:
// {persistent CTAs, R, S, G}
template <typename T>
cudaError_t prepare_tiles(bool long_seq, int L, int D, int H, int device,
                          int* cfg) {
  int sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  Plan p;
  if (!plan_of<T>(long_seq, L, D, H, optin, &p)) return cudaErrorInvalidValue;
  const void* kernel = tile_kernel<T>(long_seq);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      p.bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cfg[0] = per_sm * sms;
  cfg[1] = p.R;
  cfg[2] = p.S;
  cfg[3] = p.G;
  return cudaSuccess;
}

// 16-byte copies where x and its rows allow, else 8 (a bf16 row of D % 8
// == 4); 0 where x is not 8-byte aligned
int copy_bytes(const void* x, int row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) | (uintptr_t)row_bytes;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : 0;
}

// The CTAs an item of nt tiles is spread over, c <= nt, for `blocks`
// persistent CTAs: the least of rounds x (tiles a share + half a tile for
// a share's partials and ticket where c > 1), the rounds ceil(N c /
// blocks); the smallest such c. Items that fill the card alone take c = 1.
int split_of(int N, int nt, int blocks) {
  int best = 1;
  long long best_cost = -1;
  for (int c = 1; c <= nt; ++c) {
    const long long rounds = ((long long)N * c + blocks - 1) / blocks;
    const long long cost = rounds * (2LL * ((nt + c - 1) / c) + (c > 1));
    if (best_cost < 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T>
int launch_tiles(bool long_seq, const void* x, const void* mask,
                 const void* w1, const void* b1, const void* w2, void* out,
                 void* part, void* tickets, int N, int L, int D, int H,
                 int blocks, int R, int S, int G, int c, cudaStream_t stream) {
  const int cb = copy_bytes(x, D * (int)sizeof(T));
  if (cb == 0 || R < 16 || R > kMaxRows || R % 16 || S < 1 ||
      S > kMaxStages || G < 1 || L < 1 || (!long_seq && G * L > R) ||
      c < 1 || (long_seq && c > (L + R - 1) / R) ||
      (long_seq && c > 1 && (!part || !tickets)) ||
      reinterpret_cast<uintptr_t>(mask) % 4)
    return cudaErrorInvalidValue;
  const int smem = layout_of<T>(D, H, R, S).bytes;
  // fewer items a tile where the tiles would not fill the grid (a few
  // dozen items), so that they score on as many SMs
  if (!long_seq) G = max(1, min(G, (N + blocks - 1) / blocks));
  const long long units = long_seq ? (long long)N * c : (N + G - 1) / G;
  if (units > INT32_MAX) return cudaErrorInvalidValue;
  const int grid = units < blocks ? (int)units : blocks;
  const T* xt = static_cast<const T*>(x);
  const float* m = static_cast<const float*>(mask);
  const float* pw1 = static_cast<const float*>(w1);
  const float* pb1 = static_cast<const float*>(b1);
  const float* pw2 = static_cast<const float*>(w2);
  T* o = static_cast<T*>(out);
  if (long_seq)
    additive_pool_long<T><<<grid, kThreads, smem, stream>>>(
        xt, m, pw1, pb1, pw2, o, static_cast<float*>(part),
        static_cast<int*>(tickets), N, L, D, H, R, S, c, cb);
  else
    additive_pool_kernel<T><<<grid, kThreads, smem, stream>>>(
        xt, m, pw1, pb1, pw2, o, N, L, D, H, G, R, S, cb);
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

// The least dynamic shared memory a CTA of the tile kernels needs at these
// widths (one stage of the smallest tile: one item for additive_pool_kernel,
// 16 positions for additive_pool_long).
size_t additive_pool_smem_bytes(int long_seq, int L, int D, int H,
                                int x_is_bf16) {
  const int R = long_seq ? 16 : round_up(L, 16);
  return x_is_bf16 ? layout_of<__nv_bfloat16>(D, H, R, 1).bytes
                   : layout_of<float>(D, H, R, 1).bytes;
}

// Readies a tile kernel (additive_pool_long if long_seq, else
// additive_pool_kernel) for x of this type at these widths on `device`,
// once: cfg[0..3] = the persistent CTAs, the tile rows R, the ring's stages
// S and the items a tile G that additive_pool_forward /
// additive_pool_long_forward take. Returns a cudaError_t.
int additive_pool_prepare(int long_seq, int L, int D, int H, int x_is_bf16,
                          int device, int* cfg) {
  if (x_is_bf16)
    return prepare_tiles<__nv_bfloat16>(long_seq, L, D, H, device, cfg);
  return prepare_tiles<float>(long_seq, L, D, H, device, cfg);
}

// additive_pool_kernel. x (N, L, D) f32 or bf16 (x_is_bf16), 8-byte
// aligned, mask (N, L) f32, w1 (D, H) f32, b1 (H) f32, w2 (H) f32 -> out
// (N, D) of x's type. All contiguous, all on `device`; D % 4 == 0; blocks,
// R, S and G from additive_pool_prepare at the same widths, type and
// device. Enqueued on `stream`; queries nothing and returns a cudaError_t.
int additive_pool_forward(const void* x, const void* mask, const void* w1,
                          const void* b1, const void* w2, void* out, int N,
                          int L, int D, int H, int x_is_bf16, int blocks,
                          int R, int S, int G, int device, void* stream) {
  if (N == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_tiles<__nv_bfloat16>(false, x, mask, w1, b1, w2, out,
                                       nullptr, nullptr, N, L, D, H, blocks,
                                       R, S, G, 1, st);
  return launch_tiles<float>(false, x, mask, w1, b1, w2, out, nullptr,
                             nullptr, N, L, D, H, blocks, R, S, G, 1, st);
}

// The CTAs additive_pool_long spreads each of N items of L positions over
// (split_of), for tiles of R positions and `blocks` persistent CTAs.
int additive_pool_long_split(int N, int L, int R, int blocks) {
  return N < 1 || L < 1 || R < 1 || blocks < 1
             ? 1
             : split_of(N, (L + R - 1) / R, blocks);
}

// additive_pool_long, any L >= 1: the arguments of additive_pool_forward
// (blocks, R and S from additive_pool_prepare with long_seq), c from
// additive_pool_long_split, and where c > 1 `part`, N * c * (D + 2) f32 of
// workspace, and `tickets`, N int32 that are 0 (the kernel leaves them 0
// again).
int additive_pool_long_forward(const void* x, const void* mask,
                               const void* w1, const void* b1, const void* w2,
                               void* out, void* part, void* tickets, int N,
                               int L, int D, int H, int x_is_bf16, int blocks,
                               int R, int S, int c, int device, void* stream) {
  if (N == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_tiles<__nv_bfloat16>(true, x, mask, w1, b1, w2, out, part,
                                       tickets, N, L, D, H, blocks, R, S, 1,
                                       c, st);
  return launch_tiles<float>(true, x, mask, w1, b1, w2, out, part, tickets,
                             N, L, D, H, blocks, R, S, 1, c, st);
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

const char* additive_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
