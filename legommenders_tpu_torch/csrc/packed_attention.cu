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
// of mma.sync, which wgmma's m64nN layout repeats per warp and chunk. The
// forward and the backward call the same draw (`philox_row` once per row,
// `dropout_bits4_at` per column pair, or `dropout_bits4`), the mask kernel the same rounds split further
// (`dropout_bits4_split`), so they agree whatever their grid or block
// shape. Every kernel takes a `head_offset` added to h in the counter: a
// call over heads [o, o + H) of a tensor sharded by heads (tensor
// parallelism) draws what the whole tensor's heads o.. draw, so the shards'
// masks are slices of one mask. An element is kept iff its bits >=
// floor(dropout * 2^32), as
// in the TPU kernels (`_keep_threshold`); the TPU's own draws (seeded per
// program) cannot be reproduced and are not: the contract is that the same
// keep mask gives the same output. The seed is read from device memory.
//
// What bounds them. The LM item encoder's training page gives one call
// B = 171 packed rows, T = 120 (3 items of 40 tokens), D = 768, 12 heads,
// bf16. The forward moves q, k, v, out (4 * 171*120*768 * 2 B) and the bias
// (171*120*120 * 2 B): 131 MB, 39 us at 3.35 TB/s, against 4*B*T^2*D =
// 7.6 GFLOP, 7.7 us on the bf16 tensor cores. The backward reads q, k, v, g
// and the bias and writes dq, dk, dv (7 * 31.5 MB + 4.9 MB = 226 MB, 67 us)
// for 8*B*T^2*D = 15.1 GFLOP plus the recompute (19 GFLOP, 19 us). On this
// card neither reaches those bounds: per (b, h) item a consumer warp runs
// the softmax, the keep factors (one Philox draw per four elements, ten
// rounds of two 32-bit wide multiplies) and the epilogue, and with 8
// consumer warps per SM their latency, not bytes or tensor-core time, sets
// the pace.
//
// Design of the bf16 kernels (dh in {16, 32, 64, 128}; the main path's is
// 64): attention_fwd_tc and attention_bwd_tc. Both are persistent: a grid
// of min(B*H, SMs) CTAs of 384 threads, one per SM, each walking a
// contiguous b-major share of the (b, h) items, so the heads of one row
// follow each other and share its bias.
//  * Warp roles. Warpgroup 0 is the producer: setmaxnreg gives it 40
//    registers a thread and its warp 0 issues every copy; warpgroups 1 and 2
//    are consumers at 232 registers, warpgroup 1 + g owning query rows
//    64g..64g+63 (T <= 64 leaves warpgroup 2 idle in the forward).
//  * Loads. TMA with 3-D tensor maps over q, k, v (and g) viewed as
//    (B, T, D), boxes of 128 rows x min(dh, 64) columns (dh 128: two boxes),
//    swizzled as wgmma reads them (128, 64 or 32 B rows); rows past T are
//    TMA's zero fill, so T is never padded in device memory. They land in a
//    ring of two stages (one where two do not fit: dh 128, or an f32 bias
//    at T near 128), each with a `full` and an `empty` mbarrier; the
//    producer fills stage n+1 while the consumers work on stage n. The maps
//    are encoded on the host (cuTensorMapEncodeTiled, fetched from the
//    driver through the runtime, so nothing links libcuda) and the last 64
//    are kept by argument, so a call usually encodes none.
//  * The bias. The producer stages row b's bias in shared memory: one bulk
//    async copy (cp.async.bulk, completed on the stage's mbarrier) when its
//    rows are contiguous or a broadcast view (stride 0), whatever their
//    alignment (T = 102 bf16 rows are 204 B: too ragged for TMA), else
//    cp.async of 16, 8 or 4 bytes, or element by element. The forward keeps
//    one copy per stage and reloads it only when b changes; the backward
//    keeps one slot, refilled when every consumer is done with the previous
//    row (its own mbarrier pair), or reads device memory where the slot
//    does not fit (dh 128 with an f32 bias).
//  * Products, all wgmma (bf16 in, f32 accumulate). Forward: S = Q.K^T
//    (m64n128, both operands from shared memory, K-major), the softmax in
//    registers in f32 (scale + bias, row max, __expf, one reciprocal per
//    row, the dropout, p rounded to bf16 once), then O = P.V with P packed
//    in place as the register A operand and V read through a transposed
//    (MN-major) descriptor. The accumulator layout gives warp w rows
//    16w..16w+15 and each lane, in every 8-column chunk, the (r, r+8) x
//    (c, c+1) positions of an mma.sync m16n8 tile: the Philox mapping
//    below keeps its meaning. O goes through shared memory to a TMA store;
//    rows past T fall outside the tensor and are not written.
//  * Masked chunks (forward). A warp skips the exponentials and the Philox
//    draws of an 8-key chunk whose bias masks all its 16 x 8 scores (its
//    rows each having a key that is not masked; with dropout, rows past
//    T, whose outputs are never stored, do not count): those weights are
//    exactly 0 either way. At bert-naml's packing (3 items of 40) about half the
//    chunks of a warp fall outside its rows' items. The backward skips
//    nothing: on the card that measured slower there.
//  * Backward. Phase 1, warpgroup g on its query rows: S and dPd = g.V^T
//    (both m64n128 from shared memory), p, the keep factors, dp, the row
//    sums and dS in registers with the reference's rounding points; dS and
//    round(pd) to shared memory (bf16, 128 x 128 each, swizzled as a
//    transposed A operand), dQ = dS.K with dS as the register A operand.
//    After a barrier of both warpgroups, phase 2 on key rows 64g..:
//    dK = dS^T.Q and dV = round(pd)^T.g, dS^T and pd^T read through MN-major
//    descriptors. dQ, dK and dV go through the K and V tiles of the stage
//    (dead by then) to TMA stores; each output row is written once, no
//    atomics. Shared memory at dh 64, T = 120: 2 x 64 KB + 64 KB + the
//    bias slot, 227 KB.
//  * f32 (forward and backward, dh a multiple of 8 up to 128):
//    attention_fwd_tf32 and attention_bwd_tf32, the same two TPU kernels
//    on the tensor cores in 3xTF32. Each f32 operand fragment is split in
//    registers into hi = x rounded to TF32 (to nearest, ties away) and lo
//    = x - hi rounded likewise; a k step of 8 issues
//    lo.hi, hi.lo and hi.hi (lo.lo dropped) as mma.sync.m16n8k8.tf32 into
//    a fresh accumulator that is then added to the sum in f32: the tensor
//    core truncates as it adds to a running sum
//    (tools/tf32_probe.py). At the data sheet's 495 / 3 = 165 TFLOP/s of
//    3xTF32 the training page would be bytes-bound: the forward's 262 MB
//    (q, k, v, out and the f32 bias) take 78.2 us at 3.35 TB/s against
//    45.8 us of products, the backward's 451 MB 134.7 us against 114.6 us
//    (the CUDA cores' 67 TFLOP/s: 112.9 and 282.3 us of products). On this
//    card mma.sync.m16n8k8.tf32 issues at 0.6 a clock an SM, 323 TFLOP/s
//    (tools/tf32_probe.py), so 3xTF32 products alone take the forward 70
//    us and the backward 176 us; beside each product a warp
//    issues its B fragment's split and its accumulator's adds, and the
//    kernels are bound by that issue in 8 warps an SM, not by bytes. The
//    design: one CTA of 8 warps per (b, h) item (up to 255 registers a
//    thread: one CTA an SM), a warp per 16 query (or key) rows; row b's
//    bias and the operands' tiles reach shared memory by cp.async (16-byte
//    pieces for the tiles) in groups waited for in the order they are
//    used, so that each product runs while the next operand arrives; tile
//    rows padded to dh + 4 floats so that both fragment reads are free of
//    bank conflicts, bias rows to 8 mod 32; the A operands of S-type
//    products read from device memory one k step ahead; an accumulator is
//    the A operand of the next product in place (its columns 2t, 2t + 1
//    taken as the k steps t, t + 4, the B fragment's rows permuted to
//    match); outputs leave from the accumulators by 8-byte stores, each
//    row once. The softmax, the dropout (one Philox draw per lane and
//    8-key chunk: the accumulator layout is the draw's) and dS run on the
//    fragments, with the reference's expf and IEEE division. A warp skips
//    the products (by groups of four chunks in S, pairs in P.V), the
//    exponentials and the draws of the 8-key chunks that the bias masks in
//    all its rows (tf_dead_rows; about half of them at bert-naml's
//    packing); a group that runs is one branch-free block, so that its
//    products overlap. The backward: phase 1, K and V whole, for the
//    query rows (S, dPd, the softmax, dS, dQ); phase 2, g and Q whole, for
//    the key rows (dV and dK). Where shared memory holds them (dh up to 88
//    at T 128), pd and dS of the head stay there for phase 2's A operands;
//    else phase 1 keeps the rows' statistics and keep bits and phase 2
//    recomputes S^T and dPd^T.
//  * keep mask: dropout_mask. What bounds it is the integer work of its
//    Philox draws: of a draw's 20 IMAD.WIDE.U32 only rounds 3-9's 14 take
//    all of (b, h, i, j) (the split below), on the FMA pipe, which takes
//    two of its slots for each (32 per clock per SM, tools/int_rates.py);
//    16 XORs and 4 compares on the integer ALU (64 per clock); its bytes
//    take less time. (Measured beside twice as many XORs, the products
//    issue at 21 a clock, not 32: mixed, the two pipes issue no more than
//    2 warp instructions a clock per SM together.) So its design issues
//    little besides those: a persistent grid of 4 CTAs of 256 threads per
//    SM walks the (b, h) items; a thread keeps one block of 4 column pairs
//    for every item and takes rows (i and i + 8) of it by shifts and
//    masks, with no division in the loops; what the draws take from the
//    columns and the item is computed once per item, from the row once
//    per row, leaving per draw 15 products; the round keys once per
//    thread; each product is one mul.wide.u32; the keep bytes are packed
//    by predicated ORs. T a multiple of 8 (the training page's 120)
//    stores them 8 bytes at a time; other T up to 156 (serving's 102)
//    stage the item in shared memory for one bulk copy, which runs while
//    the next item is drawn (narrow stores straight to device memory
//    took twice as long). Any T.
// The C entry points return a cudaError_t; a launch is checked with
// cudaGetLastError() and never synchronises. packed_attention_prepare sets
// the shared-memory attributes and records the SM count once per device.

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxT = 128;
constexpr int kMaskThreads = 256;
constexpr int kMaskCtasPerSm = 4;
constexpr int kMaskDraws = 4;  // draws per unit of work of dropout_mask

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ inline float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ inline float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---------------------------------------------------------------------------
// Dropout bits: Philox4x32-10 as a pure function of (seed, b, h, i, j)
// ---------------------------------------------------------------------------

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

// The round keys of key (seed, 0): round r uses (x(r), r * kPhiloxW1), the
// second word a constant. PhiloxKey computes the first words once per
// thread and holds them; PhiloxSeed holds the seed alone and adds at each
// use, for kernels with no registers to spare.
struct PhiloxKey {
  uint32_t k[10];
  __device__ __forceinline__ explicit PhiloxKey(uint32_t seed) {
#pragma unroll
    for (int r = 0; r < 10; ++r) k[r] = seed + static_cast<uint32_t>(r) * kPhiloxW0;
  }
  __device__ __forceinline__ uint32_t x(int r) const { return k[r]; }
};

struct PhiloxSeed {
  uint32_t seed;
  __device__ __forceinline__ explicit PhiloxSeed(uint32_t s) : seed(s) {}
  __device__ __forceinline__ uint32_t x(int r) const {
    return seed + static_cast<uint32_t>(r) * kPhiloxW0;
  }
};

// (hi, lo) of the 64-bit product a * m: one IMAD.WIDE.U32
__device__ __forceinline__ void mul_wide(uint32_t a, uint32_t m, uint32_t& hi,
                                         uint32_t& lo) {
  unsigned long long p;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(p) : "r"(a), "r"(m));
  hi = static_cast<uint32_t>(p >> 32);
  lo = static_cast<uint32_t>(p);
}

// Rounds R0..9 of Philox4x32-10 on counter c: per round two wide products
// and two three-input XORs.
template <int R0, typename K>
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const K& k) {
#pragma unroll
  for (int r = R0; r < 10; ++r) {
    uint32_t hi0, lo0, hi1, lo1;
    mul_wide(c.x, kPhiloxM0, hi0, lo0);
    mul_wide(c.z, kPhiloxM1, hi1, lo1);
    c = make_uint4(hi1 ^ c.y ^ k.x(r), lo1,
                   hi0 ^ c.w ^ (static_cast<uint32_t>(r) * kPhiloxW1), lo0);
  }
  return c;
}

// A row's draws differ only in the first counter word, j / 2. What rounds
// 0 and 1 compute from the other three, (i with bit 3 clear, h, b), is
// taken once per row: round 0's product of h, and round 1's product of
// its first word (hi1(h) ^ i ^ seed), leave per draw two products and
// three XORs of the first two rounds' four and four.
struct PhiloxRow {
  uint32_t b, q, p, r;
};

template <typename K>
__device__ __forceinline__ PhiloxRow philox_row(const K& k, int b, int h,
                                                int i0) {
  uint32_t hi1, lo1, hia, loa;
  mul_wide(static_cast<uint32_t>(h), kPhiloxM1, hi1, lo1);
  mul_wide(hi1 ^ static_cast<uint32_t>(i0) ^ k.x(0), kPhiloxM0, hia, loa);
  return {static_cast<uint32_t>(b), lo1 ^ k.x(1), hia ^ kPhiloxW1, loa};
}

// The draw at column pair jp of a row: the bits of (i, 2jp), (i, 2jp+1),
// (i+8, 2jp), (i+8, 2jp+1).
template <typename K>
__device__ __forceinline__ uint4 dropout_bits4_at(const PhiloxRow& w,
                                                  const K& k, uint32_t jp) {
  uint32_t hi0, lo0, hi1, lo1;
  mul_wide(jp, kPhiloxM0, hi0, lo0);  // round 0
  mul_wide(hi0 ^ w.b, kPhiloxM1, hi1, lo1);  // round 1
  return philox4x32_10<2>(make_uint4(hi1 ^ w.q, lo1, lo0 ^ w.p, w.r), k);
}

// The bits of (i, j), (i, j+1), (i+8, j), (i+8, j+1) for i with bit 3 clear
// and j even (the words of one draw).
template <typename K>
__device__ __forceinline__ uint4 dropout_bits4(const K& k, int b, int h,
                                               int i, int j) {
  return dropout_bits4_at(philox_row(k, b, h, i & ~8), k,
                          static_cast<uint32_t>(j) >> 1);
}

// The deeper split of the mask kernel, same bits. Of a draw's 20 products
// only rounds 3-9's 14 take all four counter words: round 0's take jp
// alone and h alone, round 1's (i0, h) and (jp, b), round 2's (jp, b, h)
// and (jp, i0, h). dropout_mask keeps each thread on fixed column pairs,
// so it takes jp's product (PhiloxCol), h's (PhiloxHead) and the (jp, b)
// and (jp, b, h) terms (PhiloxColItem) once per item, the
// (i0, h) term once per row (PhiloxRow2), and per draw one XOR, one
// product and two XORs before rounds 3-9.
struct PhiloxCol {
  uint32_t hi, lo;  // round 0: M0 * jp
};
struct PhiloxHead {
  uint32_t hi, lo;  // round 0: M1 * h
};
struct PhiloxColItem {
  uint32_t y, z, w;  // x3 = hi(M1 z2) ^ y, z3 = z ^ row.w, w3 = w
};
struct PhiloxRow2 {
  uint32_t p, w;  // z2 = p ^ col.lo, and round 2's w2 (^ its key word)
};

__device__ __forceinline__ PhiloxCol philox_col(uint32_t jp) {
  PhiloxCol c;
  mul_wide(jp, kPhiloxM0, c.hi, c.lo);
  return c;
}

__device__ __forceinline__ PhiloxHead philox_head(uint32_t h) {
  PhiloxHead d;
  mul_wide(h, kPhiloxM1, d.hi, d.lo);
  return d;
}

template <typename K>
__device__ __forceinline__ PhiloxColItem philox_col_item(const PhiloxCol& c,
                                                         const PhiloxHead& d,
                                                         const K& k,
                                                         uint32_t b) {
  uint32_t zh, zl, xh, xl;
  mul_wide(c.hi ^ b, kPhiloxM1, zh, zl);              // round 1, z1 = (jp, b)
  mul_wide(zh ^ d.lo ^ k.x(1), kPhiloxM0, xh, xl);    // round 2, x2 = (jp, b, h)
  return {zl ^ k.x(2), xh ^ (2u * kPhiloxW1), xl};
}

template <typename K>
__device__ __forceinline__ PhiloxRow2 philox_row2(const PhiloxHead& d,
                                                  const K& k, uint32_t i0) {
  uint32_t xh, xl;
  mul_wide(d.hi ^ i0 ^ k.x(0), kPhiloxM0, xh, xl);    // round 1, x1 = (i0, h)
  return {xh ^ kPhiloxW1, xl};
}

template <typename K>
__device__ __forceinline__ uint4 dropout_bits4_split(const PhiloxColItem& ci,
                                                     const PhiloxRow2& w,
                                                     const PhiloxCol& c,
                                                     const K& k) {
  uint32_t hi, lo;
  mul_wide(w.p ^ c.lo, kPhiloxM1, hi, lo);            // round 2, z2 = (jp, i0, h)
  return philox4x32_10<3>(make_uint4(hi ^ ci.y, lo, ci.z ^ w.w, ci.w), k);
}

// the dropout of one probability: kept (scaled) or zero
__device__ __forceinline__ float drop(float p, uint32_t bits, uint32_t thresh,
                                      float keep_scale) {
  return bits >= thresh ? p * keep_scale : 0.f;
}

// The keep bytes (1 kept, 0 dropped) of four elements, first in the lowest
// byte: four compares, then one select and three predicated ORs.
__device__ __forceinline__ uint32_t keep_bytes(uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d,
                                               uint32_t thresh) {
  uint32_t w;
  asm("{\n\t.reg .pred p0, p1, p2, p3;\n\t"
      "setp.ge.u32 p0, %1, %5;\n\t"
      "setp.ge.u32 p1, %2, %5;\n\t"
      "setp.ge.u32 p2, %3, %5;\n\t"
      "setp.ge.u32 p3, %4, %5;\n\t"
      "selp.u32 %0, 1, 0, p0;\n\t"
      "@p1 or.b32 %0, %0, 0x100;\n\t"
      "@p2 or.b32 %0, %0, 0x10000;\n\t"
      "@p3 or.b32 %0, %0, 0x1000000;\n\t}"
      : "=r"(w)
      : "r"(a), "r"(b), "r"(c), "r"(d), "r"(thresh));
  return w;
}

// Stores the first nv of the 8 bytes w at p: as one 8-byte store (W 8,
// nv 8, p 8-aligned) or byte by byte (W 1).
template <int W>
__device__ __forceinline__ void store_keep(uint8_t* p, const uint32_t (&w)[2],
                                           int nv) {
  if constexpr (W == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < nv) p[k] = static_cast<uint8_t>(w[k / 4] >> (8 * (k % 4)));
  }
}

// Shared memory of one staging buffer of dropout_mask: a (b, h) item's
// T * T bytes at the offset mod 16 they have in device memory.
__host__ __device__ inline int mask_buffer_bytes(int T) {
  return (T * T + 31) & ~15;
}

// The keep mask. A persistent grid (kMaskCtasPerSm CTAs per SM) walks the
// (b, h) items, b-major, stepping b and h without a division. A unit of
// work is D = kMaskDraws draws along j: row group gi (rows i0 = 16 (gi >> 3)
// + (gi & 7) and i0 + 8) and column block c (columns 2Dc..2Dc+2D-1). A
// thread keeps one column block, c = t % n_cb, and takes row groups
// t / n_cb, + g_step, ... (one division, before the loops; threads past
// g_step * n_cb idle); with more than kMaskThreads blocks it takes blocks
// t, t + kMaskThreads, ... and every row group. So what a draw takes from
// its columns and the item (PhiloxCol, PhiloxColItem) is drawn once per
// item, and the loop over rows is left with the products that need the
// row (keeping PhiloxCol across items as well ran 1.6 % slower). Each
// unit's 2D + 2D keep bytes are written as two 8-byte stores when T is a
// multiple of 8 (W 8), else byte by byte (W 1). STAGED (W 1, T up to 156),
// they go into one of two shared-memory copies of the item, laid out as
// it is in device memory (its offset mod 16 kept); once the item is
// whole, one thread stores its 16-byte aligned middle by one bulk copy
// (cp.async.bulk) while the CTA draws the next item into the other copy,
// and a few threads store the ragged ends (< 16 bytes each).
template <int W, bool STAGED>
__global__ void __launch_bounds__(kMaskThreads, kMaskCtasPerSm)
dropout_mask(const int* __restrict__ seed_ptr, uint8_t* __restrict__ out,
             int n_items, int Tn, int H, int n_cb, int n_gi, uint32_t thresh,
             int head_offset) {
  constexpr int D = kMaskDraws, kCols = 2 * D;
  static_assert(D == 4, "a unit's keep bytes are two words a row");
  extern __shared__ __align__(16) uint8_t mask_smem[];
  const PhiloxKey key(static_cast<uint32_t>(*seed_ptr));
  const int item_bytes = Tn * Tn;
  const int c_first = threadIdx.x % n_cb;
  const int g_step = n_cb < kMaskThreads ? kMaskThreads / n_cb : 1;
  const int c_step = n_cb < kMaskThreads ? n_cb : kMaskThreads;
  const int g_first = threadIdx.x / n_cb < g_step ? threadIdx.x / n_cb : n_gi;
  const int step_b = gridDim.x / H, step_h = gridDim.x - step_b * H;
  int b = blockIdx.x / H, h = blockIdx.x - b * H;
  int parity = 0;  // the staging buffer of this item
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    uint8_t* g = out + (size_t)it * item_bytes;
    uint8_t* o = g;
    int shift = 0;
    if constexpr (STAGED) {
      shift = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
      o = mask_smem + parity * mask_buffer_bytes(Tn) + shift;
      // the bulk copy of two items ago has read this buffer
      if (threadIdx.x == 0) hopper::bulk_wait_read<1>();
      __syncthreads();
    }
    const PhiloxHead head = philox_head(static_cast<uint32_t>(h + head_offset));
    for (int c = c_first; c < n_cb; c += c_step) {
      PhiloxCol col[D];
      PhiloxColItem ci[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        col[d] = philox_col(static_cast<uint32_t>(c * D + d));
        ci[d] = philox_col_item(col[d], head, key, static_cast<uint32_t>(b));
      }
      const int j0 = c * kCols, nv = min(kCols, Tn - j0);
      for (int gi = g_first; gi < n_gi; gi += g_step) {
        const int i0 = (gi >> 3) << 4 | (gi & 7);
        const PhiloxRow2 row = philox_row2(head, key, static_cast<uint32_t>(i0));
        uint4 r[D];
#pragma unroll
        for (int d = 0; d < D; ++d) r[d] = dropout_bits4_split(ci[d], row, col[d], key);
        const uint32_t top[2] = {
            keep_bytes(r[0].x, r[0].y, r[1].x, r[1].y, thresh),
            keep_bytes(r[2].x, r[2].y, r[3].x, r[3].y, thresh)};
        const uint32_t bottom[2] = {
            keep_bytes(r[0].z, r[0].w, r[1].z, r[1].w, thresh),
            keep_bytes(r[2].z, r[2].w, r[3].z, r[3].w, thresh)};
        uint8_t* p = o + (i0 * Tn + j0);
        store_keep<W>(p, top, nv);
        if (i0 + 8 < Tn) store_keep<W>(p + 8 * Tn, bottom, nv);
      }
    }
    if constexpr (STAGED) {
      hopper::fence_proxy_async();
      __syncthreads();
      const int head_bytes = min((16 - shift) & 15, item_bytes);
      const int body = (item_bytes - head_bytes) & ~15;
      const int t = threadIdx.x;
      if (t == 0) {
        if (body) hopper::bulk_store(g + head_bytes, o + head_bytes, body);
        hopper::bulk_commit();  // a group per item, empty or not
      } else if (t <= head_bytes) {
        g[t - 1] = o[t - 1];
      } else if (t > 16 && t - 17 < item_bytes - head_bytes - body) {
        g[head_bytes + body + t - 17] = o[head_bytes + body + t - 17];
      }
      parity ^= 1;
    }
    h += step_h;
    b += step_b;
    if (h >= H) {
      h -= H;
      ++b;
    }
  }
  if constexpr (STAGED) {
    if (threadIdx.x == 0) hopper::bulk_wait();
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernels (f32): 3xTF32 mma.sync
// ---------------------------------------------------------------------------

constexpr int kTfWarps = 8;  // a warp per 16 rows: 128 rows
constexpr int kTfThreads = 32 * kTfWarps;
constexpr int kTfChunks = kMaxT / 8;  // 8-key chunks of a row
constexpr int kMaxDh = 128;
constexpr float kF32Lowest = -3.402823466e38f;
// the output tiles of 8 columns a pass of P.V (or dS.K, pd^T.g, dS^T.Q) in
// each kernel
constexpr int kFwdTiles = 4;
constexpr int kBwdTiles = 4;
// S = X.K^T takes its 8-key chunks in groups of this many, each group one
// block of independent products
constexpr int kTfGroup = 4;

// the 3xTF32 helpers (rna_tf32, Split, mma_tf32, mma3) are hopper.cuh's,
// shared with the pool's kernels
using hopper::mma3;
using hopper::mma_tf32;
using hopper::rna_tf32;
using hopper::Split;

// Operand tiles in shared memory: a head's rows (keys or queries) whole,
// row-major, rows padded to dh + 4 floats, so that both fragment reads are
// free of bank conflicts: row g, column t (tf_b_nk) and rows 2t and
// 2t + 1, column g (tf_b_kn), for the lane's g = lane / 4, t = lane % 4.
// Rows from T up to a multiple of 32 (a group of chunks) are zero.
__host__ __device__ inline int tf_rows(int T) { return (T + 31) & ~31; }
__host__ __device__ inline int tf_rows16(int T) { return (T + 15) & ~15; }
__host__ __device__ inline size_t tf_tile_floats(int T, int dh) {
  return (size_t)tf_rows(T) * (dh + 4);
}
// Row b's bias in shared memory: T rows (one for a broadcast view, sq 0) of
// ldb floats, ldb at least T and 8 mod 32, so that a warp's reads of
// column pairs (8 rows x 4 pairs) are free of bank conflicts; 8 floats of
// slack after it for a pair read that starts at the last column.
__host__ __device__ inline int tf_bias_ld(int T) { return (T + 23) / 32 * 32 + 8; }
__host__ __device__ inline size_t tf_bias_floats(int T) {
  return (size_t)T * tf_bias_ld(T) + 8;
}
// K and V (the forward takes Q's fragments from device memory) | the bias
__host__ __device__ inline size_t tf32_fwd_smem_bytes(int T, int dh) {
  return (2 * tf_tile_floats(T, dh) + tf_bias_floats(T)) * sizeof(float);
}
// The backward keeps P (with its keep factors) and dS of the head in
// shared memory where they fit (STASH): rows of the queries up to a
// multiple of 16, of tf_stash_ld floats (at least as many, 4 mod 32, so
// that phase 2's reads of a key column pair of rows 2t, 2t + 1 are free of
// bank conflicts)
__host__ __device__ inline int tf_stash_ld(int T) {
  return (tf_rows16(T) + 27) / 32 * 32 + 4;
}
__host__ __device__ inline size_t tf_stash_floats(int T) {
  return (size_t)tf_rows16(T) * tf_stash_ld(T);
}
// STASH: two tiles | P | dS, whose space holds the bias before dS is
// written. Else: two tiles, the row statistics m, l and rowsum(dP * P)
// [3][kMaxT], the keep bits [warps][chunks][4] | the bias.
__host__ __device__ inline size_t tf32_bwd_smem_bytes(int T, int dh,
                                                      bool stash) {
  const size_t ds = tf_stash_floats(T), bias = tf_bias_floats(T);
  return (stash ? 2 * tf_tile_floats(T, dh) + ds + (ds > bias ? ds : bias)
                : 2 * tf_tile_floats(T, dh) + 3 * kMaxT +
                      kTfWarps * kTfChunks * 4 + bias) *
         sizeof(float);
}

// rows 0..T-1 of one head (row stride D) into tile t by cp.async of 16 B,
// a thread on one 16-byte column of every (256 / (dh / 4))-th row; the
// padding rows zeroed
__device__ void tf_load_tile(float* t, const float* x, int Tn, int D, int dh) {
  const int ld = dh + 4, per_row = dh / 4, rows_per = kTfThreads / per_row;
  const int r0 = threadIdx.x / per_row, c = (threadIdx.x - r0 * per_row) * 4;
  if (r0 < rows_per)
    for (int r = r0; r < Tn; r += rows_per)
      hopper::cp_async<16>(t + r * ld + c, x + (size_t)r * D + c);
  for (int u = threadIdx.x; u < (tf_rows(Tn) - Tn) * ld; u += kTfThreads)
    t[Tn * ld + u] = 0.f;
}

// Row b's bias (src: its first element, row stride sq) into bs by cp.async
// of CB bytes (16, 8 or 4: the widest every row starts and ends on)
template <int CB>
__device__ void tf_load_bias_cb(float* bs, const float* src, long long sq,
                                int Tn) {
  constexpr int U = CB / 4;
  const int ld = tf_bias_ld(Tn), rows = sq ? Tn : 1, per_row = Tn / U;
  for (int u = threadIdx.x; u < rows * per_row; u += kTfThreads) {
    const int r = u / per_row, c = (u - r * per_row) * U;
    hopper::cp_async<CB>(bs + r * ld + c, src + r * sq + c);
  }
}

__device__ void tf_load_bias(float* bs, const float* src, long long sq,
                             int Tn, int cb) {
  if (cb == 16)
    tf_load_bias_cb<16>(bs, src, sq, Tn);
  else if (cb == 8)
    tf_load_bias_cb<8>(bs, src, sq, Tn);
  else
    tf_load_bias_cb<4>(bs, src, sq, Tn);
}

// A fragment (rows m0 + g, m0 + g + 8; columns k0 + t, k0 + t + 4) from
// device memory (row stride D, rows past T zero)
__device__ __forceinline__ void tf_a_global(float (&a)[4], const float* x,
                                            int D, int m0, int k0, int Tn,
                                            int g, int t) {
  const int r0 = m0 + g, r1 = r0 + 8;
  const float* p0 = x + (size_t)r0 * D + k0 + t;
  const float* p1 = x + (size_t)r1 * D + k0 + t;
  a[0] = r0 < Tn ? __ldg(p0) : 0.f;
  a[1] = r1 < Tn ? __ldg(p1) : 0.f;
  a[2] = r0 < Tn ? __ldg(p0 + 4) : 0.f;
  a[3] = r1 < Tn ? __ldg(p1 + 4) : 0.f;
}

// B fragment of X^T for a tile X (rows = n): B[k][n] = X[n0 + n][k0 + k]
__device__ __forceinline__ Split<2> tf_b_nk(const float* s, int ld, int n0,
                                            int k0, int g, int t) {
  const float* p = s + (n0 + g) * ld + k0 + t;
  const float b[2] = {p[0], p[4]};
  return Split<2>(b);
}

// B fragment of a tile X (rows = k) in the k order of an accumulator used
// as the A operand (tf_acc_a): logical k = t, t + 4 are rows k0 + 2t,
// k0 + 2t + 1
__device__ __forceinline__ Split<2> tf_b_kn(const float* s, int ld, int k0,
                                            int n0, int g, int t) {
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
  const float b[2] = {p[0], p[ld]};
  return Split<2>(b);
}

// An m16n8 accumulator (rows g, g + 8; columns 2t, 2t + 1) as the A
// fragment of the next product over those 8 columns, in tf_b_kn's k order
__device__ __forceinline__ Split<4> tf_acc_a(const float (&c)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  return Split<4>(a);
}

// The bias of (i0, j), (i0, j + 1), (i0 + 8, j), (i0 + 8, j + 1) from the
// staged row (bs, row stride rs: ldb, or 0 for a broadcast view): 0 in
// rows past T, -inf in columns past T
__device__ __forceinline__ float4 tf_bias4(const float* bs, int rs, int Tn,
                                           int i0, int j) {
  const int i1 = i0 + 8;
  const bool k0 = j < Tn, k1 = j + 1 < Tn;
  float2 x = make_float2(0.f, 0.f), y = x;
  if (k0) {
    x = *reinterpret_cast<const float2*>(bs + min(i0, Tn - 1) * rs + j);
    y = *reinterpret_cast<const float2*>(bs + min(i1, Tn - 1) * rs + j);
  }
  float4 r;
  r.x = k0 ? (i0 < Tn ? x.x : 0.f) : -INFINITY;
  r.y = k1 ? (i0 < Tn ? x.y : 0.f) : -INFINITY;
  r.z = k0 ? (i1 < Tn ? y.x : 0.f) : -INFINITY;
  r.w = k1 ? (i1 < Tn ? y.y : 0.f) : -INFINITY;
  return r;
}

// The chunks (bit c: keys 8c..8c+7) that a warp may skip in its 16 rows
// from i0 - g: those whose elements are all masked (bias at the f32 lowest
// value, or a row or a column past T), when each of its rows below T has
// a key that is not masked. Every weight of such a chunk is exactly 0 in a
// row below T (exp underflows), so skipping its products, exponentials and
// draws changes no value that is stored. Else none (a row over masked
// keys only takes them all, as the plain version does).
__device__ inline uint32_t tf_dead_rows(const float* bs, int rs, int Tn,
                                        int i0, int nkt, int t) {
  uint32_t live = 0u;
  bool has0 = false, has1 = false;
#pragma unroll
  for (int c = 0; c < kTfChunks; ++c) {
    const float4 e = tf_bias4(bs, rs, Tn, i0, 8 * c + 2 * t);
    const bool l0 = i0 < Tn && (e.x > kF32Lowest || e.y > kF32Lowest);
    const bool l1 = i0 + 8 < Tn && (e.z > kF32Lowest || e.w > kF32Lowest);
    has0 |= l0;
    has1 |= l1;
    live |= (uint32_t)(l0 || l1) << c;
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    has0 |= __shfl_xor_sync(0xffffffffu, (int)has0, o) != 0;
    has1 |= __shfl_xor_sync(0xffffffffu, (int)has1, o) != 0;
  }
  const bool ok = __all_sync(0xffffffffu, (has0 || i0 >= Tn) &&
                                              (has1 || i0 + 8 >= Tn));
  const uint32_t all = (1u << nkt) - 1u;
  return ok ? all & ~__reduce_or_sync(0xffffffffu, live) : 0u;
}

// The softmax of this thread's two rows of S (in place: s holds p on
// return): scale + bias, the row max, expf(s - max), the row sums and IEEE
// division, as the plain version. Scale + bias and the max take every
// chunk, branch-free (a dead chunk's scores are at the lowest value, below
// the row's max; past T -inf); the exponentials and divisions skip dead
// chunks and those past T, whose weights are exactly 0.
__device__ inline void tf_softmax(float (&s)[kTfChunks][4], uint32_t dead,
                                  int nkt, const float* bs, int rs, int Tn,
                                  int i0, int t, float scale, float& m0,
                                  float& m1, float& l0, float& l1) {
  m0 = -INFINITY;
  m1 = -INFINITY;
#pragma unroll
  for (int c = 0; c < kTfChunks; ++c) {
    const float4 e = tf_bias4(bs, rs, Tn, i0, 8 * c + 2 * t);
    s[c][0] = s[c][0] * scale + e.x;
    s[c][1] = s[c][1] * scale + e.y;
    s[c][2] = s[c][2] * scale + e.z;
    s[c][3] = s[c][3] * scale + e.w;
    m0 = fmaxf(m0, fmaxf(s[c][0], s[c][1]));
    m1 = fmaxf(m1, fmaxf(s[c][2], s[c][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  l0 = 0.f;
  l1 = 0.f;
#pragma unroll
  for (int c = 0; c < kTfChunks; ++c) {
    if (c < nkt && !((dead >> c) & 1u)) {
      s[c][0] = expf(s[c][0] - m0);
      s[c][1] = expf(s[c][1] - m0);
      s[c][2] = expf(s[c][2] - m1);
      s[c][3] = expf(s[c][3] - m1);
      l0 += s[c][0] + s[c][1];
      l1 += s[c][2] + s[c][3];
    } else {
      s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
#pragma unroll
  for (int c = 0; c < kTfChunks; ++c) {
    if (c < nkt && !((dead >> c) & 1u)) {
      s[c][0] = s[c][0] / l0;
      s[c][1] = s[c][1] / l0;
      s[c][2] = s[c][2] / l1;
      s[c][3] = s[c][3] / l1;
    }
  }
}

// S = X . K^T for a warp's 16 rows: A fragments from device memory
// (`a_glob`: rows m0.., row stride D; past T zero), B from the tile `kt`
// (all keys). A group of kTfGroup chunks is skipped where all its chunks
// are in `dead` or past T; a group that runs runs its chunks in one
// branch-free block, so that their products overlap (a chunk's three
// products and its add depend on each other). The next k step's A
// fragment is loaded ahead of its use.
__device__ __forceinline__ void tf_scores(float (&s)[kTfChunks][4],
                                          const float* a_glob, int D,
                                          const float* kt, int ld, int m0,
                                          int dh, int nkt, uint32_t dead,
                                          int Tn, int g, int t) {
#pragma unroll
  for (int c = 0; c < kTfChunks; ++c)
    s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
  constexpr uint32_t kGroupBits = (1u << kTfGroup) - 1u;
  const uint32_t idle = dead | ~((1u << nkt) - 1u);
  float an[4];
  tf_a_global(an, a_glob, D, m0, 0, Tn, g, t);
  for (int k0 = 0; k0 < dh; k0 += 8) {
    const Split<4> a(an);
    if (k0 + 8 < dh) tf_a_global(an, a_glob, D, m0, k0 + 8, Tn, g, t);
#pragma unroll
    for (int c0 = 0; c0 < kTfChunks; c0 += kTfGroup) {
      if (((idle >> c0) & kGroupBits) != kGroupBits) {
#pragma unroll
        for (int c = c0; c < c0 + kTfGroup; ++c)
          mma3(s[c], a, tf_b_nk(kt, ld, 8 * c, k0, g, t));
      }
    }
  }
}

// Y = P . X for a warp's 16 rows, P an accumulator-layout (16 x 8 chunks)
// register tile and X a tile (rows = keys): 8 NT output columns a pass,
// stored (rows below T) to y (row stride D) with 8-byte stores. Chunks go
// in pairs, a pair skipped where both are in `dead` or past T (P is 0
// there: a dead chunk beside a live one adds exact zeros).
template <int NT, bool FULL>
__device__ __forceinline__ void tf_product_pass(
    float (&o)[NT][4], const float (&p)[kTfChunks][4], const float* xt,
    int ld, uint32_t idle, int d0, int nd, int g, int t) {
#pragma unroll
  for (int c0 = 0; c0 < kTfChunks; c0 += 2) {
    if (((idle >> c0) & 3u) != 3u) {
#pragma unroll
      for (int c = c0; c < c0 + 2; ++c) {
        const Split<4> a = tf_acc_a(p[c]);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (FULL || n < nd)
            mma3(o[n], a, tf_b_kn(xt, ld, 8 * c, d0 + 8 * n, g, t));
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void tf_product_store(
    const float (&p)[kTfChunks][4], const float* xt, int ld, int nkt,
    uint32_t dead, float* y, int D, int m0, int dh, int Tn, int g, int t) {
  const int r0 = m0 + g, r1 = r0 + 8;
  const uint32_t idle = dead | ~((1u << nkt) - 1u);
  for (int d0 = 0; d0 < dh; d0 += 8 * NT) {
    const int nd = min(NT, (dh - d0) / 8);
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    // whole passes (nd == NT) without a branch per tile
    if (nd == NT)
      tf_product_pass<NT, true>(o, p, xt, ld, idle, d0, nd, g, t);
    else
      tf_product_pass<NT, false>(o, p, xt, ld, idle, d0, nd, g, t);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < nd) {
        const int col = d0 + 8 * n + 2 * t;
        if (r0 < Tn)
          *reinterpret_cast<float2*>(y + (size_t)r0 * D + col) =
              make_float2(o[n][0], o[n][1]);
        if (r1 < Tn)
          *reinterpret_cast<float2*>(y + (size_t)r1 * D + col) =
              make_float2(o[n][2], o[n][3]);
      }
    }
  }
}

// Y = X^T . Z for a warp's 16 key rows m0.. (phase 2 of the backward): X
// a stashed T x T tile (P or dS; rows = queries, row stride lx), read by
// fragments in tf_b_kn's k order, Z a tile (rows = queries): 8 NT output
// columns a pass, stored (rows below T) to y (row stride D). A chunk of 8
// queries whose fragment is 0 in every lane adds nothing and is skipped.
template <int NT>
__device__ __forceinline__ void tf_stash_product_store(
    const float* xs, int lx, const float* zt, int ld, int nkt, float* y,
    int D, int m0, int dh, int Tn, int g, int t) {
  const int r0 = m0 + g, r1 = r0 + 8;
  for (int d0 = 0; d0 < dh; d0 += 8 * NT) {
    const int nd = min(NT, (dh - d0) / 8);
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    for (int c = 0; c < nkt; ++c) {
      const float* x0 = xs + (8 * c + 2 * t) * lx + r0;
      const float a[4] = {x0[0], x0[8], x0[lx], x0[lx + 8]};
      if (!__any_sync(0xffffffffu, a[0] != 0.f || a[1] != 0.f ||
                                        a[2] != 0.f || a[3] != 0.f))
        continue;
      const Split<4> A(a);
      if (nd == NT) {  // a whole pass: no branch per tile
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma3(o[n], A, tf_b_kn(zt, ld, 8 * c, d0 + 8 * n, g, t));
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (n < nd) mma3(o[n], A, tf_b_kn(zt, ld, 8 * c, d0 + 8 * n, g, t));
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < nd) {
        const int col = d0 + 8 * n + 2 * t;
        if (r0 < Tn)
          *reinterpret_cast<float2*>(y + (size_t)r0 * D + col) =
              make_float2(o[n][0], o[n][1]);
        if (r1 < Tn)
          *reinterpret_cast<float2*>(y + (size_t)r1 * D + col) =
              make_float2(o[n][2], o[n][3]);
      }
    }
  }
}

// Rows i0 and i0 + 8 of this thread's accumulator fragments into a stashed
// tile (row stride lx), every chunk of the first 16-row multiple of T's
// columns; rows past T as 0
__device__ __forceinline__ void tf_stash_store(float* xs, int lx,
                                               const float (&x)[kTfChunks][4],
                                               int Tn, int i0, int t) {
  const bool v0 = i0 < Tn, v1 = i0 + 8 < Tn;
  const int nc = tf_rows16(Tn) / 8;
#pragma unroll
  for (int c = 0; c < kTfChunks; ++c) {
    if (c < nc) {
      float* p = xs + i0 * lx + 8 * c + 2 * t;
      *reinterpret_cast<float2*>(p) =
          v0 ? make_float2(x[c][0], x[c][1]) : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(p + 8 * lx) =
          v1 ? make_float2(x[c][2], x[c][3]) : make_float2(0.f, 0.f);
    }
  }
}

using hopper::cp_async_commit;
using hopper::cp_async_wait;

// The forward. One CTA of 8 warps per (b, h) item; row b's bias, K and V
// of the head whole in shared memory (three cp.async groups, waited for
// in that order: the dead chunks from the bias while K arrives, S =
// Q.K^T while V arrives); warp w owns query rows 16w..16w+15, Q's
// fragments read from device memory: S on the tensor cores in 3xTF32, the
// softmax and the dropout on the accumulator fragments (the Philox draw of
// a lane's four elements of a chunk is one draw), then O = P.V with P's
// fragments as the A operand, stored from the accumulators.
__global__ void __launch_bounds__(kTfThreads, 1)
attention_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   float* __restrict__ out, int Tn, int H, int dh, float scale,
                   long long sb, long long sq, int bias_copy,
                   const int* __restrict__ seed_ptr, uint32_t thresh,
                   float keep_scale, int dropout, int head_offset) {
  extern __shared__ __align__(16) float smem[];
  const size_t tile = tf_tile_floats(Tn, dh);
  float* ks = smem;
  float* vs = ks + tile;
  float* bsm = vs + tile;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int D = H * dh, ld = dh + 4, rs = sq ? tf_bias_ld(Tn) : 0;
  const size_t base = (size_t)b * Tn * D + (size_t)h * dh;
  tf_load_bias(bsm, bias + b * sb, sq, Tn, bias_copy);
  cp_async_commit();
  tf_load_tile(ks, k + base, Tn, D, dh);
  cp_async_commit();
  tf_load_tile(vs, v + base, Tn, D, dh);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * warp, i0 = m0 + g;
  const int nkt = (Tn + 7) >> 3;
  const bool has_rows = m0 < Tn;
  cp_async_wait<2>();
  __syncthreads();
  const uint32_t dead =
      has_rows ? tf_dead_rows(bsm, rs, Tn, i0, nkt, t) : 0u;
  cp_async_wait<1>();
  __syncthreads();
  float s[kTfChunks][4];
  if (has_rows) {
    tf_scores(s, q + base, D, ks, ld, m0, dh, nkt, dead, Tn, g, t);
    float mx0, mx1, l0, l1;
    tf_softmax(s, dead, nkt, bsm, rs, Tn, i0, t, scale, mx0, mx1, l0, l1);
    if (dropout) {
      const PhiloxKey key(static_cast<uint32_t>(*seed_ptr));
      const PhiloxRow prow = philox_row(key, b, h + head_offset, i0);
#pragma unroll
      for (int c = 0; c < kTfChunks; ++c) {
        if (c < nkt && !((dead >> c) & 1u)) {
          const uint4 r = dropout_bits4_at(prow, key, 4 * c + t);
          s[c][0] = drop(s[c][0], r.x, thresh, keep_scale);
          s[c][1] = drop(s[c][1], r.y, thresh, keep_scale);
          s[c][2] = drop(s[c][2], r.z, thresh, keep_scale);
          s[c][3] = drop(s[c][3], r.w, thresh, keep_scale);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (has_rows)
    tf_product_store<kFwdTiles>(s, vs, ld, nkt, dead, out + base, D, m0, dh,
                                Tn, g, t);
}

// The backward. One CTA of 8 warps per (b, h) item, each output row
// written once (no atomics). Phase 1, K and V whole in shared memory (with
// row b's bias): warp w on query rows 16w..: dPd = g.V^T, then (g loading
// into V's tile) S = Q.K^T (Q and g fragments from device memory, one k
// step ahead), the softmax, the keep factors, dP, the row sums and dS on
// the fragments, then dQ = dS.K. Phase 2, g and Q whole (Q loading into
// K's tile while dQ runs): warp w on key rows 16w.., dV = pd^T.g and dK =
// dS^T.Q. With STASH (where shared memory holds them: dh up to 88 at T
// 128), pd and dS go to shared memory (dS over the bias, once every warp
// is done with it), and phase 2 reads its A fragments there. Else phase
// 1 keeps the rows' max, sum and rowsum(dP * P) and the keep bits (four
// ballots a chunk), and phase 2 recomputes S^T = K.Q^T and dPd^T = V.g^T,
// P from the statistics (expf and IEEE division; its products in another
// order than phase 1's, so not bit for bit), with the keep bits read
// back, dS^T and pd^T on the fragments.
template <bool STASH>
__global__ void __launch_bounds__(kTfThreads, 1)
attention_bwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ g, float* __restrict__ dq,
                   float* __restrict__ dk, float* __restrict__ dv, int Tn,
                   int H, int dh, float scale, long long sb, long long sq,
                   int bias_copy, const int* __restrict__ seed_ptr,
                   uint32_t thresh, float keep_scale, int dropout,
                   int head_offset) {
  extern __shared__ __align__(16) float smem[];
  const size_t tile = tf_tile_floats(Tn, dh);
  float* as = smem;                  // K, then Q
  float* bs = as + tile;             // V, then g
  // STASH: pd | dS (the bias before it)
  float* pst = bs + tile;
  float* dst = pst + tf_stash_floats(Tn);
  // else: the row statistics, the keep bits, the bias
  float* row_m = bs + tile;          // [kMaxT]
  float* row_l = row_m + kMaxT;      // [kMaxT]
  float* row_rs = row_l + kMaxT;     // [kMaxT]
  uint32_t* keep_w = reinterpret_cast<uint32_t*>(row_rs + kMaxT);
  float* bsm = STASH ? dst
                     : reinterpret_cast<float*>(keep_w + kTfWarps * kTfChunks * 4);
  const int lx = tf_stash_ld(Tn);
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int D = H * dh, ld = dh + 4, rs = sq ? tf_bias_ld(Tn) : 0;
  const size_t base = (size_t)b * Tn * D + (size_t)h * dh;
  tf_load_bias(bsm, bias + b * sb, sq, Tn, bias_copy);
  tf_load_tile(bs, v + base, Tn, D, dh);
  cp_async_commit();
  tf_load_tile(as, k + base, Tn, D, dh);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int m0 = 16 * warp, i0 = m0 + gr, i1 = i0 + 8;
  const int nkt = (Tn + 7) >> 3;
  const bool has_rows = m0 < Tn;

  // ---- phase 1: query rows ----------------------------------------------
  cp_async_wait<1>();  // the bias and V
  __syncthreads();
  uint32_t dead = has_rows ? tf_dead_rows(bsm, rs, Tn, i0, nkt, t) : 0u;
  float s[kTfChunks][4], dp[kTfChunks][4];
  if (has_rows)
    tf_scores(dp, g + base, D, bs, ld, m0, dh, nkt, dead, Tn, gr, t);
  __syncthreads();  // V's tile is free
  tf_load_tile(bs, g + base, Tn, D, dh);
  cp_async_commit();
  cp_async_wait<1>();  // K
  __syncthreads();
  if (has_rows) {
    tf_scores(s, q + base, D, as, ld, m0, dh, nkt, dead, Tn, gr, t);
    float mx0, mx1, l0, l1;
    tf_softmax(s, dead, nkt, bsm, rs, Tn, i0, t, scale, mx0, mx1, l0, l1);
    // dp = dPd * keep factor (pd = p * keep factor too, with STASH);
    // rs = rowsum(dp * p)
    float rs0 = 0.f, rs1 = 0.f;
    const PhiloxKey key(dropout ? static_cast<uint32_t>(*seed_ptr) : 0u);
    const PhiloxRow prow = philox_row(key, b, h + head_offset, i0);
#pragma unroll
    for (int c = 0; c < kTfChunks; ++c) {
      if (dropout && c < nkt && !((dead >> c) & 1u)) {
        const uint4 r = dropout_bits4_at(prow, key, 4 * c + t);
        const bool k0 = r.x >= thresh, k1 = r.y >= thresh,
                   k2 = r.z >= thresh, k3 = r.w >= thresh;
        dp[c][0] *= k0 ? keep_scale : 0.f;
        dp[c][1] *= k1 ? keep_scale : 0.f;
        dp[c][2] *= k2 ? keep_scale : 0.f;
        dp[c][3] *= k3 ? keep_scale : 0.f;
        if constexpr (STASH) {
          // pd, for dV; dS below takes p itself
          const float pd[4] = {s[c][0] * (k0 ? keep_scale : 0.f),
                               s[c][1] * (k1 ? keep_scale : 0.f),
                               s[c][2] * (k2 ? keep_scale : 0.f),
                               s[c][3] * (k3 ? keep_scale : 0.f)};
          float* pp = pst + i0 * lx + 8 * c + 2 * t;
          *reinterpret_cast<float2*>(pp) =
              i0 < Tn ? make_float2(pd[0], pd[1]) : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(pp + 8 * lx) =
              i1 < Tn ? make_float2(pd[2], pd[3]) : make_float2(0.f, 0.f);
        } else {
          const uint4 w = make_uint4(__ballot_sync(0xffffffffu, k0),
                                     __ballot_sync(0xffffffffu, k1),
                                     __ballot_sync(0xffffffffu, k2),
                                     __ballot_sync(0xffffffffu, k3));
          if (lane == 0)
            reinterpret_cast<uint4*>(keep_w)[warp * kTfChunks + c] = w;
        }
      } else if (!STASH && dropout && lane == 0 && c < nkt) {
        reinterpret_cast<uint4*>(keep_w)[warp * kTfChunks + c] =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if constexpr (STASH) {
      // pd where the draws did not write it: no dropout, dead chunks (0)
      // and the chunks past T's (0)
      if (!dropout) {
        tf_stash_store(pst, lx, s, Tn, i0, t);
      } else {
        const int nc = tf_rows16(Tn) / 8;
#pragma unroll
        for (int c = 0; c < kTfChunks; ++c) {
          if (c < nc && !(c < nkt && !((dead >> c) & 1u))) {
            float* pp = pst + i0 * lx + 8 * c + 2 * t;
            *reinterpret_cast<float2*>(pp) = make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(pp + 8 * lx) = make_float2(0.f, 0.f);
          }
        }
      }
    }
    // p is 0 in dead chunks and past T
#pragma unroll
    for (int c = 0; c < kTfChunks; ++c) {
      rs0 += dp[c][0] * s[c][0] + dp[c][1] * s[c][1];
      rs1 += dp[c][2] * s[c][2] + dp[c][3] * s[c][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
    }
    if (!STASH && t == 0) {
      if (i0 < Tn) {
        row_m[i0] = mx0;
        row_l[i0] = l0;
        row_rs[i0] = rs0;
      }
      if (i1 < Tn) {
        row_m[i1] = mx1;
        row_l[i1] = l1;
        row_rs[i1] = rs1;
      }
    }
    // dS = p * (dp - rs) * scale, in dp's registers
#pragma unroll
    for (int c = 0; c < kTfChunks; ++c) {
      dp[c][0] = s[c][0] * (dp[c][0] - rs0) * scale;
      dp[c][1] = s[c][1] * (dp[c][1] - rs0) * scale;
      dp[c][2] = s[c][2] * (dp[c][2] - rs1) * scale;
      dp[c][3] = s[c][3] * (dp[c][3] - rs1) * scale;
    }
  }
  if constexpr (STASH) {
    __syncthreads();  // the bias is free: dS over it
    if (has_rows) tf_stash_store(dst, lx, dp, Tn, i0, t);
  }
  if (has_rows)
    tf_product_store<kBwdTiles>(dp, as, ld, nkt, dead, dq + base, D, m0, dh,
                                Tn, gr, t);
  __syncthreads();  // K's tile is free
  tf_load_tile(as, q + base, Tn, D, dh);
  cp_async_commit();

  // ---- phase 2: key rows ------------------------------------------------
  if constexpr (STASH) {
    cp_async_wait<0>();  // g and Q
    __syncthreads();     // and pd and dS
    if (has_rows) {
      tf_stash_product_store<kBwdTiles>(pst, lx, bs, ld, nkt, dv + base, D,
                                        m0, dh, Tn, gr, t);
      tf_stash_product_store<kBwdTiles>(dst, lx, as, ld, nkt, dk + base, D,
                                        m0, dh, Tn, gr, t);
    }
    return;
  }
  // A lane holds (key j, query i) for j = i0, i1 and i = 8c + 2t, 8c + 2t
  // + 1 of every chunk c of queries. dead: the query chunks whose elements
  // here are all masked (or past T) and whose rows below T each have a key
  // that is not (their max is above the lowest value).
  cp_async_wait<1>();
  __syncthreads();  // g, the statistics and the keep bits
  uint32_t mine = 0u;
  if (has_rows) {
#pragma unroll
    for (int c = 0; c < kTfChunks; ++c) {
      bool live = false, ok = true;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i = 8 * c + 2 * t + x;
        const bool in = i < Tn;
        const float m = in ? row_m[i] : 0.f;
        const float* br = bsm + min(i, Tn - 1) * rs;
        const float e0 = in && i0 < Tn ? br[i0] : kF32Lowest;
        const float e1 = in && i1 < Tn ? br[i1] : kF32Lowest;
        ok = ok && (!in || m > kF32Lowest);
        live = live || e0 > kF32Lowest || e1 > kF32Lowest;
      }
      mine |= (uint32_t)(!live && ok) << c;
    }
    mine &= (1u << nkt) - 1u;
  }
  dead = __reduce_and_sync(0xffffffffu, mine);
  if (has_rows)
    tf_scores(dp, v + base, D, bs, ld, m0, dh, nkt, dead, Tn, gr, t);
  cp_async_wait<0>();
  __syncthreads();
  if (!has_rows) return;
  tf_scores(s, k + base, D, as, ld, m0, dh, nkt, dead, Tn, gr, t);
  // s - m_i in place, every chunk, branch-free (queries past T: -inf)
#pragma unroll
  for (int c = 0; c < kTfChunks; ++c) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int i = 8 * c + 2 * t + x;  // query
      const bool in = i < Tn;
      const float m = in ? row_m[i] : 0.f;
      const float* br = bsm + min(i, Tn - 1) * rs;
      const float e0 = in && i0 < Tn ? br[i0] : -INFINITY;
      const float e1 = in && i1 < Tn ? br[i1] : -INFINITY;
      s[c][x] = s[c][x] * scale + e0 - m;
      s[c][2 + x] = s[c][2 + x] * scale + e1 - m;
    }
  }
  // P, dS and pd; dead chunks and those past T are 0
#pragma unroll
  for (int c = 0; c < kTfChunks; ++c) {
    if (c < nkt && !((dead >> c) & 1u)) {
      uint32_t w0 = 0u, w1 = 0u;
      if (dropout) {
        const uint32_t* kw = keep_w + ((c >> 1) * kTfChunks + 2 * warp) * 4 +
                             (c & 1) * 2 + (gr & 1);
        w0 = kw[0];
        w1 = kw[4];
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i = 8 * c + 2 * t + x;  // query
        const int bit = (2 * t + x) * 4 + (gr >> 1);
        const bool in = i < Tn;  // rows past T hold no statistics
        const float li = in ? row_l[i] : 1.f, rsi = in ? row_rs[i] : 0.f;
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int e = 2 * y + x;  // key i0 (y 0) or i1 (y 1)
          const float p = expf(s[c][e]) / li;  // 0 past T (expf(-inf))
          float kf = 1.f;
          if (dropout) kf = (((y ? w1 : w0) >> bit) & 1u) ? keep_scale : 0.f;
          dp[c][e] = p * (dp[c][e] * kf - rsi) * scale;  // dS
          s[c][e] = p * kf;                               // pd
        }
      }
    } else {
      s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
      dp[c][0] = dp[c][1] = dp[c][2] = dp[c][3] = 0.f;
    }
  }
  tf_product_store<kBwdTiles>(s, bs, ld, nkt, dead, dv + base, D, m0, dh, Tn,
                              gr, t);
  tf_product_store<kBwdTiles>(dp, as, ld, nkt, dead, dk + base, D, m0, dh,
                              Tn, gr, t);
}

// ---------------------------------------------------------------------------
// Tensor-core kernels (bf16, dh in {16, 32, 64, 128}): TMA + wgmma, persistent
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kAuxBytes = 1024;  // mbarriers
constexpr int kAlignBytes = 1024;

// Shared-memory geometry of one 128-row tile of a head (Q_h, K_h, V_h or
// g_h) as TMA writes it: boxes of at most 64 columns (128 B, the widest
// swizzle), each box a region of 128 rows; rows past T are TMA's zero fill.
template <int DH>
struct Tile {
  static constexpr int kBox = DH < 64 ? DH : 64;            // columns per box
  static constexpr int kBoxes = DH / kBox;                   // 2 at dh 128
  static constexpr int kRowBytes = kBox * 2;                 // 32, 64 or 128
  static constexpr int kLayout = hopper::swizzle_layout(kRowBytes);
  static constexpr int kRegion = kMaxT * kRowBytes;
  static constexpr int kBytes = kBoxes * kRegion;

  // K-major operand: rows row0.. (a multiple of 8), the 16 columns of step k
  __device__ static uint64_t kmajor(const unsigned char* t, int row0, int k) {
    const int c = k * 16;
    return hopper::make_desc(
        t + (c / kBox) * kRegion + row0 * kRowBytes + (c % kBox) * 2, 16,
        8 * kRowBytes, kLayout);
  }
  // MN-major operand (rows are K): the 16 rows of step k, all DH columns
  __device__ static uint64_t mnmajor(const unsigned char* t, int k) {
    return hopper::make_desc(t + k * 16 * kRowBytes, kRegion, 8 * kRowBytes,
                             kLayout);
  }
};

// dS and round(pd) of one item in the backward: 128 x 128 bf16 each, as two
// regions of 64 key columns (128 B rows, 128 B swizzle), the layout wgmma
// reads as a transposed (MN-major) A operand.
constexpr int kPRegion = kMaxT * 128;
constexpr int kPBytes = 2 * kPRegion;

__device__ __forceinline__ uint32_t* p_at(unsigned char* p, int i, int j) {
  return reinterpret_cast<uint32_t*>(
      p + (j >> 6) * kPRegion + i * 128 + ((((j & 63) >> 3) ^ (i & 7)) << 4) +
      (j & 7) * 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e]) :: "memory");
}

// The first and one-past-last work item (b-major (b, h)) of this CTA: a
// contiguous share, so the heads of one row follow each other.
__device__ __forceinline__ void my_items(int n_items, int& first, int& last) {
  first = static_cast<int>((long long)blockIdx.x * n_items / gridDim.x);
  last = static_cast<int>((long long)(blockIdx.x + 1) * n_items / gridDim.x);
}

// the lowest finite value of the bias type: a key at or below it is masked
template <typename TB>
__device__ __forceinline__ float masked_at();
template <>
__device__ __forceinline__ float masked_at<float>() { return -3.402823466e38f; }
template <>
__device__ __forceinline__ float masked_at<bf16>() {
  return __bfloat162float(__ushort_as_bfloat16(0xFF7Fu));
}

// Two neighbouring bias elements at shared-memory address a, read as one
// pair or as two
template <bool PAIRS, typename TB>
__device__ __forceinline__ float2 lds_bias2(uint32_t a) {
  if constexpr (sizeof(TB) == 4) {
    float2 v;
    if constexpr (PAIRS) {
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(v.x), "=f"(v.y) : "r"(a));
    } else {
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v.x) : "r"(a));
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v.y) : "r"(a + 4));
    }
    return v;
  } else {
    uint32_t lo, hi;
    if constexpr (PAIRS) {
      uint32_t w;
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(w) : "r"(a));
      lo = w << 16;
      hi = w & 0xFFFF0000u;
    } else {
      unsigned short x, y;
      asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(x) : "r"(a));
      asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(y) : "r"(a + 2));
      lo = (uint32_t)x << 16;
      hi = (uint32_t)y << 16;
    }
    return make_float2(__uint_as_float(lo), __uint_as_float(hi));
  }
}

// Scale + bias of this thread's two rows of a 64 x 128 score tile, in place
// in `s` (wgmma's accumulator layout: rows r0 = row of lane l/4 and r0 + 8,
// columns 8c + qc and 8c + qc + 1 of every chunk c), from the item's bias
// staged in shared memory: `bb` is row 0 (row stride `rs`), readable up to
// 128 columns past the start of any row < T, so every read is
// unconditional and all are issued before the first is used; rows past T
// are padding (bias 0: any finite bias will do) and columns past T are
// masked (-inf), both by selection. Returns the chunks whose four elements
// of this thread are all masked, or lie in rows past T where `pad_dead`
// (bit c).
template <bool PAIRS, typename TB>
__device__ __forceinline__ uint32_t add_bias_smem(float (&s)[64], const TB* bb,
                                                  int rs, int Tn, int r0,
                                                  int qc, float scale,
                                                  bool pad_dead) {
  const float low = masked_at<TB>();
  const int r1 = r0 + 8;
  const bool v0 = r0 < Tn, v1 = r1 < Tn;
  const uint32_t a0 =
      hopper::smem_u32(bb + min(r0, Tn - 1) * rs + qc);
  const uint32_t a1 =
      hopper::smem_u32(bb + min(r1, Tn - 1) * rs + qc);
  float2 x[16][2];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    x[c][0] = lds_bias2<PAIRS, TB>(a0 + 8 * c * sizeof(TB));
    x[c][1] = lds_bias2<PAIRS, TB>(a1 + 8 * c * sizeof(TB));
  }
  uint32_t masked = 0u;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int col = 8 * c + qc;
    const bool k0 = col < Tn, k1 = col + 1 < Tn;
    const float e0 = k0 ? (v0 ? x[c][0].x : 0.f) : -INFINITY;
    const float e1 = k1 ? (v0 ? x[c][0].y : 0.f) : -INFINITY;
    const float e2 = k0 ? (v1 ? x[c][1].x : 0.f) : -INFINITY;
    const float e3 = k1 ? (v1 ? x[c][1].y : 0.f) : -INFINITY;
    s[4 * c + 0] = s[4 * c + 0] * scale + e0;
    s[4 * c + 1] = s[4 * c + 1] * scale + e1;
    s[4 * c + 2] = s[4 * c + 2] * scale + e2;
    s[4 * c + 3] = s[4 * c + 3] * scale + e3;
    const bool c0 = v0 || !pad_dead, c1 = v1 || !pad_dead;
    const uint32_t live = (uint32_t)(c0 && e0 > low) | (uint32_t)(c0 && e1 > low) |
                          (uint32_t)(c1 && e2 > low) | (uint32_t)(c1 && e3 > low);
    masked |= (live ^ 1u) << c;
  }
  return masked;
}

// The same from the bias in device memory: only elements of the array are
// read.
template <typename TB>
__device__ inline void add_bias_global(float (&s)[64], const TB* bb,
                                       long long rs, int pairs, int Tn,
                                       int r0, int qc, float scale) {
  const int r1 = r0 + 8;
  const TB* b0 = bb + (long long)r0 * rs;
  const TB* b1 = bb + (long long)r1 * rs;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int col = 8 * c + qc;
    float2 c0, c1;
    if (pairs && col + 1 < Tn) {
      c0 = r0 < Tn ? load2(b0 + col) : make_float2(0.f, 0.f);
      c1 = r1 < Tn ? load2(b1 + col) : make_float2(0.f, 0.f);
    } else {
      c0.x = col < Tn ? (r0 < Tn ? to_f32(b0[col]) : 0.f) : -INFINITY;
      c0.y = col + 1 < Tn ? (r0 < Tn ? to_f32(b0[col + 1]) : 0.f) : -INFINITY;
      c1.x = col < Tn ? (r1 < Tn ? to_f32(b1[col]) : 0.f) : -INFINITY;
      c1.y = col + 1 < Tn ? (r1 < Tn ? to_f32(b1[col + 1]) : 0.f) : -INFINITY;
    }
    s[4 * c + 0] = s[4 * c + 0] * scale + c0.x;
    s[4 * c + 1] = s[4 * c + 1] * scale + c0.y;
    s[4 * c + 2] = s[4 * c + 2] * scale + c1.x;
    s[4 * c + 3] = s[4 * c + 3] * scale + c1.y;
  }
}

// The softmax of this thread's two rows of biased scores, in place: on
// return s holds the exponentials (0 at masked keys) and (i0, i1) the
// reciprocals of their row sums. With SKIP, `masked` (add_bias_smem's) and
// `low` (the bias's masked value) let the warp skip a chunk whose 16 x 8
// scores are all masked in rows that each have a key that is not (or lie
// in rows past T, see add_bias_smem): there every weight of a row < T is
// exactly 0 (exp underflows), so the skip changes no bit that is stored.
// Returns the chunks skipped (bit c), the same in every lane.
template <bool SKIP>
__device__ inline uint32_t softmax_rows(float (&s)[64], uint32_t masked,
                                        float low, float& i0, float& i1) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    m0 = fmaxf(m0, fmaxf(s[4 * c + 0], s[4 * c + 1]));
    m1 = fmaxf(m1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  const uint32_t dead =
      SKIP ? __reduce_and_sync(0xffffffffu, m0 > low && m1 > low ? masked : 0u)
           : 0u;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    if ((dead >> c) & 1u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * c + e] = 0.f;
      continue;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * c + e] = __expf(s[4 * c + e] - m0);
      s[4 * c + 2 + e] = __expf(s[4 * c + 2 + e] - m1);
      l0 += s[4 * c + e];
      l1 += s[4 * c + 2 + e];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  i0 = 1.f / l0;
  i1 = 1.f / l1;
  return dead;
}

// How the producer stages an item's bias (row b: T rows of T elements,
// strides (sb, sq, 1)): kBiasRows, its rows contiguous (sq = T): one bulk
// copy of the T x T block; kBiasRow, a broadcast view (sq = 0): one bulk
// copy of its one row; kBiasStrided, any other view: cp.async of
// `bias_copy` bytes (16, 8 or 4) a piece, or element by element (0), into
// rows of bias_ld(T) elements. A bulk copy takes the 16-byte aligned span
// that holds the block, so the block starts (src & 15) bytes into the
// stage's bias area; the bytes after the last 16-byte boundary are copied
// by the warp's lanes.
enum BiasMode { kBiasStrided = 0, kBiasRows = 1, kBiasRow = 2 };

__host__ __device__ inline int bias_ld(int T) { return (T + 7) & ~7; }

// shared memory for one row's bias, with room to read 128 columns past the
// start of any row and the up to 15 bytes a bulk copy starts early
__host__ __device__ inline size_t bias_slot_bytes(int T, int bias_bytes) {
  return (((size_t)T * bias_ld(T) + kMaxT) * bias_bytes + 16 + kAlignBytes -
          1) & ~(size_t)(kAlignBytes - 1);
}

__device__ __forceinline__ int bias_row_stride(int mode, int Tn) {
  return mode == kBiasRow ? 0 : mode == kBiasRows ? Tn : bias_ld(Tn);
}

template <typename TB>
__device__ __forceinline__ int bias_offset(const TB* src, int mode) {
  return mode == kBiasStrided ? 0
                              : static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
}

// Shared memory of the forward: `stages` x (Q | K | V tiles | the item's
// bias) | O of both warpgroups (64 rows each, the store's swizzled boxes) |
// mbarriers, plus the slack that aligns the start to 1024 B (the swizzle's
// repeat).
template <int DH>
__host__ __device__ inline size_t fwd_stage_bytes(int T, int bias_bytes) {
  return 3 * (size_t)Tile<DH>::kBytes + bias_slot_bytes(T, bias_bytes);
}

template <int DH>
__host__ __device__ inline size_t fwd_smem_bytes(int T, int bias_bytes,
                                                 int stages) {
  return stages * fwd_stage_bytes<DH>(T, bias_bytes) + Tile<DH>::kBytes +
         kAuxBytes + kAlignBytes;
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + kAlignBytes - 1) &
      ~(uintptr_t)(kAlignBytes - 1));
}

// The strided bias copy: rows of T elements into rows of bias_ld(T), with
// cp.async units of CB bytes (0: element by element)
template <typename TB, int CB>
__device__ void copy_bias_strided(TB* dst, const TB* src, long long sq,
                                  int Tn, int lane) {
  const int ld = bias_ld(Tn);
  if constexpr (CB == 0) {
    for (int x = lane; x < Tn * Tn; x += 32) {
      const int i = x / Tn, j = x - i * Tn;
      dst[i * ld + j] = src[i * sq + j];
    }
  } else {
    constexpr int U = CB / (int)sizeof(TB);
    const int per_row = Tn / U;
    for (int x = lane; x < Tn * per_row; x += 32) {
      const int i = x / per_row, j = (x - i * per_row) * U;
      hopper::cp_async<CB>(dst + i * ld + j, src + i * sq + j);
    }
  }
}

// The 16-byte aligned span [lo, hi) of a bulk bias copy from src (`block`
// bytes), and the tail after it
struct BiasSpan {
  uintptr_t s0, lo, hi;
  __device__ BiasSpan(const void* src, int block)
      : s0(reinterpret_cast<uintptr_t>(src)), lo(s0 & ~(uintptr_t)15),
        hi((s0 + block) & ~(uintptr_t)15) {}
  __device__ uint32_t bytes() const { return static_cast<uint32_t>(hi - lo); }
};

// The producer warp's copy of row b's bias (src) into `bs`: lane 0 issues
// the bulk copy, completed on `bar` (whose expected bytes the caller has
// set), the lanes copy its tail; or the strided copy, cp.async, waited for
// here. The caller arrives on `bar` after a __syncwarp.
template <typename TB>
__device__ void stage_bias(unsigned char* bs, const TB* src, int mode,
                           int bias_copy, long long sq, int Tn, int block,
                           int lane, uint64_t* bar) {
  if (mode != kBiasStrided) {
    const BiasSpan sp(src, block);
    if (lane == 0 && sp.hi > sp.lo)
      hopper::bulk_load(bs, reinterpret_cast<const void*>(sp.lo), sp.bytes(),
                        bar);
    const int n_tail = static_cast<int>((sp.s0 + block - sp.hi) / sizeof(TB));
    if (lane < n_tail)
      reinterpret_cast<TB*>(bs + (sp.hi - sp.lo))[lane] =
          reinterpret_cast<const TB*>(sp.hi)[lane];
    return;
  }
  TB* dst = reinterpret_cast<TB*>(bs);
  switch (bias_copy) {
    case 16: copy_bias_strided<TB, 16>(dst, src, sq, Tn, lane); break;
    case 8: copy_bias_strided<TB, 8>(dst, src, sq, Tn, lane); break;
    case 4: copy_bias_strided<TB, 4>(dst, src, sq, Tn, lane); break;
    default: copy_bias_strided<TB, 0>(dst, src, sq, Tn, lane); break;
  }
  hopper::cp_async_wait_all();
}

__device__ __forceinline__ int bias_block_bytes(int mode, int Tn, int es) {
  return (mode == kBiasRow ? Tn : Tn * Tn) * es;
}

template <int DH, typename TB, bool DROP>
__global__ void __launch_bounds__(kTcThreads, 1)
attention_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to,
                 const TB* __restrict__ bias, int n_items, int Tn, int H,
                 float scale, long long sb, long long sq, int bias_mode,
                 int bias_copy, int bias_pairs, int stages,
                 const int* __restrict__ seed_ptr, uint32_t thresh,
                 float keep_scale, int head_offset) {
  using G = Tile<DH>;
  constexpr int kORegion = 64 * G::kRowBytes;  // one box of a warpgroup's O
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const size_t stage_bytes = fwd_stage_bytes<DH>(Tn, sizeof(TB));
  unsigned char* obuf = smem + stages * stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(obuf + G::kBytes);
  uint64_t* empty = full + 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 2);  // expect_tx + the bias's arrival
      hopper::mbar_init(&empty[s], kConsumerThreads / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  int first, last;
  my_items(n_items, first, last);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp < 4) {
    // ---- producer: one warp issues the loads of the next items ----------
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp != 0) return;
    if (lane == 0) {
      hopper::prefetch_tensor_map(&tq);
      hopper::prefetch_tensor_map(&tk);
      hopper::prefetch_tensor_map(&tv);
    }
    const int block = bias_block_bytes(bias_mode, Tn, sizeof(TB));
    int stage = 0, held0 = -1, held1 = -1;  // the row whose bias a stage holds
    uint32_t phase = 0;
    for (int it = first; it < last; ++it) {
      const int b = it / H, h = it - b * H;
      hopper::mbar_wait(&empty[stage], phase ^ 1u);
      unsigned char* st = smem + stage * stage_bytes;
      unsigned char* bs = st + 3 * G::kBytes;
      const TB* src = bias + b * sb;
      const bool load_bias = (stage ? held1 : held0) != b;
      const bool bulk = load_bias && bias_mode != kBiasStrided;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(
            &full[stage],
            3 * G::kBytes + (bulk ? BiasSpan(src, block).bytes() : 0u));
#pragma unroll
        for (int x = 0; x < G::kBoxes; ++x) {
          const int c0 = h * DH + x * G::kBox;
          hopper::tma_load_3d(st + x * G::kRegion, &tq, &full[stage], c0, 0, b);
          hopper::tma_load_3d(st + G::kBytes + x * G::kRegion, &tk, &full[stage],
                              c0, 0, b);
          hopper::tma_load_3d(st + 2 * G::kBytes + x * G::kRegion, &tv,
                              &full[stage], c0, 0, b);
        }
      }
      if (load_bias) {
        stage_bias<TB>(bs, src, bias_mode, bias_copy, sq, Tn, block, lane,
                       &full[stage]);
        if (stage) held1 = b; else held0 = b;
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&full[stage]);
      if (++stage == stages) { stage = 0; phase ^= 1u; }
    }
  } else {
    // ---- consumers: warpgroup g owns query rows 64g..64g+63 --------------
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int g = (warp >> 2) - 1, wl = warp & 3;
    const int rl0 = 16 * wl + (lane >> 2);  // row within the tile
    const int r0 = 64 * g + rl0;
    const int qc = (lane & 3) * 2;
    const bool leader = (threadIdx.x & 127) == 0;
    const PhiloxKey key(DROP ? static_cast<uint32_t>(*seed_ptr) : 0u);
    const bool has_rows = 64 * g < Tn;
    const int rs = bias_row_stride(bias_mode, Tn);
    unsigned char* ob = obuf + g * G::kBoxes * kORegion;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = first; it < last; ++it) {
      const int b = it / H, h = it - b * H;
      hopper::mbar_wait(&full[stage], phase);
      const unsigned char* st = smem + stage * stage_bytes;
      float o[DH / 2];
      if (has_rows) {
        // S = Q_h . K_h^T for the tile's 64 rows and all 128 key slots
        float s[64];
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < DH / 16; ++k)
          hopper::wgmma_ss<0, 0>(s, G::kmajor(st, 64 * g, k),
                                 G::kmajor(st + G::kBytes, 0, k), k);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        const TB* bb = reinterpret_cast<const TB*>(
            st + 3 * G::kBytes + bias_offset(bias + b * sb, bias_mode));
        // With dropout, rows past T (never stored) do not keep a chunk's
        // draws alive. Without, they still vote: on an H100 80GB HBM3 at
        // 700 W (tools/time_attention.py) leaving them out took the
        // serving page (T = 102, p 0) from 57.3-57.5 to 62.1 us, for a
        // reason not yet understood. One rule for both instances waits on
        // that cause; re-measure before changing it.
        const uint32_t masked =
            bias_pairs
                ? add_bias_smem<true>(s, bb, rs, Tn, r0, qc, scale, DROP)
                : add_bias_smem<false>(s, bb, rs, Tn, r0, qc, scale, DROP);
        float i0, i1;
        const uint32_t dead =
            softmax_rows<true>(s, masked, masked_at<TB>(), i0, i1);
        // P (with its dropout) rounded to bf16, packed in place as the A
        // fragments of P.V: 16 keys per k-step; the lane's draws all share
        // rows r0 and r0 + 8
        const PhiloxRow prow = philox_row(key, b, h + head_offset, r0);
        uint32_t pa[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          float p[2][4];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int c = 2 * kk + hf;
            p[hf][0] = s[4 * c + 0] * i0;
            p[hf][1] = s[4 * c + 1] * i0;
            p[hf][2] = s[4 * c + 2] * i1;
            p[hf][3] = s[4 * c + 3] * i1;
            if (DROP && !((dead >> c) & 1u)) {
              const uint4 r = dropout_bits4_at(prow, key, 4 * c + (qc >> 1));
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
        // O = round(P) . V_h (V read as a transposed operand)
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          hopper::wgmma_rs<1>(o, pa[kk], G::mnmajor(st + 2 * G::kBytes, kk), kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        fence_frags(pa);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
      if (has_rows) {
        // O through shared memory (the store's swizzled boxes) and one TMA
        // store per box; rows past T fall outside the tensor and are not
        // written
        if (leader) hopper::bulk_wait_read();
        hopper::named_barrier_sync(2 + g, 128);
#pragma unroll
        for (int c = 0; c < DH / 8; ++c) {
          const int col = 8 * c + qc;
          unsigned char* region = ob + (col / G::kBox) * kORegion;
          const uint32_t at0 = rl0 * G::kRowBytes + (col % G::kBox) * 2;
          const uint32_t at1 = at0 + 8 * G::kRowBytes;
          *reinterpret_cast<uint32_t*>(region + hopper::swizzled(at0, G::kRowBytes)) =
              pack_bf16(o[4 * c + 0], o[4 * c + 1]);
          *reinterpret_cast<uint32_t*>(region + hopper::swizzled(at1, G::kRowBytes)) =
              pack_bf16(o[4 * c + 2], o[4 * c + 3]);
        }
        hopper::fence_proxy_async();
        hopper::named_barrier_sync(2 + g, 128);
        if (leader) {
#pragma unroll
          for (int x = 0; x < G::kBoxes; ++x)
            hopper::tma_store_3d(&to, ob + x * kORegion, h * DH + x * G::kBox,
                                 64 * g, b);
          hopper::bulk_commit();
        }
      }
      if (++stage == stages) { stage = 0; phase ^= 1u; }
    }
    if (leader) hopper::bulk_wait();
  }
}

// Shared memory of the backward: `stages` x (Q | K | V | g tiles) | dS |
// round(pd) | the bias of the current row b (one slot, `bias` bytes; 0 when
// it does not fit and the bias is read from device memory) | mbarriers,
// plus the alignment slack.
template <int DH>
__host__ __device__ constexpr size_t bwd_stage_bytes() {
  return 4 * (size_t)Tile<DH>::kBytes;
}

template <int DH>
__host__ __device__ inline size_t bwd_smem_bytes(int stages, size_t bias) {
  return stages * bwd_stage_bytes<DH>() + 2 * (size_t)kPBytes + bias +
         kAuxBytes + kAlignBytes;
}

// Rows `row` and row + 8 of this thread's part of a 64 x DH accumulator
// tile (the wgmma layout), rounded to bf16, into a 128-row head tile laid
// out as TMA reads and writes it (Tile<DH>: swizzled boxes)
template <int DH>
__device__ __forceinline__ void acc_to_tile(unsigned char* tile,
                                            const float (&acc)[DH / 2],
                                            int row, int qc) {
  using G = Tile<DH>;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const int col = 8 * c + qc;
    unsigned char* region = tile + (col / G::kBox) * G::kRegion;
    const uint32_t at0 = row * G::kRowBytes + (col % G::kBox) * 2;
    const uint32_t at1 = at0 + 8 * G::kRowBytes;
    *reinterpret_cast<uint32_t*>(region + hopper::swizzled(at0, G::kRowBytes)) =
        pack_bf16(acc[4 * c + 0], acc[4 * c + 1]);
    *reinterpret_cast<uint32_t*>(region + hopper::swizzled(at1, G::kRowBytes)) =
        pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
  }
}

// One TMA store of rows 64g..64g+63 of a head tile to head h of row b
template <int DH>
__device__ __forceinline__ void store_tile_rows(const CUtensorMap* map,
                                                const unsigned char* tile,
                                                int g, int h, int b) {
  using G = Tile<DH>;
#pragma unroll
  for (int x = 0; x < G::kBoxes; ++x)
    hopper::tma_store_3d(map, tile + x * G::kRegion + 64 * g * G::kRowBytes,
                         h * DH + x * G::kBox, 64 * g, b);
}

template <int DH, typename TB>
__global__ void __launch_bounds__(kTcThreads, 1)
attention_bwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tg,
                 const __grid_constant__ CUtensorMap tdq,
                 const __grid_constant__ CUtensorMap tdk,
                 const __grid_constant__ CUtensorMap tdv,
                 const TB* __restrict__ bias, int n_items,
                 int Tn, int H, float scale, long long sb, long long sq,
                 int bias_mode, int bias_copy, int bias_pairs, int bias_smem,
                 int stages, const int* __restrict__ seed_ptr,
                 uint32_t thresh, float keep_scale, int dropout,
                 int head_offset) {
  using G = Tile<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  constexpr size_t stage_bytes = bwd_stage_bytes<DH>();
  unsigned char* dss = smem + stages * stage_bytes;  // dS, rows = queries
  unsigned char* pds = dss + kPBytes;                // round(pd)
  unsigned char* bs = pds + kPBytes;                 // the bias slot
  uint64_t* full = reinterpret_cast<uint64_t*>(
      bs + (bias_smem ? bias_slot_bytes(Tn, sizeof(TB)) : 0));
  uint64_t* empty = full + 2;
  uint64_t* bias_full = empty + 2;
  uint64_t* bias_empty = bias_full + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // each warpgroup's leader
    }
    hopper::mbar_init(bias_full, 2);  // expect_tx + the copy's end
    hopper::mbar_init(bias_empty, kConsumerThreads / 32);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  int first, last;
  my_items(n_items, first, last);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp < 4) {
    // ---- producer: Q, K, V and g of the next items; the bias of each new
    // row b once its slot is free ---------------------------------------
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp != 0) return;
    if (lane == 0) {
      hopper::prefetch_tensor_map(&tq);
      hopper::prefetch_tensor_map(&tk);
      hopper::prefetch_tensor_map(&tv);
      hopper::prefetch_tensor_map(&tg);
    }
    const int block = bias_block_bytes(bias_mode, Tn, sizeof(TB));
    int stage = 0, held = -1;
    uint32_t phase = 0, gen = 0;  // gen: bias rows loaded so far
    for (int it = first; it < last; ++it) {
      const int b = it / H, h = it - b * H;
      hopper::mbar_wait(&empty[stage], phase ^ 1u);
      unsigned char* st = smem + stage * stage_bytes;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[stage], 4 * G::kBytes);
#pragma unroll
        for (int x = 0; x < G::kBoxes; ++x) {
          const int c0 = h * DH + x * G::kBox;
          const CUtensorMap* maps[4] = {&tq, &tk, &tv, &tg};
#pragma unroll
          for (int a = 0; a < 4; ++a)
            hopper::tma_load_3d(st + a * G::kBytes + x * G::kRegion, maps[a],
                                &full[stage], c0, 0, b);
        }
      }
      if (bias_smem && held != b) {
        const TB* src = bias + b * sb;
        // the consumers are done with the previous row's bias
        if (gen > 0) hopper::mbar_wait(bias_empty, (gen - 1) & 1u);
        if (lane == 0)
          hopper::mbar_arrive_expect_tx(
              bias_full,
              bias_mode != kBiasStrided ? BiasSpan(src, block).bytes() : 0u);
        stage_bias<TB>(bs, src, bias_mode, bias_copy, sq, Tn, block, lane,
                       bias_full);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(bias_full);
        held = b;
        ++gen;
      }
      if (++stage == stages) { stage = 0; phase ^= 1u; }
    }
  } else {
    // ---- consumers: warpgroup g owns query rows (phase 1), then key rows
    // (phase 2) 64g..64g+63 ------------------------------------------------
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int g = (warp >> 2) - 1, wl = warp & 3;
    const int r0 = 64 * g + 16 * wl + (lane >> 2), r1 = r0 + 8;
    const int qc = (lane & 3) * 2;
    const bool leader = (threadIdx.x & 127) == 0;
    // keys added at each use (PhiloxSeed): held in registers (PhiloxKey), or
    // with the draws' row terms hoisted, ptxas spills here
    const PhiloxSeed key(dropout ? static_cast<uint32_t>(*seed_ptr) : 0u);
    const int rs = bias_row_stride(bias_mode, Tn);
    int stage = 0, held = -1;
    uint32_t phase = 0, gen = 0;
    for (int it = first; it < last; ++it) {
      const int b = it / H, h = it - b * H;
      hopper::mbar_wait(&full[stage], phase);
      unsigned char* st = smem + stage * stage_bytes;
      unsigned char* qs = st;
      unsigned char* ks = st + G::kBytes;
      unsigned char* vs = st + 2 * G::kBytes;
      unsigned char* gs = st + 3 * G::kBytes;

      // phase 1, query rows: S = Q.K^T (P recomputed as in the forward) and
      // dPd = round(g).V^T
      float s[64], dpd[64];
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < DH / 16; ++k)
        hopper::wgmma_ss<0, 0>(s, G::kmajor(qs, 64 * g, k), G::kmajor(ks, 0, k),
                               k);
#pragma unroll
      for (int k = 0; k < DH / 16; ++k)
        hopper::wgmma_ss<0, 0>(dpd, G::kmajor(gs, 64 * g, k),
                               G::kmajor(vs, 0, k), k);
      hopper::wgmma_commit();
      if (bias_smem && held != b) {
        hopper::mbar_wait(bias_full, gen & 1u);
        held = b;
        ++gen;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dpd);
      if (bias_smem) {
        const TB* bb = reinterpret_cast<const TB*>(
            bs + bias_offset(bias + b * sb, bias_mode));
        if (bias_pairs)
          add_bias_smem<true>(s, bb, rs, Tn, r0, qc, scale, false);
        else
          add_bias_smem<false>(s, bb, rs, Tn, r0, qc, scale, false);
        // the last item of this row: the slot may take the next row's bias
        if (it + 1 == last || (it + 1) / H != b) {
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(bias_empty);
        }
      } else {
        add_bias_global<TB>(s, bias + b * sb, sq, bias_pairs, Tn, r0, qc,
                            scale);
      }
      // (the backward skips no chunk: on the card that measured slower)
      float i0, i1;
      softmax_rows<false>(s, 0u, 0.f, i0, i1);
      // every consumer is past the previous item's phase 2: dS and pd may
      // be rewritten
      hopper::named_barrier_sync(1, kConsumerThreads);
      // p and the keep factors; dp = dPd * keep; row sums of dp * p;
      // round(pd) to shared memory
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float kf[4] = {1.f, 1.f, 1.f, 1.f};
        if (dropout) {
          const uint4 r = dropout_bits4(key, b, h + head_offset, r0, 8 * c + qc);
          kf[0] = r.x >= thresh ? keep_scale : 0.f;
          kf[1] = r.y >= thresh ? keep_scale : 0.f;
          kf[2] = r.z >= thresh ? keep_scale : 0.f;
          kf[3] = r.w >= thresh ? keep_scale : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[4 * c + e] * (e < 2 ? i0 : i1);
          s[4 * c + e] = p;
          dpd[4 * c + e] *= kf[e];
          kf[e] *= p;  // pd, in place of the keep factor once used
        }
        rs0 += dpd[4 * c + 0] * s[4 * c + 0] + dpd[4 * c + 1] * s[4 * c + 1];
        rs1 += dpd[4 * c + 2] * s[4 * c + 2] + dpd[4 * c + 3] * s[4 * c + 3];
        const int col = 8 * c + qc;
        *p_at(pds, r0, col) = pack_bf16(kf[0], kf[1]);
        *p_at(pds, r1, col) = pack_bf16(kf[2], kf[3]);
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
      }
      // dS = round(p * (dp - rowsum) * scale), to shared memory and packed
      // as the A fragments of dQ = dS.K
      uint32_t da[8][4];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = 8 * c + qc;
        const uint32_t x0 = pack_bf16(s[4 * c + 0] * (dpd[4 * c + 0] - rs0) * scale,
                                      s[4 * c + 1] * (dpd[4 * c + 1] - rs0) * scale);
        const uint32_t x1 = pack_bf16(s[4 * c + 2] * (dpd[4 * c + 2] - rs1) * scale,
                                      s[4 * c + 3] * (dpd[4 * c + 3] - rs1) * scale);
        *p_at(dss, r0, col) = x0;
        *p_at(dss, r1, col) = x1;
        da[c >> 1][(c & 1) * 2 + 0] = x0;
        da[c >> 1][(c & 1) * 2 + 1] = x1;
      }
      hopper::fence_proxy_async();
      {
        float acc[DH / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          hopper::wgmma_rs<1>(acc, da[kk], G::mnmajor(ks, kk), kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        fence_frags(da);
        // dQ through the V tile: both warpgroups' dPd products are done
        acc_to_tile<DH>(vs, acc, r0, qc);
        hopper::fence_proxy_async();
      }
      // every row of dS and pd is written, and dQ staged
      hopper::named_barrier_sync(1, kConsumerThreads);
      if (leader) {
        store_tile_rows<DH>(&tdq, vs, g, h, b);
        hopper::bulk_commit();
      }
      // phase 2, key rows 64g..: dK = dS^T.Q, dV = round(pd)^T.g, the
      // transposed A operands read as MN-major tiles of dS and pd
      float ak[DH / 2], av[DH / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        hopper::wgmma_ss<1, 1>(
            ak, hopper::make_desc(dss + g * kPRegion + kk * 16 * 128, kPRegion,
                                  1024, 1),
            G::mnmajor(qs, kk), kk);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        hopper::wgmma_ss<1, 1>(
            av, hopper::make_desc(pds + g * kPRegion + kk * 16 * 128, kPRegion,
                                  1024, 1),
            G::mnmajor(gs, kk), kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(ak);
      hopper::fence_regs(av);
      // dK through the K tile (both warpgroups' dQ products are done), dV
      // through the V tile once dQ's store has read it; rows past T fall
      // outside the tensor and are not written
      acc_to_tile<DH>(ks, ak, r0, qc);
      if (leader) hopper::bulk_wait_read();
      hopper::named_barrier_sync(2 + g, 128);
      acc_to_tile<DH>(vs, av, r0, qc);
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(2 + g, 128);
      if (leader) {
        store_tile_rows<DH>(&tdk, ks, g, h, b);
        store_tile_rows<DH>(&tdv, vs, g, h, b);
        hopper::bulk_commit();
        // the stage is free once the stores have read it
        hopper::bulk_wait_read();
        hopper::mbar_arrive(&empty[stage]);
      }
      if (++stage == stages) { stage = 0; phase ^= 1u; }
    }
    if (leader) hopper::bulk_wait();
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
  int head_offset;  // added to h in the Philox counter
};

// per device, set by packed_attention_prepare
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
int g_optin[kMaxDevices];

// The tensor map of head tiles of a (B, T, D) bf16 array: boxes of
// Tile<DH>::kBox columns x `rows` rows x 1, swizzled as wgmma reads them;
// rows past T (and so past the row's end) are zero-filled on a load and
// left out on a store (hopper::tensor_map keeps the last maps).
template <int DH>
bool head_map(CUtensorMap* map, const void* x, int B, int T, int D, int rows) {
  using G = Tile<DH>;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {G::kBox, (cuuint32_t)rows, 1};
  const CUtensorMapSwizzle sw = G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : G::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return hopper::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, dims,
                            strides, box, sw,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

// two neighbouring bias elements are read as one when every row starts on
// a pair boundary
template <typename TB>
int bias_pairs(const void* bias, long long sb, long long sq) {
  return sb % 2 == 0 && sq % 2 == 0 &&
         reinterpret_cast<uintptr_t>(bias) % (2 * sizeof(TB)) == 0;
}

// the widest cp.async unit (16, 8 or 4 bytes; 0: none) that every bias row
// of T elements starts on and ends on
template <typename TB>
int bias_copy_bytes(const void* bias, int T, long long sb, long long sq) {
  for (int cb = 16; cb >= 4; cb >>= 1) {
    const long long es = sizeof(TB);
    if ((T * es) % cb == 0 && (sb * es) % cb == 0 && (sq * es) % cb == 0 &&
        reinterpret_cast<uintptr_t>(bias) % cb == 0)
      return cb;
  }
  return 0;
}

// kBiasRows / kBiasRow when the bias's layout allows a bulk copy (its
// start 16-byte aligned, so no span reaches before the array)
int bias_mode(const void* bias, int T, long long sq) {
  if (reinterpret_cast<uintptr_t>(bias) % 16) return kBiasStrided;
  if (sq == 0 || T == 1) return kBiasRow;
  return sq == T ? kBiasRows : kBiasStrided;
}

template <int DH>
int fwd_stages(int T, int bias_bytes, int optin) {
  return fwd_smem_bytes<DH>(T, bias_bytes, 2) <= (size_t)optin ? 2 : 1;
}

// The backward's ring depth and whether the bias has a slot in shared
// memory: the first of (2 stages, slot), (1, slot), (1, none) that fits.
// Two stages without the slot never come next: at dh 64 (1, slot) always
// fits, and at dh 128 two stages never do. (1, none) is taken at dh 128
// by an f32 bias once T > ~88, and reads the bias from device memory.
template <int DH>
void bwd_layout(int T, int bias_bytes, int optin, int& stages, int& bias_smem) {
  const size_t slot = bias_slot_bytes(T, bias_bytes);
  bias_smem = 1;
  for (stages = 2; stages >= 1; --stages)
    if (bwd_smem_bytes<DH>(stages, slot) <= (size_t)optin) return;
  stages = 1;
  bias_smem = 0;
}

template <int DH, typename TB>
int launch_fwd_tc(const void* q, const void* k, const void* v,
                  const void* bias, void* out, int B, int T_, int H,
                  float scale, long long sb, long long sq, Drop dr, int dev,
                  cudaStream_t st) {
  CUtensorMap mq, mk, mv, mo;
  const int D = H * DH;
  if (!head_map<DH>(&mq, q, B, T_, D, kMaxT) ||
      !head_map<DH>(&mk, k, B, T_, D, kMaxT) ||
      !head_map<DH>(&mv, v, B, T_, D, kMaxT) ||
      !head_map<DH>(&mo, out, B, T_, D, 64))
    return cudaErrorInvalidValue;
  const int stages = fwd_stages<DH>(T_, sizeof(TB), g_optin[dev]);
  const size_t smem = fwd_smem_bytes<DH>(T_, sizeof(TB), stages);
  const int n_items = B * H;
  const int grid = n_items < g_sms[dev] ? n_items : g_sms[dev];
  const int mode = bias_mode(bias, T_, sq);
  const int cb = bias_copy_bytes<TB>(bias, T_, sb, sq);
  // a strided copy starts every row on a pair; a bulk copy keeps the
  // array's alignment
  const int pairs = mode == kBiasStrided ? 1 : bias_pairs<TB>(bias, sb, sq);
  if (dr.on)
    attention_fwd_tc<DH, TB, true><<<grid, kTcThreads, smem, st>>>(
        mq, mk, mv, mo, static_cast<const TB*>(bias), n_items, T_, H, scale,
        sb, sq, mode, cb, pairs, stages, dr.seed, dr.thresh, dr.keep_scale,
        dr.head_offset);
  else
    attention_fwd_tc<DH, TB, false><<<grid, kTcThreads, smem, st>>>(
        mq, mk, mv, mo, static_cast<const TB*>(bias), n_items, T_, H, scale,
        sb, sq, mode, cb, pairs, stages, dr.seed, dr.thresh, dr.keep_scale,
        dr.head_offset);
  return cudaGetLastError();
}

template <int DH, typename TB>
int launch_bwd_tc(const void* q, const void* k, const void* v,
                  const void* bias, const void* g, void* dq, void* dk,
                  void* dv, int B, int T_, int H, float scale, long long sb,
                  long long sq, Drop dr, int dev, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mg, mdq, mdk, mdv;
  const int D = H * DH;
  if (!head_map<DH>(&mq, q, B, T_, D, kMaxT) ||
      !head_map<DH>(&mk, k, B, T_, D, kMaxT) ||
      !head_map<DH>(&mv, v, B, T_, D, kMaxT) ||
      !head_map<DH>(&mg, g, B, T_, D, kMaxT) ||
      !head_map<DH>(&mdq, dq, B, T_, D, 64) ||
      !head_map<DH>(&mdk, dk, B, T_, D, 64) ||
      !head_map<DH>(&mdv, dv, B, T_, D, 64))
    return cudaErrorInvalidValue;
  int stages, in_smem;
  bwd_layout<DH>(T_, sizeof(TB), g_optin[dev], stages, in_smem);
  const size_t smem = bwd_smem_bytes<DH>(
      stages, in_smem ? bias_slot_bytes(T_, sizeof(TB)) : 0);
  const int n_items = B * H;
  const int grid = n_items < g_sms[dev] ? n_items : g_sms[dev];
  const int mode = bias_mode(bias, T_, sq);
  const int pairs = in_smem && mode == kBiasStrided
                        ? 1 : bias_pairs<TB>(bias, sb, sq);
  attention_bwd_tc<DH, TB><<<grid, kTcThreads, smem, st>>>(
      mq, mk, mv, mg, mdq, mdk, mdv, static_cast<const TB*>(bias), n_items,
      T_, H, scale,
      sb, sq, mode, bias_copy_bytes<TB>(bias, T_, sb, sq), pairs, in_smem,
      stages, dr.seed, dr.thresh, dr.keep_scale, dr.on, dr.head_offset);
  return cudaGetLastError();
}

template <typename TB>
int dispatch_fwd_bf16(const void* q, const void* k, const void* v,
                      const void* bias, void* out, int B, int T_, int H,
                      int dh, float scale, long long sb, long long sq, Drop dr,
                      int dev, cudaStream_t st) {
  switch (dh) {
    case 16: return launch_fwd_tc<16, TB>(q, k, v, bias, out, B, T_, H, scale, sb, sq, dr, dev, st);
    case 32: return launch_fwd_tc<32, TB>(q, k, v, bias, out, B, T_, H, scale, sb, sq, dr, dev, st);
    case 64: return launch_fwd_tc<64, TB>(q, k, v, bias, out, B, T_, H, scale, sb, sq, dr, dev, st);
    case 128: return launch_fwd_tc<128, TB>(q, k, v, bias, out, B, T_, H, scale, sb, sq, dr, dev, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TB>
int dispatch_bwd_bf16(const void* q, const void* k, const void* v,
                      const void* bias, const void* g, void* dq, void* dk,
                      void* dv, int B, int T_, int H, int dh, float scale,
                      long long sb, long long sq, Drop dr, int dev,
                      cudaStream_t st) {
  switch (dh) {
    case 16: return launch_bwd_tc<16, TB>(q, k, v, bias, g, dq, dk, dv, B, T_, H, scale, sb, sq, dr, dev, st);
    case 32: return launch_bwd_tc<32, TB>(q, k, v, bias, g, dq, dk, dv, B, T_, H, scale, sb, sq, dr, dev, st);
    case 64: return launch_bwd_tc<64, TB>(q, k, v, bias, g, dq, dk, dv, B, T_, H, scale, sb, sq, dr, dev, st);
    case 128: return launch_bwd_tc<128, TB>(q, k, v, bias, g, dq, dk, dv, B, T_, H, scale, sb, sq, dr, dev, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int DH>
cudaError_t allow_optin_dh(int optin) {
  const cudaError_t errs[] = {
      allow_optin_smem(attention_fwd_tc<DH, float, false>, optin),
      allow_optin_smem(attention_fwd_tc<DH, float, true>, optin),
      allow_optin_smem(attention_fwd_tc<DH, bf16, false>, optin),
      allow_optin_smem(attention_fwd_tc<DH, bf16, true>, optin),
      allow_optin_smem(attention_bwd_tc<DH, float>, optin),
      allow_optin_smem(attention_bwd_tc<DH, bf16>, optin),
  };
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

// shared memory a CTA of dropout_mask may stage in (both copies): the
// default limit, so no opt-in, and kMaskCtasPerSm CTAs fit on an SM
constexpr int kMaskStageBytes = 48 * 1024;

// dropout_mask's launch for T: 8-byte stores straight to device memory
// when T is a multiple of 8; else byte stores, staged in shared memory
// where the two copies fit (T up to 156), straight to device memory above.
int keep_mask_launch(const int* seed, uint8_t* out, int B, int T, int H,
                     uint32_t thresh, int head_offset, int sms,
                     cudaStream_t st) {
  constexpr int kCols = 2 * kMaskDraws;
  const int n_cb = (T + kCols - 1) / kCols;               // column blocks
  const int n_gi = (T >> 4) * 8 + ((T & 15) < 8 ? (T & 15) : 8);  // rows, bit 3 clear
  const int n_items = B * H, ctas = kMaskCtasPerSm * sms;
  const int grid = n_items < ctas ? n_items : ctas;
  const int smem = 2 * mask_buffer_bytes(T);
  if (T % 8 == 0)
    dropout_mask<8, false><<<grid, kMaskThreads, 0, st>>>(
        seed, out, n_items, T, H, n_cb, n_gi, thresh, head_offset);
  else if (smem <= kMaskStageBytes)
    dropout_mask<1, true><<<grid, kMaskThreads, smem, st>>>(
        seed, out, n_items, T, H, n_cb, n_gi, thresh, head_offset);
  else
    dropout_mask<1, false><<<grid, kMaskThreads, 0, st>>>(
        seed, out, n_items, T, H, n_cb, n_gi, thresh, head_offset);
  return cudaGetLastError();
}


}  // namespace

extern "C" {

// Dynamic shared memory a block of the forward (backward = 0) or the
// backward (backward = 1) needs at least for this head width, length and
// type, whatever the bias type (0 for a bf16 head width the tensor-core
// kernels do not take).
size_t packed_attention_smem_bytes(int T, int dh, int qkv_is_bf16,
                                   int backward) {
  if (!qkv_is_bf16) {
    if (dh % 8 || dh < 8 || dh > kMaxDh) return 0;
    return backward ? tf32_bwd_smem_bytes(T, dh, false)
                    : tf32_fwd_smem_bytes(T, dh);
  }
  switch (dh) {
    case 16: return backward ? bwd_smem_bytes<16>(1, 0) : fwd_smem_bytes<16>(T, 4, 1);
    case 32: return backward ? bwd_smem_bytes<32>(1, 0) : fwd_smem_bytes<32>(T, 4, 1);
    case 64: return backward ? bwd_smem_bytes<64>(1, 0) : fwd_smem_bytes<64>(T, 4, 1);
    case 128: return backward ? bwd_smem_bytes<128>(1, 0) : fwd_smem_bytes<128>(T, 4, 1);
    default: return 0;
  }
}

// Lets every kernel of this library use the device's opt-in shared memory
// and records the device's SM count (the persistent grid). Once per
// device; returns a cudaError_t.
int packed_attention_prepare(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int optin = 0, sms = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (!hopper::encode_tiled()) return cudaErrorNotSupported;
  g_optin[device] = optin;
  g_sms[device] = sms;
  const cudaError_t errs[] = {
      allow_optin_smem(attention_fwd_tf32, optin),
      allow_optin_smem(attention_bwd_tf32<true>, optin),
      allow_optin_smem(attention_bwd_tf32<false>, optin),
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
// and an element is kept iff its bits >= thresh, then scaled by keep_scale,
// the bits those of head head_offset + h; enough shared memory (packed_attention_smem_bytes) and
// packed_attention_prepare called on `device`. Enqueued on `stream`;
// returns a cudaError_t.
int packed_attention_forward(const void* q, const void* k, const void* v,
                             const void* bias, void* out, int B, int T, int H,
                             int dh, float scale, long long sb, long long sq,
                             int qkv_is_bf16, int bias_is_bf16,
                             const void* seed, unsigned int thresh,
                             float keep_scale, int dropout, int head_offset,
                             int device, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (T > kMaxT || (!qkv_is_bf16 && bias_is_bf16) || (dropout && !seed))
    return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop dr = {static_cast<const int*>(seed), thresh, keep_scale, dropout,
                   head_offset};
  if (!qkv_is_bf16) {
    if (dh % 8 || dh < 8 || dh > kMaxDh) return cudaErrorInvalidValue;
    attention_fwd_tf32<<<B * H, kTfThreads, tf32_fwd_smem_bytes(T, dh), st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(bias),
        static_cast<float*>(out), T, H, dh, scale, sb, sq,
        bias_copy_bytes<float>(bias, T, sb, sq), dr.seed, thresh, keep_scale,
        dropout, head_offset);
    return cudaGetLastError();
  }
  if (bias_is_bf16)
    return dispatch_fwd_bf16<bf16>(q, k, v, bias, out, B, T, H, dh, scale, sb, sq, dr, device, st);
  return dispatch_fwd_bf16<float>(q, k, v, bias, out, B, T, H, dh, scale, sb, sq, dr, device, st);
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
                              float keep_scale, int dropout, int head_offset,
                              int device, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (T > kMaxT || (!qkv_is_bf16 && bias_is_bf16) || (dropout && !seed))
    return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop dr = {static_cast<const int*>(seed), thresh, keep_scale, dropout,
                   head_offset};
  if (!qkv_is_bf16) {
    if (dh % 8 || dh < 8 || dh > kMaxDh) return cudaErrorInvalidValue;
    // pd and dS kept in shared memory where they fit
    const bool stash =
        tf32_bwd_smem_bytes(T, dh, true) <= (size_t)g_optin[device];
    auto kernel = stash ? attention_bwd_tf32<true> : attention_bwd_tf32<false>;
    kernel<<<B * H, kTfThreads, tf32_bwd_smem_bytes(T, dh, stash), st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(bias),
        static_cast<const float*>(g), static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), T, H, dh, scale,
        sb, sq, bias_copy_bytes<float>(bias, T, sb, sq), dr.seed, thresh,
        keep_scale, dropout, head_offset);
    return cudaGetLastError();
  }
  if (bias_is_bf16)
    return dispatch_bwd_bf16<bf16>(q, k, v, bias, g, dq, dk, dv, B, T, H, dh, scale, sb, sq, dr, device, st);
  return dispatch_bwd_bf16<float>(q, k, v, bias, g, dq, dk, dv, B, T, H, dh, scale, sb, sq, dr, device, st);
}

// The (B, H, T, T) keep mask (one byte per element, 1 = kept) that the
// forward and the backward draw for the int32 at `seed`, `thresh` and
// `head_offset`, for any T; packed_attention_prepare called on `device`. Enqueued on
// `stream`; returns a cudaError_t.
int packed_attention_keep_mask(const void* seed, void* out, int B, int T,
                               int H, unsigned int thresh, int head_offset,
                               int device, void* stream) {
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sms[device] <= 0) return cudaErrorInitializationError;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((long long)T * T > INT_MAX) return cudaErrorInvalidValue;
  return keep_mask_launch(static_cast<const int*>(seed),
                          static_cast<uint8_t*>(out), B, T, H, thresh,
                          head_offset, g_sms[device],
                          static_cast<cudaStream_t>(stream));
}

const char* packed_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
