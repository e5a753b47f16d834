// Additive-attention pooling, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of the JAX package's
// ops/pallas_additive.py (launched by `_forward_pallas`). For each row n:
//     h[l, j] = tanh(sum_d x[n, l, d] * W1[d, j] + b1[j])
//     s[l]    = sum_j h[l, j] * w2[j]
//     a       = masked softmax of s over l: masked scores are -FLT_MAX, a
//               row max below -FLT_MAX/2 is replaced by 0 (all-masked rows
//               pool to exactly 0), the denominator adds EPS = 1e-8
//     out[n]  = sum_l a[l] * x[n, l, :]
// x is f32 or bf16, mask/W1/b1/w2 are f32, out has x's type; all sums are
// taken in f32.
//
// What bounds it: 2*N*L*(D*H + H + D) flops against N*L*D elements of x.
// At the widths NAML serves with (L = 31 or 50, D = 64, H = 256) that is
// about 250 flops per bf16 byte of x: on the tensor cores the bytes of x
// would bound it, but this kernel runs the product on the CUDA cores in
// f32, where the flops bound it (about 1 ms for the 65k-item catalog at
// 67 TFLOP/s). Moving the x.W1 product onto the tensor cores is the next
// step for speed.
//
// Design. Persistent blocks of 256 threads; block b walks rows
// n = b, b + gridDim.x, ... . W1 (D x H, f32) is staged in shared memory
// once per block and serves every row the block owns, so device memory
// sees each x row once and W1 once per block. For each row:
//   1. the x row is staged in shared memory as f32 (positions L..Lp-1 are
//      zero, Lp = L rounded up to the register tile LT);
//   2. thread t owns hidden units j = t, t + 256, ...; it keeps LT
//      accumulators in registers, so each W1 value read from shared memory
//      feeds LT FMAs while x is read as broadcast float4s;
//   3. tanh(.) * w2[j] is summed over each warp with shuffles and over the
//      eight warps through shared memory;
//   4. warp 0 runs the masked softmax with the reference's guards;
//   5. threads d < D write sum_l a[l] * x[l, d].
// The device queries and the shared-memory attribute are set once per
// width by additive_pool_prepare, not on every launch. The C entry points
// return a cudaError_t; the launch is checked with cudaGetLastError() and
// never synchronises.

#include <cfloat>
#include <cstddef>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLT = 8;  // sequence positions per register tile
constexpr float kEps = 1e-8f;

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// shared memory, in floats: W1[D*H] | x[Lp*D] | partial s[Lp*kWarps] | a[Lp]
__host__ __device__ inline size_t smem_floats(int L, int D, int H) {
  const size_t Lp = round_up(L, kLT);
  return (size_t)D * H + Lp * D + Lp * kWarps + Lp;
}

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

    // scores: s[l] = sum_j tanh(x[l] . W1[:, j] + b1[j]) * w2[j]
    for (int l0 = 0; l0 < Lp; l0 += kLT) {
      float p[kLT];
#pragma unroll
      for (int t = 0; t < kLT; ++t) p[t] = 0.f;
      for (int j = tid; j < H; j += kThreads) {
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
    __syncthreads();  // xs and as are rewritten by the next row
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

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at these widths.
size_t additive_pool_smem_bytes(int L, int D, int H) {
  return smem_floats(L, D, H) * sizeof(float);
}

// Readies the kernel for x of this type at these widths on `device`, once:
// sets *blocks to the persistent grid that additive_pool_forward takes.
// Returns a cudaError_t.
int additive_pool_prepare(int L, int D, int H, int x_is_bf16, int device,
                          int* blocks) {
  if (x_is_bf16) return prepare<__nv_bfloat16>(L, D, H, device, blocks);
  return prepare<float>(L, D, H, device, blocks);
}

// x (N, L, D) f32 or bf16 (x_is_bf16), mask (N, L) f32, w1 (D, H) f32,
// b1 (H) f32, w2 (H) f32 -> out (N, D) of x's type. All contiguous, all on
// `device`; D % 4 == 0; `blocks` from additive_pool_prepare at the same
// widths, type and device. Enqueued on `stream`; queries nothing and
// returns a cudaError_t.
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

const char* additive_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
