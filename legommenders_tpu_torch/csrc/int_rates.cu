// Issue rates of the integer instructions a Philox4x32-10 draw is made of,
// on this card: a measurement, not a kernel of the port. Each kernel runs
// one instruction (or one mix) over eight independent chains a thread, in
// one CTA of 1,024 threads on every SM (its shared memory keeps a second
// CTA off the SM), so that neither latency nor occupancy hides the rate:
//   op 0  mul.wide.u32 (IMAD.WIDE.U32: the Philox round's two products)
//   op 1  mul.hi.u32   (IMAD.HI.U32)
//   op 2  mad.lo.u32   (IMAD)
//   op 3  lop3.b32     (LOP3.LUT: the round's two three-input XORs)
//   op 4  lop3.b32 and setp.and.u32 (LOP3 + ISETP: the keep compares)
//   op 5  mul.wide.u32 and lop3.b32, one each (a Philox round's mix)
//   op 6  mad.lo.u32 and lop3.b32, one each: do the FMA pipe and the
//         integer ALU issue side by side?
//   op 7  mul.wide.u32 and two lop3.b32 (the mask kernel's mix)
// Operands are other chains' values (read before they are rewritten, or
// in place), so no step can be folded or hoisted. Thread 0 of each CTA
// records its span in SM clocks (clock64) and in nanoseconds
// (%globaltimer). tools/int_rates.py counts each loop's instructions in
// the SASS and turns spans and counts into instructions per clock per SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kCtasPerSm = 1;
constexpr int kPadBytes = 120 * 1024;  // dynamic shared memory: one CTA per SM
constexpr int kChains = 8;
constexpr int kSteps = 16;  // steps per loop iteration, unrolled

__device__ __forceinline__ uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

template <int OP>
__device__ __forceinline__ uint32_t step32(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  if constexpr (OP == 2)
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  else
    asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// 1 if every (x[i] < x[i + 2]) holds: eight ISETPs chained by their
// predicate input
__device__ __forceinline__ uint32_t all_below(const uint32_t (&x)[kChains]) {
  uint32_t r;
  asm("{\n\t.reg .pred p;\n\t"
      "setp.lt.u32 p, %1, %3;\n\t"
      "setp.lt.and.u32 p, %2, %4, p;\n\t"
      "setp.lt.and.u32 p, %3, %5, p;\n\t"
      "setp.lt.and.u32 p, %4, %6, p;\n\t"
      "setp.lt.and.u32 p, %5, %7, p;\n\t"
      "setp.lt.and.u32 p, %6, %8, p;\n\t"
      "setp.lt.and.u32 p, %7, %1, p;\n\t"
      "setp.lt.and.u32 p, %8, %2, p;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(r)
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),
        "r"(x[6]), "r"(x[7]));
  return r;
}

template <int OP>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
int_rate(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
         int iters, long long* __restrict__ cycles) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  uint32_t v[kChains];
  unsigned long long a[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    v[i] = in[(t * kChains + i) & 1023];
    a[i] = v[i] | static_cast<unsigned long long>(~v[i]) << 32;
  }
  __syncthreads();
  const long long t0 = clock64();
  unsigned long long g0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if constexpr (OP == 0) {
        // no addend: a 64-bit one costs a separate add
#pragma unroll
        for (int i = 0; i < kChains; ++i)
          asm("mul.wide.u32 %0, %1, %2;"
              : "=l"(a[i])
              : "r"(static_cast<uint32_t>(a[i])),
                "r"(static_cast<uint32_t>(a[(i + 1) % kChains] >> 32)));
      } else if constexpr (OP == 1) {
#pragma unroll
        for (int i = 0; i < kChains; ++i)
          asm("mul.hi.u32 %0, %0, %1;" : "+r"(v[i]) : "r"(v[(i + 1) % kChains]));
      } else if constexpr (OP == 5) {
#pragma unroll
        for (int i = 0; i < kChains; ++i) {
          unsigned long long p;
          asm("mul.wide.u32 %0, %1, %2;" : "=l"(p) : "r"(v[i]), "r"(0xD2511F53u));
          v[i] = static_cast<uint32_t>(p >> 32) ^ static_cast<uint32_t>(p) ^
                 v[(i + 1) % kChains];
        }
      } else if constexpr (OP == 6 || OP == 7) {
        uint32_t w[kChains];
#pragma unroll
        for (int i = 0; i < kChains; ++i) {
          if constexpr (OP == 6) {
            w[i] = xor3(step32<2>(v[i], v[(i + 1) % kChains], v[(i + 3) % kChains]),
                        v[(i + 2) % kChains], v[(i + 5) % kChains]);
          } else {
            unsigned long long p;
            asm("mul.wide.u32 %0, %1, %2;" : "=l"(p) : "r"(v[i]), "r"(0xD2511F53u));
            w[i] = xor3(xor3(static_cast<uint32_t>(p >> 32), v[(i + 1) % kChains],
                             v[(i + 3) % kChains]),
                        static_cast<uint32_t>(p), v[(i + 5) % kChains]);
          }
        }
#pragma unroll
        for (int i = 0; i < kChains; ++i) v[i] = w[i];
      } else {
        uint32_t w[kChains];
#pragma unroll
        for (int i = 0; i < kChains; ++i)
          w[i] = step32<OP>(v[i], v[(i + 1) % kChains], v[(i + 3) % kChains]);
        if constexpr (OP == 4) w[0] ^= all_below(w);
#pragma unroll
        for (int i = 0; i < kChains; ++i) v[i] = w[i];
      }
    }
  }
  const long long t1 = clock64();
  unsigned long long g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < kChains; ++i)
    acc ^= v[i] ^ static_cast<uint32_t>(a[i]) ^ static_cast<uint32_t>(a[i] >> 32);
  out[t] = acc;
  if (threadIdx.x == 0) {
    cycles[2 * blockIdx.x] = t1 - t0;
    cycles[2 * blockIdx.x + 1] = static_cast<long long>(g1 - g0);
  }
}

template <int OP>
int launch(int blocks, int iters, const uint32_t* in, uint32_t* out,
           long long* cycles, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      int_rate<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kPadBytes);
  if (err != cudaSuccess) return err;
  int_rate<OP><<<blocks, kThreads, kPadBytes, st>>>(in, out, iters, cycles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int int_rates_threads() { return kThreads; }
int int_rates_ctas_per_sm() { return kCtasPerSm; }
int int_rates_ops() { return 8; }

// Runs op `op` over `blocks` CTAs: `in` 1,024 uint32 on the device, `out`
// blocks * int_rates_threads() uint32, `cycles` 2 * blocks int64 (each
// CTA's span in clocks, then in ns). Enqueued on `stream`; returns a
// cudaError_t.
int int_rates_run(int op, int blocks, int iters, const void* in, void* out,
                  void* cycles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* i = static_cast<const uint32_t*>(in);
  uint32_t* o = static_cast<uint32_t*>(out);
  long long* c = static_cast<long long*>(cycles);
  switch (op) {
    case 0: return launch<0>(blocks, iters, i, o, c, st);
    case 1: return launch<1>(blocks, iters, i, o, c, st);
    case 2: return launch<2>(blocks, iters, i, o, c, st);
    case 3: return launch<3>(blocks, iters, i, o, c, st);
    case 4: return launch<4>(blocks, iters, i, o, c, st);
    case 5: return launch<5>(blocks, iters, i, o, c, st);
    case 6: return launch<6>(blocks, iters, i, o, c, st);
    case 7: return launch<7>(blocks, iters, i, o, c, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* int_rates_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
