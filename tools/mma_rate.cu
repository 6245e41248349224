// The rate of mma.sync.m16n8k8 TF32 (fp32 accumulate) on the card, the
// instruction the SSD kernels' 3xTF32 products are built from: each warp
// issues kChains independent MMAs per step on register operands (no memory
// traffic), so that the count per second is the tensor cores' issue rate
// for this instruction. With `split`, each step also splits fresh operands
// into TF32 big and small parts and runs the three 3xTF32 passes, as the
// kernels do. Built and timed by tools/mma_rate.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void split(float a, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(a) & 0xffffe000u;
  small = __float_as_uint(a - __uint_as_float(big));
}

template <bool kSplit>
__global__ void mma_rate_kernel(float* out, int steps, float seed) {
  float acc[kChains][4] = {};
  float v = seed + threadIdx.x * 1e-3f;
  uint32_t a[4], as[4], b0, b1, bs0, bs1;
  split(v, a[0], as[0]);
  split(v + 1.f, a[1], as[1]);
  split(v + 2.f, a[2], as[2]);
  split(v + 3.f, a[3], as[3]);
  split(v + 4.f, b0, bs0);
  split(v + 5.f, b1, bs1);
  for (int s = 0; s < steps; ++s) {
    if (kSplit) {   // fresh operands each step, split, three passes per chain
      v += 1.f;
      split(v, a[0], as[0]);
      split(v * 1.5f, a[1], as[1]);
      split(v * 0.5f, a[2], as[2]);
      split(v + 2.f, a[3], as[3]);
      split(v - 1.f, b0, bs0);
      split(v * 3.f, b1, bs1);
#pragma unroll
      for (int c = 0; c < kChains; ++c) mma_tf32(acc[c], as, b0, b1);
#pragma unroll
      for (int c = 0; c < kChains; ++c) mma_tf32(acc[c], a, bs0, bs1);
#pragma unroll
      for (int c = 0; c < kChains; ++c) mma_tf32(acc[c], a, b0, b1);
    } else {
#pragma unroll
      for (int c = 0; c < kChains; ++c) mma_tf32(acc[c], a, b0, b1);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// Launches `blocks` blocks of `threads` threads, each warp issuing `steps`
// steps of kChains MMAs (three times that with split); returns the CUDA
// error, 0 on success. MMAs per launch: blocks * threads / 32 * steps *
// kChains * (split ? 3 : 1).
int repro_mma_rate(void* out, int blocks, int threads, int steps, int split_operands,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split_operands)
    mma_rate_kernel<true><<<blocks, threads, 0, s>>>(static_cast<float*>(out), steps, 1.f);
  else
    mma_rate_kernel<false><<<blocks, threads, 0, s>>>(static_cast<float*>(out), steps, 1.f);
  return (int)cudaGetLastError();
}

int repro_mma_chains() { return kChains; }

}  // extern "C"
