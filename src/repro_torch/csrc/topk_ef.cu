// Fused error feedback + block top-k, and plain block top-k, for Hopper
// (sm_90a). Built with nvcc into a shared library with a plain C interface
// and loaded through ctypes (repro_torch/kernels/build.py).
//
// Replaces the TPU Pallas kernels
//   src/repro/kernels/topk_ef/topk_ef.py     _topk_ef_kernel   (EF = true)
//   src/repro/kernels/block_topk/block_topk.py _topk_tile_kernel (EF = false)
//
// Function, per row r of a (rows, bc) view:
//   g        = lr * grad + err            (two roundings, no FMA: the
//                                          Pallas source rounds twice)
//   repeat kb times: take the largest |g| among the entries not yet taken,
//   the LOWEST column among equal magnitudes, write the signed g and its
//   column, mark it taken
//   new_err  = taken ? 0 : g
// The plain block top-k is the same selection on x, with no EF.
//
// Bound: bytes. The work per element is a few compares per round, and
// kb <= 3 on the main path, so the kernel moves 12 bytes per element
// (read grad and err, write new_err) plus 8 bytes per selection. At
// cnn_cifar with 10 workers one training step hands it 27.8 M elements:
// about 336 MB, 0.10 ms at 3.35 TB/s.
//
// Design against that bound: one warp per row, the row held in registers
// (VPL = values per lane, element j in lane j % 32, slot j / 32, so every
// load and store of a slot is coalesced across the warp). grad and err
// are read once and new_err written once; the kb selection rounds run on
// registers only: each lane scans its slots, then a butterfly of
// warp shuffles reduces (|g|, column) pairs: larger |g| wins, the lower
// column on equal |g|. The lane that owns the winner writes the value and
// column and marks its slot taken in a bit mask. Rows up to 2048 columns
// fit (VPL <= 64, one 64-bit mask). Small blocks (bc = 10) leave most
// lanes idle and small leaves are launch-bound; packing several rows per
// warp and fusing the leaves into one launch are left for later.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;

// The selection shared by both kernels. g holds the lane's slots of one
// row; writes the kb (value, column) pairs of the row at vals/idx and
// returns the lane's taken-slot mask.
template <int VPL>
__device__ __forceinline__ unsigned long long select_topk(
    const float (&g)[VPL], int lane, int bc, int kb,
    float* __restrict__ vals, int32_t* __restrict__ idx) {
  unsigned long long taken = 0ull;
  // A NaN makes the row's max NaN in the reference (jnp.max / amax
  // propagate it), so no entry equals the max: every round yields value 0
  // at column bc and nothing is taken. Reproduce that exactly.
  bool lane_nan = false;
#pragma unroll
  for (int s = 0; s < VPL; ++s) lane_nan |= isnan(g[s]);
  if (__any_sync(0xffffffffu, lane_nan)) {
    for (int k = lane; k < kb; k += kWarp) {
      vals[k] = 0.0f;
      idx[k] = bc;
    }
    return taken;
  }
  for (int k = 0; k < kb; ++k) {
    // lane-local best: slots in ascending column order, so the first of
    // equal magnitudes (the lowest column) is kept
    float best = -CUDART_INF_F;
    int best_c = 0x7fffffff;
#pragma unroll
    for (int s = 0; s < VPL; ++s) {
      const int c = s * kWarp + lane;
      if (c < bc) {
        const float m = ((taken >> s) & 1ull) ? -CUDART_INF_F : fabsf(g[s]);
        if (m > best || (m == best && c < best_c)) {
          best = m;
          best_c = c;
        }
      }
    }
    // warp butterfly: every lane ends with the same (best, best_c)
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oc = __shfl_xor_sync(0xffffffffu, best_c, off);
      if (ob > best || (ob == best && oc < best_c)) {
        best = ob;
        best_c = oc;
      }
    }
    // kb <= bc leaves an untaken column with |g| >= 0 every round, so
    // best_c < bc here; the owner lane writes the pair and marks the slot
    if (best_c % kWarp == lane) {
      const int slot = best_c / kWarp;
      float v = 0.0f;
#pragma unroll
      for (int s = 0; s < VPL; ++s) {
        if (s == slot) v = g[s];
      }
      taken |= 1ull << slot;
      vals[k] = v;
      idx[k] = best_c;
    }
  }
  return taken;
}

template <int VPL, bool EF>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
topk_rows_kernel(const float* __restrict__ x,      // grad (EF) or x
                 const float* __restrict__ err,    // EF only
                 float lr,
                 float* __restrict__ new_err,      // EF only
                 float* __restrict__ vals,
                 int32_t* __restrict__ idx,
                 long long rows, int bc, int kb) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // whole warp exits together

  const size_t base = (size_t)row * (size_t)bc;
  float g[VPL];
#pragma unroll
  for (int s = 0; s < VPL; ++s) {
    const int c = s * kWarp + lane;
    if (c < bc) {
      if (EF) {
        g[s] = __fadd_rn(__fmul_rn(lr, x[base + c]), err[base + c]);
      } else {
        g[s] = x[base + c];
      }
    } else {
      g[s] = 0.0f;
    }
  }

  const size_t obase = (size_t)row * (size_t)kb;
  const unsigned long long taken =
      select_topk<VPL>(g, lane, bc, kb, vals + obase, idx + obase);

  if (EF) {
#pragma unroll
    for (int s = 0; s < VPL; ++s) {
      const int c = s * kWarp + lane;
      if (c < bc) new_err[base + c] = ((taken >> s) & 1ull) ? 0.0f : g[s];
    }
  }
}

template <bool EF>
cudaError_t launch(const float* x, const float* err, float lr, float* new_err,
                   float* vals, int32_t* idx, long long rows, int bc, int kb,
                   cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 grid((unsigned)blocks), block(kWarp * kWarpsPerBlock);
  const int vpl = (bc + kWarp - 1) / kWarp;
#define REPRO_TOPK_CASE(N)                                                   \
  if (vpl <= N) {                                                            \
    topk_rows_kernel<N, EF><<<grid, block, 0, stream>>>(                     \
        x, err, lr, new_err, vals, idx, rows, bc, kb);                       \
    return cudaGetLastError();                                               \
  }
  REPRO_TOPK_CASE(1)
  REPRO_TOPK_CASE(2)
  REPRO_TOPK_CASE(4)
  REPRO_TOPK_CASE(8)
  REPRO_TOPK_CASE(16)
  REPRO_TOPK_CASE(32)
  REPRO_TOPK_CASE(64)
#undef REPRO_TOPK_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// grad, err, new_err: (rows, bc) fp32; vals (rows, kb) fp32; idx (rows, kb)
// int32. 1 <= kb <= bc <= 2048 (checked by the Python wrapper). Returns
// cudaGetLastError() after the launch.
int repro_topk_ef(const void* grad, const void* err, float lr, void* new_err,
                  void* vals, void* idx, long long rows, int bc, int kb,
                  void* stream) {
  return (int)launch<true>(
      static_cast<const float*>(grad), static_cast<const float*>(err), lr,
      static_cast<float*>(new_err), static_cast<float*>(vals),
      static_cast<int32_t*>(idx), rows, bc, kb,
      static_cast<cudaStream_t>(stream));
}

// x: (rows, bc) fp32; vals (rows, kb) fp32; idx (rows, kb) int32.
int repro_block_topk(const void* x, void* vals, void* idx, long long rows,
                     int bc, int kb, void* stream) {
  return (int)launch<false>(
      static_cast<const float*>(x), nullptr, 1.0f, nullptr,
      static_cast<float*>(vals), static_cast<int32_t*>(idx), rows, bc, kb,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
