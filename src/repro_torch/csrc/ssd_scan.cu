// Mamba-2 SSD intra-chunk term for Hopper (sm_90a). Built with nvcc into a
// shared library with a plain C interface and loaded through ctypes
// (repro_torch/kernels/build.py).
//
// Replaces the TPU Pallas kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py   _ssd_chunk_kernel
//
// Function, per (batch b, chunk z, head h), with group g = h / (H / G):
//   cum      = cumsum(da)                                   (Q,)
//   L[i, j]  = exp(cum_i - cum_j) if i >= j, else 0         (Q, Q)
//   y        = ((C_g B_g^T) . L . dt_j) X                   (Q, P)
//   st       = (B_g . (exp(cum_{Q-1} - cum) dt))^T X        stored (P, N)
// Inputs x (B,NC,Q,H,P), dt/da (B,NC,Q,H), b/c (B,NC,Q,G,N), all fp32 and
// contiguous; outputs y (B,NC,Q,H,P), st (B,NC,H,P,N), fp32.
//
// Bound: fp32 operations. Per (b, z, h) the causal half of C B^T costs
// Q^2/2 * N multiply-adds, the causal half of W X Q^2/2 * P and the state
// Q * N * P; at Q = 256, N = 128, P = 64 that is ~67 operations per byte
// moved, far above the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20).
// Tensor cores are not used: the function is specified in fp32 (TF32
// would keep ~3 decimal digits).
//
// Design. The Pallas block holds one (chunk, head) in VMEM: a Q x Q fp32
// matrix alone is 256 KB at Q = 256, more than a Hopper block's 227 KB of
// shared memory. Here one block of 256 threads owns one (b, z, h) and a
// role, blockIdx.z:
//   - role t < ceil(Q / 64): output rows i in [64 t, 64 t + 64). The block
//     walks the column tiles j0 = 0, 64, ..., 64 t (the causal ones only).
//     Per tile it stages B_j (64 x N) and X_j (64 x P) in shared memory,
//     computes the 64 x 64 tile S = C_i B_j^T (each thread a 4 x 4
//     register tile, float4 loads from n-major staging), turns it into
//     W = select(j <= i, S * exp(cum_i - cum_j), 0) * dt_j in shared
//     memory and accumulates W X_j into a 4 x 4 register tile of y.
//     The mask is a select: exp(cum_i - cum_j) overflows to inf above the
//     diagonal at full width (cum falls to ~-1e3 over a chunk), and
//     inf * 0 would be NaN.
//   - role t = ceil(Q / 64): the chunk state. It reduces over the Q rows in
//     tiles of 64: B_j scaled by exp(cum_{Q-1} - cum_j) dt_j, times X_j,
//     each thread a 4 (p) x 8 (n) register tile, written transposed (P, N)
//     as the Pallas kernel stores it.
// Every block first scans cum = cumsum(da) over the chunk into shared
// memory (one warp: each lane sums up to 8 consecutive steps, then a
// shuffle scan of the lane sums). All blocks of a (b, z, h) recompute
// C B^T for every head of a group, as the Pallas grid does: with G = 1
// and H = 32 that term is done 32 times over. Sharing it across the heads
// of a group, and moving the products to tensor cores where the precision
// contract allows, are left for later.
//
// Limits (the Python wrapper checks them): 1 <= Q <= 256, 1 <= P <= 64,
// 1 <= N <= 128, H % G == 0. Sums run in another order than the plain
// PyTorch version; the tolerance the port holds the kernel to is stated
// in repro_torch/kernels/checks.py (SSD_TOL).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kTile = 64;       // rows of a chunk per tile (i and j)
constexpr int kMaxQ = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kLd = kTile + 4;  // row stride of 64-wide staging (16-byte aligned)
constexpr int kLdN = kMaxN + 4; // row stride of N-wide staging

// shared memory, in floats: cum and dt of the chunk, then the role's tiles
constexpr int kHead = 2 * kMaxQ;
constexpr int kYTiles = 2 * kMaxN * kLd + 2 * kTile * kLd;         // Cs, Bs, Ws, Xs
constexpr int kStTiles = kTile * kLdN + kTile * kLd + kMaxQ;        // Bw, Xs, decay
constexpr int kSmemFloats = kHead + (kYTiles > kStTiles ? kYTiles : kStTiles);
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ da, const float* __restrict__ bm,
                 const float* __restrict__ cm, float* __restrict__ y,
                 float* __restrict__ st, int Q, int H, int P, int G, int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* cum = smem;            // [kMaxQ]
  float* dts = smem + kMaxQ;    // [kMaxQ]
  float* work = smem + kHead;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int hh = blockIdx.y;
  const int gg = hh / (H / G);
  const int ntiles = (Q + kTile - 1) / kTile;

  // this (b, z)'s first token row; per-token strides H*P, H, G*N
  const size_t row0 = (size_t)blockIdx.x * Q;
  const size_t sx = (size_t)H * P;
  const size_t sb = (size_t)G * N;
  const float* xh = x + row0 * sx + (size_t)hh * P;
  const float* dth = dt + row0 * H + hh;
  const float* dah = da + row0 * H + hh;
  const float* bg = bm + row0 * sb + (size_t)gg * N;
  const float* cg = cm + row0 * sb + (size_t)gg * N;

  // cum = cumsum(da): lane l sums steps [l*per, l*per + per) in order,
  // then adds the inclusive scan of the lower lanes' sums
  for (int t = tid; t < Q; t += kThreads) dts[t] = dth[(size_t)t * H];
  if (tid < 32) {
    const int per = (Q + 31) / 32;   // <= 8
    const int t0 = tid * per;
    float loc[8];
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int t = t0 + k;
      if (k < per && t < Q) run += dah[(size_t)t * H];
      loc[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    const float up = __shfl_up_sync(0xffffffffu, incl, 1);
    const float base = tid == 0 ? 0.f : up;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int t = t0 + k;
      if (k < per && t < Q) cum[t] = base + loc[k];
    }
  }
  __syncthreads();

  if ((int)blockIdx.z < ntiles) {
    // ---- role: 64 output rows of y --------------------------------------
    const int it = blockIdx.z;
    const int i0 = it * kTile;
    float* Cs = work;                  // [kMaxN][kLd]  n-major, i contiguous
    float* Bs = Cs + kMaxN * kLd;      // [kMaxN][kLd]  n-major, j contiguous
    float* Ws = Bs + kMaxN * kLd;      // [kTile][kLd]  j-major, i contiguous
    float* Xs = Ws + kTile * kLd;      // [kTile][kLd]  j-major, p contiguous

    for (int e = tid; e < kTile * N; e += kThreads) {
      const int il = e / N, n = e % N;
      const int i = i0 + il;
      Cs[n * kLd + il] = i < Q ? cg[(size_t)i * sb + n] : 0.f;
    }

    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();  // the previous tile's Bs, Ws, Xs are consumed
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int jl = e / N, n = e % N;
        const int j = j0 + jl;
        Bs[n * kLd + jl] = j < Q ? bg[(size_t)j * sb + n] : 0.f;
      }
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int jl = e / kTile, p = e % kTile;
        const int j = j0 + jl;
        Xs[jl * kLd + p] = (j < Q && p < P) ? xh[(size_t)j * sx + p] : 0.f;
      }
      __syncthreads();

      // S = C_i B_j^T: rows i = ty*4 + r, columns j = tx*4 + c
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(&Cs[n * kLd + ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[n * kLd + tx * 4]);
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
        const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(ca[r], ba[c], s[r][c]);
      }

      // W = select(j <= i, S * exp(cum_i - cum_j), 0) * dt_j, stored j-major
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int il = ty * 4 + r;
        const int i = i0 + il;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jl = tx * 4 + c;
          const int j = j0 + jl;
          float w = 0.f;
          if (j <= i && i < Q) w = (s[r][c] * expf(cum[i] - cum[j])) * dts[j];
          Ws[jl * kLd + il] = w;
        }
      }
      __syncthreads();

      // y += W X_j: rows i = ty*4 + r, columns p = tx*4 + c
#pragma unroll 4
      for (int jl = 0; jl < kTile; ++jl) {
        const float4 wv = *reinterpret_cast<const float4*>(&Ws[jl * kLd + ty * 4]);
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[jl * kLd + tx * 4]);
        const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(wa[r], xa[c], acc[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i >= Q) continue;
      float* yrow = y + (row0 + i) * sx + (size_t)hh * P;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx * 4 + c;
        if (p < P) yrow[p] = acc[r][c];
      }
    }
    return;
  }

  // ---- role: the chunk state, st[p, n] = sum_j X[j, p] B[j, n] w_j ----------
  float* Bw = work;                    // [kTile][kLdN]  j-major, n contiguous
  float* Xs = Bw + kTile * kLdN;       // [kTile][kLd]   j-major, p contiguous
  float* decay = Xs + kTile * kLd;     // [kMaxQ]
  const float last = cum[Q - 1];
  for (int t = tid; t < Q; t += kThreads) decay[t] = expf(last - cum[t]) * dts[t];

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int jt = 0; jt < ntiles; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();  // decay is written / the previous tile is consumed
    for (int e = tid; e < kTile * kMaxN; e += kThreads) {
      const int jl = e / kMaxN, n = e % kMaxN;
      const int j = j0 + jl;
      Bw[jl * kLdN + n] = (j < Q && n < N) ? bg[(size_t)j * sb + n] * decay[j] : 0.f;
    }
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int jl = e / kTile, p = e % kTile;
      const int j = j0 + jl;
      Xs[jl * kLd + p] = (j < Q && p < P) ? xh[(size_t)j * sx + p] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jl = 0; jl < kTile; ++jl) {
      const float4 xv = *reinterpret_cast<const float4*>(&Xs[jl * kLd + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bw[jl * kLdN + tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bw[jl * kLdN + tx * 8 + 4]);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ba[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(xa[r], ba[c], acc[r][c]);
    }
  }

  float* sth = st + ((size_t)blockIdx.x * H + hh) * P * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = ty * 4 + r;
    if (p >= P) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = tx * 8 + c;
      if (n < N) sth[(size_t)p * N + n] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" {

// x, y: (bnc, q, h, p); dt, da: (bnc, q, h); b, c: (bnc, q, g, n);
// st: (bnc, h, p, n); all fp32, contiguous; bnc = batch * chunks.
// Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for shapes outside the kernel's limits.
int repro_ssd_chunk(const void* x, const void* dt, const void* da,
                    const void* b, const void* c, void* y, void* st,
                    long long bnc, int q, int h, int p, int g, int n,
                    void* stream) {
  if (bnc < 1 || bnc > 0x7fffffffLL || q < 1 || q > kMaxQ || p < 1 ||
      p > kMaxP || n < 1 || n > kMaxN || g < 1 || h < 1 || h > 65535 ||
      h % g != 0)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int ntiles = (q + kTile - 1) / kTile;
  const dim3 grid((unsigned)bnc, (unsigned)h, (unsigned)(ntiles + 1));
  ssd_chunk_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(da), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y),
      static_cast<float*>(st), q, h, p, g, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
