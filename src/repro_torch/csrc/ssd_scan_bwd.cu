// Backward of the Mamba-2 SSD intra-chunk term for Hopper (sm_90a). Built
// with nvcc into a shared library with a plain C interface and loaded
// through ctypes (repro_torch/kernels/build.py).
//
// Replaces no Pallas kernel: the JAX package differentiates its jnp oracle
// (src/repro/models/ssd.py ssd_chunked) under jax.grad. This is the
// backward of the port's forward kernel (csrc/ssd_scan.cu), so that the
// training path runs the chunk term through kernels both ways.
//
// Function: the vector-Jacobian product of the forward's function, per
// (batch b, chunk z, head h), group g = h / (H / G). With
//   cum_i = sum_{m <= i} da_m,  L_ij = exp(cum_i - cum_j) (i >= j, else 0),
//   CB = C_g B_g^T,  W_ij = CB_ij L_ij dt_j,  E_j = exp(cum_{Q-1} - cum_j),
//   decay_j = E_j dt_j,  and the cotangents gy (Q x P), gst (P x N):
//   gW    = gy X^T on the causal half
//   dX    = W^T gy + decay . (B_g gst^T)
//   dCB   = sum over the heads of g of gW . L . dt_j
//   dC_g  = dCB B_g,  dB_g = dCB^T C_g + sum over the heads of decay . (X gst)
//   ddt_j = sum_i gW_ij CB_ij L_ij + E_j r_j,   r_j = X_j^T gst B_j
//   dcum_i = sum_{j < i} S_ij - sum_{k > i} S_ki - R_i (+ sum_j R_j at i = Q-1),
//            S = gW . W,  R_j = decay_j r_j
//   dda   = the reverse cumulative sum of dcum.
// Inputs x, gy (B,NC,Q,H,P), dt/da (B,NC,Q,H), b/c (B,NC,Q,G,N), gst
// (B,NC,H,P,N), fp32 and contiguous; outputs dx (B,NC,Q,H,P), ddt/dda
// (B,NC,Q,H), db/dc (B,NC,Q,G,N), fp32. The plain PyTorch version is
// repro_torch/kernels/ssd_scan/ref.py ssd_chunk_bwd_ref.
//
// Design. Four kernels in order on the caller's stream, one call. The
// chunk is cut into 64-row tiles; a (row tile i, column tile j) pair with
// i >= j is a causal tile pair. A block has two warpgroups of four warps;
// warp (wg, wl) owns the rows of 16 wl and, in a 64 x 64 tile pair, the
// columns of 32 wg.
//   1. prep, two roles. State: one block per (b*z, group, head slice,
//      column tile j) takes the slice's heads in turn (X_j and gst of the
//      next head load through cp.async while the current one multiplies):
//      u = B_j gst^T; dX_j's state term decay . u into dx (staged in
//      shared memory and stored as whole rows) and r_j = X_j . u into
//      scratch; dB's state term decay . (X_j gst), summed over the slice's
//      heads in registers, into scratch. C B^T: one block per (b*z, group,
//      causal tile pair) writes C_i B_j^T to scratch in the walk's fragment
//      order, so that a warp reads its values as whole lines.
//   2. walk: one block per (b*z, group, head slice, column tile j), the
//      long walks (j = 0) first. For each head of the slice and each row
//      tile i >= j, gy_i arrives through a cp.async ring of three tiles
//      (X_j with the head's first tile): gW^T = X_j gy_i^T in registers;
//      then elementwise L, W, S, the row and column sums, and dCB += gW .
//      L . dt_j into the slice's dCB strip in shared memory (the slice's
//      heads summed in head order, no scratch per head); the W values,
//      still in registers, are the A operand of dX_j += W^T gy_i (the
//      accumulator's columns are the product's k, permuted). The head's
//      state term of dX_j and its r_j load at its first tile; at its last,
//      the warpgroups' halves of dX_j are summed in a staging tile and
//      written as whole rows, and ddt_j and dcum's column part complete.
//      The strip goes to scratch once per block.
//   3. reduce: dCB and dB's state term summed over the head slices in
//      slice order, one thread a float4 of dCB or an element of the term.
//   4. group, two roles. dC and dB: one block per (b*z, group, 64-row
//      tile, role, 32 columns n), dC = dCB B or dB = dCB^T C plus the
//      state term. dda: a warp per (b*z, head) sums the row partials of
//      dcum over the column tiles, and scans in reverse (a blocked warp
//      scan).
// The wrapper picks the head slice so that the walk's grid gives every SM
// two blocks (repro_torch/kernels/ssd_scan/ssd_scan_bwd.py, head_slice).
// No atomics: every sum runs in one fixed order, so repeat launches are
// bitwise equal (the training path runs with deterministic algorithms).
//
// Route: every product runs on the tensor cores in 3xTF32 (mma.sync
// m16n8k8, the forward's split); the exponentials, the causal select, the
// dt / decay scalings and the sums of S, dCB, ddt and dcum run in fp32 on
// the CUDA cores. The select acts on the exponent (exp(-inf) = 0):
// exp(cum_i - cum_j) overflows above the diagonal at full width. S's
// diagonal is left out of dcum, where its two terms cancel.
//
// Bound. Per (b, z), with T = Q (Q + 1) / 2 causal pairs: C B^T, dC and dB
// G T N multiply-adds each, gW and W^T gy H T P each, the two state
// products H Q N P each; at the training shape (Q = 256, P = 64, N = 128,
// H = 32, G = 1, B = 4, NC = 2) 2.25 G multiply-adds a launch, three TF32
// passes each at 494.7 TFLOP/s: 0.027 ms, above the bytes (0.019 ms at
// 3.35 TB/s); chip_smoke.py phase 14 prints both and the fp32 CUDA-core
// bound. The kernel runs at ~0.13 of that bound (PERF.md): the products
// themselves issue near mma.sync's measured TF32 rate (tools/mma_rate.py,
// ~0.6 of the 494.7 peak), the rest is the walk's per-tile staging and
// elementwise work and prep's exposed first loads. Left for later: wgmma;
// the diagonal tiles' upper halves (1.25x of the walk's products); prep's
// start; the dx round trip between prep and walk.
//
// Precision: 3xTF32 as the forward (csrc/ssd_scan.cu): each operand split
// into a TF32 big part and its remainder, three TF32 products summed in
// fp32; the dropped terms are ~2^-19 of a product (fp32's are 2^-24), so
// against a float64 evaluation the kernel's gap is a few times the fp32
// plain version's own (PERF.md has both). Sums run in another order than the
// plain version; the tolerance the port holds the kernel to is stated in
// repro_torch/kernels/checks.py (SSD_BWD_TOL).
//
// Limits (the Python wrapper checks them): 1 <= Q <= 256, 1 <= P <= 64,
// 1 <= N <= 128, H % G == 0, 1 <= heads per block <= min(kMaxHeads, H/G).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // two warpgroups
constexpr int kTile = 64;         // rows / columns of a chunk tile
constexpr int kMaxQ = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxTiles = kMaxQ / kTile;
constexpr int kMaxHeads = 8;      // heads of one block's slice (one warp scans each)
constexpr int kStages = 3;        // gy tiles in flight in the walk
constexpr int kNq = 32;           // columns n of a dC / dB block
// Row strides in floats, chosen so that the MMA fragment loads hit 32
// distinct banks: a row-major A or an n-contiguous B read at (g, t) wants a
// stride of 4 mod 32, a k-major operand read at (t, g) 8 mod 32, and a
// pair of consecutive k (2t, 2t + 1) read as one float2 8 mod 32.
constexpr int kLdA = kMaxP + 4;   // X_j, gy_i (rows j / i, columns p)
constexpr int kLdN = kMaxN + 8;   // B_j, C_i, gst (k pairs along n; gst k-major)
constexpr int kLdT = kTile + 8;   // the dCB strip (float2 at (g, 2t)); dCB k-major
constexpr int kLdR = kTile + 4;   // dCB row-major
constexpr int kLdO = kNq + 8;     // B_j / C_i columns of a dC / dB block (k-major)

constexpr int kHeadF = 2 * kMaxHeads * kMaxQ;   // cum and dt of the slice's heads
constexpr int kXTileF = kTile * kLdA;
constexpr int kNTileF = kTile * kLdN;
constexpr int kOutF = kTile * kLdT;   // a 64 x 64 output tile staged for coalesced stores
constexpr int kPrepF = kHeadF + kNTileF + 2 * (kXTileF + kNTileF) + 2 * 2 * kTile + kOutF;
constexpr int kWalkF = kHeadF + 2 * kStages * kXTileF + kMaxTiles * kTile * kLdT +
                       2 * 4 * kTile + 2 * 2 * kTile + kOutF;
constexpr int kGroupF = kTile * kLdT + kTile * kLdO;

// ---- cp.async (as csrc/ssd_scan.cu) --------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copies `bytes` (16 or 0) and zero-fills the rest of the 16
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage rows [r0, r0 + rows) of a row-major matrix in global memory (row
// stride ld_g floats, `valid` floats a row, `nrows` rows) into shared rows
// of `width` floats (stride ld_s); rows >= nrows and columns >= valid are
// zero-filled. width % 4 == 0; `vec`: 16-byte copies (valid % 4 == 0 and
// 16-byte aligned rows), else 4-byte ones.
__device__ __forceinline__ void stage_rows(float* dst, int ld_s, const float* src,
                                           size_t ld_g, int r0, int rows, int nrows,
                                           int valid, int width, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int cpr = width / 4;
    for (int e = tid; e < rows * cpr; e += kThreads) {
      const int r = e / cpr, c = (e % cpr) * 4;
      const int gr = r0 + r;
      const bool ok = gr < nrows && c < valid;
      cp_async16(dst + r * ld_s + c, ok ? src + (size_t)gr * ld_g + c : src, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * width; e += kThreads) {
      const int r = e / width, c = e % width;
      const int gr = r0 + r;
      const bool ok = gr < nrows && c < valid;
      cp_async4(dst + r * ld_s + c, ok ? src + (size_t)gr * ld_g + c : src, ok ? 4 : 0);
    }
  }
}

// rows [r0, r0 + kTile) of a row-major matrix (row stride ld_g floats,
// `valid` <= kMaxP floats a row, `nrows` rows) into kTile shared rows of
// kMaxP floats (stride kLdA), zero-filled as stage_rows; the walk's X_j and
// gy_i tiles, with the index arithmetic on constants
__device__ __forceinline__ void stage_tile(float* dst, const float* src, size_t ld_g, int r0,
                                           int nrows, int valid, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int k = 0; k < kTile * kMaxP / 4 / kThreads; ++k) {
      const int e = tid + k * kThreads;
      const int r = e / (kMaxP / 4), c = (e % (kMaxP / 4)) * 4;
      const bool ok = r0 + r < nrows && c < valid;
      cp_async16(dst + r * kLdA + c, ok ? src + (size_t)(r0 + r) * ld_g + c : src, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kTile * kMaxP; e += kThreads) {
      const int r = e / kMaxP, c = e % kMaxP;
      const bool ok = r0 + r < nrows && c < valid;
      cp_async4(dst + r * kLdA + c, ok ? src + (size_t)(r0 + r) * ld_g + c : src, ok ? 4 : 0);
    }
  }
}

// Rows [0, kTile) of a shared tile (stride ld_s) to rows r0 + r < nrows of
// a row-major matrix in global memory (stride ld_g): the first `valid` <= W
// floats of each row, W % 4 == 0. `vec`: 16-byte stores (valid % 4 == 0,
// 16-byte aligned rows), else 4-byte ones. Consecutive threads take
// consecutive 16 bytes of a row, so that a warp writes whole lines.
template <int W>
__device__ __forceinline__ void store_rows(float* dst, size_t ld_g, int r0, int nrows, int valid,
                                           const float* src, int ld_s, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int k = 0; k < kTile * W / 4 / kThreads; ++k) {
      const int e = tid + k * kThreads;
      const int r = e / (W / 4), c = (e % (W / 4)) * 4;
      if (r0 + r < nrows && c < valid)
        *reinterpret_cast<float4*>(dst + (size_t)(r0 + r) * ld_g + c) =
            *reinterpret_cast<const float4*>(src + r * ld_s + c);
    }
  } else {
    for (int e = tid; e < kTile * W; e += kThreads) {
      const int r = e / W, c = e % W;
      if (r0 + r < nrows && c < valid) dst[(size_t)(r0 + r) * ld_g + c] = src[r * ld_s + c];
    }
  }
}

// dt and da of heads h0 .. h0 + nh - 1 (token stride H) into dts / cum,
// head-major, zero from Q to the tile's end
__device__ __forceinline__ void stage_heads(float* cum, float* dts, const float* dt,
                                            const float* da, size_t row0, int Q, int qpad,
                                            int H, int h0, int nh) {
  for (int e = threadIdx.x; e < (qpad - Q) * nh; e += kThreads) {
    const int t = Q + e / nh, hl = e % nh;
    dts[hl * kMaxQ + t] = 0.f;
    cum[hl * kMaxQ + t] = 0.f;
  }
  for (int e = threadIdx.x; e < Q * nh; e += kThreads) {
    const int t = e / nh, hl = e % nh;
    const size_t off = (row0 + t) * H + h0 + hl;
    cp_async4(dts + hl * kMaxQ + t, dt + off, 4);
    cp_async4(cum + hl * kMaxQ + t, da + off, 4);
  }
}

// ---- 3xTF32 on the tensor cores (as csrc/ssd_scan.cu) ---------------------------

// a = big + small: big is a with its low 13 bits cleared (a TF32 value,
// |small| < 2^-10 |a|), small the exact remainder, of which the MMA reads
// the top 19 bits (an error below 2^-20 |a|)
__device__ __forceinline__ void split(float a, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(a) & 0xffffe000u;
  small = __float_as_uint(a - __uint_as_float(big));
}

// d += a b on one m16n8k8 tile. Fragments, lane = 4 gq + tq: a0 (gq, tq),
// a1 (gq + 8, tq), a2 (gq, tq + 4), a3 (gq + 8, tq + 4); b0 (k tq, n gq),
// b1 (k tq + 4, n gq); d0, d1 (gq, 2 tq + {0, 1}), d2, d3 (gq + 8, ...).
// k is a summation index: any one-to-one map of the fragment's k slots
// onto the product's k works, as long as A and B use the same one. The
// "paired" map takes slot tq to k = 2 tq and slot tq + 4 to k = 2 tq + 1,
// so that an accumulator (d0, d2, d1, d3) is an A fragment.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] += A B_nt in 3xTF32 for NT tiles side by side: A (16 x 8) given
// as its four fragment values, B_nt's at b[nt * nstride] (first k slot) and
// b[nt * nstride + k4] (second); kPairs: k4 = 1, the two read as one
// float2. The small terms go first; the three passes run over all NT
// tiles in turn, so that no MMA waits on the one before it.
template <int NT, bool kPairs>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[NT][4], const float (&a)[4],
                                           const float* b, int nstride, int k4) {
  uint32_t ab[4], as[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) split(a[c], ab[c], as[c]);
  uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float b0, b1;
    if (kPairs) {
      const float2 v = *reinterpret_cast<const float2*>(b + nt * nstride);
      b0 = v.x;
      b1 = v.y;
    } else {
      b0 = b[nt * nstride];
      b1 = b[nt * nstride + k4];
    }
    split(b0, bb[nt][0], bs[nt][0]);
    split(b1, bb[nt][1], bs[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], as, bb[nt][0], bb[nt][1]);   // small big
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], ab, bs[nt][0], bs[nt][1]);   // big small
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], ab, bb[nt][0], bb[nt][1]);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
}

// v[0..Q) = cumsum(v[0..Q)) in place, by one warp: lane l sums steps
// [l*per, l*per + per) in order, then adds the inclusive scan of the lower
// lanes' sums (as csrc/ssd_scan.cu)
__device__ __forceinline__ void warp_cumsum(float* v, int Q, int lane) {
  const int per = (Q + 31) / 32;   // <= 8
  const int t0 = lane * per;
  float loc[8];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int t = t0 + k;
    if (k < per && t < Q) run += v[t];
    loc[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float up = __shfl_up_sync(0xffffffffu, incl, 1);
  const float base = lane == 0 ? 0.f : up;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int t = t0 + k;
    if (k < per && t < Q) v[t] = base + loc[k];
  }
}

// the causal tile pair (it, jt), it >= jt, as one index
__device__ __forceinline__ int pair_index(int it, int jt) { return it * (it + 1) / 2 + jt; }

struct Dims {
  int Q, H, P, G, N;
  int hs, nslices, ntiles, npairs, qp;
};


// ---- 1. prep: the state products per head slice, C B^T per tile pair ----------
// Blocks [0, units * ntiles): the state role, block = jt * units + us with
// us = (bz * G + g) * nslices + slice; then C B^T, block - units * ntiles =
// (bz * G + g) * npairs + pair.
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_prep_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ da, const float* __restrict__ bm,
                    const float* __restrict__ cm, const float* __restrict__ gst,
                    float* __restrict__ dx, float* __restrict__ cbt, float* __restrict__ dbsp,
                    float* __restrict__ rs, Dims d, int units, int vec_x, int vec_n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;   // fragment row / column
  const int wg = warp / 4, wl = warp % 4;
  const int r0 = 16 * wl;                   // this warp's rows of a tile
  const int Q = d.Q, H = d.H, P = d.P, G = d.G, N = d.N;
  const int wn = (N + 7) & ~7, wp = (P + 7) & ~7;
  const size_t sx = (size_t)H * P;
  const size_t sb = (size_t)G * N;
  const int nstate = units * d.ntiles;

  if ((int)blockIdx.x >= nstate) {
    // ---- role: CB^T_ji = B_j . C_i on one causal tile pair (it, jt) ---------
    const int blk = blockIdx.x - nstate;
    const int pair = blk % d.npairs;
    const int ug = blk / d.npairs;          // bz * G + g
    int it = 0;
    while ((it + 1) * (it + 2) / 2 <= pair) ++it;
    const int jt = pair - it * (it + 1) / 2;
    const size_t off = (size_t)(ug / G) * Q * sb + (size_t)(ug % G) * N;
    float* Bs = smem;                       // [kTile][kLdN] B_j
    float* Cs = Bs + kNTileF;               // [kTile][kLdN] C_i
    stage_rows(Bs, kLdN, bm + off, sb, jt * kTile, kTile, Q, N, wn, vec_n);
    stage_rows(Cs, kLdN, cm + off, sb, it * kTile, kTile, Q, N, wn, vec_n);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    // warp (wg, wl): rows j r0 .. r0 + 15, columns i 32 wg .. 32 wg + 31; k = n paired
    float s[4][4];
    zero(s);
#pragma unroll 4
    for (int k0 = 0; k0 < wn; k0 += 8) {
      const float* ba = Bs + (r0 + gq) * kLdN + k0 + 2 * tq;
      const float2 lo = *reinterpret_cast<const float2*>(ba);
      const float2 hi = *reinterpret_cast<const float2*>(ba + 8 * kLdN);
      const float a[4] = {lo.x, hi.x, lo.y, hi.y};
      mma_3xtf32<4, true>(s, a, Cs + (32 * wg + gq) * kLdN + k0 + 2 * tq, 8 * kLdN, 1);
    }
    // in the walk's fragment order: thread tid's four values of n-tile nt
    // at float4 nt * kThreads + tid (the walk's warps own the same positions)
    float4* out = reinterpret_cast<float4*>(cbt + ((size_t)ug * d.npairs + pair) * kTile * kTile);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      out[nt * kThreads + tid] = make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
    return;
  }

  // ---- role: the state products of a head slice on column tile jt ----------
  const int jt = blockIdx.x / units;
  const int us = blockIdx.x % units;
  const int slice = us % d.nslices;
  const int ug = us / d.nslices;
  const int gg = ug % G;
  const size_t bz = ug / G;
  const int hpg = H / G;
  const int h0 = gg * hpg + slice * d.hs;
  const int nh = min(d.hs, hpg - slice * d.hs);
  const int j0 = jt * kTile;
  const size_t row0 = bz * Q;
  float* cum = smem;                        // [kMaxHeads][kMaxQ]
  float* dts = smem + kMaxHeads * kMaxQ;    // [kMaxHeads][kMaxQ]
  float* Bs = smem + kHeadF;                // [kTile][kLdN] B_j
  float* buf = Bs + kNTileF;                // [2] x ([kTile][kLdA] X_j, [kMaxP][kLdN] gst)
  float* red = buf + 2 * (kXTileF + kNTileF);   // [2 head parity][2 wg][kTile] r_j halves
  float* ot = red + 2 * 2 * kTile;          // [kTile][kLdT] the head's dX state term
  auto stage_head = [&](int hl) {
    float* xb = buf + (hl & 1) * (kXTileF + kNTileF);
    stage_rows(xb, kLdA, x + row0 * sx + (size_t)(h0 + hl) * P, sx, j0, kTile, Q, P, kMaxP,
               vec_x);
    stage_rows(xb + kXTileF, kLdN, gst + ((size_t)bz * H + h0 + hl) * P * N, N, 0, kMaxP, P,
               N, kMaxN, vec_n);
  };
  auto flush_r = [&](int hl) {   // r_j = the two warpgroups' halves, to scratch
    const int j = j0 + tid;
    if (tid < kTile && j < Q) {
      const float* rp = red + (hl & 1) * 2 * kTile + tid;
      rs[((size_t)bz * H + h0 + hl) * d.qp + j] = rp[0] + rp[kTile];
    }
  };
  stage_heads(cum, dts, dt, da, row0, Q, d.ntiles * kTile, H, h0, nh);
  stage_rows(Bs, kLdN, bm + row0 * sb + (size_t)gg * N, sb, j0, kTile, Q, N, wn, vec_n);
  stage_head(0);
  cp_commit();

  const int ja = j0 + r0 + gq, jb = ja + 8;   // this thread's rows
  const bool dbs_on = 64 * wg < N;            // this warpgroup's columns of dB's state term
  float dbs[8][4];
  zero(dbs);
  for (int hl = 0; hl < nh; ++hl) {
    cp_wait<0>();
    __syncthreads();   // head hl has landed; head hl - 1's buffer and r halves are read
    if (hl == 0) {
      if (warp < nh) warp_cumsum(cum + warp * kMaxQ, Q, lane);
      __syncthreads();
    } else {
      flush_r(hl - 1);
    }
    if (hl + 1 < nh) stage_head(hl + 1);   // lands while head hl multiplies
    cp_commit();
    const float* ch = cum + hl * kMaxQ;
    const float* dh = dts + hl * kMaxQ;
    const float* xs = buf + (hl & 1) * (kXTileF + kNTileF);
    const float* gs = xs + kXTileF;
    const float deca = ja < Q ? expf(ch[Q - 1] - ch[ja]) * dh[ja] : 0.f;
    const float decb = jb < Q ? expf(ch[Q - 1] - ch[jb]) * dh[jb] : 0.f;

    // u = B_j gst^T: rows j, columns p = 32 wg + 8 nt + 2 tq (+1); k = n paired
    float u[4][4];
    zero(u);
#pragma unroll
    for (int k0 = 0; k0 < kMaxN; k0 += 8) {
      if (k0 >= wn) break;
      const float* ba = Bs + (r0 + gq) * kLdN + k0 + 2 * tq;
      const float2 lo = *reinterpret_cast<const float2*>(ba);
      const float2 hi = *reinterpret_cast<const float2*>(ba + 8 * kLdN);
      const float a[4] = {lo.x, hi.x, lo.y, hi.y};
      mma_3xtf32<4, true>(u, a, gs + (32 * wg + gq) * kLdN + k0 + 2 * tq, 8 * kLdN, 1);
    }
    // dX_j's state term decay . u, staged for dx (the walk adds W^T gy);
    // r_j's part over this warp's 32 columns p
    float rp[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int pc = 32 * wg + 8 * nt + 2 * tq;
        const float* xr = xs + (r0 + gq + 8 * rr) * kLdA + pc;
        rp[rr] = fmaf(xr[0], u[nt][2 * rr], rp[rr]);
        rp[rr] = fmaf(xr[1], u[nt][2 * rr + 1], rp[rr]);
        const float dec = rr ? decb : deca;
        *reinterpret_cast<float2*>(ot + (r0 + gq + 8 * rr) * kLdT + pc) =
            make_float2(dec * u[nt][2 * rr], dec * u[nt][2 * rr + 1]);
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      rp[rr] += __shfl_xor_sync(0xffffffffu, rp[rr], 1);
      rp[rr] += __shfl_xor_sync(0xffffffffu, rp[rr], 2);
    }
    if (tq == 0) {
      float* rh = red + ((hl & 1) * 2 + wg) * kTile + r0 + gq;
      rh[0] = rp[0];
      rh[8] = rp[1];
    }
    __syncthreads();   // the state term is staged
    store_rows<kMaxP>(dx + row0 * sx + (size_t)(h0 + hl) * P, sx, j0, Q, P, ot, kLdT, vec_x);
    // dB's state term, summed over the slice's heads: += (decay . X_j) gst,
    // rows j, columns n = 64 wg + 8 nt + 2 tq (+1)
    if (dbs_on) {
#pragma unroll
      for (int k0 = 0; k0 < kMaxP; k0 += 8) {
        if (k0 >= wp) break;
        const float* xa = xs + (r0 + gq) * kLdA + k0 + tq;
        const float a[4] = {deca * xa[0], decb * xa[8 * kLdA], deca * xa[4],
                            decb * xa[8 * kLdA + 4]};
        mma_3xtf32<8, false>(dbs, a, gs + (k0 + tq) * kLdN + 64 * wg + gq, 8, 4 * kLdN);
      }
    }
  }
  __syncthreads();   // the head buffers are read: stage dB's state term there
  flush_r(nh - 1);
  if (dbs_on) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float2*>(buf + (r0 + gq + 8 * rr) * kLdN + 64 * wg + 8 * nt + 2 * tq) =
            make_float2(dbs[nt][2 * rr], dbs[nt][2 * rr + 1]);
  }
  __syncthreads();
  store_rows<kMaxN>(dbsp + (size_t)us * d.qp * N, N, j0, Q, N, buf, kLdN, vec_n);
}

// ---- 2. walk: the causal tile pairs of a column tile, per head slice ----------
// block = jt * units + us, us = (bz * G + g) * nslices + slice: the long walks
// (jt = 0) first
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_walk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ da, const float* __restrict__ gy,
                    const float* __restrict__ cbt, const float* __restrict__ rs,
                    float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dcbp,
                    float* __restrict__ rowp, float* __restrict__ aux, Dims d, int units,
                    int vec_x) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* cum = smem;                            // [kMaxHeads][kMaxQ]
  float* dts = smem + kMaxHeads * kMaxQ;        // [kMaxHeads][kMaxQ]
  float* xr = smem + kHeadF;                    // [kStages][kTile][kLdA] X_j by head
  float* yr = xr + kStages * kXTileF;           // [kStages][kTile][kLdA] gy_i by item
  float* strip = yr + kStages * kXTileF;        // [kMaxTiles][kTile][kLdT] dCB^T (j, i)
  float* redr = strip + kMaxTiles * kTile * kLdT;   // [2 item parity][4 wl][kTile]
  float* redc = redr + 2 * 4 * kTile;           // [2 wg][S, ddt][kTile]
  float* ot = redc + 2 * 2 * kTile;             // [kTile][kLdT] dX_j of the head

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wg = warp / 4, wl = warp % 4;
  const int r0 = 16 * wl;
  const int Q = d.Q, H = d.H, P = d.P, G = d.G;
  const int wp = (P + 7) & ~7;
  const size_t sx = (size_t)H * P;
  const int jt = blockIdx.x / units;
  const int us = blockIdx.x % units;
  const int slice = us % d.nslices;
  const int ug = us / d.nslices;
  const size_t bz = ug / G;
  const int hpg = H / G;
  const int h0 = (ug % G) * hpg + slice * d.hs;
  const int nh = min(d.hs, hpg - slice * d.hs);
  const int j0 = jt * kTile;
  const int per = d.ntiles - jt;   // row tiles it = jt .. ntiles - 1
  const int nitems = nh * per;     // (head, row tile), head-major
  const size_t row0 = bz * Q;
  const float neg_inf = __int_as_float(0xff800000);

  stage_heads(cum, dts, dt, da, row0, Q, d.ntiles * kTile, H, h0, nh);
  cp_commit();
  for (int e = tid; e < per * kTile * kLdT; e += kThreads) strip[e] = 0.f;
  // item = (head, row tile): gy_i through the ring, X_j with the head's first tile
  auto issue = [&](int item) {
    if (item < nitems) {
      const int hl = item / per, t = item % per;
      const size_t hoff = row0 * sx + (size_t)(h0 + hl) * P;
      if (t == 0) stage_tile(xr + (hl % kStages) * kXTileF, x + hoff, sx, j0, Q, P, vec_x);
      stage_tile(yr + (item % kStages) * kXTileF, gy + hoff, sx, (jt + t) * kTile, Q, P, vec_x);
    }
    cp_commit();
  };
  // row sums of S of item k over the four warps' rows, to scratch
  auto flush_rows = [&](int k) {
    const int hl = k / per, i = (jt + k % per) * kTile + tid;
    if (tid < kTile && i < Q) {
      const float* rr = redr + (k & 1) * 4 * kTile + tid;
      rowp[(((size_t)bz * H + h0 + hl) * d.ntiles + jt) * d.qp + i] =
          ((rr[0] + rr[kTile]) + rr[2 * kTile]) + rr[3 * kTile];
    }
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  cp_wait<kStages - 1>();
  __syncthreads();   // dt and da have landed
  if (warp < nh) warp_cumsum(cum + warp * kMaxQ, Q, lane);

  const int ja = j0 + r0 + gq, jb = ja + 8;   // this thread's rows j
  const float* cbg = cbt + (size_t)ug * d.npairs * kTile * kTile;
  float dxa[8][4];
  float colS[2], colD[2];
  float dxs[16];     // the head's dX state term (from prep), in store_rows' order
  float rj = 0.f;    // r_j of row j0 + tid (tid < kTile)
  for (int item = 0; item < nitems; ++item) {
    cp_wait<kStages - 2>();
    __syncthreads();   // item's tiles have landed; item - 1's are read; cum is scanned
    issue(item + kStages - 1);
    const int hl = item / per, t = item % per;
    const int it = jt + t, ic = it * kTile + 32 * wg;   // this warp's first column i
    if (item > 0) flush_rows(item - 1);
    if (t == 0) {
      zero(dxa);
      colS[0] = colS[1] = colD[0] = colD[1] = 0.f;
      // loads that land while the head's tiles multiply: what its last tile
      // adds to, each thread the elements it will store
      const float* dxh = dx + row0 * sx + (size_t)(h0 + hl) * P;
      if (vec_x) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = tid + k * kThreads, r = e / (kMaxP / 4), c = (e % (kMaxP / 4)) * 4;
          const float4 v = j0 + r < Q && c < P
                               ? *reinterpret_cast<const float4*>(dxh + (size_t)(j0 + r) * sx + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          dxs[4 * k] = v.x;
          dxs[4 * k + 1] = v.y;
          dxs[4 * k + 2] = v.z;
          dxs[4 * k + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int e = tid + k * kThreads, r = e / kMaxP, c = e % kMaxP;
          dxs[k] = j0 + r < Q && c < P ? dxh[(size_t)(j0 + r) * sx + c] : 0.f;
        }
      }
      if (tid < kTile && j0 + tid < Q) rj = rs[((size_t)bz * H + h0 + hl) * d.qp + j0 + tid];
    }
    const float* X = xr + (hl % kStages) * kXTileF;
    const float* Y = yr + (item % kStages) * kXTileF;
    const float* ch = cum + hl * kMaxQ;
    const float* dh = dts + hl * kMaxQ;
    float rsum[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) rsum[nt][0] = rsum[nt][1] = 0.f;
    // a warp whose rows all lie below its columns' causal reach has nothing to add
    if (j0 + r0 <= ic + 31 && ic < Q && j0 + r0 < Q) {
      // C B^T at this thread's accumulator positions, from scratch (L2), in
      // fragment order: (c0, c1) row gq, (c2, c3) row gq + 8
      const float4* cbp =
          reinterpret_cast<const float4*>(cbg + (size_t)pair_index(it, jt) * kTile * kTile);
      float4 cbv[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) cbv[nt] = __ldg(cbp + nt * kThreads + tid);
      // gW^T = X_j gy_i^T: rows j, columns i
      float gw[4][4];
      zero(gw);
#pragma unroll
      for (int k0 = 0; k0 < kMaxP; k0 += 8) {
        if (k0 >= wp) break;
        const float* xa = X + (r0 + gq) * kLdA + k0 + tq;
        const float a[4] = {xa[0], xa[8 * kLdA], xa[4], xa[8 * kLdA + 4]};
        mma_3xtf32<4, false>(gw, a, Y + (32 * wg + gq) * kLdA + k0 + tq, 8 * kLdA, 4);
      }
      // elementwise, in fp32: L, dCB += gW L dt_j, S = gW . W and its sums,
      // gW CB L for ddt; gw becomes W
      const float cj[2] = {ch[ja], ch[jb]};
      const float dj[2] = {dh[ja], dh[jb]};
      float* sp = strip + t * kTile * kLdT + (r0 + gq) * kLdT + 32 * wg + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int i = ic + 8 * nt + 2 * tq;
        const float2 ci = *reinterpret_cast<const float2*>(ch + i);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int j = rr ? jb : ja;
          float2* sv = reinterpret_cast<float2*>(sp + 8 * nt + 8 * rr * kLdT);
          float2 acc = *sv;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ii = i + e;
            // the causal select acts on the exponent: exp(-inf) = 0, where
            // exp(cum_i - cum_j) would overflow above the diagonal
            const bool ok = j <= ii && ii < Q;
            const float lij = expf(ok ? (e ? ci.y : ci.x) - cj[rr] : neg_inf);
            const float gl = gw[nt][2 * rr + e] * lij;
            const float cbx = rr ? (e ? cbv[nt].w : cbv[nt].z) : (e ? cbv[nt].y : cbv[nt].x);
            if (e) acc.y += gl * dj[rr];
            else acc.x += gl * dj[rr];
            const float gc = gl * cbx;
            const float sij = j < ii ? gc * dj[rr] : 0.f;
            colS[rr] += sij;
            colD[rr] += gc;
            rsum[nt][e] += sij;
            gw[nt][2 * rr + e] = cbx * lij * dj[rr];
          }
          *sv = acc;
        }
      }
      // dX_j += W^T gy_i over this warp's 32 columns i: the accumulator of W
      // is the A fragment with k = i paired; on the diagonal tile the
      // columns left of all the warp's rows add nothing
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (ic + 8 * kt + 7 < j0 + r0) continue;
        const float a[4] = {gw[kt][0], gw[kt][2], gw[kt][1], gw[kt][3]};
        mma_3xtf32<8, false>(dxa, a, Y + (32 * wg + 8 * kt + 2 * tq) * kLdA + gq, 8, kLdA);
      }
    }
    // the row sums of S over this warp's 16 rows: across the gq lanes
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = rsum[nt][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gq == 0) redr[((item & 1) * 4 + wl) * kTile + 32 * wg + 8 * nt + 2 * tq + e] = v;
      }
    if (t == per - 1) {
      // the head's last tile: column sums across the tq lanes, then the two
      // warpgroups' halves of the columns i
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        colS[rr] += __shfl_xor_sync(0xffffffffu, colS[rr], 1);
        colS[rr] += __shfl_xor_sync(0xffffffffu, colS[rr], 2);
        colD[rr] += __shfl_xor_sync(0xffffffffu, colD[rr], 1);
        colD[rr] += __shfl_xor_sync(0xffffffffu, colD[rr], 2);
      }
      if (tq == 0) {
        float* cs = redc + 2 * wg * kTile + r0 + gq;
        cs[0] = colS[0];
        cs[8] = colS[1];
        cs[kTile] = colD[0];
        cs[kTile + 8] = colD[1];
      }
      // dX_j: the warpgroups' halves of the columns i summed in a staging
      // tile, warpgroup 0 then 1, then added to the state term and stored
      float* od = ot + (r0 + gq) * kLdT + 2 * tq;
      if (wg == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            *reinterpret_cast<float2*>(od + 8 * rr * kLdT + 8 * nt) =
                make_float2(dxa[nt][2 * rr], dxa[nt][2 * rr + 1]);
      }
      __syncthreads();
      if (wg == 1) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float2* o = reinterpret_cast<float2*>(od + 8 * rr * kLdT + 8 * nt);
            const float2 v = *o;
            *o = make_float2(v.x + dxa[nt][2 * rr], v.y + dxa[nt][2 * rr + 1]);
          }
      }
      __syncthreads();
      float* dxh = dx + row0 * sx + (size_t)(h0 + hl) * P;
      if (vec_x) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = tid + k * kThreads, r = e / (kMaxP / 4), c = (e % (kMaxP / 4)) * 4;
          if (j0 + r < Q && c < P) {
            const float4 v = *reinterpret_cast<const float4*>(ot + r * kLdT + c);
            *reinterpret_cast<float4*>(dxh + (size_t)(j0 + r) * sx + c) =
                make_float4(dxs[4 * k] + v.x, dxs[4 * k + 1] + v.y, dxs[4 * k + 2] + v.z,
                            dxs[4 * k + 3] + v.w);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int e = tid + k * kThreads, r = e / kMaxP, c = e % kMaxP;
          if (j0 + r < Q && c < P) dxh[(size_t)(j0 + r) * sx + c] = dxs[k] + ot[r * kLdT + c];
        }
      }
      // ddt_j, and dcum's column part cols_j + R_j with R_j beside it
      const int j = j0 + tid;
      if (tid < kTile && j < Q) {
        const size_t hq = (size_t)bz * H + h0 + hl;
        const float ej = expf(ch[Q - 1] - ch[j]);
        ddt[(row0 + j) * H + h0 + hl] = (redc[kTile + tid] + redc[3 * kTile + tid]) + ej * rj;
        const float big_r = ej * dh[j] * rj;   // R_j
        aux[hq * 2 * d.qp + j] = (redc[tid] + redc[2 * kTile + tid]) + big_r;
        aux[(hq * 2 + 1) * d.qp + j] = big_r;
      }
    }
  }
  __syncthreads();
  flush_rows(nitems - 1);
  // the strip, dCB summed over the slice's heads, to scratch
  float* out = dcbp + (size_t)us * d.npairs * kTile * kTile;
  for (int t = 0; t < per; ++t) {
    float* o = out + (size_t)pair_index(jt + t, jt) * kTile * kTile;
    const float* s = strip + t * kTile * kLdT;
    for (int e = tid; e < kTile * kTile / 4; e += kThreads) {
      const int r = e / (kTile / 4), c = (e % (kTile / 4)) * 4;
      *reinterpret_cast<float4*>(o + r * kTile + c) =
          *reinterpret_cast<const float4*>(s + r * kLdT + c);
    }
  }
}

// ---- 3. reduce: sums over the head slices, in slice order --------------------
// threads [0, ncb): a float4 of dCB each, into cbt; then an element of dB's
// state term each, into the first slice of dbsp (each element is read and
// written by one thread)
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float4* __restrict__ dcbp, float4* __restrict__ dcb,
                      float* __restrict__ dbsp, int nslices, long long per_cb, long long ncb,
                      long long per_bs, long long nbs) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx < ncb) {
    const float4* p = dcbp + (idx / per_cb) * nslices * per_cb + idx % per_cb;
    float4 s = p[0];
    for (int k = 1; k < nslices; ++k) {
      const float4 v = p[k * per_cb];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    dcb[idx] = s;
  } else if (idx < ncb + nbs) {
    const long long e = idx - ncb;
    float* p = dbsp + (e / per_bs) * nslices * per_bs + e % per_bs;
    float s = p[0];
    for (int k = 1; k < nslices; ++k) s += p[k * per_bs];
    p[0] = s;
  }
}

// ---- 4. group: dC and dB per 64-row tile and 32 columns; dda per head ---------
// Blocks [0, ndb): block = ((rank * 2 + role) * bncg + ug) * nq + qi, role 0
// dC of row tile ntiles - 1 - rank, role 1 dB of row tile rank (the longest
// sums first); then warp w of block ndb + k takes (b*z, head) 8 k + w.
__global__ void __launch_bounds__(kThreads, 2)   // two blocks an SM: the tiles' loads overlap
ssd_bwd_group_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                     const float* __restrict__ dcb, const float* __restrict__ dbsp,
                     const float* __restrict__ rowp, const float* __restrict__ aux,
                     float* __restrict__ db, float* __restrict__ dc, float* __restrict__ dda,
                     Dims d, int bncg, int vec_n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wg = warp / 4, wl = warp % 4;
  const int r0 = 16 * wl;
  const int Q = d.Q, H = d.H, G = d.G, N = d.N, qp = d.qp;
  const int nq = (N + kNq - 1) / kNq;
  const long long ndb = (long long)d.ntiles * 2 * bncg * nq;

  if ((long long)blockIdx.x >= ndb) {
    // ---- role: dda of one (b*z, head) per warp --------------------------------
    const long long hq = ((long long)blockIdx.x - ndb) * 8 + warp;   // bz * H + h
    if (hq >= (long long)bncg / G * H) return;
    const float* rp = rowp + hq * d.ntiles * qp;
    const float* ax = aux + hq * 2 * qp;
    const int per = (Q + 31) / 32;   // <= 8 steps a lane
    float v[8];
    float rsum = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int t = lane * per + k;
      v[k] = 0.f;
      if (k < per && t < Q) {
        float rows = 0.f;
        for (int jt = 0; jt <= t / kTile; ++jt) rows += rp[jt * qp + t];
        v[k] = rows - ax[t];   // dcum_t = sum_{j < t} S_tj - (sum_{k > t} S_kt + R_t)
        rsum += ax[qp + t];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (lane * per + k == Q - 1 && k < per) v[k] += rsum;   // + sum_j R_j at Q - 1
    // dda = the reverse cumsum of dcum: each lane's steps from its last, then
    // the sums of the higher lanes
    float loc[8];
    float run = 0.f;
#pragma unroll
    for (int k = 7; k >= 0; --k) {
      run += v[k];
      loc[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += o;
    }
    const float down = __shfl_down_sync(0xffffffffu, incl, 1);
    const float base = lane == 31 ? 0.f : down;
    const size_t bz = hq / H;
    const int h = hq % H;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int t = lane * per + k;
      if (k < per && t < Q) dda[(bz * Q + t) * H + h] = base + loc[k];
    }
    return;
  }

  // ---- role: dC or dB rows of one tile, 32 columns n ------------------------
  const int qi = blockIdx.x % nq;
  const int ug = (blockIdx.x / nq) % bncg;
  const int role = (blockIdx.x / nq / bncg) % 2;   // 0: dC, 1: dB
  const int rank = blockIdx.x / nq / bncg / 2;
  const int t = role ? rank : d.ntiles - 1 - rank;
  const size_t bz = ug / G;
  const int n0 = qi * kNq, nv = min(kNq, N - n0);
  const size_t sb = (size_t)G * N;
  float* S = smem;                   // a tile of dCB (j, i): dC k-major, dB row-major
  float* O = S + kTile * kLdT;       // [kTile][kLdO] B_j or C_i, columns n0 ..
  const int lds = role ? kLdR : kLdT;
  const float* opg = (role ? cm : bm) + bz * Q * sb + (size_t)(ug % G) * N + n0;
  const float* dcbg = dcb + (size_t)ug * d.npairs * kTile * kTile;
  float acc[2][4];
  zero(acc);
  // dC rows i of tile t: sum over j tiles kt <= t of dCB_ij B_j; dB rows j of
  // tile t: sum over i tiles kt >= t of dCB_ij C_i
  const int k0t = role ? t : 0, k1t = role ? d.ntiles - 1 : t;
  for (int kt = k0t; kt <= k1t; ++kt) {
    __syncthreads();   // the previous tiles are read
    const int it = role ? kt : t, jt = role ? t : kt;
    stage_rows(S, lds, dcbg + (size_t)pair_index(it, jt) * kTile * kTile, kTile, 0, kTile,
               kTile, kTile, kTile, true);
    stage_rows(O, kLdO, opg, sb, kt * kTile, kTile, Q, nv, kNq, vec_n);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kTile; k0 += 8) {
      float a[4];
      if (role) {   // A(j, i) = dCB_ij, row-major
        const float* sa = S + (r0 + gq) * kLdR + k0 + tq;
        a[0] = sa[0];
        a[1] = sa[8 * kLdR];
        a[2] = sa[4];
        a[3] = sa[8 * kLdR + 4];
      } else {      // A(i, j) = dCB_ij, k-major
        const float* sa = S + (k0 + tq) * kLdT + r0 + gq;
        a[0] = sa[0];
        a[1] = sa[8];
        a[2] = sa[4 * kLdT];
        a[3] = sa[4 * kLdT + 8];
      }
      mma_3xtf32<2, false>(acc, a, O + (k0 + tq) * kLdO + 16 * wg + gq, 8, 4 * kLdO);
    }
  }
  float* out = (role ? db : dc) + bz * Q * sb + (size_t)(ug % G) * N + n0;
  const float* dbg = dbsp + (size_t)ug * d.nslices * qp * N + n0;   // summed by reduce
  const int ra = t * kTile + r0 + gq;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = ra + 8 * (c >> 1);
      const int nc = 16 * wg + 8 * nt + 2 * tq + (c & 1);
      if (row < Q && nc < nv) {
        float v = acc[nt][c];
        if (role) v += dbg[(size_t)row * N + nc];   // + dB's state term
        out[(size_t)row * sb + nc] = v;
      }
    }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// x, gy, dx: (bnc, q, h, p); dt, da, ddt, dda: (bnc, q, h); b, c, db, dc:
// (bnc, q, g, n); gst: (bnc, h, p, n); hs: heads per block (the head
// slice), nslices = ceil((h / g) / hs); scratch, with qp = 64 ceil(q / 64)
// and npairs = the causal 64 x 64 tile pairs: cbt (bnc g, npairs, 64, 64),
// C B^T then dCB; dcbp (bnc g nslices, npairs, 64, 64); dbsp (bnc g
// nslices, qp, n); rs (bnc h, qp); rowp (bnc h, qp / 64, qp); aux (bnc h,
// 2, qp); all fp32, contiguous; bnc = batch * chunks. Returns the CUDA
// error of the launches (0 on success), or cudaErrorInvalidValue for
// arguments outside the kernels' limits.
int repro_ssd_chunk_bwd(const void* x, const void* dt, const void* da, const void* b,
                        const void* c, const void* gy, const void* gst, void* dx,
                        void* ddt, void* dda, void* db, void* dc, void* cbt, void* dcbp,
                        void* dbsp, void* rs, void* rowp, void* aux, long long bnc, int q,
                        int h, int p, int g, int n, int hs, void* stream) {
  if (bnc < 1 || q < 1 || q > kMaxQ || p < 1 || p > kMaxP || n < 1 || n > kMaxN ||
      g < 1 || h < 1 || h % g != 0 || hs < 1 || hs > kMaxHeads || hs > h / g)
    return (int)cudaErrorInvalidValue;
  Dims d;
  d.Q = q;
  d.H = h;
  d.P = p;
  d.G = g;
  d.N = n;
  d.hs = hs;
  d.nslices = (h / g + hs - 1) / hs;
  d.ntiles = (q + kTile - 1) / kTile;
  d.npairs = d.ntiles * (d.ntiles + 1) / 2;
  d.qp = d.ntiles * kTile;
  const long long units = bnc * g * d.nslices;
  const long long nstate = units * d.ntiles;
  const long long prep = nstate + bnc * g * d.npairs;
  const long long per_cb = (long long)d.npairs * kTile * kTile / 4, per_bs = (long long)d.qp * n;
  const long long reduce = (bnc * g * (per_cb + per_bs) + kThreads - 1) / kThreads;
  const long long group = (long long)d.ntiles * 2 * bnc * g * ((n + kNq - 1) / kNq) +
                          (bnc * h + 7) / 8;
  if (prep > 0x7fffffffLL || reduce > 0x7fffffffLL || group > 0x7fffffffLL ||
      bnc * h * 2 * d.qp > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = set_smem((const void*)ssd_bwd_prep_kernel, sizeof(float) * kPrepF);
    if (e == cudaSuccess) e = set_smem((const void*)ssd_bwd_walk_kernel, sizeof(float) * kWalkF);
    if (e == cudaSuccess)
      e = set_smem((const void*)ssd_bwd_group_kernel, sizeof(float) * kGroupF);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const auto aligned = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
  };
  const int vec_x = p % 4 == 0 && aligned(x) && aligned(gy) && aligned(dx);
  const int vec_n = n % 4 == 0 && aligned(b) && aligned(c) && aligned(gst);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* daf = static_cast<const float*>(da);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  float* cbtf = static_cast<float*>(cbt);
  ssd_bwd_prep_kernel<<<(unsigned)prep, kThreads, sizeof(float) * kPrepF, s>>>(
      xf, dtf, daf, bf, cf, static_cast<const float*>(gst), static_cast<float*>(dx), cbtf,
      static_cast<float*>(dbsp), static_cast<float*>(rs), d, (int)units, vec_x, vec_n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_walk_kernel<<<(unsigned)nstate, kThreads, sizeof(float) * kWalkF, s>>>(
      xf, dtf, daf, static_cast<const float*>(gy), cbtf, static_cast<const float*>(rs),
      static_cast<float*>(dx), static_cast<float*>(ddt), static_cast<float*>(dcbp),
      static_cast<float*>(rowp), static_cast<float*>(aux), d, (int)units, vec_x);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the slice sums: dCB into cbt's scratch (C B^T is read no more), dB's
  // state term into dbsp's first slice
  ssd_bwd_reduce_kernel<<<(unsigned)reduce, kThreads, 0, s>>>(
      static_cast<const float4*>(dcbp), reinterpret_cast<float4*>(cbtf),
      static_cast<float*>(dbsp), d.nslices, per_cb, bnc * g * per_cb, per_bs, bnc * g * per_bs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_group_kernel<<<(unsigned)group, kThreads, sizeof(float) * kGroupF, s>>>(
      bf, cf, cbtf, static_cast<const float*>(dbsp), static_cast<const float*>(rowp),
      static_cast<const float*>(aux), static_cast<float*>(db), static_cast<float*>(dc),
      static_cast<float*>(dda), d, (int)(bnc * g), vec_n);
  return (int)cudaGetLastError();
}

}  // extern "C"
