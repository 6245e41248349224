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
// Bound. Per (b, z) the causal half of C B^T costs G Q^2/2 N multiply-adds,
// then per head the causal half of W X Q^2/2 P and the state Q N P; at
// Q = 256, N = 128, P = 64 that is ~25 multiply-adds (50 operations) per
// byte moved, above the fp32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s =
// 20 per byte). This kernel runs the products on the tensor cores in
// 3xTF32, three TF32 products per fp32 product: at 494.7 TFLOP/s the
// operations and the bytes take about as long (chip_smoke.py phase 7
// prints the route's bound beside the fp32 one). Left for later: the
// kernel runs at a fraction of that bound, held back more by its staging,
// barriers and the MMAs' issue than by the products' count (PERF.md has
// the split of its time).
//
// Precision: 3xTF32. Each operand a is split into big (a with its low 13
// bits cleared, a TF32 value) and small = a - big (exact, |small| <
// 2^-10 |a|); a b ~ big big + big small + small big with fp32 accumulation
// (mma.sync m16n8k8 tf32, which reads the top 19 bits of small). The
// dropped small small term and the cut bits of small are about 2^-19 of
// the product; one TF32 pass (~2^-10) is not enough: it misses SSD_TOL by
// 5-11x in every case of checks.ssd_cases() (PERF.md).
// Rounding big (cvt.rna) instead of cutting it gives the same error there
// and costs ~20% more time. The exponentials, the causal select and the
// dt / decay scalings run in fp32 on CUDA cores. The select acts on the
// exponent (exp(-inf) = 0): exp(cum_i - cum_j) overflows to inf above the
// diagonal at full width (cum falls to ~-3e3 over a chunk), and inf * 0
// would be NaN.
//
// Design. One block of kWarpgroups warpgroups of four warps owns (b, z,
// group g, a slice of at most kMaxHeads heads of g) and a role:
//   - a 64-row tile i of y. It first computes S = C_i B_{0..i}^T (64 x
//     64(i+1), K = N) once into shared memory, staging B_j through two
//     buffers with cp.async so that B_{j+1} loads while B_j multiplies.
//     S is shared by the slice's heads: C B^T is computed once per head
//     slice, not once per head. Then each warpgroup takes its share of the
//     slice's heads and walks their causal column tiles j <= i: X_j
//     arrives through a cp.async ring of kStages tiles (the next tile, of
//     this head or the next, loads while the current one multiplies); each
//     warp builds its 16 rows of W = select(j <= i, S . exp(cum_i - cum_j),
//     0) . dt_j in registers, straight into the MMA's A fragments, and
//     accumulates W X_j (16 x 64) in registers.
//   - a 64-column half of the chunk state. B (Q x 64) is staged once and
//     shared by the slice's heads; each warpgroup takes its share of the
//     heads, X_j arrives through the same ring, and each warp accumulates
//     its 16 rows p of st = (w . X)^T B, w = exp(cum_{Q-1} - cum) dt, over
//     the chunk's tiles.
// The blocks are numbered role by role, largest first (the last row tile,
// the state halves, then the row tiles downwards), so that the long causal
// walks start first and the short ones fill in behind them. The wrapper
// picks the head slice so that the grid fills the card
// (repro_torch/kernels/ssd_scan/ssd_scan.py, head_slice). Each block first
// scans cum = cumsum(da) of its heads into shared memory (one warp a head:
// each lane sums up to 8 consecutive steps, then a shuffle scan of the lane
// sums). Operands are staged zero-filled to whole tiles, so that the inner
// loops run without bounds checks.
//
// Limits (the Python wrapper checks them): 1 <= Q <= 256, 1 <= P <= 64,
// 1 <= N <= 128, H % G == 0, 1 <= heads per block <= min(kMaxHeads, H/G).
// Sums run in another order than the plain PyTorch version; the tolerance
// the port holds the kernel to is stated in repro_torch/kernels/checks.py
// (SSD_TOL).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpgroups = 3;   // of four warps; each takes its own heads
constexpr int kThreads = 128 * kWarpgroups;
static_assert(kWarpgroups >= 2, "the C B^T phase uses eight warps");
constexpr int kTile = 64;         // rows of a chunk per tile (i and j)
constexpr int kMaxQ = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxHeads = 6;      // heads of one block's slice (the wrapper's largest)
constexpr int kNHalf = 64;        // state columns n of one block
constexpr int kStages = 2;        // X tiles in flight per warpgroup
// Row strides in floats, chosen so that the MMA fragment loads hit 32
// distinct banks: a row-major A (row g, column t) or an n-contiguous B
// wants a stride of 4 mod 32, a k-major operand (row t, column g) 8 mod 32.
constexpr int kLdS = kMaxQ + 4;   // S, row-major A
constexpr int kLdCB = kMaxN + 4;  // C_i (row-major A), B_j (n-contiguous B)
constexpr int kLdX = kTile + 8;   // X tiles (k-major B of y, A^T of st), B of st

// shared memory, in floats: cum and dt (the state's w) of the slice's
// heads, then the role's buffers
constexpr int kHeadF = 2 * kMaxHeads * kMaxQ;
constexpr int kXTileF = kTile * kLdX;
constexpr int kRingF = kWarpgroups * kStages * kXTileF;
constexpr int kSF = kTile * kLdS;
constexpr int kSPhaseF = 3 * kTile * kLdCB;          // C_i and two B_j
constexpr int kYF = kSF + (kSPhaseF > kRingF ? kSPhaseF : kRingF);
constexpr int kStF = kMaxQ * kLdX + kRingF;
constexpr int kSmemFloats = kHeadF + (kYF > kStF ? kYF : kStF);
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

// ---- cp.async ---------------------------------------------------------------

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

// the 128 threads of warpgroup wg (named barriers 1 and 2)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}

// Stage rows [r0, r0 + rows) of a row-major matrix in global memory (row
// stride ld_g floats, `valid` floats a row, `nrows` rows) into shared rows
// of `width` floats (stride ld_s); rows >= nrows and columns >= valid are
// zero-filled. width % 4 == 0; `vec`: 16-byte copies (valid % 4 == 0 and
// 16-byte aligned rows), else 4-byte ones.
__device__ __forceinline__ void stage_rows(float* dst, int ld_s, const float* src,
                                           size_t ld_g, int r0, int rows, int nrows,
                                           int valid, int width, bool vec, int tid,
                                           int nthreads) {
  if (vec) {
    const int cpr = width / 4;
    for (int e = tid; e < rows * cpr; e += nthreads) {
      const int r = e / cpr, c = (e % cpr) * 4;
      const int gr = r0 + r;
      const bool ok = gr < nrows && c < valid;
      cp_async16(dst + r * ld_s + c, ok ? src + (size_t)gr * ld_g + c : src, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * width; e += nthreads) {
      const int r = e / width, c = e % width;
      const int gr = r0 + r;
      const bool ok = gr < nrows && c < valid;
      cp_async4(dst + r * ld_s + c, ok ? src + (size_t)gr * ld_g + c : src, ok ? 4 : 0);
    }
  }
}

// ---- 3xTF32 on the tensor cores ---------------------------------------------

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
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] += A B_nt in 3xTF32 for NT tiles side by side: A (16 x 8) given
// split, B_nt's fragment values at b[nt * nstride] (k = tq) and
// b[nt * nstride + k4] (k = tq + 4). The small terms go first; the three
// passes run over all NT tiles in turn, so that no MMA waits on the one
// before it.
template <int NT>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[NT][4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const float* b,
                                           int nstride, int k4) {
  uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    split(b[nt * nstride], bb[nt][0], bs[nt][0]);
    split(b[nt * nstride + k4], bb[nt][1], bs[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], as, bb[nt][0], bb[nt][1]);   // small big
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], ab, bs[nt][0], bs[nt][1]);   // big small
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], ab, bb[nt][0], bb[nt][1]);
}

// the four A fragment values of rows (gq, gq + 8) and columns (tq, tq + 4),
// split
__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&ab)[4],
                                        uint32_t (&as)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) split(a[c], ab[c], as[c]);
}

// v[0..Q) = cumsum(v[0..Q)) in place, by one warp: lane l sums steps
// [l*per, l*per + per) in order, then adds the inclusive scan of the lower
// lanes' sums
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

__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ da, const float* __restrict__ bm,
                 const float* __restrict__ cm, float* __restrict__ y,
                 float* __restrict__ st, int Q, int H, int P, int G, int N,
                 int hs, int nslices, int units, int vec_x, int vec_bc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* cum = smem;                        // [kMaxHeads][kMaxQ]
  float* dts = smem + kMaxHeads * kMaxQ;    // [kMaxHeads][kMaxQ]: dt, the state's w
  float* work = smem + kHeadF;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;   // fragment row / column
  const int wg = warp / 4, wl = warp % 4, wtid = tid % 128;
  const int ntiles = (Q + kTile - 1) / kTile;
  const int nstate = (N + kNHalf - 1) / kNHalf;
  const int qpad = ntiles * kTile;

  // block -> (role rank, b*z, group, head slice); rank 0: the last row tile
  // of y, 1..nstate: the state halves, then the other row tiles downwards
  const int rank = blockIdx.x / units;
  int u = blockIdx.x % units;
  const int slice = u % nslices;
  u /= nslices;
  const int gg = u % G;
  const int bz = u / G;
  const int hpg = H / G;
  const int h0 = gg * hpg + slice * hs;
  const int nh = min(hs, hpg - slice * hs);
  const bool is_state = rank >= 1 && rank <= nstate;

  // this (b, z)'s first token row; per-token strides H*P, H, G*N
  const size_t row0 = (size_t)bz * Q;
  const size_t sx = (size_t)H * P;
  const size_t sb = (size_t)G * N;
  const float* xg = x + row0 * sx;
  const float* bg = bm + row0 * sb + (size_t)gg * N;
  const float* cg = cm + row0 * sb + (size_t)gg * N;

  // dt and da of the slice's heads, head-major (cp.async group 0), zero
  // from Q to the tile's end
  for (int e = tid; e < (qpad - Q) * nh; e += kThreads) {
    const int t = Q + e / nh, hl = e % nh;
    dts[hl * kMaxQ + t] = 0.f;
    cum[hl * kMaxQ + t] = 0.f;
  }
  for (int e = tid; e < Q * nh; e += kThreads) {
    const int t = e / nh, hl = e % nh;
    const size_t off = (row0 + t) * H + h0 + hl;
    cp_async4(dts + hl * kMaxQ + t, dt + off, 4);
    cp_async4(cum + hl * kMaxQ + t, da + off, 4);
  }

  // warpgroup wg takes the slice's heads wg, wg + kWarpgroups, ...; its items are
  // (head, column tile) in order, staged through its ring of X tiles
  float* ring = work + (is_state ? kMaxQ * kLdX : kSF) + wg * kStages * kXTileF;
  const int nmine = (nh - wg + kWarpgroups - 1) / kWarpgroups;
  const int it = rank == 0 ? ntiles - 1 : ntiles - 1 - (rank - nstate);
  const int per = is_state ? ntiles : it + 1;
  const int nitems = nmine * per;
  auto issue = [&](int item) {
    if (item < nitems) {
      const int hl = wg + kWarpgroups * (item / per), jt = item % per;
      stage_rows(ring + (item % kStages) * kXTileF, kLdX, xg + (size_t)(h0 + hl) * P, sx,
                 jt * kTile, kTile, Q, P, kTile, vec_x, wtid, 128);
    }
    cp_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;

  if (!is_state) {
    // ---- role: 64 output rows of y for the slice's heads --------------------
    float* S = work;                    // [kTile][kLdS]     S[i - i0][j]
    float* Cs = S + kSF;                // [kTile][kLdCB]    C[i0 + i][n]
    float* Bb = Cs + kTile * kLdCB;     // [2][kTile][kLdCB] B[j0 + j][n]
    const int i0 = it * kTile;
    const int wn = (N + 7) & ~7;
    stage_rows(Cs, kLdCB, cg, sb, i0, kTile, Q, N, wn, vec_bc, tid, kThreads);
    stage_rows(Bb, kLdCB, bg, sb, 0, kTile, Q, N, wn, vec_bc, tid, kThreads);
    cp_commit();

    // S = C_i B_{0..i}^T, once for the slice: warp (r, c) < 8 the rows
    // 16 r .. 16 r + 15 and columns 32 c .. 32 c + 31 of each column tile
    {
      const int r0 = (warp % 4) * 16, c0 = (warp / 4) * 32;
      for (int jt = 0; jt <= it; ++jt) {
        cp_wait<0>();
        __syncthreads();   // B_jt has landed; B_{jt-1}'s buffer is free
        if (jt < it)
          stage_rows(Bb + ((jt + 1) & 1) * kTile * kLdCB, kLdCB, bg, sb, (jt + 1) * kTile,
                     kTile, Q, N, wn, vec_bc, tid, kThreads);
        cp_commit();
        const float* Bt = Bb + (jt & 1) * kTile * kLdCB;
        if (warp >= 8) continue;
        float s[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll 4
        for (int k0 = 0; k0 < wn; k0 += 8) {
          const float* ca = Cs + (r0 + gq) * kLdCB + k0 + tq;
          const float a[4] = {ca[0], ca[8 * kLdCB], ca[4], ca[8 * kLdCB + 4]};
          uint32_t ab[4], as[4];
          split_a(a, ab, as);
          mma_3xtf32<4>(s, ab, as, Bt + (c0 + gq) * kLdCB + k0 + tq, 8 * kLdCB, 4);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float* sp = S + (r0 + gq) * kLdS + jt * kTile + c0 + nt * 8 + 2 * tq;
          *reinterpret_cast<float2*>(sp) = make_float2(s[nt][0], s[nt][1]);
          *reinterpret_cast<float2*>(sp + 8 * kLdS) = make_float2(s[nt][2], s[nt][3]);
        }
      }
    }
    if (warp < nh) warp_cumsum(cum + warp * kMaxQ, Q, lane);
    __syncthreads();   // S and cum are complete; the staging buffers are free

    // the heads: y_i += W X_j over the causal column tiles j <= i
    for (int s = 0; s < kStages - 1; ++s) issue(s);
    const int r0 = wl * 16;              // this warp's rows of the tile
    const int ia = i0 + r0 + gq, ib = ia + 8;
    const int la = ia < Q ? ia : -1, lb = ib < Q ? ib : -1;   // last causal column
    const float neg_inf = __int_as_float(0xff800000);
    for (int item = 0; item < nitems; ++item) {
      cp_wait<kStages - 2>();
      warpgroup_sync(wg);   // X of `item` has landed; item - 1's stage is free
      issue(item + kStages - 1);
      const int hl = wg + kWarpgroups * (item / per), jt = item % per;
      const float* X = ring + (item % kStages) * kXTileF;
      const float* ch = cum + hl * kMaxQ;
      const float* dh = dts + hl * kMaxQ;
      if (i0 + r0 < Q) {
        const float cia = ch[ia], cib = ch[ib];
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          if (jt == it && ks * 8 > r0 + 15) break;   // above the diagonal
          const int jl = ks * 8 + tq;
          const int ja = jt * kTile + jl, jb = ja + 4;
          const float cja = ch[ja], cjb = ch[jb], dja = dh[ja], djb = dh[jb];
          const float* sa = S + (r0 + gq) * kLdS + ja;
          // the causal select acts on the exponent: exp(-inf) = 0, where
          // exp(cum_i - cum_j) would overflow above the diagonal
          const float a[4] = {
              (sa[0] * expf(ja <= la ? cia - cja : neg_inf)) * dja,
              (sa[8 * kLdS] * expf(ja <= lb ? cib - cja : neg_inf)) * dja,
              (sa[4] * expf(jb <= la ? cia - cjb : neg_inf)) * djb,
              (sa[8 * kLdS + 4] * expf(jb <= lb ? cib - cjb : neg_inf)) * djb};
          uint32_t ab[4], as[4];
          split_a(a, ab, as);
          mma_3xtf32<8>(acc, ab, as, X + jl * kLdX + gq, 8, 4 * kLdX);
        }
      }
      if (jt == it) {   // the head's last tile: write its rows of y
        float* yh = y + row0 * sx + (size_t)(h0 + hl) * P;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int p = nt * 8 + 2 * tq;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = c < 2 ? ia : ib;
            if (i < Q && p + (c & 1) < P) yh[(size_t)i * sx + p + (c & 1)] = acc[nt][c];
            acc[nt][c] = 0.f;
          }
        }
      }
    }
    return;
  }

  // ---- role: columns n0 .. n0 + 63 of the chunk state for the slice's heads --
  // st[p, n] = sum_j X[j, p] w_j B[j, n], w = exp(cum_{Q-1} - cum) dt
  float* Bs = work;                     // [kMaxQ][kLdX]  B[j][n0 + n]
  const int n0 = (rank - 1) * kNHalf;
  const int nv = min(kNHalf, N - n0);
  stage_rows(Bs, kLdX, bg + n0, sb, 0, qpad, Q, nv, kNHalf, vec_bc, tid, kThreads);
  cp_commit();
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  cp_wait<kStages - 1>();
  __syncthreads();   // dt, da and B have landed
  if (warp < nh) warp_cumsum(cum + warp * kMaxQ, Q, lane);
  __syncthreads();
  for (int e = tid; e < nh * qpad; e += kThreads) {
    const int hl = e / qpad, t = e % qpad;
    const float* ch = cum + hl * kMaxQ;
    float* w = dts + hl * kMaxQ;
    w[t] = t < Q ? expf(ch[Q - 1] - ch[t]) * w[t] : 0.f;
  }
  __syncthreads();

  const int pr = wl * 16;               // this warp's rows p
  const int pa = pr + gq, pb = pa + 8;
  for (int item = 0; item < nitems; ++item) {
    cp_wait<kStages - 2>();
    warpgroup_sync(wg);
    issue(item + kStages - 1);
    const int hl = wg + kWarpgroups * (item / per), jt = item % per;
    const float* X = ring + (item % kStages) * kXTileF;
    const float* w = dts + hl * kMaxQ;
    if (pr < P) {
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        if (jt * kTile + ks * 8 >= Q) break;
        const int jl = ks * 8 + tq;
        const int ja = jt * kTile + jl;
        const float wa = w[ja], wb = w[ja + 4];
        const float* xp = X + jl * kLdX;
        const float a[4] = {xp[pa] * wa, xp[pb] * wa, xp[4 * kLdX + pa] * wb,
                            xp[4 * kLdX + pb] * wb};
        uint32_t ab[4], as[4];
        split_a(a, ab, as);
        mma_3xtf32<8>(acc, ab, as, Bs + ja * kLdX + gq, 8, 4 * kLdX);
      }
    }
    if (jt == ntiles - 1) {   // the head's last tile: write its rows of st
      float* sth = st + ((size_t)bz * H + h0 + hl) * P * N + n0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + 2 * tq;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = c < 2 ? pa : pb;
          if (p < P && n + (c & 1) < nv) sth[(size_t)p * N + n + (c & 1)] = acc[nt][c];
          acc[nt][c] = 0.f;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x, y: (bnc, q, h, p); dt, da: (bnc, q, h); b, c: (bnc, q, g, n);
// st: (bnc, h, p, n); all fp32, contiguous; bnc = batch * chunks; hs: heads
// per block (the head slice). Returns the CUDA error of the launch (0 on
// success), or cudaErrorInvalidValue for arguments outside the kernel's
// limits.
int repro_ssd_chunk(const void* x, const void* dt, const void* da,
                    const void* b, const void* c, void* y, void* st,
                    long long bnc, int q, int h, int p, int g, int n, int hs,
                    void* stream) {
  if (bnc < 1 || q < 1 || q > kMaxQ || p < 1 || p > kMaxP || n < 1 || n > kMaxN ||
      g < 1 || h < 1 || h % g != 0 || hs < 1 || hs > kMaxHeads || hs > h / g)
    return (int)cudaErrorInvalidValue;
  const int ntiles = (q + kTile - 1) / kTile;
  const int nstate = (n + kNHalf - 1) / kNHalf;
  const int nslices = (h / g + hs - 1) / hs;
  const long long units = bnc * g * nslices;
  const long long blocks = units * (ntiles + nstate);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const auto aligned = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
  };
  const int vec_x = p % 4 == 0 && aligned(x);
  const int vec_bc = n % 4 == 0 && aligned(b) && aligned(c);
  ssd_chunk_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(da), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y),
      static_cast<float*>(st), q, h, p, g, n, hs, nslices, (int)units, vec_x, vec_bc);
  return (int)cudaGetLastError();
}

}  // extern "C"
