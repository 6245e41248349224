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
// Design. Five kernels in order on the caller's stream, one call:
//   1. cb: C B^T once per (b*z, group), on the causal 64 x 64 tiles, into
//      scratch (the forward's products are not stored: recomputed here);
//   2. head: one block per (b*z, head). It walks the column tiles j of the
//      chunk, and for each the row tiles i >= j: gW = gy_i X_j^T, then
//      elementwise L, W, S and gW . L . dt_j, which it writes to the
//      head's dCB scratch; dX_j accumulates W^T gy_i in registers over the
//      row tiles, after the state term decay . (B_j gst^T). The row and
//      column sums of S and of gW . CB . L go through shared memory, each
//      summed by one thread in a fixed order; the head's state term of dB
//      goes to scratch. At the end one thread scans dcum into dda;
//   3. head sums (two launches): dCB and the state term of dB summed over
//      the group's heads in head order, one thread an element (the causal
//      tiles are the ones read later), into scratch;
//   4. group: two blocks per (b*z, group, 64-row tile), one for dC's rows
//      and one for dB's: dC = dCB B, or dB = dCB^T C + the state term.
// No atomics: every sum runs in one fixed order, so repeat launches are
// bitwise equal (the training path runs with deterministic algorithms).
// The dCB_ij sum over heads (the mirror of the forward's C B^T shared by
// a group's heads) runs in kernel 3, not across the head blocks.
//
// Products run on the CUDA cores in fp32: each thread owns a 4 x 4 (or
// 4 x 8) tile, rows ty + 16 m, columns tx + 16 n of a 16 x 16 thread grid,
// reading both operands from shared memory (rows padded to odd strides, so
// that column reads hit distinct banks). The select acts on the exponent
// (exp(-inf) = 0): exp(cum_i - cum_j) overflows above the diagonal at full
// width. S's diagonal is left out of dcum, where its two terms cancel.
//
// Bound. Per (b, z), with T = Q (Q + 1) / 2 causal pairs: C B^T, dC and dB
// G T N multiply-adds each, gW and W^T gy H T P each, the two state
// products H Q N P each; at the training shape (Q = 256, P = 64, N = 128,
// H = 32, G = 1) ~4.6 GFLOP against ~63 MB for B = 4, NC = 2: bound by the
// operations at the fp32 CUDA-core rate (chip_smoke.py phase 14 prints
// both). Left for later: the tensor cores (the forward's 3xTF32
// mma.sync), cp.async staging, and the scratch round trip of dCB.
//
// Limits (the Python wrapper checks them): 1 <= Q <= 256, 1 <= P <= 64,
// 1 <= N <= 128, H % G == 0. Sums run in another order than the plain
// version; the tolerance the port holds the kernel to is stated in
// repro_torch/kernels/checks.py (SSD_BWD_TOL).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // a 16 x 16 grid
constexpr int kTile = 64;         // rows / columns of a chunk tile
constexpr int kMaxQ = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kLdP = kMaxP + 1;   // rows of P floats: X and gy tiles
constexpr int kLdN = kMaxN + 1;   // rows of N floats: B and C tiles, gst
constexpr int kLdT = kTile + 1;   // 64 x 64 tiles
constexpr int kLdR = 17;          // row partials over the 16 thread columns

// shared memory of each kernel, in floats
constexpr int kCbFloats = 2 * kTile * kLdN;
constexpr int kHeadVec = 7 * kMaxQ;   // cum, dt, E, row / column sums, ddt part, r
constexpr int kHeadFloats = kHeadVec + kMaxP * kLdN + 2 * kTile * kLdP + kTile * kLdN
                            + kTile * kLdT + kTile * kLdR + 2 * 16 * kTile;
constexpr int kGroupFloats = kTile * kLdT + kTile * kLdN;

// Copy rows [r0, r0 + kTile) of a row-major matrix in global memory (row
// stride ld_g floats, `valid` floats a row, `nrows` rows) into shared rows
// of `width` floats (stride ld_s); rows >= nrows and columns >= valid are
// zero-filled.
__device__ __forceinline__ void stage(float* dst, int ld_s, const float* src, size_t ld_g,
                                      int r0, int rows, int nrows, int valid, int width) {
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    const int r = e / width, c = e % width;
    const int gr = r0 + r;
    dst[r * ld_s + c] = gr < nrows && c < valid ? src[(size_t)gr * ld_g + c] : 0.f;
  }
}

// acc[m][n] += sum_{k < K} A(ty + 16 m, k) B(k, tx + 16 n), with
// A(r, k) = a[r * ar + k * ak] and B(k, c) = b[k * bk + c * bc], in k order
template <int TM, int TN>
__device__ __forceinline__ void mm_acc(float (&acc)[TM][TN], const float* a, int ar, int ak,
                                       const float* b, int bk, int bc, int K, int ty, int tx) {
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int m = 0; m < TM; ++m) av[m] = a[(ty + 16 * m) * ar + k * ak];
#pragma unroll
    for (int n = 0; n < TN; ++n) bv[n] = b[k * bk + (tx + 16 * n) * bc];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;
}

// ---- 1. C B^T per (b*z, group) on the causal tiles ---------------------------
// block (bz, g, it): rows it of CB (qp x qp, qp = tiles * 64), columns jt <= it
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ cb, int Q, int G, int N, int ntiles) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Cs = smem;                   // [kTile][kLdN]
  float* Bs = Cs + kTile * kLdN;      // [kTile][kLdN]
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int it = blockIdx.x % ntiles;
  const int u = blockIdx.x / ntiles;
  const int g = u % G;
  const size_t bz = u / G;
  const int qp = ntiles * kTile;
  const size_t sb = (size_t)G * N;
  const float* bg = bm + bz * Q * sb + (size_t)g * N;
  const float* cg = cm + bz * Q * sb + (size_t)g * N;
  float* out = cb + (bz * G + g) * qp * qp;

  stage(Cs, kLdN, cg, sb, it * kTile, kTile, Q, N, N);
  for (int jt = 0; jt <= it; ++jt) {
    __syncthreads();   // the previous B tile is no longer read
    stage(Bs, kLdN, bg, sb, jt * kTile, kTile, Q, N, N);
    __syncthreads();
    float acc[4][4];
    zero(acc);
    mm_acc<4, 4>(acc, Cs, kLdN, 1, Bs, 1, kLdN, N, ty, tx);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        out[(size_t)(it * kTile + ty + 16 * m) * qp + jt * kTile + tx + 16 * n] = acc[m][n];
  }
}

// ---- 2. per (b*z, head) -------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ssd_bwd_head_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ da, const float* __restrict__ bm,
                    const float* __restrict__ gy, const float* __restrict__ gst,
                    const float* __restrict__ cb, float* __restrict__ dcb,
                    float* __restrict__ dbs, float* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ dda,
                    int Q, int H, int P, int G, int N, int ntiles) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* cum = smem;                    // [kMaxQ] cumsum(da), later dcum
  float* dts = cum + kMaxQ;             // [kMaxQ] dt
  float* ev = dts + kMaxQ;              // [kMaxQ] E
  float* rows = ev + kMaxQ;             // [kMaxQ] sum_{j < i} S_ij
  float* cols = rows + kMaxQ;           // [kMaxQ] sum_{k > j} S_kj
  float* ddtc = cols + kMaxQ;           // [kMaxQ] sum_i gW_ij CB_ij L_ij
  float* rj = ddtc + kMaxQ;             // [kMaxQ] r_j
  float* gsts = smem + kHeadVec;        // [kMaxP][kLdN] gst
  float* xs = gsts + kMaxP * kLdN;      // [kTile][kLdP] X_j
  float* gys = xs + kTile * kLdP;       // [kTile][kLdP] gy_i
  float* bs = gys + kTile * kLdP;       // [kTile][kLdN] B_j
  float* ws = bs + kTile * kLdN;        // [kTile][kLdT] W tile
  float* redr = ws + kTile * kLdT;      // [kTile][kLdR] row partials
  float* redc = redr + kTile * kLdR;    // [2][16][kTile] column partials

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int h = blockIdx.x % H;
  const size_t bz = blockIdx.x / H;
  const int g = h / (H / G);
  const int qp = ntiles * kTile;
  const size_t sx = (size_t)H * P;
  const size_t sb = (size_t)G * N;
  const float* xh = x + bz * Q * sx + (size_t)h * P;
  const float* gyh = gy + bz * Q * sx + (size_t)h * P;
  const float* bg = bm + bz * Q * sb + (size_t)g * N;
  const float* cbg = cb + (bz * G + g) * qp * qp;
  float* dcbh = dcb + (bz * H + h) * qp * qp;
  float* dbsh = dbs + (bz * H + h) * qp * N;
  const float neg_inf = __int_as_float(0xff800000);

  for (int t = tid; t < kMaxQ; t += kThreads) {
    const bool ok = t < Q;
    dts[t] = ok ? dt[(bz * Q + t) * H + h] : 0.f;
    cum[t] = ok ? da[(bz * Q + t) * H + h] : 0.f;
    rows[t] = cols[t] = ddtc[t] = rj[t] = 0.f;
  }
  stage(gsts, kLdN, gst + (bz * H + h) * P * N, N, 0, kMaxP, P, N, kMaxN);
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int t = 0; t < Q; ++t) {
      run += cum[t];
      cum[t] = run;
    }
  }
  __syncthreads();
  for (int t = tid; t < kMaxQ; t += kThreads) ev[t] = t < Q ? expf(cum[Q - 1] - cum[t]) : 0.f;
  __syncthreads();

  for (int jt = 0; jt < ntiles; ++jt) {
    const int j0 = jt * kTile;
    stage(xs, kLdP, xh, sx, j0, kTile, Q, P, kMaxP);
    stage(bs, kLdN, bg, sb, j0, kTile, Q, N, kMaxN);
    __syncthreads();

    // the state term: u_j = gst B_j (rows j, columns p), dX_j = decay_j u_j,
    // r_j = X_j . u_j; dB's part decay_j X_j gst to scratch
    float acc[4][4];
    {
      float u[4][4];
      zero(u);
      mm_acc<4, 4>(u, bs, kLdN, 1, gsts, 1, kLdN, N, ty, tx);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int jl = ty + 16 * m;
        const float dec = ev[j0 + jl] * dts[j0 + jl];
        float part = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          part = fmaf(xs[jl * kLdP + tx + 16 * n], u[m][n], part);
          acc[m][n] = dec * u[m][n];
        }
        redr[jl * kLdR + tx] = part;
      }
    }
    {
      float v[4][8];
      zero(v);
      mm_acc<4, 8>(v, xs, kLdP, 1, gsts, kLdN, 1, P, ty, tx);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int jl = ty + 16 * m;
        const float dec = ev[j0 + jl] * dts[j0 + jl];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int nn = tx + 16 * n;
          if (nn < N) dbsh[(size_t)(j0 + jl) * N + nn] = dec * v[m][n];
        }
      }
    }
    __syncthreads();
    if (tid < kTile) {
      float r = 0.f;
      for (int t = 0; t < 16; ++t) r += redr[tid * kLdR + t];
      rj[j0 + tid] = r;
    }

    for (int it = jt; it < ntiles; ++it) {
      const int i0 = it * kTile;
      stage(gys, kLdP, gyh, sx, i0, kTile, Q, P, kMaxP);
      __syncthreads();   // gy_i has landed; redr's r partials are read
      float gw[4][4];
      zero(gw);
      mm_acc<4, 4>(gw, gys, kLdP, 1, xs, 1, kLdP, P, ty, tx);
      float rs[4] = {0.f, 0.f, 0.f, 0.f};
      float cs[4] = {0.f, 0.f, 0.f, 0.f};
      float cd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int il = ty + 16 * m, i = i0 + il;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int jl = tx + 16 * n, j = j0 + jl;
          const bool ok = j <= i && i < Q;
          const float lij = expf(ok ? cum[i] - cum[j] : neg_inf);
          const float cbv = cbg[(size_t)i * qp + j];
          const float dtj = dts[j];
          const float gl = gw[m][n] * lij;
          dcbh[(size_t)i * qp + j] = gl * dtj;
          ws[il * kLdT + jl] = cbv * lij * dtj;
          const float gc = gl * cbv;
          const float sv = j < i ? gc * dtj : 0.f;
          rs[m] += sv;
          cs[n] += sv;
          cd[n] += gc;
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) redr[(ty + 16 * m) * kLdR + tx] = rs[m];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        redc[ty * kTile + tx + 16 * n] = cd[n];
        redc[16 * kTile + ty * kTile + tx + 16 * n] = cs[n];
      }
      __syncthreads();
      if (tid < kTile) {
        float s = 0.f;
        for (int t = 0; t < 16; ++t) s += redr[tid * kLdR + t];
        rows[i0 + tid] += s;
      } else if (tid < 2 * kTile) {
        const int c = tid - kTile;
        float s = 0.f;
        for (int t = 0; t < 16; ++t) s += redc[t * kTile + c];
        ddtc[j0 + c] += s;
      } else if (tid < 3 * kTile) {
        const int c = tid - 2 * kTile;
        float s = 0.f;
        for (int t = 0; t < 16; ++t) s += redc[16 * kTile + t * kTile + c];
        cols[j0 + c] += s;
      }
      // dX_j += W^T gy_i: A(j, i) = ws[i][j], B(i, p) = gy_i[i][p]
      mm_acc<4, 4>(acc, ws, 1, kLdT, gys, kLdP, 1, kTile, ty, tx);
      __syncthreads();   // ws, gys and the partials are free again
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = j0 + ty + 16 * m;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int p = tx + 16 * n;
        if (j < Q && p < P) dx[(bz * Q + j) * sx + (size_t)h * P + p] = acc[m][n];
      }
    }
  }

  // ddt and dcum (into cum), then dda = the reverse cumsum of dcum
  __syncthreads();
  for (int t = tid; t < Q; t += kThreads) {
    const float er = ev[t] * rj[t];       // E_t r_t
    ddt[(bz * Q + t) * H + h] = ddtc[t] + er;
    const float rt = dts[t] * er;         // R_t = decay_t r_t
    ddtc[t] = rt;
    cum[t] = rows[t] - cols[t] - rt;
  }
  __syncthreads();
  if (tid == 0) {
    float sr = 0.f;
    for (int t = 0; t < Q; ++t) sr += ddtc[t];
    cum[Q - 1] += sr;
    float run = 0.f;
    for (int t = Q - 1; t >= 0; --t) {
      run += cum[t];
      dda[(bz * Q + t) * H + h] = run;
    }
  }
}

// ---- 3. sums over the heads of each group ---------------------------------------
// dst[bz, g, e] = sum over hh < H/G, in head order, of src[bz, g H/G + hh, e],
// e < L: one thread an element, consecutive threads on consecutive e
__global__ void __launch_bounds__(kThreads)
ssd_bwd_head_sum_kernel(const float* __restrict__ src, float* __restrict__ dst, int H, int G,
                        long long L, long long total) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long e = idx % L;
  const long long bg = idx / L;             // bz * G + g
  const int hpg = H / G;
  const float* p = src + ((bg / G) * H + (bg % G) * hpg) * L + e;
  float s = 0.f;
#pragma unroll 8
  for (int hh = 0; hh < hpg; ++hh) s += p[hh * L];
  dst[idx] = s;
}

// ---- 4. per (b*z, group, 64-row tile, role) ------------------------------------
// from the group's summed dCB and state term: role 0, dC rows i of tile t,
// sum_{j <= i} dCB_ij B_j; role 1, dB rows j of tile t, sum_{i >= j} dCB_ij
// C_i plus the state term
__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                     const float* __restrict__ dcb, const float* __restrict__ dbs,
                     float* __restrict__ db, float* __restrict__ dc,
                     int Q, int G, int N, int ntiles) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ds = smem;                     // [kTile][kLdT] a tile of dCB
  float* ops = ds + kTile * kLdT;       // [kTile][kLdN] B_j or C_i
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const bool is_db = blockIdx.x % 2;
  const int t = (blockIdx.x / 2) % ntiles;
  const int u = blockIdx.x / 2 / ntiles;
  const int g = u % G;
  const size_t bz = u / G;
  const int qp = ntiles * kTile;
  const size_t sb = (size_t)G * N;
  const float* dcbg = dcb + (bz * G + g) * qp * qp;
  const float* dbsg = dbs + (bz * G + g) * qp * N;
  const float* opg = (is_db ? cm : bm) + bz * Q * sb + (size_t)g * N;
  float* out = (is_db ? db : dc) + bz * Q * sb + (size_t)g * N;

  float acc[4][8];
  zero(acc);
  const int k0 = is_db ? t : 0, k1 = is_db ? ntiles - 1 : t;
  for (int kt = k0; kt <= k1; ++kt) {
    __syncthreads();   // the previous tiles are no longer read
    // dCB's tile (t, kt) for dC, (kt, t) for dB
    const int ti = is_db ? kt : t, tj = is_db ? t : kt;
    stage(ds, kLdT, dcbg + (size_t)ti * kTile * qp + tj * kTile, qp, 0, kTile, kTile, kTile,
          kTile);
    stage(ops, kLdN, opg, sb, kt * kTile, kTile, Q, N, kMaxN);
    __syncthreads();
    if (is_db)   // A(j, i) = dCB_ij
      mm_acc<4, 8>(acc, ds, 1, kLdT, ops, kLdN, 1, kTile, ty, tx);
    else         // A(i, j) = dCB_ij
      mm_acc<4, 8>(acc, ds, kLdT, 1, ops, kLdN, 1, kTile, ty, tx);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = t * kTile + ty + 16 * m;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int nn = tx + 16 * n;
      if (r < Q && nn < N)
        out[(size_t)r * sb + nn] = acc[m][n] + (is_db ? dbsg[(size_t)r * N + nn] : 0.f);
    }
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// x, gy, dx: (bnc, q, h, p); dt, da, ddt, dda: (bnc, q, h); b, c, db, dc:
// (bnc, q, g, n); gst: (bnc, h, p, n); scratch: cb (bnc, g, qp, qp), dcb
// (bnc, h, qp, qp), dbs (bnc, h, qp, n), dbsum (bnc, g, qp, n) with qp = 64
// ceil(q / 64); all fp32,
// contiguous; bnc = batch * chunks. Returns the CUDA error of the launches
// (0 on success), or cudaErrorInvalidValue for arguments outside the
// kernels' limits.
int repro_ssd_chunk_bwd(const void* x, const void* dt, const void* da, const void* b,
                        const void* c, const void* gy, const void* gst, void* dx,
                        void* ddt, void* dda, void* db, void* dc, void* cb, void* dcb,
                        void* dbs, void* dbsum, long long bnc, int q, int h, int p, int g,
                        int n, void* stream) {
  if (bnc < 1 || q < 1 || q > kMaxQ || p < 1 || p > kMaxP || n < 1 || n > kMaxN ||
      g < 1 || h < 1 || h % g != 0)
    return (int)cudaErrorInvalidValue;
  const int ntiles = (q + kTile - 1) / kTile;
  const long long qp = (long long)ntiles * kTile;
  const long long sum_cb = bnc * g * qp * qp, sum_bs = bnc * g * qp * n;
  if (bnc * h > 0x7fffffffLL || bnc * g * ntiles * 2 > 0x7fffffffLL ||
      (sum_cb + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = set_smem((const void*)ssd_bwd_cb_kernel, sizeof(float) * kCbFloats);
    if (e == cudaSuccess)
      e = set_smem((const void*)ssd_bwd_head_kernel, sizeof(float) * kHeadFloats);
    if (e == cudaSuccess)
      e = set_smem((const void*)ssd_bwd_group_kernel, sizeof(float) * kGroupFloats);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  float* cbf = static_cast<float*>(cb);
  ssd_bwd_cb_kernel<<<(unsigned)(bnc * g * ntiles), kThreads, sizeof(float) * kCbFloats, s>>>(
      bf, cf, cbf, q, g, n, ntiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_head_kernel<<<(unsigned)(bnc * h), kThreads, sizeof(float) * kHeadFloats, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(da), bf, static_cast<const float*>(gy),
      static_cast<const float*>(gst), cbf, static_cast<float*>(dcb),
      static_cast<float*>(dbs), static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dda), q, h, p, g, n, ntiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the group sums: dCB into cb's scratch (C B^T is read no more), the state
  // term of dB into dbsum
  ssd_bwd_head_sum_kernel<<<(unsigned)((sum_cb + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const float*>(dcb), cbf, h, g, qp * qp, sum_cb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_head_sum_kernel<<<(unsigned)((sum_bs + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const float*>(dbs), static_cast<float*>(dbsum), h, g, qp * n, sum_bs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_group_kernel<<<(unsigned)(bnc * g * ntiles * 2), kThreads,
                         sizeof(float) * kGroupFloats, s>>>(
      bf, cf, cbf, static_cast<const float*>(dbsum), static_cast<float*>(db),
      static_cast<float*>(dc), q, g, n, ntiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
