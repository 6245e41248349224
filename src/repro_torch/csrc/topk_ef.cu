// Fused error feedback + block top-k, and plain block top-k, for Hopper
// (sm_90a), over a group of (rows, bc) views in one launch. Built with nvcc
// into a shared library with a plain C interface and loaded through ctypes
// (repro_torch/kernels/build.py).
//
// Replaces the TPU Pallas kernels
//   src/repro/kernels/topk_ef/topk_ef.py       _topk_ef_kernel   (EF = true)
//   src/repro/kernels/block_topk/block_topk.py _topk_tile_kernel (EF = false)
//
// Function, per row r of each (rows, bc) view:
//   g        = lr * grad + err            (two roundings, no FMA: the
//                                          Pallas source rounds twice)
//   repeat kb times: take the largest |g| among the entries not yet taken,
//   the LOWEST column among equal magnitudes, write the signed g and its
//   column, mark it taken
//   new_err  = taken ? 0 : g
// A row holding a NaN takes nothing: every pick is value 0 at column bc.
// The plain block top-k is the same selection on x, with no EF.
//
// Bound: bytes. The work per element is a few compares per round and
// kb <= 3 on the main path, so the kernel moves 12 bytes per element
// (read grad and err, write new_err) plus 8 bytes per pick. One cnn_cifar
// step at 10 workers hands it 37 views, 27.8 M elements: about 336 MB,
// 0.100 ms at 3.35 TB/s (block top-k: 4 bytes per element, 0.034 ms).
//
// Design against that bound (each choice timed on an H100 at the cnn_cifar
// encode's shapes; PERF.md):
//  - One launch for a whole group. The views are the segments of a table
//    passed by value as a __grid_constant__ parameter (kMaxSegments per
//    launch, 3,600 bytes: no host-to-device copy, and a CUDA graph can
//    capture the launch). A segment's rows are cut into work units, one
//    per warp-step, numbered in one range over all segments. One
//    instantiation covers up to VPL values per lane: VPL = 8 takes every
//    bc <= 256, so a cnn_cifar encode (bc in 10..256) is one launch; wider
//    rows go through VPL = 16 / 32 / 64 launches.
//  - Warps that stride over the units: warp w of W takes units w, w + W,
//    ..., so neighbouring warps stream neighbouring rows. The EF kernel
//    issues the loads of a warp's next unit before it runs the selection
//    of the current one (VPL <= 16); the EF-free kernel, bound by its
//    selection rather than its bytes, keeps the registers for more warps
//    instead. The grid is a few waves of the blocks that fit at once
//    (kWavesEF, kWavesSelect), which ran faster than one resident wave of
//    persistent warps (perhaps as SMs that stream faster take more blocks).
//  - Several rows per warp. A row takes L in {8, 16, 32} lanes, the fewest
//    that cover it (bc = 10: 16 lanes, two rows per warp; bc = 64 with
//    16-byte loads: 16 lanes), and each lane runs only the slots its
//    segment needs (Segment::slots: 1, 2, 4 or 8 under VPL = 8). Lanes of
//    a row past the segment's end still take part in every warp
//    instruction and only skip their loads and stores; the NaN test is a
//    ballot masked to the row's lanes.
//  - 16-byte loads and stores where bc % 4 == 0 and the segment's
//    pointers are 16-byte aligned (the planner, repro_torch/kernels/
//    topk_ef/topk_ef.py::plan_segments, decides per segment): lane l of a
//    row holds columns 4l..4l+3 of each 4L-column stripe. Otherwise one
//    column per lane per stripe of L (bc = 10, a view at an odd offset).
//    Either way a lane's slots run in ascending column order.
//  - A round of the selection is short. The key of a column is |g|'s bits
//    + 1 (ordered as |g|, since |g| >= 0), 0 when taken or outside the
//    row. A lane finds its best slot by a tree over its slots (the lower
//    slot, so the lower column, wins a tie); the row's lanes then take the
//    largest key and the lowest column holding it with two warp reductions
//    (redux.sync max and min, each row naming its own lanes): the
//    lowest-column tie-break of the reference. The winner's owner kept its
//    value in the tree, writes the pick and sets the slot's key to 0, so
//    new_err = key ? g : 0 needs no separate taken mask.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kMaxSegments = 64;
// Blocks per launch, in multiples of those resident at once (measured on an
// H100 at the cnn_cifar encode's shapes): the EF kernel streams 3 bytes for
// every byte the EF-free one reads and runs best at 8 waves; the EF-free
// one is bound by its selection and runs best at 2.
constexpr int kWavesEF = 8;
constexpr int kWavesSelect = 2;

// One (rows, bc) view. The layout is mirrored byte for byte by the Python
// planner (topk_ef.py: _SEGMENT, _TABLE_TAIL).
struct Segment {
  const float* x;         // grad (EF) or x, (rows, bc)
  const float* err;       // EF only, (rows, bc)
  float* new_err;         // EF only, (rows, bc)
  float* vals;            // (rows, kb)
  int32_t* idx;           // (rows, kb)
  int rows;
  int unit0;              // the segment's first work unit in the launch
  int16_t bc;             // 1..2048
  int16_t kb;             // 1..bc
  uint8_t lane_shift;     // L = 1 << lane_shift lanes per row: 3, 4 or 5
  uint8_t vec;            // 1: 16-byte loads and stores
  uint8_t slots;          // values per lane: 1, 2, 4 or 8, or the VPL above 8
};
static_assert(sizeof(Segment) == 56, "Segment layout");
static_assert(offsetof(Segment, rows) == 40 && offsetof(Segment, bc) == 48 &&
              offsetof(Segment, lane_shift) == 52 && offsetof(Segment, slots) == 54,
              "Segment layout");

struct Table {
  Segment seg[kMaxSegments];
  int nseg;
  int units;              // work units of all segments
  float lr;               // EF only
  int vpl;                // the instantiation: 8, 16, 32 or 64
};
static_assert(sizeof(Table) == 3600, "Table layout");
static_assert(offsetof(Table, nseg) == kMaxSegments * 56, "Table layout");

__device__ __forceinline__ int seg_end(const Table& t, int s) {
  return s + 1 < t.nseg ? t.seg[s + 1].unit0 : t.units;
}

// Column of slot s of lane li in a row of L = 1 << shift lanes.
template <bool VEC>
__device__ __forceinline__ int column(int s, int li, int shift) {
  return VEC ? ((s >> 2) << (shift + 2)) + 4 * li + (s & 3) : (s << shift) + li;
}

// Slots [0, NS) of the lane in one unit's row: raw x and err (EF), 0
// outside the row. NS is the segment's slot count (Segment::slots).
template <int NS, int VPL, bool EF, bool VEC>
__device__ __forceinline__ void load_unit(const Segment& sg, int unit, int lane,
                                          float (&x)[VPL], float (&e)[VPL]) {
  const int shift = sg.lane_shift;
  const int li = lane & ((1 << shift) - 1);
  const int row = unit * (kWarp >> shift) + (lane >> shift);
  const int bc = sg.bc;
  const bool active = row < sg.rows;
  const size_t base = (size_t)row * (size_t)bc;
  if (VEC) {
#pragma unroll
    for (int v = 0; v < NS / 4; ++v) {
      const int c = column<true>(4 * v, li, shift);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (active && c < bc) {
        a = __ldg(reinterpret_cast<const float4*>(sg.x + base + c));
        if (EF) b = __ldg(reinterpret_cast<const float4*>(sg.err + base + c));
      }
      x[4 * v] = a.x; x[4 * v + 1] = a.y; x[4 * v + 2] = a.z; x[4 * v + 3] = a.w;
      e[4 * v] = b.x; e[4 * v + 1] = b.y; e[4 * v + 2] = b.z; e[4 * v + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int c = column<false>(s, li, shift);
      const bool in = active && c < bc;
      x[s] = in ? __ldg(sg.x + base + c) : 0.0f;
      e[s] = (EF && in) ? __ldg(sg.err + base + c) : 0.0f;
    }
  }
}

// Selection and stores of one unit: every lane of the warp calls it (the
// row reductions name the row's lanes), lanes of an absent row write
// nothing.
template <int NS, int VPL, bool EF, bool VEC>
__device__ __forceinline__ void run_unit(const Segment& sg, int unit, int lane, float lr,
                                         const float (&x)[VPL], const float (&e)[VPL]) {
  const int shift = sg.lane_shift;
  const int lanes = 1 << shift;
  const int li = lane & (lanes - 1);
  const int grp = lane >> shift;
  const int row = unit * (kWarp >> shift) + grp;
  const int bc = sg.bc, kb = sg.kb;
  const bool active = row < sg.rows;

  // key: |g|'s bits + 1 for a column of the row (the order of |g|, as
  // |g| >= 0), 0 outside it; a taken column's key is set to 0
  float g[NS];
  unsigned key[NS];
  bool lane_nan = false;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    g[s] = EF ? __fadd_rn(__fmul_rn(lr, x[s]), e[s]) : x[s];
    lane_nan |= isnan(g[s]);   // slots outside the row hold 0
    key[s] = column<VEC>(s, li, shift) < bc ? (__float_as_uint(g[s]) & 0x7fffffffu) + 1u : 0u;
  }
  // A NaN makes the row's max NaN in the reference (jnp.max / amax
  // propagate it), so no entry equals the max: every round yields value 0
  // at column bc and nothing is taken. Per row: the ballot's bits of the
  // row's lanes only.
  const unsigned row_lanes = lanes == kWarp ? kFull : ((1u << lanes) - 1u) << (grp * lanes);
  const bool row_nan = (__ballot_sync(kFull, lane_nan) & row_lanes) != 0u;
  const bool live = active && !row_nan;
  const size_t obase = (size_t)row * (size_t)kb;
  if (active && row_nan) {
    for (int k = li; k < kb; k += lanes) {
      sg.vals[obase + k] = 0.0f;
      sg.idx[obase + k] = bc;
    }
  }

  for (int k = 0; k < kb; ++k) {   // kb is the same for the whole warp
    // lane-local best by a tree over the slots: on equal keys the lower
    // slot, which is the lower column, wins
    unsigned bk[NS];
    int bs[NS];
    float bv[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      bk[s] = key[s];
      bs[s] = s;
      bv[s] = g[s];
    }
#pragma unroll
    for (int w = 1; w < NS; w <<= 1) {
#pragma unroll
      for (int s = 0; s + w < NS; s += 2 * w) {
        if (bk[s + w] > bk[s]) {
          bk[s] = bk[s + w];
          bs[s] = bs[s + w];
          bv[s] = bv[s + w];
        }
      }
    }
    const int best_c = column<VEC>(bs[0], li, shift);
    // over the row's lanes: the largest key, then the lowest column
    // holding it (each row group names its own lanes)
    const unsigned wkey = __reduce_max_sync(row_lanes, bk[0]);
    const int wc = (int)__reduce_min_sync(row_lanes, bk[0] == wkey ? (unsigned)best_c : ~0u);
    // kb <= bc leaves an untaken column every round, so wkey > 0 and the
    // winner is a column of the row; its owner had it as its lane best
    const int owner = VEC ? (wc >> 2) & (lanes - 1) : wc & (lanes - 1);
    if (live && owner == li) {
      sg.vals[obase + k] = bv[0];
      sg.idx[obase + k] = wc;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (s == bs[0]) key[s] = 0u;
      }
    }
  }

  if (EF && active) {   // key 0 on a column of the row: taken
    const size_t base = (size_t)row * (size_t)bc;
    if (VEC) {
#pragma unroll
      for (int v = 0; v < NS / 4; ++v) {
        const int c = column<true>(4 * v, li, shift);
        if (c < bc) {
          float4 o;
          o.x = key[4 * v] ? g[4 * v] : 0.0f;
          o.y = key[4 * v + 1] ? g[4 * v + 1] : 0.0f;
          o.z = key[4 * v + 2] ? g[4 * v + 2] : 0.0f;
          o.w = key[4 * v + 3] ? g[4 * v + 3] : 0.0f;
          *reinterpret_cast<float4*>(sg.new_err + base + c) = o;
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int c = column<false>(s, li, shift);
        if (c < bc) sg.new_err[base + c] = key[s] ? g[s] : 0.0f;
      }
    }
  }
}

// The segment's instantiation: VPL = 8 takes 1, 2, 4 or 8 slots (4 or 8
// on the 16-byte path), the wider classes all VPL.
template <int VPL, bool EF>
__device__ __forceinline__ void load_any(const Segment& sg, int unit, int lane,
                                         float (&x)[VPL], float (&e)[VPL]) {
  if constexpr (VPL > 8) {
    if (sg.vec) load_unit<VPL, VPL, EF, true>(sg, unit, lane, x, e);
    else        load_unit<VPL, VPL, EF, false>(sg, unit, lane, x, e);
  } else {
    switch (sg.slots + sg.vec) {   // slots 4 / 8 with vec: 5 / 9
      case 9: load_unit<8, 8, EF, true>(sg, unit, lane, x, e); break;
      case 5: load_unit<4, 8, EF, true>(sg, unit, lane, x, e); break;
      case 8: load_unit<8, 8, EF, false>(sg, unit, lane, x, e); break;
      case 4: load_unit<4, 8, EF, false>(sg, unit, lane, x, e); break;
      case 2: load_unit<2, 8, EF, false>(sg, unit, lane, x, e); break;
      default: load_unit<1, 8, EF, false>(sg, unit, lane, x, e); break;
    }
  }
}

template <int VPL, bool EF>
__device__ __forceinline__ void run_any(const Segment& sg, int unit, int lane, float lr,
                                        const float (&x)[VPL], const float (&e)[VPL]) {
  if constexpr (VPL > 8) {
    if (sg.vec) run_unit<VPL, VPL, EF, true>(sg, unit, lane, lr, x, e);
    else        run_unit<VPL, VPL, EF, false>(sg, unit, lane, lr, x, e);
  } else {
    switch (sg.slots + sg.vec) {
      case 9: run_unit<8, 8, EF, true>(sg, unit, lane, lr, x, e); break;
      case 5: run_unit<4, 8, EF, true>(sg, unit, lane, lr, x, e); break;
      case 8: run_unit<8, 8, EF, false>(sg, unit, lane, lr, x, e); break;
      case 4: run_unit<4, 8, EF, false>(sg, unit, lane, lr, x, e); break;
      case 2: run_unit<2, 8, EF, false>(sg, unit, lane, lr, x, e); break;
      default: run_unit<1, 8, EF, false>(sg, unit, lane, lr, x, e); break;
    }
  }
}

template <int VPL, bool EF>
__global__ void __launch_bounds__(kThreads)
topk_group_kernel(__grid_constant__ const Table t) {
  constexpr bool kPrefetch = EF && VPL <= 16;
  const int lane = threadIdx.x % kWarp;
  const int stride = gridDim.x * kWarpsPerBlock;
  int u = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (u >= t.units) return;   // the whole warp
  int s = 0;
  while (u >= seg_end(t, s)) ++s;
  float x[VPL], e[VPL];
  if (kPrefetch) load_any<VPL, EF>(t.seg[s], u - t.seg[s].unit0, lane, x, e);
  for (;;) {
    if (!kPrefetch) load_any<VPL, EF>(t.seg[s], u - t.seg[s].unit0, lane, x, e);
    const int nu = u + stride;          // t.units + stride < 2^31 (wrapper)
    int ns = s;
    float nx[VPL], ne[VPL];
    if (kPrefetch && nu < t.units) {
      while (nu >= seg_end(t, ns)) ++ns;
      load_any<VPL, EF>(t.seg[ns], nu - t.seg[ns].unit0, lane, nx, ne);
    }
    run_any<VPL, EF>(t.seg[s], u - t.seg[s].unit0, lane, t.lr, x, e);
    if (nu >= t.units) break;
    if (!kPrefetch) {
      while (nu >= seg_end(t, ns)) ++ns;
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        x[i] = nx[i];
        e[i] = ne[i];
      }
    }
    u = nu;
    s = ns;
  }
}

template <int VPL, bool EF>
cudaError_t launch_vpl(const Table& t, cudaStream_t stream) {
  static int per_sm = 0;   // resident blocks per SM (the same on every H100)
  if (per_sm == 0) {
    const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, topk_group_kernel<VPL, EF>, kThreads, 0);
    if (rc != cudaSuccess) return rc;
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  const long long want = ((long long)t.units + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long fit = (long long)sms * per_sm * (EF ? kWavesEF : kWavesSelect);
  const unsigned blocks = (unsigned)(want < fit ? want : fit);
  topk_group_kernel<VPL, EF><<<blocks, kThreads, 0, stream>>>(t);
  return cudaGetLastError();
}

template <bool EF>
cudaError_t launch(const Table* t, cudaStream_t stream) {
  if (t->nseg < 1 || t->nseg > kMaxSegments || t->units < 1) return cudaErrorInvalidValue;
  switch (t->vpl) {
    case 8:  return launch_vpl<8, EF>(*t, stream);
    case 16: return launch_vpl<16, EF>(*t, stream);
    case 32: return launch_vpl<32, EF>(*t, stream);
    case 64: return launch_vpl<64, EF>(*t, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The table's size in bytes and its segment capacity, read by the Python
// wrapper when it loads the library to check that both sides agree.
int repro_topk_table_bytes(void) { return (int)sizeof(Table); }
int repro_topk_max_segments(void) { return kMaxSegments; }

// One launch over the table at `table` (host memory, copied into the
// kernel's parameters at the launch). The wrapper checks every view: fp32,
// contiguous, 1 <= kb <= bc <= 2048, rows and units within int32, pointers
// 16-byte aligned where vec is set. Returns cudaGetLastError() after the
// launch.
int repro_topk_ef_group(const void* table, void* stream) {
  return (int)launch<true>(static_cast<const Table*>(table), static_cast<cudaStream_t>(stream));
}

int repro_block_topk_group(const void* table, void* stream) {
  return (int)launch<false>(static_cast<const Table*>(table), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
