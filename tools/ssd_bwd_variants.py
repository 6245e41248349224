#!/usr/bin/env python3
"""Where the SSD chunk backward's time goes: variants of
``src/repro_torch/csrc/ssd_scan_bwd.cu``, built from this checkout into
``build/variants/<name>/`` and timed in turns with the checkout's own kernel
at the training shape of ``tools/ssd_bwd_times.py``, on one NVIDIA GPU.

    python3 tools/ssd_bwd_variants.py

Variants (each a copy of the tree with a few lines of the kernel source
replaced; none is part of the port):

- ``no_dx``: the walk skips its dX_j += W^T gy_i product;
- ``no_gw``: the walk skips its gW^T = X_j gy_i^T product (gW stays 0);
- ``prep_two_blocks``: prep with one head buffer and at most 128 registers
  a thread, so that two blocks share an SM;
- ``phases``: ``clock64()`` stamps around each phase of prep's state role
  and of the walk, summed over every warp's lane 0 (atomics into a
  ``__device__`` array read back through ``cudaMemcpyFromSymbol``); prints
  each phase's cycles per warp per block and its share.

The first three give wrong gradients and are timed only; ``phases`` gives
the kernel's results. Prints one JSON line per timing run (as
``tools/ssd_bwd_times.py``) and the phase table.
"""
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = "src/repro_torch/csrc/ssd_scan_bwd.cu"

VARIANTS = {
    "no_dx": [("        if (ic + 8 * kt + 7 < j0 + r0) continue;",
               "        if (ic + 8 * kt + 7 < j0 + r0 || Q > 0) continue;")],
    "no_gw": [("        if (k0 >= wp) break;\n        const float* xa = X + (r0 + gq) * kLdA + k0 + tq;",
               "        if (k0 >= wp || Q > 0) break;\n"
               "        const float* xa = X + (r0 + gq) * kLdA + k0 + tq;")],
    "prep_two_blocks": [
        ("constexpr int kPrepF = kHeadF + kNTileF + 2 * (kXTileF + kNTileF) + 2 * 2 * kTile + kOutF;",
         "constexpr int kPrepF = kHeadF + kNTileF + (kXTileF + kNTileF) + 2 * 2 * kTile + kOutF;"),
        ("__global__ void __launch_bounds__(kThreads, 1)\nssd_bwd_prep_kernel(",
         "__global__ void __launch_bounds__(kThreads, 2)\nssd_bwd_prep_kernel("),
        ("  float* red = buf + 2 * (kXTileF + kNTileF);", "  float* red = buf + (kXTileF + kNTileF);"),
        ("    float* xb = buf + (hl & 1) * (kXTileF + kNTileF);", "    float* xb = buf;"),
        ("""  for (int hl = 0; hl < nh; ++hl) {
    cp_wait<0>();
    __syncthreads();   // head hl has landed; head hl - 1's buffer and r halves are read
    if (hl == 0) {
      if (warp < nh) warp_cumsum(cum + warp * kMaxQ, Q, lane);
      __syncthreads();
    } else {
      flush_r(hl - 1);
    }
    if (hl + 1 < nh) stage_head(hl + 1);   // lands while head hl multiplies
    cp_commit();""", """  for (int hl = 0; hl < nh; ++hl) {
    if (hl > 0) {
      __syncthreads();
      stage_head(hl);
      cp_commit();
    }
    cp_wait<0>();
    __syncthreads();
    if (hl == 0) {
      if (warp < nh) warp_cumsum(cum + warp * kMaxQ, Q, lane);
      __syncthreads();
    } else {
      flush_r(hl - 1);
    }"""),
        ("    const float* xs = buf + (hl & 1) * (kXTileF + kNTileF);", "    const float* xs = buf;"),
    ],
}

PREP_PHASES = ["start: issue loads", "wait (cp.async)", "barrier", "scan / flush r",
               "stage next head", "u product", "dx state staging + r", "barrier + dx rows",
               "dbs product", "end: barrier + dbs rows"]
WALK_PHASES = ["start + scan", "wait (cp.async)", "barrier", "issue the ring's copies",
               "flush + prefetch + C B^T loads", "gW product", "elementwise", "dX product",
               "row sums", "column sums + tile sum", "dx rows + ddt", "block end"]


def _stamp(k):
    return f"    PT({k});\n"


PHASES = [
    ("struct Dims {", "__device__ unsigned long long g_prof[64];\n#define PT(k) do { if (lane == 0) "
     "{ long long _n = clock64(); pt[k] += _n - t_last; t_last = _n; } } while (0)\n"
     "struct Dims {"),
    # prep's state role
    ("  const bool dbs_on = 64 * wg < N;            // this warpgroup's columns of dB's state term\n",
     "  const bool dbs_on = 64 * wg < N;            // this warpgroup's columns of dB's state term\n"
     "  long long pt[12] = {0}; long long t_last = clock64();\n"),
    ("  for (int hl = 0; hl < nh; ++hl) {\n    cp_wait<0>();\n    __syncthreads();",
     "  PT(0);\n  for (int hl = 0; hl < nh; ++hl) {\n    cp_wait<0>();\n    PT(1);\n"
     "    __syncthreads();\n    PT(2);"),
    ("    if (hl + 1 < nh) stage_head(hl + 1);   // lands while head hl multiplies\n    cp_commit();\n",
     "    PT(3);\n    if (hl + 1 < nh) stage_head(hl + 1);   // lands while head hl multiplies\n"
     "    cp_commit();\n    PT(4);\n"),
    ("    // dX_j's state term decay . u, staged for dx", _stamp(5) + "    // dX_j's state term decay . u, staged for dx"),
    ("    __syncthreads();   // the state term is staged", _stamp(6) + "    __syncthreads();   // the state term is staged"),
    ("    // dB's state term, summed over the slice's heads", _stamp(7) + "    // dB's state term, summed over the slice's heads"),
    ("  __syncthreads();   // the head buffers are read", "  PT(8);\n  __syncthreads();   // the head buffers are read"),
    ("  store_rows<kMaxN>(dbsp + (size_t)us * d.qp * N, N, j0, Q, N, buf, kLdN, vec_n);\n}",
     "  store_rows<kMaxN>(dbsp + (size_t)us * d.qp * N, N, j0, Q, N, buf, kLdN, vec_n);\n  PT(9);\n"
     "  if (lane == 0) {\n    for (int k = 0; k < 10; ++k) atomicAdd(&g_prof[k], (unsigned long long)pt[k]);\n"
     "    atomicAdd(&g_prof[10], 1ull);\n  }\n}"),
    # the walk
    ("  const float neg_inf = __int_as_float(0xff800000);\n\n  stage_heads(",
     "  const float neg_inf = __int_as_float(0xff800000);\n"
     "  long long pt[14] = {0}; long long t_last = clock64();\n\n  stage_heads("),
    ("  if (warp < nh) warp_cumsum(cum + warp * kMaxQ, Q, lane);\n\n  const int ja",
     "  if (warp < nh) warp_cumsum(cum + warp * kMaxQ, Q, lane);\n  PT(0);\n\n  const int ja"),
    ("    cp_wait<kStages - 2>();\n    __syncthreads();", "    cp_wait<kStages - 2>();\n    PT(1);\n"
     "    __syncthreads();\n    PT(2);"),
    ("    issue(item + kStages - 1);\n", "    issue(item + kStages - 1);\n    PT(3);\n"),
    ("      // gW^T = X_j gy_i^T: rows j, columns i", "      PT(4);\n      // gW^T = X_j gy_i^T: rows j, columns i"),
    ("      // elementwise, in fp32", "      PT(5);\n      // elementwise, in fp32"),
    ("      // dX_j += W^T gy_i over this warp's", "      PT(6);\n      // dX_j += W^T gy_i over this warp's"),
    ("    // the row sums of S over this warp's 16 rows", "    PT(7);\n    // the row sums of S over this warp's 16 rows"),
    ("    if (t == per - 1) {\n      // the head's last tile", "    PT(8);\n    if (t == per - 1) {\n"
     "      // the head's last tile"),
    ("      float* dxh = dx + row0 * sx + (size_t)(h0 + hl) * P;\n      if (vec_x) {\n#pragma unroll\n"
     "        for (int k = 0; k < 4; ++k) {\n          const int e = tid + k * kThreads, r = e / (kMaxP / 4), "
     "c = (e % (kMaxP / 4)) * 4;\n          if (j0 + r < Q && c < P) {",
     "      PT(9);\n      float* dxh = dx + row0 * sx + (size_t)(h0 + hl) * P;\n      if (vec_x) {\n"
     "#pragma unroll\n        for (int k = 0; k < 4; ++k) {\n          const int e = tid + k * kThreads, "
     "r = e / (kMaxP / 4), c = (e % (kMaxP / 4)) * 4;\n          if (j0 + r < Q && c < P) {"),
    ("        aux[(hq * 2 + 1) * d.qp + j] = big_r;\n      }\n    }\n  }",
     "        aux[(hq * 2 + 1) * d.qp + j] = big_r;\n      }\n      PT(10);\n    }\n  }"),
    ("          *reinterpret_cast<const float4*>(s + r * kLdT + c);\n    }\n  }\n}",
     "          *reinterpret_cast<const float4*>(s + r * kLdT + c);\n    }\n  }\n  PT(11);\n"
     "  if (lane == 0) {\n    for (int k = 0; k < 12; ++k) atomicAdd(&g_prof[32 + k], "
     "(unsigned long long)pt[k]);\n    atomicAdd(&g_prof[45], 1ull);\n  }\n}"),
    ('extern "C" {\n', 'extern "C" {\n\nint repro_prof_read(unsigned long long* host) {\n'
     "  return (int)cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));\n}\n"
     "int repro_prof_reset() {\n  unsigned long long z[64] = {0};\n"
     "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n"),
]


def make(name: str, patches) -> Path:
    """A copy of the checkout's sources and tools under build/variants/name,
    each (old, new) of ``patches`` replaced once in the kernel source."""
    tree = ROOT / "build" / "variants" / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "src", tree / "src", ignore=shutil.ignore_patterns("__pycache__"))
    text = (tree / SRC).read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the kernel source changed; no single match for {old!r}")
        text = text.replace(old, new)
    (tree / SRC).write_text(text)
    return tree


def phases(tree: Path) -> None:
    """Run the instrumented kernel at the training shape and print each
    phase's cycles per warp per block (every warp's lane 0, 20 launches)."""
    code = f"""
import ctypes, sys
sys.path.insert(0, {str(tree / 'src')!r})
import torch
from repro_torch.kernels import checks
from repro_torch.kernels.ssd_scan import ssd_scan_bwd as W
lib = W.library()
case = checks.SsdCase("train", 4, 512, 32, 64, 1, 128, 256, "model")
ins = checks.ssd_bwd_inputs(case, "cuda")
for _ in range(3):
    W.ssd_chunk_bwd_cuda(*ins)
torch.cuda.synchronize()
lib.repro_prof_reset()
for _ in range(20):
    W.ssd_chunk_bwd_cuda(*ins)
torch.cuda.synchronize()
buf = (ctypes.c_ulonglong * 64)()
lib.repro_prof_read(buf)
print(list(buf))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    v = json.loads(out.stdout.strip().splitlines()[-1])
    for what, names, base, count in (("prep (state role)", PREP_PHASES, 0, 10),
                                     ("walk", WALK_PHASES, 32, 45)):
        warps = v[count]
        total = sum(v[base:base + len(names)])
        print(f"{what}: {total / warps:.0f} cycles per warp per block", flush=True)
        for k, name in enumerate(names):
            print(f"  {name:32s} {v[base + k] / warps:8.0f}  {100 * v[base + k] / total:5.1f}%",
                  flush=True)


def main() -> int:
    times = [sys.executable, str(ROOT / "tools" / "ssd_bwd_times.py"), "--evals", "10", "--tree"]
    trees = {name: make(name, patches) for name, patches in VARIANTS.items()}
    order = [ROOT] + list(trees.values()) + list(reversed(trees.values())) + [ROOT]
    for tree in order:
        subprocess.run(times + [str(tree)], check=True)
    phases(make("phases", PHASES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
