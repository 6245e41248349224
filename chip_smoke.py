#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each on lines of its own:

  1. environment: the card, its power limit, torch and CUDA versions;
  2. build: nvcc builds the port's kernels from ``src/repro_torch/csrc``
     (the top-k kernels, the SSD chunk kernel and its backward), one nvcc
     per source, all at once, and prints ptxas's registers /
     shared memory / spills; ``cuobjdump -sass`` of the SSD libraries must
     show tensor-core MMAs (HMMA) in the SSD entry and in each of the
     backward's kernels with products (prep, walk, group);
  3. every kernel against its plain PyTorch version on the card: the
     top-k kernels bitwise at the training path's shapes and at the edges
     (ties, zeros, bc up to 2048, kb = bc, lr != 1), one view at a time and
     as groups of views in one launch (whole cnn_cifar / fc_mnist encodes,
     NaN rows sharing a warp, ragged rows, more than 64 segments, views at
     an odd offset); the SSD chunk kernel
     within ``checks.SSD_TOL`` at the JAX package's test shapes, the
     serving slice's shape and the edges, alone and inside
     ``ssd_chunked`` with and without an initial state;
  4. the training path: cnn_cifar at full width, SASG, 10 workers x 10
     samples, lr 0.02, 20 steps through ``repro_torch.launch.train``, with
     the kernel launches counted (one grouped launch of 37 segments per
     encode); then the same 20 steps with the kernel and
     with ``topk_impl="reference"`` in lockstep, held bitwise equal; then
     fc_mnist with sgd and lasg (the identity exchange);
  5. times: each top-k kernel per training step (one grouped launch over
     the 37 leaves) beside its bytes bound, its plain version and a library
     call, and per (bc, kb) class of leaves over enough input copies to
     exceed the L2; the step time and the peak memory;
  6. the serving path: mamba2_370m at full width (48 layers, bf16, random
     params from a seed) served by ``BatchedServer`` (4 slots, max_seq
     1024, prefill chunk 512: tick widths 512, 256 and 1) answering 8
     requests of 768 / 300 / 256 / 40 prompt tokens and 16 new tokens,
     drained strictly, with the SSD kernel's launches counted (48 per
     prefill tick); every tick replayed in lockstep through a second model
     on the SSD oracle, logits and SSD states held to stated tolerances;
     then a profile of a width-512 and a width-1 tick;
  7. times: the SSD kernel per width-512 prefill tick beside its bound
     (its route: 3xTF32 on the tensor cores; the fp32 CUDA-core bound is
     printed too) and its plain version; ms per tick of each width,
     decode tokens/s, peak memory.

Between the training options and serving, two more phases:

  8. the paper's tables through ``repro_torch.benchmarks``: Table 1;
     Table 2 on fc_mnist (300 steps, the four algorithms, top-k through
     the kernel, one launch per encode counted) with Sparse and SASG
     stepped again by a simulator with the reference's selection
     (``topk_impl="sharded"``) and held bitwise; Table 2 on cnn_cifar at
     full width over 200 of its 400 steps (``TABLE2_CNN_STEPS``); Table 3
     with the card's auxiliary-gradient time; ``hit_target``, the uploads
     SASG and LASG skipped, and the paper's two assertions per model,
     checked as the reference checks them (they fail the run; not
     checked, and said so, when SASG misses its target); ms per simulator
     step;
  9. workers as processes: phase 4's run, built by the launcher's
     ``build_trainer`` in each rank of a spawned group, as 2 gloo
     processes x 5 workers sharing the card and as 1 NCCL process x 10
     workers, held to phase 4's stacked run (sends and counters exactly,
     params bitwise or, where the split gradients are not, within 2e-2),
     each rank's launches counted, ms per step.

Then the dense-attention slice:

 10. dense-attention serving: llama3_8b at full width and depth (32
     layers, bf16, 16.06 GB of params from a seed) served by
     ``BatchedServer`` on the dense KV cache (4 slots, max_seq 1024,
     prefill chunk 256, ``paged=False``) answering phase 6's 8 requests,
     drained strictly; init seconds, ms per tick of each width beside the
     tick's bytes bound and bf16 products bound (fp32 attention products
     on a line of their own), decode tokens/s, peak memory, KV-cache
     bytes; a profile of a width-256 and a width-1 tick; cuBLAS's bf16
     reduced-precision reduction on vs off; then each of the five dense
     archs at full width, 2 layers, fp32, its engine on the card against
     the same engine on the CPU (tokens equal, logits within
     ``FP32_CARD_TOL`` of max|logits|);
 11. training a reduced llama3_8b with SASG, 4 workers x 2 sequences of
     64 tokens, 10 steps, through ``repro_torch.launch.train``: one
     grouped EF + top-k launch per encode over the LM's 12 leaves,
     counted, counters exact; then kernel vs ``topk_impl="reference"`` in
     lockstep, bitwise.

Then the paged KV cache and the MoE / sliding-window layers:

 12. (a) llama3_8b at full width and depth (bf16) served from the paged
     KV cache (block 16, the dense-equivalent pool of 256 blocks) with
     phase 10's stream: tick plans and tokens equal to phase 10's dense
     run and every tick's logits bitwise equal; ms per tick of each width
     beside the dense run's, the block high-water and its bytes against
     the dense bytes, peak memory; (b) the same stream from a 64-block
     pool: requests wait for blocks, tokens equal the dense run's, every
     block comes back, the peak memory falls; (c) the bf16 cache codec on
     a 2-layer fp32 llama3_8b at full width, held to its fp32-block chain
     within ``CODEC_TOL``; (d) reduced mixtral_8x7b (sliding window, dense
     ring) and kimi_k2 (paged, MoE + a shared expert), then mixtral_8x7b
     at full width, 2 layers, fp32: the router's top-k picks, tokens and
     every tick's logits of the card's engine against the CPU's; (e)
     reduced mixtral_8x7b trained with SASG as phase 11 (its expert
     leaves through the grouped EF + top-k launch), kernel ==
     ``topk_impl="reference"`` bitwise.

Then the RG-LRU hybrid and the encoder-decoder:

 13. (a) recurrentgemma_9b at full width and depth (38 layers, bf16,
     10.4 B params from a seed) served by ``BatchedServer`` on the dense
     cache (RG-LRU states and local-attention rings: nothing to page) with
     phase 10's stream; init seconds, ms per tick of each width beside its
     bytes bound and its operations bound (bf16 products plus the fp32 gate
     products), decode tokens/s, peak memory, the cache's bytes, a profile
     of a width-256 and a width-1 tick; (b) one unit of it (3 layers) at
     full width in fp32: the card's engine against the CPU's, and on the
     card the chained prefill + decode against the full forward; (c)
     seamless_m4t_v2 at full width and depth (24 + 24 layers), 4 rows of
     512 seeded frames, 64-token prompts, 16 greedy tokens generated
     through ``init_cache`` with the encoder's cross K/V, every step's
     logits against a teacher-forced decode, in fp32 and in bf16 (encode
     ms, ms per decode step beside its bytes bound, peak memory), then 2 +
     2 layers in fp32, the card against the CPU; (d) reduced
     recurrentgemma_9b trained with SASG as phase 11, kernel ==
     ``topk_impl="reference"`` bitwise.

Then training the Mamba-2 stack through the SSD kernels:

 14. (a) the SSD chunk kernel's backward against its plain version on
     every case of phase 3 within ``checks.SSD_BWD_TOL``, a second launch
     bitwise equal to the first; (b) mamba2_370m at full width, 4 layers,
     fp32: the SASG step's per-worker gradients (4 workers x 1 x 512
     tokens, under ``torch.func.vmap``) through both SSD kernels against
     the oracle under autograd, every leaf within ``SSD_GRAD_TOL``, one
     forward and one backward launch per layer; (c) mamba2_370m at full
     width and depth (48 layers, bf16) trained with SASG, 4 workers x 1
     sequence of 512 tokens, 4 steps through ``repro_torch.launch.train``:
     loss finite, counters exact, the SSD forward and backward launches (48
     x 2 gradient evaluations a step) and the grouped top-k launches
     counted, ms per step and peak memory; (d) reduced mamba2_370m trained
     with SASG as phase 11, kernel == ``topk_impl="reference"`` bitwise with
     the SSD kernels in both runs; then the backward's time per gradient
     evaluation of (c) (48 launches) beside its 3xTF32 bound (the fp32
     CUDA-core bound on a line of its own), its plain version, its head
     slice and its blocks per launch.

  15. strategies and sharding (slices 12 and 16): phase 4's run (cnn_cifar
     at full width, SASG, 10 workers, 20 steps) through ``--mesh-shape``:
     (a) a stacked (10, 2) mesh in one process, whose exchange takes the
     TP block geometry (1,477,664 bits per upload, the JAX package's
     number at model = 2, which ``tests/test_torch_strategy.py`` holds on
     the CPU), one grouped top-k launch per encode with its segment count,
     the kernel path == ``topk_impl="reference"`` bitwise; (b) 2 gloo ranks
     on cuda:0 as a (1, 2) device mesh, each holding half of every
     TP-sharded leaf, computing its gradients on its own shards
     (``tp_compute=sharded``, ``dist.tensor_parallel``) and launching the
     top-k kernel on them: sends, rounds and bits == (a)'s on both ranks,
     params within ``MESH_PARAM_TOL`` of (a)'s, per-rank param + EF bytes
     against (a)'s, each rank's ms per step, peak and model-axis bytes of a
     step (wire log); (c) one NCCL rank as a (1, 1) device mesh == phase 4
     bitwise; (d) llama3_8b at full width, 2 layers, fp32, served by (b)'s
     two ranks as a tensor-parallel (1, 2) mesh (half the params and KV
     heads each) against the unsharded engine: tokens equal, every tick's
     logits within ``FP32_CARD_TOL`` of max|logits|; (e) the same
     llama3_8b cut trained with SASG over 2 gloo ranks as (1, 2), 2
     workers x 256 tokens, 3 steps, each rank on its shards: step 0's loss
     within ``TP_LM_LOSS_RTOL`` of the unsharded model's, counters equal on
     both ranks, one top-k launch per encode, each rank's ms per step, peak
     and model-axis bytes. With ``--parent DIR`` (a checkout of the parent
     commit, e.g. unpacked from ``git archive`` under ``build/``), (b) and
     (e) run on that tree too, in a process of this script's own
     (``--tp-cells DIR``), and its numbers (or its out-of-memory error)
     are printed beside this tree's. Then the recurrent layers' and the
     unsplit KV heads' tensor-parallel forms (slice 17), 2 gloo ranks on
     cuda:0 as (1, 2), each on its shards: (f) mamba2_370m at full width,
     ``SSD_GRAD_LAYERS`` layers, fp32, served with phase 6's prompts
     (768 / 300 / 256 / 40 tokens, 16 new each) at prefill chunk 256 and
     max_seq 1024 against the unsharded engine: tokens equal, every
     tick's logits within ``FP32_CARD_TOL`` of max|logits|, the SSD chunk
     kernel launched once per layer in every width-256 tick at H = 16 (the
     rank's heads); each rank's state bytes and ms per tick; (g)
     recurrentgemma_9b's one-unit fp32 cut (phase 13 (b)'s) served the
     same way with phase 10's fp32 prompts: the same gates, the single KV
     head whole in each rank's local cache, param bytes per rank and ms
     per tick; (h) mamba2_370m's (f) cut trained with SASG (per_shard
     topk_ef), 2 workers x 512 tokens, 3 steps: step 0's per-worker
     gradients on each rank's shards within ``SSD_GRAD_TOL`` of each
     leaf's max of the unsharded kernel path's (sliced by
     ``param_specs``), one SSD forward and one backward launch per layer
     per gradient evaluation at H = 16, step 0's loss within
     ``TP_LM_LOSS_RTOL`` of the unsharded model's, counters equal on both
     ranks, one top-k launch per encode, and the model-axis bytes of a
     step equal to ``TP_SSD_MODEL_BYTES`` (worked out from the shapes);
     ms per step and peak per rank. recurrentgemma_9b is trained over
     (1, 2) on the CPU only (``tests/test_torch_mesh.py``): its one-unit
     fp32 cut holds 2.7 B params, too many for two ranks on one card.
     Then the MoE and a vocabulary the axis does not divide (slice 18),
     one spawn of 2 gloo ranks on cuda:0 as (1, 2): (i) mixtral_8x7b at
     full width, ``FP32_CHECK_LAYERS`` layers, fp32 (3.16 B params),
     expert-parallel (4 of the 8 experts and the router's 4 columns a
     rank), served with phase 12 (d)'s prompts at chunk 32 against the
     unsharded engine: each rank's router picks (from the full
     probabilities) equal the unsharded engine's MoE call by MoE call,
     tokens equal, every tick's logits within ``FP32_CARD_TOL``; params
     per rank, ms per tick by width and the model axis's collectives per
     tick; (k) internvl2_2b at full width, ``FP32_CHECK_LAYERS`` layers,
     fp32, its vocabulary of 92,553 whole on each rank, served with phase
     10's fp32 prompts: the same gates; (j) mixtral_8x7b at full width, 1
     layer, fp32 (1.71 B params), SASG per_shard topk_ef, 1 worker x 512
     tokens, 3 steps: step 0's loss within ``TP_MOE_LOSS_RTOL`` of the
     unsharded model's (whose forward prints the choices dropped past
     capacity), counters equal on both ranks, one top-k launch per
     encode over the expert shards, the model-axis bytes of a step equal
     to ``TP_MOE_MODEL_BYTES``; ms per step and peak per rank (a rank out
     of memory fails the run, its peak printed).

Then remat and the pipeline (slice 13):

 16. (a) phase 14 (c)'s cell with ``--remat full`` (``dots`` runs as
     ``full``): loss finite, counters exact, params after the 4 steps
     bitwise 14 (c)'s (the recompute replays the same kernels on the same
     inputs), 48 SSD forward launches + 48 for the recompute and 48
     backward per gradient evaluation; ms per step and peak memory beside
     14 (c)'s; then one gradient evaluation of the cell with and without
     remat: the bytes held when the forward returns, the peak and the
     gradients' bytes, remat's first two below the run without it; (b) phase 4's cell over 2 stages (``--mesh-shape
     1,1 --stages 2``, 1F1B, identity ring) stacked in one process and as
     2 gloo ranks on cuda:0, one stage a rank: sends, rounds, bits and
     params bitwise between the two, one grouped top-k launch per encode on
     each rank's stage-local slice, step 0's loss within
     ``PIPE_LOSS_RTOL`` of phase 4's flat run and its per-worker gradients,
     pipelined and flat both in float64, within ``PIPE_F64_TOL`` of each
     leaf's max (the fp32 gap, against ``PIPE_GRAD_TOL``, printed); ms per
     step, each rank's resident trunk bytes; (c) (b)'s stacked run with
     the compressed ring (fp32 values, k 0.05, blocks of 256) and
     ``overlap=True``, every ring encode through the block_topk kernel
     held to its plain version bitwise, the stage traffic equal to
     ``PipelineCommModel``'s; one hop's ring encode timed beside its bound,
     its plain version and ``torch.topk``; (d) mamba2_370m at full width,
     4 layers, fp32, 2 stages, ``remat="full"``: 2 gloo ranks bitwise the
     stacked run, step 0's per-worker gradients within ``SSD_GRAD_TOL`` of
     the unpipelined step's.

Then elasticity and chaos (slice 14):

 17. (a) the elastic bench (``benchmarks/elastic_bench.py``: fc_mnist,
     the chaos matrix and 4 -> 2 -> 4 in-run, each cell within its
     bounds); (b) phase 4's cell through the launcher with ``--resize
     6:5,13:10``, stragglers at 5 and 9, ``--ckpt-every 4`` and a crash at
     7, whose restore point (step 4, 10 workers) comes before the shrink:
     the final state bitwise the same command without the crash, and
     bitwise three restart legs (10 workers to step 6, 5 to 13, 10 to 20,
     each restoring the one before and starting its worker state cold);
     counters exact against the per-step history; top-k launches and
     segments exact (one grouped launch of 37 segments per encode at both
     counts: one encode per executed step, replays included, and one per
     worker-state start); the kernel's plan cache grows by at most the two
     counts' plans; (c) ms per step at 10 and 5 workers, each resize from
     the event to the end of its step with the bytes allocated before, at
     the peak and after, the recovery latency and each checkpoint's bytes.

Then the analysis gate (slice 15):

 18. (a) ``python -m repro_torch.analysis --check`` on the card (its
     ``main``): the lint sweep of ``src/repro_torch`` against its baseline,
     the registry rule on CUDA tensors, the five audit cells (the bytes
     each step moves, from the comm seam's wire log, against
     ``comm/bits.py`` and ``PipelineCommModel``; the same bytes as on the
     CPU) and the bench gates over phase 17's elastic record; each cell's
     numbers on a line; (b) phase 4's cell, 5 steps under the wire log and
     5 without: params bitwise equal, every step's exchange bytes (M-1) x
     ``bits_wire`` / 8 and nothing d-sized, one topk_ef launch per encode,
     ms per step with and without the log beside the card; (c) phase 16
     (c)'s compressed ring, 2 steps under the log: ring bytes
     ``PipelineCommModel``'s, the stage gradient traffic k-sized and its
     gather ``pipeline_gather_bits``', one block_topk launch per ring
     encode; the stage axis's rows on lines of their own.

The ``kernels`` line's ``launches`` sums each kernel's counts over the
paths that drive it (phases 4, 6, 8, 9, 11, 12, 13, 14 (c), (d), 15, 16,
17 and 18 (b), (c): block_topk's are the ring encodes of phases 16 (c)
and 18 (c), its main path, and its times those of one hop's encode in
16 (c)), each counted from 0.

Prints a JSON line of the kernels, then, as the last line,
``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when
there is no CUDA device, no checkout around it, or any phase fails.
"""
import os

# deterministic cuBLAS, set before CUDA initialises (the lockstep run of
# phase 4 compares two runs bitwise)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TF32_OPS_PER_S = 494.7e12      # H100 SXM TF32 tensor cores, dense
TF32_PASSES = 3                # the SSD kernel's 3xTF32 route
WORKERS, PER_WORKER, LR, STEPS = 10, 10, 0.02, 20

# the serving slice
SERVE_ARCH = "mamba2_370m"
SERVE_BATCH, SERVE_MAX_SEQ, SERVE_PREFILL = 4, 1024, 512
SERVE_PROMPTS, SERVE_REQUESTS, SERVE_NEW = (768, 300, 256, 40), 8, 16
# Lockstep, kernel path vs oracle path, every tick, layer by layer: each
# layer of the oracle gets the kernel path's input and pre-tick state (the
# residual stream is teacher-forced). Held per layer:
#   - the layer's bf16 output within LAYER_ULPS bf16 ulps of its largest
#     magnitude: the two SSD results differ only by the order of fp32 sums
#     (~1e-6 relative), which moves a bf16 cast by at most one rounding
#     step, plus one more in the residual add;
#   - the new SSD state (fp32) within SSD_TOL of its largest magnitude, the
#     kernel checks' tolerance (same inputs, fp32 sums in other orders);
#   - the tick's logits from the oracle's last layer within LOGIT_ULPS bf16
#     ulps of their largest magnitude.
# The engine's own logits and states must equal the kernel path's replay
# bitwise (the same ops on the same inputs). The stream is teacher-forced
# because a free-running bf16 replay cannot be held to a few ulps: a
# random-init 48-layer stack amplifies the single bf16 rounding flips that
# any change of fp32 summation order causes into O(1) logit differences.
# That divergence is reported per tick, and the same free-running
# comparison in fp32, where no bf16 rounding flips, is held to
# FP32_FREE_TOL.
LAYER_ULPS = 2
LOGIT_ULPS = 4
FP32_FREE_TOL = 1e-2   # of max|logits|, fp32 kernel model vs fp32 oracle model


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around many calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of ``fn`` in ms without the host's launch overhead: ``fn``
    is captured once into a CUDA graph and the graph replayed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment():
    import torch

    name = torch.cuda.get_device_name(0)
    log(f"device {name} count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return name, card


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan.ssd_scan import library as ssd_library
    from repro_torch.kernels.ssd_scan.ssd_scan_bwd import library as ssd_bwd_library
    from repro_torch.kernels.topk_ef.topk_ef import library as topk_library

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = ("topk_ef", "ssd_scan", "ssd_scan_bwd")
    with ThreadPoolExecutor(len(sources)) as pool:
        for lib in pool.map(build.build, sources):
            log(f"built {lib.name}")
    topk_library()
    ssd_library()
    ssd_bwd_library()
    log(f"built and loaded csrc/{{{','.join(sources)}}}.cu in {time.perf_counter() - t0:.1f} s")
    # ptxas -v, one line per kernel instantiation: registers, stack, spills
    entry = None
    for line in "".join(build.build_log(src) for src in sources).splitlines():
        m = re.search(r"Compiling entry function '.*?topk_group_kernelILi(\d+)ELb([01])", line)
        b = re.search(r"Compiling entry function '.*?(ssd_bwd_\w+_kernel)", line)
        if m:
            entry = f"topk_group_kernel<VPL={m.group(1)}, EF={m.group(2)}>"
        elif b:
            entry = b.group(1)
        elif "Compiling entry function" in line and "ssd_chunk_kernel" in line:
            entry = "ssd_chunk_kernel"
        elif entry and "spill" in line:
            spills = line.strip()
        elif entry and "registers" in line:
            print(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}; {spills}", flush=True)
            entry = None
    # the SSD kernel's products run on the tensor cores: HMMA in its SASS
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.build("ssd_scan"))],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump failed on the SSD library: {sass.stderr.strip()}")
    hmma, fn = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and re.search(r"\bHMMA\.", line):
            hmma[fn] = hmma.get(fn, 0) + 1
    n_hmma = sum(v for k, v in hmma.items() if "ssd_chunk_kernel" in k)
    log(f"cuobjdump -sass: {n_hmma} HMMA instructions in ssd_chunk_kernel")
    if n_hmma == 0:
        fail("no HMMA in the SSD kernel's SASS: its products are not on the tensor cores")
    # the backward's: every kernel with products (all but the slice sums)
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.build("ssd_scan_bwd"))],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump failed on the SSD backward library: {sass.stderr.strip()}")
    hmma, fn = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : \S*?(ssd_bwd_\w+_kernel)", line)
        if m:
            fn = m.group(1)
            hmma.setdefault(fn, 0)
        elif fn and re.search(r"\bHMMA\.", line):
            hmma[fn] += 1
    log("cuobjdump -sass of the SSD backward: "
        + ", ".join(f"{k} {v} HMMA" for k, v in sorted(hmma.items())))
    for k in ("ssd_bwd_prep_kernel", "ssd_bwd_walk_kernel", "ssd_bwd_group_kernel"):
        if not hmma.get(k):
            fail(f"no HMMA in {k}'s SASS: its products are not on the tensor cores")


def phase_kernels():
    from repro_torch.kernels import checks

    err = {"topk_ef": 0.0, "block_topk": 0.0}
    cases = checks.cases(WORKERS)
    for case in cases:
        e1 = checks.check_topk_ef(case)
        e2 = checks.check_block_topk(case)
        err["topk_ef"] = max(err["topk_ef"], e1)
        err["block_topk"] = max(err["block_topk"], e2)
        log(f"bitwise ok: {case.name:24s} rows={case.rows:6d} kind={case.kind:6s} "
            f"lr={case.lr}")
    log(f"phase 3: {len(cases)} cases x 2 kernels bitwise equal to the plain versions")
    groups = checks.group_cases(WORKERS)
    for case in groups:
        e1 = checks.check_topk_ef_group(case)
        e2 = checks.check_block_topk_group(case)
        err["topk_ef"] = max(err["topk_ef"], e1)
        err["block_topk"] = max(err["block_topk"], e2)
        log(f"bitwise ok: group {case.name:22s} {len(case.views):3d} views, "
            f"{sum(v[0] for v in case.views):6d} rows, offset {case.offset}, lr={case.lr}")
    log(f"phase 3: {len(groups)} groups x 2 kernels bitwise equal to the plain versions, "
        f"one launch per table")
    # the SSD chunk kernel: alone (y and st) and inside ssd_chunked (y and
    # the final state, with and without h0) against the oracle
    err["ssd_chunk"] = 0.0
    cases = checks.ssd_cases() + checks.ssd_tp_cases()
    for case in cases:
        e = checks.check_ssd_chunk(case)
        e0 = checks.check_ssd_chunked(case, with_h0=False)
        e1 = checks.check_ssd_chunked(case, with_h0=True)
        err["ssd_chunk"] = max(err["ssd_chunk"], e)
        log(f"within tol: ssd {case.name:40s} kernel {e:.3g}, ssd_chunked {e0:.3g}, "
            f"with h0 {e1:.3g}")
    log(f"phase 3: {len(cases)} SSD cases (the tensor-parallel rank's among them) within "
        f"{checks.SSD_TOL} x "
        f"max(1, max|plain|) of the plain versions")
    return err


def _final_params_equal(a, b) -> bool:
    import torch

    from repro_torch.core.types import tree_leaves

    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def phase_main_path():
    import torch

    from repro_torch.kernels.block_topk import block_topk
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch import train as launch

    argv = ["--arch", "cnn_cifar", "--algo", "sasg", "--workers", str(WORKERS),
            "--global-batch", str(WORKERS * PER_WORKER), "--lr", str(LR),
            "--steps", str(STEPS), "--device", "cuda"]
    torch.use_deterministic_algorithms(True)
    torch.cuda.reset_peak_memory_stats()
    for counter in (topk_ef.LAUNCHES, topk_ef.SEGMENTS, block_topk.LAUNCHES,
                    block_topk.SEGMENTS):
        counter.reset()
    trainer, state = launch.train(argv, log_fn=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    launches = {"topk_ef": topk_ef.LAUNCHES.count, "block_topk": block_topk.LAUNCHES.count}
    segments = topk_ef.SEGMENTS.count
    peak = torch.cuda.max_memory_allocated()

    n_leaves = 37
    encodes = STEPS + 1   # one encode per step + one zero_payload
    log(f"main path launches: topk_ef {launches['topk_ef']} covering {segments} segments "
        f"(expected {encodes} = {STEPS} steps + 1, one grouped launch per encode, covering "
        f"{n_leaves * encodes} = {n_leaves} leaves x {encodes}), block_topk "
        f"{launches['block_topk']}")
    if launches["topk_ef"] != encodes or segments != n_leaves * encodes:
        fail(f"topk_ef launched {launches['topk_ef']} times over {segments} segments, "
             f"expected {encodes} over {n_leaves * encodes}")
    hist = trainer.history
    if len(hist) != STEPS or not all(math.isfinite(r["loss"]) for r in hist):
        fail("main path loss is not finite")
    rounds = hist[-1]["rounds_total"]
    if not 0 < rounds <= WORKERS * STEPS or hist[0]["num_sent"] != WORKERS:
        fail(f"implausible rounds {rounds} / first-step sends {hist[0]['num_sent']}")
    if hist[-1]["bits_paper_total"] != rounds * 1_132_736:
        fail("bits_paper_total != rounds x 1,132,736 (cnn_cifar top-1% payload)")
    log(f"main path: {STEPS} steps, loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, "
        f"rounds {rounds:.0f}/{WORKERS * STEPS}, peak memory {peak / 2**20:.1f} MiB")
    return trainer, state, launches, peak


def phase_lockstep(arch, lr, state_main=None, want_skips=False, workers=WORKERS,
                   global_batch=WORKERS * PER_WORKER, steps=STEPS, extra=()):
    """Kernel and reference impls step by step from the same init, held
    bitwise equal every step (sends, counters, loss, params, taus); with
    ``state_main`` the kernel run must also equal the main path's run.
    ``extra``: more launcher flags (``--reduced``, ``--seq-len``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import build_train_step

    args = launch.parse_args(["--arch", arch, "--algo", "sasg", *extra])
    cfg = get_config(arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    built = {}
    for impl in ("kernel", "reference"):
        scfg = launch.sasg_config_from_args(args)
        scfg = dataclasses.replace(
            scfg, compressor=dataclasses.replace(scfg.compressor, topk_impl=impl))
        built[impl] = build_train_step(model, scfg, workers, constant(lr), device="cuda")
    states = {impl: b.init(seed=0) for impl, b in built.items()}
    stream = launch.data_stream(cfg, global_batch, args.seq_len)
    step_s = {"kernel": [], "reference": []}
    sent = []
    for step in range(steps):
        batch = stream.batch_at(step)
        mets = {}
        for impl in ("kernel", "reference"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[impl], m = built[impl].step(states[impl], batch)
            torch.cuda.synchronize()
            step_s[impl].append(time.perf_counter() - t0)
            mets[impl] = {k: float(v) for k, v in m.items()}
        if mets["kernel"] != mets["reference"]:
            fail(f"{arch} step {step}: metrics differ kernel {mets['kernel']} "
                 f"vs reference {mets['reference']}")
        if not _final_params_equal(states["kernel"].params, states["reference"].params):
            fail(f"{arch} step {step}: params differ between the kernel and reference runs")
        if not torch.equal(states["kernel"].wstate.tau, states["reference"].wstate.tau):
            fail(f"{arch} step {step}: staleness counters differ")
        sent.append(int(mets["kernel"]["num_sent"]))
    if state_main is not None and not _final_params_equal(states["kernel"].params,
                                                          state_main.params):
        fail("the lockstep kernel run differs from the main run (not deterministic)")
    if want_skips and min(sent) == workers:
        fail(f"{arch} lr={lr}: no worker skipped, the stale-payload path did not run")
    log(f"lockstep {arch} sasg lr={lr}: {steps} steps, kernel == reference bitwise "
        f"(sends, counters, loss, params, taus each step)"
        + ("; kernel run == main run bitwise" if state_main is not None else "")
        + f"; sends per step {sent}")
    med = {k: statistics.median(v[1:]) * 1e3 for k, v in step_s.items()}
    log(f"step time {arch} (host clock around synchronize, median of steps "
        f"1..{steps - 1}): kernel {med['kernel']:.2f} ms, reference {med['reference']:.2f} ms")
    return med


def phase_identity_exchange():
    from repro_torch.launch import train as launch

    for algo in ("sgd", "lasg"):
        trainer, _ = launch.train(
            ["--arch", "fc_mnist", "--algo", algo, "--workers", "4", "--steps", "3",
             "--lr", "0.05", "--device", "cuda"], log_fn=lambda m: None)
        losses = [r["loss"] for r in trainer.history]
        if not all(math.isfinite(x) for x in losses):
            fail(f"fc_mnist {algo}: loss not finite {losses}")
        log(f"fc_mnist {algo}: 3 steps, losses {[round(x, 4) for x in losses]}, "
            f"rounds {trainer.history[-1]['rounds_total']:.0f}")


def phase_times():
    """The top-k kernels per cnn_cifar step: the 37 leaves of an encode in
    one grouped launch, beside the bytes bound, the plain version and
    torch.topk + gather; then the EF kernel per (bc, kb) class of leaves."""
    import torch

    from repro_torch.kernels import checks
    from repro_torch.kernels.block_topk.block_topk import block_topk_group
    from repro_torch.kernels.block_topk.ref import block_topk_ref
    from repro_torch.kernels.topk_ef.ref import topk_ef_ref
    from repro_torch.kernels.topk_ef.topk_ef import plan_segments, topk_ef_group

    # Phase 5 runs as phase 4 leaves it, with deterministic algorithms on:
    # every torch.empty then fills its memory with NaN, which the kernels
    # line's times include (one fill per output buffer of a grouped call).
    # The training launcher makes no fills; the same calls without them are
    # logged after, beside the per-class times, which are taken without too.
    views = checks.leaf_views("cnn_cifar", WORKERS)
    kbs = [v.kb for v in views]
    gen = torch.Generator(device="cuda").manual_seed(1)
    inputs = [(torch.randn((v.rows, v.bc), generator=gen, device="cuda"),
               0.01 * torch.randn((v.rows, v.bc), generator=gen, device="cuda"))
              for v in views]
    grads, errs = [g for g, _ in inputs], [e for _, e in inputs]
    corrected = [g + e for g, e in inputs]
    n_launch = len(plan_segments([(v.rows, v.bc, v.kb) for v in views],
                                 [(g.data_ptr(), e.data_ptr()) for g, e in inputs]).launches)

    def run_kernel():
        topk_ef_group(grads, errs, 1.0, kbs)

    def run_plain():
        for v, (g, e) in zip(views, inputs):
            topk_ef_ref(g, e, 1.0, v.kb)

    def run_library():
        for v, c in zip(views, corrected):
            c.gather(-1, torch.topk(c.abs(), v.kb, dim=-1).indices)

    def run_bt_kernel():
        block_topk_group(corrected, kbs)

    def run_bt_plain():
        for v, c in zip(views, corrected):
            block_topk_ref(c, v.kb)

    def bytes_of(vs, ef=True):
        # read grad + err, write new_err (EF) or read x; write (value, index) per pick
        return sum((12 if ef else 4) * v.rows * v.bc + 8 * v.rows * v.kb for v in vs)

    elems = sum(v.rows * v.bc for v in views)
    cmp_ops = sum(v.rows * v.bc * v.kb for v in views)
    bounds = {
        # ops: lr*grad + err (2) and one compare per element per round
        "topk_ef": (bytes_of(views), 2 * elems + cmp_ops),
        "block_topk": (bytes_of(views, ef=False), cmp_ops),
    }
    # device time: the encode captured in a CUDA graph and replayed; eager:
    # the same call from Python, which is what the training step pays. One
    # encode moves 336 MB (EF), over the 50 MB L2. The library call
    # (torch.topk + gather on g) is the yardstick of both kernels; the port
    # never calls it.
    fns = {"topk_ef": (run_kernel, run_plain), "block_topk": (run_bt_kernel, run_bt_plain)}
    library = (graph_ms(run_library, 50), cuda_ms(run_library, 20))
    # a streaming yardstick for the EF kernel's bytes: torch.add(grad, err)
    # over the same 37 leaves reads 8 and writes 4 bytes per element
    add_ms = graph_ms(lambda: [torch.add(g, e) for g, e in inputs], 50)
    log(f"yardstick: torch.add(grad, err) over the {len(views)} leaves (37 launches, "
        f"{12 * elems / 1e6:.1f} MB) {add_ms:.4f} ms, {12 * elems / add_ms / 1e9:.3f} TB/s")
    out = {}
    for name, (nbytes, ops) in bounds.items():
        kernel = (graph_ms(fns[name][0], 100), cuda_ms(fns[name][0], 50))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fns[name][0]()
        host = (time.perf_counter() - t0) / 50 * 1e3   # enqueue only
        plain = (graph_ms(fns[name][1], 10), cuda_ms(fns[name][1], 5))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        out[name] = {
            "ms": kernel[0], "eager_ms": kernel[1], "plain_ms": plain[0],
            "library_ms": library[0], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        log(f"{name}: {kernel[0]:.4f} ms per step on the device ({n_launch} launch over "
            f"{len(views)} segments, {nbytes / 1e6:.1f} MB; eager {kernel[1]:.4f} ms, host "
            f"{host:.4f} ms a call) vs bound "
            f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']}, "
            f"{HBM_BYTES_PER_S / 1e12} TB/s): {nbytes / kernel[0] / 1e9:.3f} TB/s, "
            f"{t_bytes / kernel[0]:.3f} of the HBM rate; plain {plain[0]:.3f} ms (eager "
            f"{plain[1]:.3f}); torch.topk+gather {library[0]:.3f} ms (eager {library[1]:.3f})")
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    for name, (nbytes, _) in bounds.items():
        kernel = (graph_ms(fns[name][0], 100), cuda_ms(fns[name][0], 50))
        log(f"{name} without the NaN fills: {kernel[0]:.4f} ms per step on the device "
            f"(eager {kernel[1]:.4f} ms), {nbytes / kernel[0] / 1e9:.3f} TB/s, "
            f"{nbytes / HBM_BYTES_PER_S * 1e3 / kernel[0]:.3f} of the HBM rate")
    # per (bc, kb) class of leaves: each class's leaves in one grouped
    # launch, rotating through enough copies of its inputs that their bytes
    # exceed twice the 50 MB L2 (at most 1,024 copies; a class whose copies
    # stay under 50 MB is labelled L2-warm)
    classes = {}
    for v, (g, e) in zip(views, inputs):
        classes.setdefault((v.bc, v.kb), []).append((v, g, e))
    for (bc, kb), members in sorted(classes.items()):
        nbytes = bytes_of([v for v, _, _ in members])
        copies = min(1024, max(1, math.ceil(100e6 / nbytes)))
        sets = [([g.clone() for _, g, _ in members], [e.clone() for _, _, e in members])
                for _ in range(copies)]
        ks = [kb] * len(members)

        def run_class():
            for gs, es in sets:
                topk_ef_group(gs, es, 1.0, ks)

        ms = graph_ms(run_class, 20) / copies
        b = nbytes / HBM_BYTES_PER_S * 1e3
        rows = sum(v.rows for v, _, _ in members)
        warm = " (L2-warm)" if copies * nbytes < 50e6 else ""
        log(f"  topk_ef class bc={bc:3d} kb={kb} ({len(members):2d} leaves, {rows:6d} rows, "
            f"{nbytes / 1e6:7.3f} MB, {copies} copies{warm}): {ms * 1e3:8.2f} us per step, "
            f"bound {b * 1e3:7.2f} us, {b / ms:.3f} of the HBM rate")
        del sets
    torch.use_deterministic_algorithms(deterministic)
    return out


# ---------------------------------------------------------------------------
# phase 5b: training options (slice 5)
# ---------------------------------------------------------------------------

BASELINES = ("randk", "qsgd", "signsgd_ef", "terngrad")
OPT_STEPS, FAULT_STEPS, FAULT_EVERY, FAULT_AT = 5, 12, 4, 7
UNBIASED_DRAWS, UNBIASED_Z = 2000, 5.0


def _states_equal(a, b) -> bool:
    """Every leaf of two trees bitwise equal (dtypes and shapes too)."""
    import torch

    from repro_torch.core.types import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(la, lb))


def _train_argv(algo, *extra, steps=OPT_STEPS):
    return ["--arch", "cnn_cifar", "--algo", algo, "--workers", str(WORKERS),
            "--global-batch", str(WORKERS * PER_WORKER), "--lr", str(LR),
            "--steps", str(steps), "--device", "cuda", *extra]


def _counters_exact(hist, bits_paper, bits_wire, what):
    """The counters are the float32 running sums of sends x bits per upload
    (``bits.account``), step by step, exactly."""
    import numpy as np

    acc = [np.float32(0)] * 3
    for row in hist:
        n = np.float32(row["num_sent"])
        acc = [np.float32(acc[0] + n), np.float32(acc[1] + n * np.float32(bits_paper)),
               np.float32(acc[2] + n * np.float32(bits_wire))]
    got = [hist[-1]["rounds_total"], hist[-1]["bits_paper_total"], hist[-1]["bits_wire_total"]]
    if got != [float(a) for a in acc]:
        fail(f"{what}: counters {got} != float32 sums of sends x bits.account {acc}")
    rounds = sum(r["num_sent"] for r in hist)
    if abs(got[1] - rounds * bits_paper) > 1e-6 * rounds * bits_paper:
        fail(f"{what}: bits_paper_total {got[1]} != rounds {rounds} x {bits_paper}")
    return rounds


def _run_steps(built, stream, steps, seed=0):
    """``steps`` steps from ``built.init(seed)``; returns the final state,
    the metrics rows and the host-clock seconds of each step."""
    import torch

    state = built.init(seed=seed)
    rows, secs = [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = built.step(state, stream.batch_at(step))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        rows.append({k: float(v) for k, v in m.items()})
    return state, rows, secs


def _unbiased(name, gen):
    """Mean of UNBIASED_DRAWS draws of one fixed 256 x 256 fp32 tensor on the
    card against the tensor, in standard errors from the compressor's own
    variance: the error projected on x, and the sum of squared standardized
    errors (chi-square: n coordinates, standard deviation sqrt(2n)). Returns
    both z-scores."""
    import torch

    from repro_torch.core.compressors import CompressorConfig, build_compressor

    x = torch.randn((256, 256), generator=gen, device="cuda")
    comp = build_compressor(CompressorConfig(name=name))
    k = CompressorConfig().leaf_k(x.numel())
    total = torch.zeros_like(x, dtype=torch.float64)
    chunk = 250
    for _ in range(UNBIASED_DRAWS // chunk):
        tree = {"w": x.expand((chunk,) + tuple(x.shape))}
        out, _ = comp.compress(comp.init(tree), tree, gen)
        dense = out["w"].densify().reshape(tree["w"].shape) if name == "randk" else out["w"]
        total += dense.double().sum(0)
    mean, xd = total / UNBIASED_DRAWS, x.double()
    a = xd.abs()
    if name == "randk":
        var = xd.square() * (x.numel() / k - 1)
    elif name == "qsgd":
        q = xd.norm() / 256
        p = a / q - torch.floor(a / q)
        var = q.square() * p * (1 - p)
    else:
        s = a.max()
        var = s.square() * (a / s) * (1 - a / s)
    # the draws' own fp32 rounding, ~1 ulp of each value
    var = (var + (2.0 ** -23 * a).square()) / UNBIASED_DRAWS
    err = mean - xd
    z_proj = float((err * xd).sum() / (xd.square() * var).sum().sqrt())
    n = x.numel()
    z_chi = float(((err.square() / var).sum() - n) / math.sqrt(2 * n))
    if not (abs(z_proj) <= UNBIASED_Z and abs(z_chi) <= UNBIASED_Z):
        fail(f"{name} on the card: mean of {UNBIASED_DRAWS} draws is biased "
             f"(projected error {z_proj:.2f} SE, chi-square {z_chi:.2f} SD)")
    return z_proj, z_chi


def phase_training_options(card):
    """The rest of single-card training on cnn_cifar at full width, M = 10:
    per-layer k with a bf16 wire, each baseline compressor, fold_lr=False
    with an optimizer, restore-and-continue, a kernel fault, the loader.
    Runs with deterministic algorithms on (bitwise reruns and recovery
    need cuDNN's deterministic backward) and restores the setting after."""
    import torch

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _training_options(card)
    finally:
        torch.use_deterministic_algorithms(deterministic)


def _training_options(card):
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.comm import bits as bits_lib
    from repro_torch.configs import get_config
    from repro_torch.core.compressors import leaf_geometry
    from repro_torch.core.types import tree_flatten_with_paths
    from repro_torch.data import ShardedLoader
    from repro_torch.kernels.build import KernelLaunchError
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch import train as launch
    from repro_torch.models import build
    from repro_torch.optim import adamw, chain, clip_by_global_norm, constant, momentum
    from repro_torch.train import Trainer, TrainerConfig, build_train_step
    from repro_torch.train import checkpoint as ckpt

    n_leaves = 37
    cfg = get_config("cnn_cifar")
    model = build(cfg)
    stream = launch.data_stream(cfg, WORKERS * PER_WORKER)
    template = model.init(torch.Generator().manual_seed(0), device="cpu")
    out = {"step_ms": {}}

    # 1. per-layer k and a bf16 wire: the kernel run == the reference run
    extra = ["--k-ratio-per-layer", "stem=0.05,s3b=0.005", "--wire-dtype", "bfloat16"]
    scfg = launch.sasg_config_from_args(launch.parse_args(_train_argv("sasg", *extra)))
    kbs = {leaf_geometry(scfg.compressor, tuple(x.shape), p)[1]
           for p, x in zip(*tree_flatten_with_paths(template)[:2])}
    runs = {}
    for impl in ("kernel", "reference"):
        topk_ef.LAUNCHES.reset()
        topk_ef.SEGMENTS.reset()
        trainer, state = launch.train(_train_argv("sasg", *extra, "--topk-impl", impl,
                                                  steps=6), log_fn=lambda m: None)
        runs[impl] = (trainer.history, state, topk_ef.LAUNCHES.count, topk_ef.SEGMENTS.count)
    (hk, sk, nk, segk), (hr, sr, nr, _) = runs["kernel"], runs["reference"]
    if (nk, segk, nr) != (7, 7 * n_leaves, 0):
        fail(f"per-layer k: {nk} top-k launches over {segk} segments (reference run {nr}), "
             f"expected 7 = 6 steps + 1 over {7 * n_leaves}")
    if len(kbs) < 2:
        fail(f"per-layer k: one kb {kbs} over the leaves; the schedule did not apply")
    if hk != hr or not _states_equal(sk, sr):
        fail("per-layer k + bf16 wire: the kernel run differs from the reference run "
             "(sends, counters, params, EF or stale cache)")
    bits = bits_lib.account(scfg.compressor, template)
    _counters_exact(hk, bits.paper, bits.wire, "per-layer k")
    log(f"per-layer k (stem 0.05, s3b 0.005; kb in {sorted(kbs)}) + bf16 wire: 6 steps, "
        f"{nk} grouped launches over {segk} segments (one per encode), kernel run == "
        f"reference run bitwise (params, EF, stale cache, sends, counters); "
        f"bits/upload paper {bits.paper:.0f} wire {bits.wire:.0f}")

    # 2. each baseline compressor, Sparse and SASG: exact counters,
    #    bitwise repeatable seeded runs, step times
    for name in BASELINES:
        for algo in ("sparse", "sasg"):
            scfg = launch.sasg_config_from_args(launch.parse_args(_train_argv(algo)))
            scfg = dataclasses.replace(scfg, compressor=dataclasses.replace(
                scfg.compressor, name=name))
            built = build_train_step(model, scfg, WORKERS, constant(LR), device="cuda")
            first, hist, secs = _run_steps(built, stream, OPT_STEPS, seed=1)
            again, hist2, _ = _run_steps(built, stream, OPT_STEPS, seed=1)
            if hist != hist2 or not _states_equal(first, again):
                fail(f"{algo} + {name}: two runs with the same seed differ")
            if not all(math.isfinite(r["loss"]) for r in hist):
                fail(f"{algo} + {name}: loss not finite")
            rounds = _counters_exact(hist, built.bits_paper, built.bits_wire, f"{algo}+{name}")
            out["step_ms"][(name, algo)] = statistics.median(secs[1:]) * 1e3
            log(f"{algo} + {name}: {OPT_STEPS} steps, loss {hist[0]['loss']:.4f} -> "
                f"{hist[-1]['loss']:.4f}, rounds {rounds:.0f}, counters == float32 sums of "
                f"sends x bits.account ({built.bits_paper:.6g} paper bits/upload), "
                f"seeded rerun bitwise equal")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name in ("randk", "qsgd", "terngrad"):
        z = _unbiased(name, gen)
        log(f"unbiased on the card: {name}, mean of {UNBIASED_DRAWS} draws of a 256 x 256 "
            f"tensor: projected error {z[0]:+.2f} SE, chi-square {z[1]:+.2f} SD "
            f"(held to {UNBIASED_Z})")
    scfg = launch.sasg_config_from_args(launch.parse_args(_train_argv("sasg")))
    sig_scfg = dataclasses.replace(scfg, compressor=dataclasses.replace(
        scfg.compressor, name="signsgd_ef"))
    sig_state, _, _ = _run_steps(build_train_step(model, sig_scfg, WORKERS, constant(LR),
                                                  device="cuda"), stream, 2)

    # 3. fold_lr=False with an optimizer
    for label, make in (("momentum(0.02, 0.9)", lambda: momentum(LR, 0.9)),
                        ("clip(1.0) + adamw(1e-3)",
                         lambda: chain(clip_by_global_norm(1.0), adamw(1e-3)))):
        built = build_train_step(model, dataclasses.replace(scfg, fold_lr=False), WORKERS,
                                 constant(LR), device="cuda", optimizer=make())
        first, hist, secs = _run_steps(built, stream, OPT_STEPS)
        again, hist2, _ = _run_steps(built, stream, OPT_STEPS)
        if hist != hist2 or not _states_equal(first, again):
            fail(f"fold_lr=False {label}: two runs differ")
        if not all(math.isfinite(r["loss"]) for r in hist):
            fail(f"fold_lr=False {label}: loss not finite")
        _counters_exact(hist, built.bits_paper, built.bits_wire, label)
        out["step_ms"][(label, "sasg")] = statistics.median(secs[1:]) * 1e3
        log(f"sasg fold_lr=False {label}: {OPT_STEPS} steps, loss {hist[0]['loss']:.4f} -> "
            f"{hist[-1]['loss']:.4f}, counters exact, rerun bitwise equal")

    # 4-6. restore-and-continue through the kernel, fed by the loader
    class Checked:
        """The loader's batches, each held to be on the card and equal to
        ``batch_at(step)``."""

        def __init__(self, loader):
            self.loader, self.step = loader, 0

        def __iter__(self):
            return self

        def __next__(self):
            batch = next(self.loader)
            want = stream.batch_at(self.step)
            for k, v in want.items():
                if not batch[k].is_cuda or not np.array_equal(batch[k].cpu().numpy(), v):
                    fail(f"loader batch {self.step} {k!r}: not on cuda or != batch_at")
            self.step += 1
            return batch

    hit = []

    def fault(step):
        if step == FAULT_AT and not hit:
            hit.append(step)
            raise RuntimeError("injected node failure")

    # the launcher's SASG step and Trainer settings, with the loader or the
    # fault hook that the launcher does not take
    built = build_train_step(model, launch.sasg_config_from_args(launch.parse_args(
        _train_argv("sasg"))), WORKERS, constant(LR), device="cuda")

    def make_trainer(data, ckpt_dir, fault_hook=None):
        return Trainer(built, data, TrainerConfig(
            total_steps=FAULT_STEPS, ckpt_dir=ckpt_dir, ckpt_every=FAULT_EVERY,
            log_every=max(FAULT_STEPS // 20, 1)), fault_hook=fault_hook,
            log_fn=lambda m: None)

    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        with ShardedLoader(iter(stream), device="cuda") as loader:
            fed = Checked(loader)
            want = make_trainer(fed, d1).run(seed=0)
        topk_ef.LAUNCHES.reset()
        faulted = make_trainer(stream, d2, fault)
        got = faulted.run(seed=0)
        launches = topk_ef.LAUNCHES.count
        rec = [e for e in faulted.events if e["kind"] == "recovery"]
        if len(faulted.events) != 1 or len(rec) != 1 or (
                rec[0]["failed_step"], rec[0]["restored_step"]) != (FAULT_AT, FAULT_EVERY):
            fail(f"restore-and-continue: events {faulted.events}")
        if not _states_equal(got, want):
            fail("restore-and-continue: the faulted run's TrainState differs from the "
                 "uninterrupted run's")
        encodes = len(faulted.history) + 2     # steps run (replays too) + two inits
        if launches != encodes:
            fail(f"restore-and-continue: {launches} top-k launches, expected {encodes}")
        if fed.step != FAULT_STEPS:
            fail(f"the loader fed {fed.step} batches, expected {FAULT_STEPS}")
        log(f"restore-and-continue: {FAULT_STEPS} steps, ckpt every {FAULT_EVERY} (async), "
            f"fault at step {FAULT_AT} -> restored step {rec[0]['restored_step']} in "
            f"{rec[0]['latency_s']:.3f} s; final TrainState == uninterrupted run bitwise; "
            f"{launches} top-k launches = {len(faulted.history)} steps (3 replayed) + 2 "
            f"inits; the uninterrupted run fed by ShardedLoader ({fed.step} batches on cuda "
            f"== batch_at)")

        # a kernel fault ends the run: no recovery
        def broken(state, batch, force_skip=None):
            if int(state.gstate.step) == 2:
                raise KernelLaunchError("topk_group_kernel: CUDA error 700 at launch (injected)")
            return built.step(state, batch, force_skip)

        with tempfile.TemporaryDirectory() as d3:
            tr = Trainer(built._replace(step=broken), stream,
                         TrainerConfig(total_steps=6, ckpt_dir=d3, ckpt_every=1),
                         log_fn=lambda m: None)
            try:
                tr.run()
            except KernelLaunchError:
                pass
            else:
                fail("a KernelLaunchError in the step did not end the run")
        if tr.events or len(tr.history) != 2:
            fail(f"kernel fault: events {tr.events}, {len(tr.history)} steps")
        log("a KernelLaunchError at step 2 ended the run: raised to the caller, "
            "no recovery event")

        # one checkpoint save of SASG + signsgd_ef (params, EF, stale cache,
        # stale params): the device-to-host copy, then the write
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = ckpt.save(sig_state, d1, 999, blocking=False)
        t1 = time.perf_counter()
        handle.join()
        t2 = time.perf_counter()
        nbytes = sum(os.path.getsize(os.path.join(d1, "step_999", f))
                     for f in os.listdir(os.path.join(d1, "step_999")))
        out["save"] = (t1 - t0, t2 - t1, nbytes)
    log(f"card {card}: checkpoint of SASG + signsgd_ef at M={WORKERS}: {nbytes} bytes, "
        f"device-to-host copy {1e3 * (t1 - t0):.1f} ms (what a step waits for), "
        f"write {1e3 * (t2 - t1):.1f} ms (on the writer thread)")
    for (name, algo), ms in out["step_ms"].items():
        log(f"card {card}: step time {algo} + {name}: {ms:.2f} ms (median of steps "
            f"1..{OPT_STEPS - 1}, host clock around synchronize)")
    return out


# ---------------------------------------------------------------------------
# phase 8: the paper's tables (slice 6)
# ---------------------------------------------------------------------------

TABLES_DIR = ROOT / "artifacts" / "bench_torch_smoke"
CNN_PARAMS = 2_776_906
# Table 2 on cnn_cifar runs 200 of the reference's full 400 steps, to keep
# phases 1-18 well within the time limit beside phase 15 (e): the four
# algorithms reach the 90% target by step 80 on the H100 (sgd in 800
# rounds, sparse and SASG in 600), so the claims are still checked
TABLE2_CNN_STEPS = 200


def _table2_model(name, steps, lr, target, lockstep):
    """One model of Table 2 through ``run_model`` with top-k through the
    kernel, the launches counted. With ``lockstep``, Sparse and SASG are
    stepped again by a simulator with ``topk_impl="sharded"`` (the
    reference's selection) on the same batches, held bitwise: rounds,
    bits and taus every step, params at every evaluation point. Returns
    the results, the curves, the ms per step of each run and the
    launches."""
    import torch

    from repro_torch.benchmarks import table2_rounds_bits as t2
    from repro_torch.benchmarks.simulator import make_simulator
    from repro_torch.configs import get_config
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.models import build

    model = build(get_config(name))
    shadow, times, clock = {}, {}, {"last": 0.0}

    def on_step(algo, t, batches, state):
        now = time.perf_counter()
        if t > 0:   # from the last hook's end: the draw, the step, an evaluation
            times.setdefault(algo, []).append(now - clock["last"])
        if lockstep and algo in ("sparse", "sasg"):
            if t == 0:
                init, step, _, _ = make_simulator(t2.algo_config(algo, "sharded"),
                                                  model.loss_fn, t2.M, device="cuda")
                gen = torch.Generator(device="cuda").manual_seed(0)
                shadow[algo] = [step, init(model.init(gen, device="cuda"))]
            step, ref = shadow[algo]
            t0 = time.perf_counter()
            ref, _ = step(ref, batches, lr)
            times.setdefault(algo + "/sharded", []).append(time.perf_counter() - t0)
            shadow[algo][1] = ref
            if (ref.rounds, ref.bits_paper) != (state.rounds, state.bits_paper):
                fail(f"table 2 {name} {algo} step {t}: kernel run rounds/bits "
                     f"{state.rounds}/{state.bits_paper} != reference run "
                     f"{ref.rounds}/{ref.bits_paper}")
            if not torch.equal(ref.wstate.tau, state.wstate.tau):
                fail(f"table 2 {name} {algo} step {t}: sends differ (staleness counters)")
            if ((t + 1) % 20 == 0 or t == steps - 1) and not _final_params_equal(
                    ref.params, state.params):
                fail(f"table 2 {name} {algo} step {t + 1}: params differ between the "
                     "kernel and reference runs")
        clock["last"] = time.perf_counter()

    topk_ef.LAUNCHES.reset()
    res, curves = t2.run_model(name, steps=steps, lr=lr, target_acc=target,
                               log=lambda m: print(m, flush=True), topk_impl="kernel",
                               device="cuda", on_step=on_step)
    launches = topk_ef.LAUNCHES.count
    want = 2 * (steps + 1)   # Sparse and SASG: one encode per step + the zero payload
    log(f"table 2 {name}: topk_ef launched {launches} times (expected {want} = 2 x "
        f"({steps} steps + 1), one grouped launch per encode)")
    if launches != want:
        fail(f"table 2 {name}: topk_ef launched {launches} times, expected {want}")
    ms = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    return res, curves, ms, launches


def phase_tables(card):
    """Table 1; Table 2 on fc_mnist in full (300 steps) with the kernel run
    of Sparse and SASG held bitwise to the reference's selection, and on
    cnn_cifar at full width over ``TABLE2_CNN_STEPS`` steps, each with the paper's
    assertions; Table 3 with the card's auxiliary-gradient time; the
    figures. Runs with deterministic algorithms on and restores the
    setting after."""
    import torch

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _tables(card)
    finally:
        torch.use_deterministic_algorithms(deterministic)


def _tables(card):
    import torch

    from repro_torch.benchmarks import fig_curves, table1_comm_model, table3_comm_time
    from repro_torch.benchmarks import table2_rounds_bits as t2
    from repro_torch.configs import get_config
    from repro_torch.core.metrics import model_dimension
    from repro_torch.models import build

    table1_comm_model.run(log=lambda m: print(m, flush=True))
    TABLES_DIR.mkdir(parents=True, exist_ok=True)
    (fc_name, fc_steps, _, fc_lr, fc_target), (cnn_name, _, _, cnn_lr, cnn_target) = (
        t2.SETTINGS)
    d = model_dimension(build(get_config(cnn_name)).init(torch.Generator(), device="cpu"))
    if d != CNN_PARAMS:
        fail(f"cnn_cifar has {d} params, not the full width's {CNN_PARAMS}")
    runs = ((fc_name, fc_steps, fc_lr, fc_target, True),
            (cnn_name, TABLE2_CNN_STEPS, cnn_lr, cnn_target, False))
    results, out = {}, {"launches": 0, "ms": {}}
    for name, steps, lr, target, lockstep in runs:
        log(f"table 2 {name}: M={t2.M}, {steps} steps, lr {lr}, target {target:.0%}, "
            f"topk_impl=kernel, full width")
        t0 = time.perf_counter()
        res, curves, ms, launches = _table2_model(name, steps, lr, target, lockstep)
        skipped = {a: t2.M * steps - res[a]["rounds_total"] for a in ("lasg", "sasg")}
        log(f"table 2 {name}: uploads skipped in {t2.M * steps}: " + ", ".join(
            f"{a} {n:.0f}" for a, n in skipped.items()))
        # the reference's assertions, as it checks them: they fail the run
        try:
            checked = t2.check_claims(res, log=lambda m: print(m, flush=True))
        except AssertionError as e:
            fail(f"table 2 {name}: the paper's assertion failed: {e}")
        res["assertions_checked"] = checked
        results[name] = res
        out["launches"] += launches
        out["ms"][name] = ms
        with open(TABLES_DIR / f"curves_{name}.json", "w") as f:
            json.dump(curves, f, indent=1)
        log(f"table 2 {name}: hit_target " + ", ".join(
            f"{a}={res[a]['hit_target']}" for a in t2.ALGOS)
            + "; the paper's assertions "
            + ("checked and passed (" + ", ".join(
                f"{a} {res[a]['rounds_to_target']:.0f} rounds / "
                f"{res[a]['bits_to_target']:.4g} bits to target"
                for a in ("sgd", "sparse", "sasg")) + ")"
               if checked else "NOT checked (SASG missed its target)")
            + (", kernel == reference (topk_impl=sharded) bitwise for sparse and sasg: "
               "sends, rounds and bits every step, params at every evaluation"
               if lockstep else "") + f"; {time.perf_counter() - t0:.1f} s")
        log(f"card {card}: table 2 {name} ms per simulator step (host clock, median): "
            + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    with open(TABLES_DIR / "table2.json", "w") as f:
        json.dump(results, f, indent=1)
    t3 = table3_comm_time.run(out_dir=str(TABLES_DIR), log=lambda m: print(m, flush=True),
                              device="cuda")["table3"]
    log(f"card {card}: table 3 auxiliary gradient {t3['aux_grad_s']:.4f} s per 100 "
        f"cnn_cifar gradients at 10 samples; skip fraction {t3['skip_fraction']:.4f} "
        f"(fc_mnist, this run)")
    fig_curves.run(out_dir=str(TABLES_DIR), log=lambda m: print(m, flush=True))
    return out


# ---------------------------------------------------------------------------
# phase 9: workers as processes (slice 6)
# ---------------------------------------------------------------------------

def _grads_split_bitwise():
    """Whether the main path's per-worker gradients at its init, on its
    first batch, computed for each half of the workers equal those of all
    ``WORKERS`` computed together (on the card, deterministic)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.sasg import per_worker_grad_fn
    from repro_torch.core.types import tree_leaves
    from repro_torch.launch import train as launch
    from repro_torch.models import build
    from repro_torch.train.step import worker_batch

    cfg = get_config("cnn_cifar")
    model = build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    batch = launch.data_stream(cfg, WORKERS * PER_WORKER).batch_at(0)
    grad_fn = per_worker_grad_fn(model.loss_fn)
    full = tree_leaves(grad_fn(params, worker_batch(batch, WORKERS, "cuda"), False)[1])
    n = WORKERS // 2
    halves = [tree_leaves(grad_fn(params, worker_batch(batch, WORKERS, "cuda", (s, n)),
                                  False)[1]) for s in (0, n)]
    return all(torch.equal(f, torch.cat([a, b])) for f, a, b in zip(full, *halves))


def _procs_rank(group, argv):
    """One rank of phase 9 (module-level: the spawned ranks import it):
    its share of the launcher's training of ``argv``, each step timed to
    the card's end; returns its per-step metrics, final params (numpy, by
    path), seconds per step and top-k kernel launches."""
    import torch

    from repro_torch.core.types import path_str, tree_flatten_with_paths
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch import train as launch

    trainer = launch.build_trainer(launch.parse_args(argv), print, group)
    step, step_s = trainer.built.step, []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = step(*a, **kw)
        torch.cuda.synchronize(group.device)
        step_s.append(time.perf_counter() - t0)
        return out

    trainer.built = trainer.built._replace(step=timed)
    topk_ef.LAUNCHES.reset()
    state = trainer.run(seed=0)
    paths, leaves, _ = tree_flatten_with_paths(state.params)
    return {"rank": group.rank, "history": trainer.history, "step_s": step_s,
            "params": {path_str(p): x.cpu().numpy() for p, x in zip(paths, leaves)},
            "topk_ef_launches": topk_ef.LAUNCHES.count}


def phase_procs(card, trainer_main, state_main):
    """Phase 4's run again with its workers as processes spawned by
    ``comm.process_group`` (``_procs_rank``): (a) 2 gloo processes x 5
    workers, both on cuda:0; (b) 1 NCCL process x 10 workers (a group of
    one: the only NCCL run one card allows). Sends, rounds and bits equal
    the stacked run's exactly on every rank; params bitwise for (b), and
    for (a) bitwise where the 5 + 5
    per-worker gradients equal the 10, else within the top-k tier 2e-2 of
    ``tests/test_torch_train_step.py``. Each rank counts its launches."""
    import numpy as np
    import torch

    from repro_torch.comm import process_group
    from repro_torch.core.types import path_str, tree_flatten_with_paths

    torch.use_deterministic_algorithms(True)   # as phase 4 ran; the ranks inherit it
    argv = ["--arch", "cnn_cifar", "--algo", "sasg", "--workers", str(WORKERS),
            "--global-batch", str(WORKERS * PER_WORKER), "--lr", str(LR),
            "--steps", str(STEPS), "--device", "cuda"]
    paths, leaves, _ = tree_flatten_with_paths(state_main.params)
    main_params = {path_str(p): x.cpu().numpy() for p, x in zip(paths, leaves)}
    keys = ("num_sent", "rounds_total", "bits_paper_total", "bits_wire_total")
    want_hist = [{k: h[k] for k in keys} for h in trainer_main.history]
    split_bitwise = _grads_split_bitwise()
    log(f"per-worker gradients of 5 + 5 workers {'==' if split_bitwise else '!='} those "
        f"of 10 at the main path's init (bitwise)")
    out = {"launches": 0, "ms": {}}
    for label, procs, backend in (("a", 2, "gloo"), ("b", 1, "nccl")):
        t0 = time.perf_counter()
        ranks = process_group.spawn(_procs_rank, procs, backend, "cuda", args=(
            argv + ["--procs", str(procs), "--backend", backend],))
        took = time.perf_counter() - t0
        bitwise = procs == 1 or split_bitwise
        worst = 0.0
        for r in ranks:
            got = [{k: h[k] for k in keys} for h in r["history"]]
            if got != want_hist:
                fail(f"procs ({label}) rank {r['rank']}: sends/counters differ from the "
                     f"stacked run: {got} vs {want_hist}")
            for p, want in main_params.items():
                diff = float(np.max(np.abs(r["params"][p] - want)))
                worst = max(worst, diff)
                same = np.array_equal(r["params"][p].view(np.int32), want.view(np.int32))
                if (bitwise and not same) or diff >= 2e-2:
                    fail(f"procs ({label}) rank {r['rank']}: params {p} differ from the "
                         f"stacked run by {diff:.3g} (bitwise required: {bitwise})")
            if r["topk_ef_launches"] != STEPS + 1:
                fail(f"procs ({label}) rank {r['rank']}: topk_ef launched "
                     f"{r['topk_ef_launches']} times, expected {STEPS + 1}")
            out["launches"] += r["topk_ef_launches"]
        ms = statistics.median(s for r in ranks for s in r["step_s"][1:]) * 1e3
        out["ms"][label] = ms
        log(f"procs ({label}) {procs} {backend} process(es) x {WORKERS // procs} workers: "
            f"{STEPS} steps, sends and counters == the stacked run on every rank; params "
            + ("bitwise equal" if worst == 0.0 else f"within 2e-2 (largest difference "
                                                    f"{worst:.3g})")
            + f"; topk_ef {sum(r['topk_ef_launches'] for r in ranks)} launches "
            f"({STEPS + 1} per rank); {took:.1f} s with the processes' start")
        log(f"card {card}: procs ({label}) ms per step {ms:.2f} (median of steps "
            f"1..{STEPS - 1} over the ranks, host clock around synchronize)")
    return out


# ---------------------------------------------------------------------------
# phase 15: strategies and sharding (slice 12)
# ---------------------------------------------------------------------------

MESH_BITS_MODEL2 = 1_477_664   # bits per upload of cnn_cifar's top-1% payload at model = 2
# (b)'s params against (a)'s: the top-k tier of tests/test_torch_train_step.py
# (a near-tied pick may flip where the sharded products' sums reassociate)
MESH_PARAM_TOL = 2e-2
# (e)'s step-0 loss against the unsharded model: fp32 sums over the ranks
TP_LM_LOSS_RTOL = 1e-5
# --parent DIR: phase 15 (b) and (e) run on that tree too, beside this one's
PARENT_TREE = None


def _state_bytes_of(tree) -> int:
    """Bytes this rank holds of a tree (local shards of DTensors)."""
    from repro_torch.core.types import tree_leaves

    def local(x):
        return x.to_local() if hasattr(x, "to_local") else x

    return sum(local(x).numel() * local(x).element_size() for x in tree_leaves(tree))


def _state_bytes(state) -> int:
    """Bytes this rank holds of the params and the EF buffers."""
    return _state_bytes_of((state.params, state.wstate.comp_state))


def _timed_steps(step, device, step_s, model_bytes, logged=1):
    """``step`` timed to the card's end; step ``logged`` runs under the wire
    log, and its bytes over the model axis (each rank's rows) are kept."""
    import torch

    from repro_torch.comm import collectives

    def timed(*a, **kw):
        t0 = time.perf_counter()
        if len(step_s) == logged:
            with collectives.wire_log() as rows:
                out = step(*a, **kw)
            model_bytes.append(sum(r["result_bytes"] for r in rows if r["axes"] == ["model"]))
        else:
            out = step(*a, **kw)
        torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        return out

    return timed


def _tp_compute(built) -> str:
    """The step's model-axis compute path (a tree from before it was named
    gathers the params on every rank)."""
    return getattr(built, "tp_compute", "gathered (a tree before tp_compute)")


def _mesh_rank(group, argv):
    """One rank of phase 15 (b), (c) (module-level: the spawned ranks import
    it): the launcher's training of ``argv`` on a device mesh over the
    group, each step timed to the card's end (step 1 under the wire log);
    returns the per-step metrics, the full params (gathered by every
    rank), the local shapes of the params, the param + EF bytes it holds,
    its peak of allocated device memory, its top-k launches, its
    model-axis compute path and bytes per step."""
    import torch

    from repro_torch.core.types import tree_flatten_with_paths
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch import train as launch

    trainer = launch.build_trainer(launch.parse_args(argv), print, group)
    step_s, model_bytes = [], []
    trainer.built = trainer.built._replace(step=_timed_steps(
        trainer.built.step, group.device, step_s, model_bytes))
    topk_ef.LAUNCHES.reset()
    topk_ef.SEGMENTS.reset()
    state = trainer.run(seed=0)
    torch.cuda.synchronize(group.device)
    launches, segments = topk_ef.LAUNCHES.count, topk_ef.SEGMENTS.count
    full = trainer.built.gather_state(state)
    paths, leaves, _ = tree_flatten_with_paths(full.params)
    lpaths, lleaves, _ = tree_flatten_with_paths(state.params)
    return {"rank": group.rank, "history": trainer.history, "step_s": step_s,
            "params": {p: x.cpu().numpy() for p, x in zip(paths, leaves)},
            "local_shapes": {p: tuple((x.to_local() if hasattr(x, "to_local") else x).shape)
                             for p, x in zip(lpaths, lleaves)},
            "bytes": _state_bytes(state), "peak": torch.cuda.max_memory_allocated(group.device),
            "launches": launches, "segments": segments, "tp_compute": _tp_compute(trainer.built),
            "model_bytes": model_bytes[0], "ms": statistics.median(step_s[2:]) * 1e3}


TP_LM_WORKERS, TP_LM_TOKENS, TP_LM_STEPS, TP_LM_LR = 2, 256, 3, 0.02


def _fp32_cut(arch, layers):
    """``arch`` at full width, ``layers`` deep, in fp32."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=layers, param_dtype="float32",
                               compute_dtype="float32")


def _tp_lm_cfg():
    """Phase 15 (e)'s model: phase 15 (d)'s cut of llama3_8b (full width,
    ``FP32_CHECK_LAYERS`` layers, fp32)."""
    return _fp32_cut(DENSE_ARCH, FP32_CHECK_LAYERS)


def _tp_lm_batches(cfg=None, workers=TP_LM_WORKERS, tokens=TP_LM_TOKENS, steps=TP_LM_STEPS):
    from repro_torch.data import indexed_token_stream

    cfg = cfg or _tp_lm_cfg()
    stream = indexed_token_stream(cfg.vocab_size, workers, tokens, seed=0)
    return [stream.batch_at(t) for t in range(steps)]


def _tp_lm_rank(group, cfg=None, workers=TP_LM_WORKERS, tokens=TP_LM_TOKENS,
                steps=TP_LM_STEPS, lr=TP_LM_LR):
    """One rank of phase 15 (e) (or (j): ``cfg`` and its cell's sizes): SASG
    (per_shard topk_ef) on ``_tp_lm_cfg`` over a (1, 2) device mesh,
    ``TP_LM_WORKERS`` workers x 1 x ``TP_LM_TOKENS`` tokens,
    ``TP_LM_STEPS`` steps from ``init(seed=0)``, each timed (step 1 under
    the wire log). Returns the history, the ms per step, the peak, the
    model-axis bytes of a step and the top-k launches; a CUDA
    out-of-memory error comes back as the finding."""
    import torch

    from repro_torch.core.sasg import PRESETS
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import build_train_step

    cfg = cfg or _tp_lm_cfg()
    torch.cuda.reset_peak_memory_stats(group.device)
    mesh = make_test_mesh((1, 2), ("data", "model"), group=group)
    try:
        built = build_train_step(build(cfg), PRESETS["sasg"](), workers, constant(lr),
                                 group=group, mesh=mesh)
        topk_ef.LAUNCHES.reset()
        topk_ef.SEGMENTS.reset()
        state = built.init(seed=0)
        step_s, model_bytes, hist = [], [], []
        step = _timed_steps(built.step, group.device, step_s, model_bytes)
        for batch in _tp_lm_batches(cfg, workers, tokens, steps):
            state, mets = step(state, batch)
            hist.append({k: float(mets[k]) for k in (
                "loss", "num_sent", "rounds_total", "bits_paper_total", "bits_wire_total")})
    except torch.cuda.OutOfMemoryError as e:
        return {"rank": group.rank, "oom": str(e).splitlines()[0],
                "peak": torch.cuda.max_memory_allocated(group.device)}
    except RuntimeError as e:   # e.g. the other rank ran out of memory and left
        return {"rank": group.rank, "error": f"{type(e).__name__}: {str(e).splitlines()[0]}",
                "peak": torch.cuda.max_memory_allocated(group.device)}
    torch.cuda.synchronize(group.device)
    return {"rank": group.rank, "history": hist, "ms": statistics.median(step_s[1:]) * 1e3,
            "step_s": step_s, "peak": torch.cuda.max_memory_allocated(group.device),
            "model_bytes": model_bytes[0], "launches": topk_ef.LAUNCHES.count,
            "segments": topk_ef.SEGMENTS.count, "tp_compute": _tp_compute(built),
            "bytes": _state_bytes(state)}


def _tp_lm_reference(cfg=None, workers=TP_LM_WORKERS, tokens=TP_LM_TOKENS):
    """Phase 15 (e)'s (or (j)'s) step-0 loss on one process: the same params
    (``init(seed=0)`` draws the full params on the card), each worker's
    rows through the unsharded model, averaged over the workers; and an
    MoE's router picks (``_record_router``) in that forward."""
    import torch

    from repro_torch.models import build
    from repro_torch.train.step import resolve_device, worker_batch

    cfg = cfg or _tp_lm_cfg()
    dev = resolve_device("cuda")
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    wb = worker_batch(_tp_lm_batches(cfg, workers, tokens)[0], workers, dev)
    picks, undo = _record_router()
    try:
        with torch.no_grad():
            losses = [float(model.loss_fn(params, {k: v[m] for k, v in wb.items()}))
                      for m in range(workers)]
    finally:
        undo()
    del params
    torch.cuda.empty_cache()
    return sum(losses) / len(losses), picks


def tp_cells(tree: str) -> dict:
    """Phase 15 (b) and (e) on the package of ``tree`` (a checkout, e.g.
    the parent's from ``git archive``): each rank's compute path, ms per
    step, peak and model-axis bytes, or (e)'s out-of-memory error."""
    import torch

    from repro_torch.comm import process_group

    torch.use_deterministic_algorithms(True)   # as phase 15 runs them
    argv = _mesh_argv() + ["--mesh-shape", "1,2", "--procs", "2", "--backend", "gloo"]
    keep = ("rank", "tp_compute", "ms", "peak", "model_bytes", "launches", "oom", "error")
    out = {"tree": tree}
    for label, fn, args in (("b", _mesh_rank, (argv,)), ("e", _tp_lm_rank, ())):
        try:
            ranks = process_group.spawn(fn, 2, "gloo", "cuda", args=args)
            out[label] = [{k: r[k] for k in keep if k in r} for r in ranks]
        except Exception as e:   # a rank that died: its error is the finding
            out[label] = {"error": f"{type(e).__name__}: {str(e).splitlines()[-1][:300]}"}
        torch.cuda.empty_cache()
    return out


def _mesh_argv():
    """Phase 4's cell through the launcher (phase 15's base command)."""
    return ["--arch", "cnn_cifar", "--algo", "sasg", "--workers", str(WORKERS),
            "--global-batch", str(WORKERS * PER_WORKER), "--lr", str(LR),
            "--steps", str(STEPS), "--device", "cuda"]


def _tp_serve(arch, group=None):
    """Phase 15 (d) (llama3_8b, ``FP32_CHECK_LAYERS`` layers, paged), (f)
    (mamba2_370m, ``SSD_GRAD_LAYERS`` layers, phase 6's prompts at chunk
    256), (g) (recurrentgemma_9b, ``RG_CHECK_LAYERS`` layers), (i)
    (mixtral_8x7b, ``FP32_CHECK_LAYERS`` layers, phase 12 (d)'s prompts at
    chunk 32) or (k) (internvl2_2b, ``FP32_CHECK_LAYERS`` layers); (d), (g)
    and (k) with phase 10's fp32 prompts at chunk 64: fp32 at full width,
    served unsharded or over the (1, 2) device mesh of ``group``. Returns
    the completions, every tick's logits (the active rows, on the host),
    the KV heads of each attention layer's cache, the SSD chunk launches
    of each multi-token tick and the heads they ran at, an MoE's router
    picks (``_record_router``), the cache and param bytes, the ms per tick
    by width (median, count) and the model axis's collectives per tick
    (wire log rows, on ranks)."""
    import numpy as np
    import torch

    from repro_torch.comm import collectives
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build
    from repro_torch.serve import BatchedServer, Request, build_serve
    from repro_torch.serve.paged_cache import cache_bytes
    from repro_torch.train.step import resolve_device

    dev = resolve_device(group.device if group is not None else "cuda")
    if arch == SSD_ARCH:
        cfg = _fp32_cut(arch, SSD_GRAD_LAYERS)
        prompts, new, max_seq, chunk = (SERVE_PROMPTS, SERVE_NEW, SERVE_MAX_SEQ,
                                        cfg.ssm.chunk_size)
    elif arch == MOE_ARCH:
        cfg = _fp32_cut(arch, FP32_CHECK_LAYERS)
        prompts, new, max_seq, chunk = MOE_FULL_PROMPTS, MOE_FULL_NEW, 128, 32
    else:
        cfg = _fp32_cut(arch, RG_CHECK_LAYERS if arch == RG_ARCH else FP32_CHECK_LAYERS)
        prompts, new, max_seq, chunk = FP32_CHECK_PROMPTS, FP32_CHECK_NEW, 128, 64
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    serve = build_serve(model)
    if group is not None:
        mesh = make_test_mesh((1, 2), ("data", "model"), group=group)
        serve = build_serve(model, mesh, None, "model", "data", group=group)
        params = serve.place(params)
    torch.cuda.synchronize(dev)
    rng = np.random.default_rng(0)
    srv = BatchedServer(serve, params, cfg, len(prompts), max_seq, prefill_chunk=chunk)
    for uid, n in enumerate(prompts):
        srv.submit(Request(uid, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32), new))
    logits, tick_s, launches, calls = [], {}, [], []
    shapes = set()
    picks, undo = _record_router() if cfg.moe is not None else ([], lambda: None)
    while True:
        ssd_scan.LAUNCHES.reset()
        t0 = time.perf_counter()
        with collectives.wire_log() as rows:
            ran = srv.tick()
            torch.cuda.synchronize(dev)
        if not ran:
            break
        calls.append(sum(1 for r in rows if r["axes"] == ["model"]
                         and r["op"] != "router_record"))
        width = srv.last_tick.plan.width
        tick_s.setdefault(width, []).append(time.perf_counter() - t0)
        if width > 1:
            launches.append(ssd_scan.LAUNCHES.count)
            shapes |= ssd_scan.LAUNCHES.shapes
        logits.append(srv.last_tick.logits[srv.last_tick.plan.active].cpu().numpy())
    undo()
    kv = [int(st[k].shape[-2]) for st in srv.cache["unit"] + srv.cache["rem"]
          for k in ("k", "pk") if k in st]
    out = {"done": sorted((c["uid"], [int(t) for t in c["tokens"]]) for c in srv.completed),
           "logits": logits, "launches": launches, "picks": picks, "calls": calls,
           "heads": sorted({shape[3] for shape in shapes}), "shapes": shapes, "kv_heads": kv,
           "state_bytes": cache_bytes(srv.cache), "param_bytes": _state_bytes_of(params),
           "ms": {w: (statistics.median(v) * 1e3, len(v)) for w, v in sorted(tick_s.items())},
           "ms_all": statistics.median(t for v in tick_s.values() for t in v) * 1e3,
           "ticks": len(logits)}
    del params, srv, serve
    torch.cuda.empty_cache()
    return out


def _held_to(got, want, what) -> float:
    """``got``'s serving run against the unsharded ``want``: tokens equal and
    every tick's logits finite and within ``FP32_CARD_TOL`` of max|logits|
    (raises); the largest gap."""
    import numpy as np

    if got["done"] != want["done"] or len(got["logits"]) != len(want["logits"]):
        raise AssertionError(f"{what}: tokens {got['done']} vs {want['done']}")
    worst = 0.0
    for a, b in zip(got["logits"], want["logits"]):
        if not np.isfinite(a).all():
            raise AssertionError(f"{what}: logits not finite")
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    if worst > FP32_CARD_TOL:
        raise AssertionError(f"{what}: logits differ by {worst:.3g} of max|logits| > "
                             f"{FP32_CARD_TOL}")
    return worst


def _mesh_serve_rank(group, want):
    """One rank of phase 15 (d): the tensor-parallel server, held on the
    rank to the unsharded run ``want``; returns what it measured."""
    got = _tp_serve(DENSE_ARCH, group)
    return {"rank": group.rank, "worst": _held_to(got, want, f"mesh (d) rank {group.rank}"),
            "heads": got["kv_heads"], "param_bytes": got["param_bytes"], "ms": got["ms_all"],
            "ticks": got["ticks"]}


def phase_mesh(card, trainer_main, state_main):
    """Phase 15: the strategies and the TP geometry on the main path."""
    import numpy as np
    import torch

    from repro_torch.comm import process_group
    from repro_torch.core.types import tree_flatten_with_paths
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch import train as launch

    torch.use_deterministic_algorithms(True)   # as phase 4 ran; the ranks inherit it
    argv = _mesh_argv()
    keys = ("num_sent", "rounds_total", "bits_paper_total", "bits_wire_total")
    encodes = STEPS + 1

    def flat(params):
        paths, leaves, _ = tree_flatten_with_paths(params)
        return {p: x.cpu().numpy() for p, x in zip(paths, leaves)}

    # (a) stacked (10, 2): the kernel path, then the reference path
    runs, step_ms = {}, {}
    for impl in ("kernel", "reference"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        topk_ef.LAUNCHES.reset()
        topk_ef.SEGMENTS.reset()
        trainer = launch.build_trainer(launch.parse_args(
            argv + ["--mesh-shape", f"{WORKERS},2", "--topk-impl", impl]), print)
        step, step_s = trainer.built.step, []

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = step(*a, **kw)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out

        trainer.built = trainer.built._replace(step=timed)
        state = trainer.run(seed=0)
        torch.cuda.synchronize()
        runs[impl] = (trainer, state, topk_ef.LAUNCHES.count, topk_ef.SEGMENTS.count,
                      torch.cuda.max_memory_allocated() - base)
        step_ms[impl] = statistics.median(step_s[1:]) * 1e3
    trainer_a, state_a, launches_a, segments_a, peak_a = runs["kernel"]
    if trainer_a.built.strategy.name != "flat" or trainer_a.built.bits_paper != MESH_BITS_MODEL2:
        fail(f"mesh (a): strategy {trainer_a.built.strategy.name}, bits per upload "
             f"{trainer_a.built.bits_paper}, expected flat and {MESH_BITS_MODEL2}")
    hist_a = trainer_a.history
    if hist_a[-1]["bits_paper_total"] != hist_a[-1]["rounds_total"] * MESH_BITS_MODEL2:
        fail("mesh (a): bits_paper_total != rounds x 1,477,664")
    if launches_a != encodes or runs["reference"][2] != 0:
        fail(f"mesh (a): topk_ef launched {launches_a} times (expected {encodes}, one "
             f"grouped launch per encode) and {runs['reference'][2]} on the reference path")
    if not (_final_params_equal(state_a.params, runs["reference"][1].params)
            and trainer_a.history == runs["reference"][0].history):
        fail("mesh (a): the kernel path differs from topk_impl='reference'")
    bytes_a = _state_bytes(state_a)
    log(f"mesh (a) stacked (10, 2) flat: {MESH_BITS_MODEL2} bits per upload (the JAX "
        f"package's at model = 2; phase 4: 1,132,736), topk_ef {launches_a} launches "
        f"covering {segments_a} segments = {segments_a // encodes} per encode (phase 4: "
        f"37), kernel == reference bitwise over {STEPS} steps; rounds "
        f"{hist_a[-1]['rounds_total']:.0f}; params + EF {bytes_a} bytes; peak device "
        f"memory of the run {peak_a} bytes above what the process held before it")

    # (b) 2 gloo ranks on cuda:0 as a (1, 2) device mesh, each computing its
    # gradients on its own shards (tp_compute=sharded): counters exact,
    # params within the top-k tier of (a) (the sharded products' partial
    # sums are added over the ranks); (c) 1 NCCL rank (1, 1), which holds
    # the full params: bitwise phase 4
    want_a = [{k: h[k] for k in keys} for h in hist_a]
    params_a, params_main = flat(state_a.params), flat(state_main.params)
    want_main = [{k: h[k] for k in keys} for h in trainer_main.history]
    out = {"launches": launches_a, "ms": {"a": step_ms["kernel"]}, "ranks": {}}
    for label, shape, backend, want_hist, want_params in (
            ("b", "1,2", "gloo", want_a, params_a),
            ("c", "1,1", "nccl", want_main, params_main)):
        procs = 2 if shape == "1,2" else 1
        t0 = time.perf_counter()
        ranks = process_group.spawn(_mesh_rank, procs, backend, "cuda", args=(
            argv + ["--mesh-shape", shape, "--procs", str(procs), "--backend", backend],))
        took = time.perf_counter() - t0
        worst = 0.0
        for r in ranks:
            got = [{k: h[k] for k in keys} for h in r["history"]]
            if got != want_hist:
                fail(f"mesh ({label}) rank {r['rank']}: sends/counters differ: {got} vs "
                     f"{want_hist}")
            path = "sharded" if label == "b" else "none"
            if r["tp_compute"] != path:
                fail(f"mesh ({label}) rank {r['rank']}: tp_compute={r['tp_compute']}, "
                     f"expected {path}")
            for p, want in want_params.items():
                diff = float(np.max(np.abs(r["params"][p] - want)))
                worst = max(worst, diff)
                if label == "c" and not np.array_equal(r["params"][p].view(np.int32),
                                                       want.view(np.int32)):
                    fail(f"mesh (c) rank {r['rank']}: params {p} differ by {diff:.3g}")
                if label == "b" and not diff < MESH_PARAM_TOL:
                    fail(f"mesh (b) rank {r['rank']}: params {p} differ by {diff:.3g} "
                         f">= {MESH_PARAM_TOL}")
            if r["launches"] != encodes:
                fail(f"mesh ({label}) rank {r['rank']}: topk_ef launched {r['launches']} "
                     f"times, expected {encodes}")
            if label == "b":
                for p, shp in r["local_shapes"].items():
                    full = want_params[p].shape
                    halves = [i for i, (a, b) in enumerate(zip(shp, full)) if a != b]
                    if len(halves) > 1 or any(2 * shp[i] != full[i] for i in halves):
                        fail(f"mesh (b) rank {r['rank']}: {p} holds {shp} of {full}")
            out["launches"] += r["launches"]
        out["ranks"][label] = ranks
        ms = statistics.median(s for r in ranks for s in r["step_s"][2:]) * 1e3
        out["ms"][label] = ms
        sharded = (sum(1 for p, shp in ranks[0]["local_shapes"].items()
                       if shp != want_params[p].shape))
        log(f"mesh ({label}) {procs} {backend} rank(s) as a ({shape}) device mesh, "
            f"tp_compute={ranks[0]['tp_compute']}: sends and counters == "
            f"{'(a)' if label == 'b' else 'phase 4'} on every rank; params "
            + ("bitwise equal" if label == "c" else
               f"within {worst:.3g} of (a)'s (tolerance {MESH_PARAM_TOL})")
            + f"; topk_ef {sum(r['launches'] for r in ranks)} launches ({encodes} per rank, "
            f"{ranks[0]['segments'] // encodes} segments each); {sharded} of "
            f"{len(want_params)} leaves split; params + EF per rank "
            + ", ".join(str(r["bytes"]) for r in ranks)
            + f" bytes against (a)'s {bytes_a}; peak device memory per rank "
            + ", ".join(str(r["peak"]) for r in ranks)
            + f" bytes (the process's whole allocation; (a)'s run {peak_a}); "
            f"{took:.1f} s with the processes' start")
        for r in ranks:
            log(f"card {card}: mesh ({label}) rank {r['rank']} tp_compute={r['tp_compute']}: "
                f"{r['ms']:.2f} ms per step (median of steps 2..{STEPS - 1}), peak "
                f"{r['peak']} bytes, model-axis bytes per step {r['model_bytes']} (wire log, "
                f"step 1)")
    out["e"] = _phase_mesh_lm(card)
    out["launches"] += sum(r["launches"] for r in out["e"])
    if PARENT_TREE is not None:
        t0 = time.perf_counter()
        _parent_tp_cells(card, out)
        log(f"phase 15 (b), (e) on the parent tree: {time.perf_counter() - t0:.1f} s (not "
            "run without --parent)")
    # (d) serving over (b)'s mesh against the unsharded engine
    t0 = time.perf_counter()
    want = _tp_serve(DENSE_ARCH)
    torch.cuda.empty_cache()
    ranks = process_group.spawn(_mesh_serve_rank, 2, "gloo", "cuda", args=(want,))
    worst = max(r["worst"] for r in ranks)
    if any(2 * h != w for r in ranks for h, w in zip(r["heads"], want["kv_heads"])):
        fail(f"mesh (d): the ranks' pools hold {[r['heads'] for r in ranks]} KV heads, "
             f"expected half of {want['kv_heads']}")
    out["serve_ms"] = (want["ms_all"], statistics.median(r["ms"] for r in ranks))
    log(f"mesh (d) {DENSE_ARCH} ({FP32_CHECK_LAYERS} layers, fp32, paged) served by 2 gloo "
        f"ranks as a (1, 2) device mesh (tensor-parallel): tokens == the unsharded engine's, "
        f"{ranks[0]['ticks']} ticks, logits within {worst:.3g} of max|logits| (tolerance "
        f"{FP32_CARD_TOL}); KV heads per pool {ranks[0]['heads']} of {want['kv_heads']}; "
        f"params per rank {ranks[0]['param_bytes']} bytes of {want['param_bytes']}; "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"card {card}: mesh (d) ms per tick {out['serve_ms'][1]:.2f} against "
        f"{out['serve_ms'][0]:.2f} unsharded (medians, host clock around synchronize)")
    rec = _phase_mesh_recurrent(card)
    out["launches"] += rec["launches"] + _phase_mesh_moe(card)["launches"]
    out["ssd_chunk"], out["ssd_chunk_bwd"] = rec["ssd_chunk"], rec["ssd_chunk_bwd"]
    log(f"card {card}: mesh ms per step (a) {out['ms']['a']:.2f} (reference path "
        f"{step_ms['reference']:.2f}; median of steps 1..{STEPS - 1}), (b) "
        f"{out['ms']['b']:.2f}, (c) {out['ms']['c']:.2f} (median of steps 2..{STEPS - 1}, "
        f"over the ranks), host clock around synchronize")
    return out


# phase 15 (f)-(h): the recurrent layers' tensor-parallel forms (slice 17)
TP_SSD_WORKERS, TP_SSD_TOKENS, TP_SSD_STEPS, TP_SSD_LR = 2, 512, 3, 0.02
# (h)'s model-axis wire-log bytes of one SASG step on each rank, worked out
# from the shapes as tests/test_torch_mesh.py::_ssd_model_axis_bytes does
# (2 workers x 1 x 512 tokens, fp32, t = 2): per gradient evaluation (two a
# step) the embedding's reduce and the loss's hidden copy_to (t x 4,096 x
# 1,024 bytes each), the loss's three vocabulary-parallel statistics
# (3 x t x 4,096), and per layer the fused projection (4,384 columns)
# gathered and reduce-scattered back (4,384 x 4,096 x 3 / 2), the normed
# input's and the variance's copy_to and the variance's and w_out's reduce
# (t x 4,096 x 2,050), the vectors' copy_to (t x 2 x 4 x (3 x 32 + 2,048)),
# conv_w's reduce-scatter (2 x 4 x 2,304 x 4 / t); per step conv_w's
# gather in each layer (3 x 4 x 2,304 x 4: the fresh gradient's and each
# worker's stale one) and the rule's norm partials (t x 11 leaves x 3 x 4)
TP_SSD_MODEL_BYTES = 384_446_728


def _tp_ssd_train(group):
    """One rank of phase 15 (h): step 0's per-worker gradients of the fp32
    mamba2_370m cut on this rank's shards against the unsharded kernel
    path's on the full params (both from ``init(seed=0)``'s draw), then
    ``TP_SSD_STEPS`` SASG steps over the (1, 2) device mesh, each timed
    (step 1 under the wire log)."""
    import torch

    from repro_torch.comm.process_group import axis_group
    from repro_torch.core.sasg import PRESETS, per_worker_grad_fn
    from repro_torch.core.types import (tree_flatten, tree_flatten_with_paths, tree_leaves,
                                        tree_unflatten)
    from repro_torch.data import indexed_token_stream
    from repro_torch.dist import tensor_parallel
    from repro_torch.dist.sharding import P, is_spec, take_local
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import build_train_step
    from repro_torch.train.step import worker_batch

    dev = group.device
    cfg = _fp32_cut(SSD_ARCH, SSD_GRAD_LAYERS)
    model = build(cfg)
    mesh = make_test_mesh((1, 2), ("data", "model"), group=group)
    built = build_train_step(model, PRESETS["sasg"](), TP_SSD_WORKERS, constant(TP_SSD_LR),
                             group=group, mesh=mesh)
    stream = indexed_token_stream(cfg.vocab_size, TP_SSD_WORKERS, TP_SSD_TOKENS, seed=0)
    batches = [stream.batch_at(t) for t in range(TP_SSD_STEPS)]
    full = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    wb = worker_batch(batches[0], TP_SSD_WORKERS, dev)
    loss_ref, g_ref = per_worker_grad_fn(model.loss_fn)(full, wb, False)
    specs = tree_leaves(built.param_specs, is_leaf=is_spec)
    leaves, treedef = tree_flatten(full)
    local = tree_unflatten(treedef, [take_local(x, sp, mesh) for x, sp in zip(leaves, specs)])
    axis = tensor_parallel.ModelAxis(axis_group(group, mesh, "model"), "model")
    _reset_ssd_launches()
    loss_tp, g_tp = per_worker_grad_fn(tensor_parallel.local_model(model, axis).loss_fn)(
        local, wb, False)
    torch.cuda.synchronize(dev)
    eval_launches = (ssd_scan.LAUNCHES.count, ssd_scan_bwd.LAUNCHES.count)
    eval_shapes = ssd_scan.LAUNCHES.shapes | ssd_scan_bwd.LAUNCHES.shapes
    eval_heads = sorted({s[3] for s in eval_shapes})
    paths, refs, _ = tree_flatten_with_paths(g_ref)
    gaps = {}
    for path, ref, got, sp in zip(paths, refs, tree_leaves(g_tp), specs):
        want = take_local(ref, P(None, *tuple(sp)), mesh)
        scale = float(ref.abs().max())
        gaps[path] = float((got - want).abs().max()) / scale if scale else 0.0
        if not (bool(torch.isfinite(got).all()) and gaps[path] <= SSD_GRAD_TOL):
            raise AssertionError(f"mesh (h) rank {group.rank}: gradient {path} differs from "
                                 f"the unsharded kernel path's by {gaps[path]:.3g} of its max "
                                 f"> {SSD_GRAD_TOL}")
    ref_loss = float(loss_ref.mean())
    loss_gap = float((loss_tp - loss_ref).abs().max() / loss_ref.abs().max())
    del g_ref, g_tp, refs, local, wb
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for counter in (topk_ef.LAUNCHES, topk_ef.SEGMENTS):
        counter.reset()
    _reset_ssd_launches()
    state = built.init(seed=0, params=full)
    del full
    step_s, model_bytes, hist = [], [], []
    step = _timed_steps(built.step, dev, step_s, model_bytes)
    for batch in batches:
        state, mets = step(state, batch)
        hist.append({k: float(mets[k]) for k in (
            "loss", "num_sent", "rounds_total", "bits_paper_total", "bits_wire_total")})
    torch.cuda.synchronize(dev)
    return {"history": hist, "ms": statistics.median(step_s[1:]) * 1e3, "step_s": step_s,
            "peak": torch.cuda.max_memory_allocated(dev), "model_bytes": model_bytes[0],
            "launches": topk_ef.LAUNCHES.count, "segments": topk_ef.SEGMENTS.count,
            "ssd": (ssd_scan.LAUNCHES.count, ssd_scan_bwd.LAUNCHES.count),
            "ssd_heads": sorted({s[3] for s in ssd_scan.LAUNCHES.shapes
                                 | ssd_scan_bwd.LAUNCHES.shapes}),
            "ssd_shapes": ssd_scan.LAUNCHES.shapes | ssd_scan_bwd.LAUNCHES.shapes | eval_shapes,
            "eval_launches": eval_launches, "eval_heads": eval_heads,
            "gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:4], "ref_loss": ref_loss,
            "eval_loss_gap": loss_gap, "tp_compute": _tp_compute(built),
            "bytes": _state_bytes(state)}


def _tp_recurrent_rank(group, want_f, want_g):
    """One rank of phase 15 (f), (g) and (h) (one spawn: the ranks' start is
    paid once); (f) and (g) held on the rank to the unsharded runs."""
    out = {"rank": group.rank}
    for label, arch, want in (("f", SSD_ARCH, want_f), ("g", RG_ARCH, want_g)):
        got = _tp_serve(arch, group)
        worst = _held_to(got, want, f"mesh ({label}) rank {group.rank}")
        out[label] = {k: got[k] for k in ("launches", "heads", "shapes", "kv_heads",
                                          "state_bytes", "param_bytes", "ms", "ticks")}
        out[label]["worst"] = worst
    out["h"] = _tp_ssd_train(group)
    return out


def _phase_mesh_recurrent(card):
    """Phase 15 (f), (g), (h) (module docstring): the unsharded serving runs
    in this process, then the 2 ranks; returns the SSD and top-k launches
    of the main paths ((f)'s ticks, (h)'s steps)."""
    import torch

    from repro_torch.comm import process_group

    t0 = time.perf_counter()
    want_f = _tp_serve(SSD_ARCH)
    want_g = _tp_serve(RG_ARCH)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = process_group.spawn(_tp_recurrent_rank, 2, "gloo", "cuda",
                                    args=(want_f, want_g))
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    torch.cuda.empty_cache()
    from repro_torch.models.ssd import ssd_dims

    from repro_torch.kernels import checks

    layers, heads = SSD_GRAD_LAYERS, ssd_dims(_fp32_cut(SSD_ARCH, SSD_GRAD_LAYERS))[1] // 2
    checked = {(c.b, c.s // c.chunk, c.chunk, c.h, c.p) for c in checks.ssd_tp_cases()}
    for r in ranks:
        f, h = r["f"], r["h"]
        unchecked = (f["shapes"] | h["ssd_shapes"]) - checked
        if unchecked:
            fail(f"mesh rank {r['rank']}: SSD kernels launched at {sorted(unchecked)}, shapes "
                 "that phases 3 and 14 (a) do not hold to the plain versions "
                 "(checks.ssd_tp_cases())")
        if not f["launches"] or set(f["launches"]) != {layers} or f["heads"] != [heads]:
            fail(f"mesh (f) rank {r['rank']}: SSD chunk launches per multi-token tick "
                 f"{f['launches']} at heads {f['heads']}, expected {layers} (one per layer) "
                 f"at {heads}")
        if set(r["g"]["kv_heads"]) != {1}:
            fail(f"mesh (g) rank {r['rank']}: local caches hold {r['g']['kv_heads']} KV heads, "
                 "expected the whole single head")
        evals = 2   # the fresh and the stale-params gradient a step
        if (h["eval_launches"] != (layers, layers) or h["eval_heads"] != [heads]
                or h["ssd"] != (layers * evals * TP_SSD_STEPS,) * 2
                or h["ssd_heads"] != [heads]):
            fail(f"mesh (h) rank {r['rank']}: SSD launches {h['eval_launches']} in one "
                 f"gradient evaluation at heads {h['eval_heads']} (expected {layers} each at "
                 f"{heads}), {h['ssd']} over the steps at heads {h['ssd_heads']} (expected "
                 f"{layers * evals * TP_SSD_STEPS} each)")
        hist = h["history"]
        if h["tp_compute"] != "sharded" or hist != ranks[0]["h"]["history"]:
            fail(f"mesh (h) rank {r['rank']}: tp_compute={h['tp_compute']}, history {hist} "
                 f"vs rank 0's {ranks[0]['h']['history']}")
        if not all(math.isfinite(x["loss"]) for x in hist) or hist[0]["num_sent"] != \
                TP_SSD_WORKERS:
            fail(f"mesh (h) rank {r['rank']}: losses {[x['loss'] for x in hist]}, step-0 "
                 f"sends {hist[0]['num_sent']}")
        gap = abs(hist[0]["loss"] - h["ref_loss"]) / abs(h["ref_loss"])
        if gap > TP_LM_LOSS_RTOL:
            fail(f"mesh (h) rank {r['rank']}: step-0 loss {hist[0]['loss']} vs the unsharded "
                 f"model's {h['ref_loss']}: {gap:.3g} > {TP_LM_LOSS_RTOL}")
        if h["launches"] != TP_SSD_STEPS + 1:
            fail(f"mesh (h) rank {r['rank']}: topk_ef launched {h['launches']} times, "
                 f"expected {TP_SSD_STEPS + 1} (one per encode and the zero payload)")
        if h["model_bytes"] != TP_SSD_MODEL_BYTES:
            fail(f"mesh (h) rank {r['rank']}: {h['model_bytes']} model-axis bytes a step, "
                 f"expected {TP_SSD_MODEL_BYTES} from the shapes")
    f0, g0, h0 = ranks[0]["f"], ranks[0]["g"], ranks[0]["h"]
    log(f"mesh (f) {SSD_ARCH} full width, {layers} layers, fp32, served by 2 gloo ranks as "
        f"(1, 2) (tensor-parallel SSD): tokens == the unsharded engine's, {f0['ticks']} "
        f"ticks, logits within {max(r['f']['worst'] for r in ranks):.3g} of max|logits| "
        f"(tolerance {FP32_CARD_TOL}); SSD chunk launches per multi-token tick "
        f"{f0['launches']} on each rank at H = {f0['heads']}; state bytes per rank "
        + ", ".join(str(r["f"]["state_bytes"]) for r in ranks)
        + f" of the unsharded {want_f['state_bytes']}; params per rank {f0['param_bytes']} "
        f"bytes of {want_f['param_bytes']}")
    log(f"mesh (g) {RG_ARCH} one unit ({RG_CHECK_LAYERS} layers), full width, fp32, served "
        f"by 2 gloo ranks as (1, 2) (tensor-parallel RG-LRU, whole KV head): tokens == the "
        f"unsharded engine's, {g0['ticks']} ticks, logits within "
        f"{max(r['g']['worst'] for r in ranks):.3g} of max|logits|; KV heads in each "
        f"rank's local caches {g0['kv_heads']}; params per rank "
        + ", ".join(str(r["g"]["param_bytes"]) for r in ranks)
        + f" bytes of {want_g['param_bytes']}; state bytes per rank {g0['state_bytes']} of "
        f"{want_g['state_bytes']}")
    log(f"mesh (h) {SSD_ARCH} full width, {layers} layers, fp32, SASG per_shard topk_ef, "
        f"{TP_SSD_WORKERS} workers x 1 x {TP_SSD_TOKENS} tokens, {TP_SSD_STEPS} steps over 2 "
        f"gloo ranks as (1, 2), tp_compute=sharded: step 0's per-worker gradients within "
        + ", ".join(f"{p} {g:.3g}" for p, g in h0["gaps"])
        + f" (largest, of each leaf's max; tolerance {SSD_GRAD_TOL}) of the unsharded kernel "
        f"path's, losses {h0['eval_loss_gap']:.3g} apart; SSD launches per gradient "
        f"evaluation {h0['eval_launches']} at H = {h0['eval_heads']}; loss "
        f"{h0['history'][0]['loss']:.6f} -> {h0['history'][-1]['loss']:.6f} (step 0 the "
        f"unsharded model's {h0['ref_loss']:.6f}), counters equal on both ranks; SSD "
        f"{h0['ssd']} launches over the steps, topk_ef {h0['launches']} a rank; model-axis "
        f"bytes a step {h0['model_bytes']} == {TP_SSD_MODEL_BYTES} from the shapes; params + "
        f"EF per rank " + ", ".join(str(r["h"]["bytes"]) for r in ranks)
        + f" bytes; {time.perf_counter() - t0:.1f} s for (f)-(h)")
    def per_width(ms):
        return ", ".join(f"{w}: {t:.2f} ({n} ticks)" for w, (t, n) in ms.items())

    for r in ranks:
        log(f"card {card}: mesh (f) rank {r['rank']} ms per tick by width "
            f"{per_width(r['f']['ms'])} (unsharded {per_width(want_f['ms'])}); (g) "
            f"{per_width(r['g']['ms'])} (unsharded {per_width(want_g['ms'])}), medians, host "
            "clock around synchronize")
        log(f"card {card}: mesh (h) rank {r['rank']}: {r['h']['ms']:.2f} ms per step (median "
            f"of steps 1..{TP_SSD_STEPS - 1}), peak {r['h']['peak']} bytes, model-axis bytes "
            f"per step {r['h']['model_bytes']} (wire log, step 1)")
    return {"ssd_chunk": sum(sum(r["f"]["launches"]) + r["h"]["ssd"][0] for r in ranks),
            "ssd_chunk_bwd": sum(r["h"]["ssd"][1] for r in ranks),
            "launches": sum(r["h"]["launches"] for r in ranks)}


# phase 15 (i)-(k): the MoE and a vocabulary the model axis does not
# divide, on the shards (slice 18)
MOE_ARCH, VLM_ARCH = "mixtral_8x7b", "internvl2_2b"
# (j): mixtral_8x7b at full width, 1 layer, fp32 (1.71 B params, 0.86 B a
# rank), 1 worker x 512 tokens: two ranks of 2 workers would need ~78 GB
TP_MOE_LAYERS, TP_MOE_WORKERS, TP_MOE_TOKENS, TP_MOE_STEPS, TP_MOE_LR = 1, 1, 512, 3, 0.02
# (j)'s step-0 loss against the unsharded model: the top-2 routing of 512
# tokens through sums reassociated over the ranks
TP_MOE_LOSS_RTOL = 1e-4
# (j)'s model-axis wire-log bytes of one SASG step on each rank, worked out
# from the shapes as tests/test_torch_mesh.py::_moe_model_axis_bytes does
# (1 worker x 1 x 512 tokens, fp32, t = 2, 8 experts split): per gradient
# evaluation (two a step) the embedding's reduce and the loss's hidden
# copy_to (t x 512 x 4,096 x 4 each), per layer the normed inputs' two
# copy_to and the attention's and the MoE's reduce (4 x t x 512 x 4,096 x
# 4), the router's logits gathered and reduce-scattered back (512 x 8 x 4
# x 3 / 2), the loss's three vocabulary-parallel statistics (3 x t x 512 x
# 4); per step the rule's norm partials (t x 13 leaves x 2 x 4)
TP_MOE_MODEL_BYTES = 201_400_528


def _moe_cfg():
    """Phase 15 (j)'s model."""
    return _fp32_cut(MOE_ARCH, TP_MOE_LAYERS)


def _same_picks(got, want) -> bool:
    """Two runs' router records (``_record_router``) pick the same experts,
    MoE call by MoE call."""
    import torch

    return len(got) == len(want) and all(torch.equal(a, b) for (a, _), (b, _) in zip(got, want))


def _tp_moe_rank(group, want_i, want_k):
    """One rank of phase 15 (i), (k) and (j) (one spawn: the ranks' start is
    paid once): (i) and (k) held on the rank to the unsharded runs, the
    router picks first; then (j)'s training."""
    out = {"rank": group.rank}
    for label, arch, want in (("i", MOE_ARCH, want_i), ("k", VLM_ARCH, want_k)):
        got = _tp_serve(arch, group)
        if not _same_picks(got["picks"], want["picks"]):
            raise AssertionError(f"mesh ({label}) rank {group.rank}: router picks differ from "
                                 f"the unsharded engine's over {len(got['picks'])} MoE calls")
        worst = _held_to(got, want, f"mesh ({label}) rank {group.rank}")
        out[label] = {k: got[k] for k in ("kv_heads", "state_bytes", "param_bytes", "ms",
                                          "ms_all", "ticks", "calls")}
        out[label].update(worst=worst, moe_calls=len(got["picks"]),
                          gap=min((m for _, m in got["picks"]), default=None))
    out["j"] = _tp_lm_rank(group, _moe_cfg(), TP_MOE_WORKERS, TP_MOE_TOKENS, TP_MOE_STEPS,
                           TP_MOE_LR)
    return out


def _phase_mesh_moe(card):
    """Phase 15 (i), (k), (j) (module docstring): the unsharded runs in this
    process, then the 2 ranks; returns (j)'s top-k launches."""
    import torch

    from repro_torch.comm import process_group

    t0 = time.perf_counter()
    want_i = _tp_serve(MOE_ARCH)
    want_k = _tp_serve(VLM_ARCH)
    ref, ref_picks = _tp_lm_reference(_moe_cfg(), TP_MOE_WORKERS, TP_MOE_TOKENS)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = process_group.spawn(_tp_moe_rank, 2, "gloo", "cuda", args=(want_i, want_k))
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    torch.cuda.empty_cache()
    for r in ranks:
        j = r["j"]
        if "oom" in j or "error" in j:
            fail(f"mesh (j) rank {r['rank']}: {j.get('oom') or j['error']} (peak {j['peak']} "
                 "bytes)")
        hist = j["history"]
        if j["tp_compute"] != "sharded" or hist != ranks[0]["j"]["history"]:
            fail(f"mesh (j) rank {r['rank']}: tp_compute={j['tp_compute']}, history {hist} "
                 f"vs rank 0's {ranks[0]['j']['history']}")
        if not all(math.isfinite(h["loss"]) for h in hist) or \
                hist[0]["num_sent"] != TP_MOE_WORKERS:
            fail(f"mesh (j) rank {r['rank']}: losses {[h['loss'] for h in hist]}, step-0 "
                 f"sends {hist[0]['num_sent']}")
        gap = abs(hist[0]["loss"] - ref) / abs(ref)
        if gap > TP_MOE_LOSS_RTOL:
            fail(f"mesh (j) rank {r['rank']}: step-0 loss {hist[0]['loss']} vs the unsharded "
                 f"model's {ref}: {gap:.3g} > {TP_MOE_LOSS_RTOL}")
        if j["launches"] != TP_MOE_STEPS + 1:
            fail(f"mesh (j) rank {r['rank']}: topk_ef launched {j['launches']} times, "
                 f"expected {TP_MOE_STEPS + 1} (one per encode and the zero payload)")
        if j["model_bytes"] != TP_MOE_MODEL_BYTES:
            fail(f"mesh (j) rank {r['rank']}: {j['model_bytes']} model-axis bytes a step, "
                 f"expected {TP_MOE_MODEL_BYTES} from the shapes")
    i0, k0, j0 = ranks[0]["i"], ranks[0]["k"], ranks[0]["j"]
    h = j0["history"]
    mcfg = _moe_cfg()

    def per_width(ms):
        return ", ".join(f"{w}: {t:.2f} ({n} ticks)" for w, (t, n) in ms.items())

    log(f"mesh (i) {MOE_ARCH} full width, {FP32_CHECK_LAYERS} layers, fp32, served by 2 gloo "
        f"ranks as (1, 2) (expert-parallel, {mcfg.moe.num_experts // 2} experts a rank): "
        f"router picks of {i0['moe_calls']} MoE calls equal to the unsharded engine's on both "
        f"ranks (smallest top-k gap {min(m for _, m in want_i['picks']):.3g}), tokens equal, "
        f"{i0['ticks']} ticks, logits within {max(r['i']['worst'] for r in ranks):.3g} of "
        f"max|logits| (tolerance {FP32_CARD_TOL}); params per rank "
        + ", ".join(str(r["i"]["param_bytes"]) for r in ranks)
        + f" bytes of {want_i['param_bytes']}; model-axis collectives per tick {i0['calls']}")
    log(f"mesh (k) {VLM_ARCH} full width ({want_k['param_bytes'] // 4} params, vocabulary "
        f"92,553 whole on each rank), {FP32_CHECK_LAYERS} layers, fp32, served by 2 gloo "
        f"ranks as (1, 2): tokens == the unsharded engine's, {k0['ticks']} ticks, logits "
        f"within {max(r['k']['worst'] for r in ranks):.3g} of max|logits|; params per rank "
        + ", ".join(str(r["k"]["param_bytes"]) for r in ranks)
        + f" bytes of {want_k['param_bytes']}; model-axis collectives per tick {k0['calls']}")
    log(f"mesh (j) {MOE_ARCH} full width, {TP_MOE_LAYERS} layer, fp32, SASG per_shard "
        f"topk_ef, {TP_MOE_WORKERS} worker x 1 x {TP_MOE_TOKENS} tokens, {TP_MOE_STEPS} steps "
        f"over 2 gloo ranks as (1, 2), tp_compute=sharded: loss {h[0]['loss']:.6f} -> "
        f"{h[-1]['loss']:.6f} (step 0 the unsharded model's {ref:.6f} within "
        f"{abs(h[0]['loss'] - ref) / abs(ref):.3g}, tolerance {TP_MOE_LOSS_RTOL}), counters "
        f"equal on both ranks; choices dropped past capacity in step 0's unsharded forward "
        f"{_dropped(mcfg, ref_picks)} of {TP_MOE_TOKENS * mcfg.moe.top_k * TP_MOE_LAYERS}; "
        f"topk_ef {j0['launches']} launches a rank ({j0['segments']} segments); model-axis "
        f"bytes a step {j0['model_bytes']} == {TP_MOE_MODEL_BYTES} from the shapes; params + "
        f"EF per rank " + ", ".join(str(r["j"]["bytes"]) for r in ranks)
        + f" bytes; {time.perf_counter() - t0:.1f} s for (i)-(k)")
    for r in ranks:
        log(f"card {card}: mesh (i) rank {r['rank']} ms per tick by width "
            f"{per_width(r['i']['ms'])} (unsharded {per_width(want_i['ms'])}); (k) "
            f"{per_width(r['k']['ms'])} (unsharded {per_width(want_k['ms'])}), medians, host "
            "clock around synchronize")
        log(f"card {card}: mesh (j) rank {r['rank']}: {r['j']['ms']:.2f} ms per step (median "
            f"of steps 1..{TP_MOE_STEPS - 1}), peak {r['j']['peak']} bytes, model-axis bytes "
            f"per step {r['j']['model_bytes']} (wire log, step 1)")
    return {"launches": sum(r["j"]["launches"] for r in ranks)}


def _phase_mesh_lm(card):
    """Phase 15 (e): llama3_8b at full width, 2 layers, fp32, SASG over 2
    gloo ranks as (1, 2) on cuda:0, each computing on its shards: loss
    finite and step 0's equal to the unsharded model's on the same params
    within ``TP_LM_LOSS_RTOL``, counters equal on both ranks (every worker
    sends at step 0), one top-k launch per encode; each rank's ms per
    step, peak and model-axis bytes."""
    import os

    import torch

    from repro_torch.comm import process_group

    t0 = time.perf_counter()
    ref, _ = _tp_lm_reference()
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = process_group.spawn(_tp_lm_rank, 2, "gloo", "cuda")
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    torch.cuda.empty_cache()
    for r in ranks:
        if "oom" in r or "error" in r:
            fail(f"mesh (e) rank {r['rank']}: {r.get('oom') or r['error']}")
        hist = r["history"]
        if r["tp_compute"] != "sharded" or hist != ranks[0]["history"]:
            fail(f"mesh (e) rank {r['rank']}: tp_compute={r['tp_compute']}, history {hist} "
                 f"vs rank 0's {ranks[0]['history']}")
        if not all(math.isfinite(h["loss"]) for h in hist) or hist[0]["num_sent"] != TP_LM_WORKERS:
            fail(f"mesh (e) rank {r['rank']}: losses {[h['loss'] for h in hist]}, step-0 sends "
                 f"{hist[0]['num_sent']}")
        gap = abs(hist[0]["loss"] - ref) / abs(ref)
        if gap > TP_LM_LOSS_RTOL:
            fail(f"mesh (e) rank {r['rank']}: step-0 loss {hist[0]['loss']} vs the unsharded "
                 f"model's {ref}: {gap:.3g} > {TP_LM_LOSS_RTOL}")
        if r["launches"] != TP_LM_STEPS + 1:
            fail(f"mesh (e) rank {r['rank']}: topk_ef launched {r['launches']} times, "
                 f"expected {TP_LM_STEPS + 1} (one per encode and the zero payload)")
    h = ranks[0]["history"]
    log(f"mesh (e) {DENSE_ARCH} full width, {FP32_CHECK_LAYERS} layers, fp32, SASG per_shard "
        f"topk_ef, {TP_LM_WORKERS} workers x 1 x {TP_LM_TOKENS} tokens, {TP_LM_STEPS} steps "
        f"over 2 gloo ranks as (1, 2) on cuda:0, tp_compute=sharded: loss {h[0]['loss']:.6f} "
        f"-> {h[-1]['loss']:.6f} (step 0 the unsharded model's {ref:.6f} within "
        f"{abs(h[0]['loss'] - ref) / abs(ref):.3g}), rounds {h[-1]['rounds_total']:.0f}, "
        f"counters equal on both ranks; topk_ef {ranks[0]['launches']} launches a rank "
        f"({ranks[0]['segments']} segments); params + EF per rank "
        + ", ".join(str(r["bytes"]) for r in ranks)
        + f" bytes; {time.perf_counter() - t0:.1f} s with the reference and the processes' "
        "start")
    for r in ranks:
        log(f"card {card}: mesh (e) rank {r['rank']} tp_compute={r['tp_compute']}: "
            f"{r['ms']:.2f} ms per step (median of steps 1..{TP_LM_STEPS - 1}), peak "
            f"{r['peak']} bytes, model-axis bytes per step {r['model_bytes']} (wire log, "
            "step 1)")
    return ranks


def _parent_tp_cells(card, out):
    """Phase 15 (b) and (e) on the parent tree (``--parent DIR``), run by
    this script in a process of its own on that tree's package, printed
    beside this tree's numbers."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tp-cells",
                           str(PARENT_TREE)], capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"tp_cells"')]
    if proc.returncode or not lines:
        fail(f"the parent tree's cells failed (exit {proc.returncode}): "
             f"{(proc.stderr or proc.stdout)[-2000:]}")
    cells = json.loads(lines[-1])["tp_cells"]
    for label in ("b", "e"):
        mine = {r["rank"]: r for r in (out["ranks"]["b"] if label == "b" else out["e"])}
        theirs = cells[label]
        if isinstance(theirs, dict):
            log(f"card {card}: mesh ({label}) parent tree {cells['tree']}: {theirs['error']}")
            continue
        for r in theirs:
            m = mine[r["rank"]]
            if "oom" in r or "error" in r:
                what = (f"{'out of memory' if 'oom' in r else 'failed'} "
                        f"({(r.get('oom') or r['error'])[:160]}), peak {r['peak']} bytes")
            else:
                what = (f"{r['ms']:.2f} ms per step, peak {r['peak']} bytes, model-axis "
                        f"bytes per step {r['model_bytes']}")
            log(f"card {card}: mesh ({label}) rank {r['rank']}: this tree "
                f"tp_compute={m['tp_compute']} {m['ms']:.2f} ms per step, peak {m['peak']} "
                f"bytes, model-axis bytes {m['model_bytes']}; parent tree "
                + (f"tp_compute={r['tp_compute']}: " if "tp_compute" in r else "") + what)


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 numbers at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def phase_serve():
    """The serving path at full width with the SSD launches counted, every
    tick replayed through an oracle model in lockstep."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_leaves, tree_map
    from repro_torch.kernels import checks
    from repro_torch.kernels.block_topk import block_topk
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.serve import BatchedServer, Request, build_serve, reset_slots, select_slots
    from repro_torch.train.step import resolve_device

    torch.use_deterministic_algorithms(False)
    dev = resolve_device("cuda")   # both TF32 flags off: fp32 matmuls stay fp32
    log(f"TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    cfg = get_config(SERVE_ARCH)
    model = build(cfg)                      # SSD through the CUDA kernel
    oracle = build(cfg, use_kernel=False)   # SSD through the oracle
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"{SERVE_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {n_params} params ({cfg.param_dtype}), compute {cfg.compute_dtype}")
    serve = build_serve(model)

    def twin(rec, pre, post):
        """Replay one tick layer by layer through both SSD paths on the
        kernel path's stream; returns the worst err/tol ratios."""
        plan = rec.plan
        act = torch.tensor(plan.active, device=dev)
        tokens = torch.from_numpy(plan.tokens).to(dev)
        x = L.embed_apply(params, cfg, tokens)
        worst = {"layer": 0.0, "h": 0.0, "logits": 0.0}
        where = f"tick {len(srv.ticks)} (width {plan.width})"
        for i in range(cfg.n_layers):
            lp = tree_map(lambda a: a[i], params["unit"][0])
            st = tree_map(lambda a: a[i], pre["unit"][0])
            xk, sk = LM._layer_apply(lp, cfg, "ssd", x, state=st, use_kernel=True)
            xo, so = LM._layer_apply(lp, cfg, "ssd", x, state=st, use_kernel=False)
            hk, ho = sk["h"][act], so["h"][act]
            if not torch.equal(hk, post["unit"][0]["h"][i][act]):
                fail(f"{where} layer {i}: the engine's SSD state differs from its replay")
            for key, a, b, tol in (
                ("layer", xk[act].float(), xo[act].float(),
                 LAYER_ULPS * bf16_ulp(float(xo[act].float().abs().max()))),
                ("h", hk, ho, checks.SSD_TOL * float(ho.abs().max())),
            ):
                err = float((a - b).abs().max())
                if not err <= tol:
                    fail(f"lockstep {where} layer {i}: {key} max abs diff {err:.4g} > {tol:.4g}")
                worst[key] = max(worst[key], err / tol if tol > 0 else 0.0)
            x = xk
        lk = L.lm_head_apply(params, cfg, L.rmsnorm(params["final_norm"], xk, cfg.norm_eps))
        lo = L.lm_head_apply(params, cfg, L.rmsnorm(params["final_norm"], xo, cfg.norm_eps))
        if not torch.equal(lk, rec.logits):
            fail(f"{where}: the engine's logits differ from its layer-by-layer replay")
        lk, lo = lk[act].float(), lo[act].float()
        if not (torch.isfinite(lk).all() and torch.isfinite(lo).all()):
            fail(f"{where}: logits not finite")
        tol = LOGIT_ULPS * bf16_ulp(float(lo.abs().max()))
        err = float((lk - lo).abs().max())
        if not err <= tol:
            fail(f"lockstep {where}: logits max abs diff {err:.4g} > {tol:.4g}")
        worst["logits"] = err / tol
        return worst

    class Lockstep(BatchedServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.oracle_cache = oracle.init_cache(self.batch, self.max_seq, self.device)
            self.ticks = []          # (width, seconds)
            self.peak = 0
            self.worst = {"layer": 0.0, "h": 0.0, "logits": 0.0}   # max err / tol
            self.free = 0.0          # free-running oracle: max |logits diff| / max |logits|
            self.agree = [0, 0]

        def _admit(self):
            admitted = super()._admit()
            self.pre_cache = self.cache   # what the tick's forward starts from
            return admitted

        def tick(self):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ran = super().tick()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.peak = max(self.peak, torch.cuda.max_memory_allocated())
            if ran:
                self.ticks.append((self.last_tick.plan.width, dt))
                # the replay's kernel launches are comparisons: keep them out
                # of the main path's count
                engine_launches = ssd_scan.LAUNCHES.count
                w = twin(self.last_tick, self.pre_cache, self.cache)
                ssd_scan.LAUNCHES.count = engine_launches
                self.worst = {k: max(v, w[k]) for k, v in self.worst.items()}
                self.free_running(self.last_tick)
            return ran

        def free_running(self, rec):
            """The oracle model on its own cache, as a user would run it:
            reported, not held (see LAYER_ULPS)."""
            plan = rec.plan
            if rec.admitted:
                mask = torch.zeros((self.batch,), dtype=torch.bool)
                mask[rec.admitted] = True
                self.oracle_cache = reset_slots(self.oracle_cache, mask.to(self.device))
            pos = torch.from_numpy(plan.pos).to(self.device)
            logits, nc = oracle.decode_step(self.params, self.oracle_cache,
                                            torch.from_numpy(plan.tokens).to(self.device), pos)
            self.oracle_cache = select_slots(nc, self.oracle_cache, pos >= 0)
            act = torch.tensor(plan.active, device=self.device)
            lk, lo = rec.logits[act].float(), logits[act].float()
            self.free = max(self.free, float((lk - lo).abs().max() / lo.abs().max()))
            for i in plan.samplers:
                j = plan.active.index(i)
                self.agree[0] += int(lk[j, -1].argmax() == lo[j, -1].argmax())
                self.agree[1] += 1

    def requests(n, new):
        rng = np.random.default_rng(0)
        return [Request(uid, rng.integers(0, cfg.vocab_size, size=SERVE_PROMPTS[uid % 4])
                        .astype(np.int32), new) for uid in range(n)]

    # warm-up (cuBLAS heuristics, the allocator): one request, not counted
    warm = BatchedServer(serve, params, cfg, SERVE_BATCH, SERVE_MAX_SEQ,
                         prefill_chunk=SERVE_PREFILL)
    warm.submit(requests(1, 2)[0])
    warm.drain(strict=True)
    del warm

    srv = Lockstep(serve, params, cfg, SERVE_BATCH, SERVE_MAX_SEQ, prefill_chunk=SERVE_PREFILL)
    reqs = requests(SERVE_REQUESTS, SERVE_NEW)
    for r in reqs:
        srv.submit(r)
    for counter in (topk_ef.LAUNCHES, block_topk.LAUNCHES, ssd_scan.LAUNCHES):
        counter.reset()
    done, pending = srv.drain(strict=True)
    launches = ssd_scan.LAUNCHES.count
    others = topk_ef.LAUNCHES.count + block_topk.LAUNCHES.count

    widths = [w for w, _ in srv.ticks]
    n_prefill = sum(1 for w in widths if w > 1)
    want = cfg.n_layers * n_prefill
    mix = ", ".join(f"{widths.count(w)} of width {w}" for w in sorted(set(widths), reverse=True))
    log(f"serving path: {len(done)} requests, {len(widths)} ticks ({mix}), "
        f"SSD kernel launches {launches} (expected {want} = {cfg.n_layers} layers x "
        f"{n_prefill} prefill ticks), top-k launches {others}")
    if launches != want or n_prefill == 0:
        fail(f"ssd_chunk launched {launches} times, expected {want}")
    if len(done) != SERVE_REQUESTS or pending:
        fail(f"served {len(done)} of {SERVE_REQUESTS} requests, pending {pending}")
    for r in done:
        if len(r["tokens"]) != SERVE_NEW or not all(0 <= t < cfg.vocab_size for t in r["tokens"]):
            fail(f"request {r['uid']}: bad completion {r['tokens']}")
    if not (torch.isfinite(srv.cache["unit"][0]["h"]).all()):
        fail("SSD state not finite after the drain")
    log(f"lockstep, every tick layer by layer on the kernel path's stream: engine logits "
        f"and SSD states == their replay bitwise; oracle layer outputs within {LAYER_ULPS} "
        f"bf16 ulps (worst {srv.worst['layer']:.3f} of the tolerance), SSD states within "
        f"{checks.SSD_TOL} of max (worst {srv.worst['h']:.3f}), logits within {LOGIT_ULPS} "
        f"bf16 ulps (worst {srv.worst['logits']:.3f})")
    log(f"free-running oracle model (own cache, not held): max |logits diff| "
        f"{srv.free:.4f} of max |logits|; greedy tokens agree {srv.agree[0]}/{srv.agree[1]}")
    per_width = {w: statistics.median([t for ww, t in srv.ticks if ww == w]) * 1e3
                 for w in sorted(set(widths), reverse=True)}
    engine_s = sum(t for _, t in srv.ticks)
    stats = srv.cache_stats()
    out = {
        "launches": launches, "n_prefill": n_prefill, "per_width_ms": per_width,
        "decode_tok_s": stats["decode_tokens"] / engine_s, "peak": srv.peak,
        "model": model, "params": params,
    }
    log("ms per tick (host clock around synchronize, median): "
        + ", ".join(f"width {w}: {ms:.2f}" for w, ms in per_width.items())
        + f"; {stats['decode_tokens']} sampled tokens in {engine_s:.3f} s of ticks = "
        f"{out['decode_tok_s']:.1f} tok/s; peak memory {srv.peak} bytes "
        f"(incl. the oracle's cache, {stats['cache_bytes']} bytes)")
    return out


def phase_free_running():
    """One width-512 tick from a fresh cache through the kernel model and
    the oracle model, each free-running over the 48 layers, in bf16 (the
    config) and in fp32: the bf16 divergence is reported, the fp32 one
    held to FP32_FREE_TOL."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build

    dev = torch.device("cuda")
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config(SERVE_ARCH), param_dtype=dtype, compute_dtype=dtype)
        model, oracle = build(cfg), build(cfg, use_kernel=False)
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PREFILL), generator=gen,
                               device=dev, dtype=torch.int32)
        pos = torch.zeros((SERVE_BATCH,), dtype=torch.int32, device=dev)
        lk, _ = model.decode_step(params, model.init_cache(SERVE_BATCH, SERVE_MAX_SEQ, dev),
                                  tokens, pos)
        lo, _ = oracle.decode_step(params, oracle.init_cache(SERVE_BATCH, SERVE_MAX_SEQ, dev),
                                   tokens, pos)
        lk, lo = lk.float(), lo.float()
        if not (torch.isfinite(lk).all() and torch.isfinite(lo).all()):
            fail(f"free-running {dtype}: logits not finite")
        peak = float(lo.abs().max())
        rel = float((lk - lo).abs().max()) / peak
        agree = float((lk.argmax(-1) == lo.argmax(-1)).float().mean())
        out[dtype] = rel
        log(f"free-running {dtype}, width {SERVE_PREFILL} x {SERVE_BATCH} slots, 48 layers: "
            f"kernel model vs oracle model max |logits diff| {rel:.3g} of max |logits| "
            f"({peak:.3f}); argmax agrees on {100 * agree:.1f}% of positions")
        del params, lk, lo
        torch.cuda.empty_cache()
    if not out["float32"] <= FP32_FREE_TOL:
        fail(f"free-running fp32: {out['float32']:.3g} of max |logits| > {FP32_FREE_TOL}")
    return out


def _fresh_cache(model, paged: bool, dev="cuda"):
    """A fresh decode cache of 4 slots of 1,024: dense, or paged (block 16,
    256 blocks, slot b's table naming blocks 64 b .. 64 b + 63)."""
    import torch

    if not paged:
        return model.init_cache(SERVE_BATCH, SERVE_MAX_SEQ, dev)
    nb = SERVE_MAX_SEQ // 16
    cache = model.init_paged_cache(SERVE_BATCH, SERVE_MAX_SEQ, SERVE_BATCH * nb, 16, None, dev)
    cache["bt"] = torch.arange(SERVE_BATCH * nb, dtype=torch.int32,
                               device=dev).reshape(SERVE_BATCH, nb)
    return cache


def profile_tick(model, params, width: int, iters: int, paged: bool = False):
    """Device busy share and top device ops of a tick of ``width`` over all
    slots (a forward from a fresh cache, what the engine's tick runs)."""
    import torch

    dev = "cuda"
    cache = _fresh_cache(model, paged, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, model.config.vocab_size, (SERVE_BATCH, width),
                           generator=gen, device=dev, dtype=torch.int32)
    pos = torch.zeros((SERVE_BATCH,), dtype=torch.int32, device=dev)
    model.decode_step(params, cache, tokens, pos)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            model.decode_step(params, cache, tokens, pos)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    log(f"profile width {width} x {SERVE_BATCH} slots{' (paged cache)' if paged else ''}: "
        f"wall {wall_us / iters / 1e3:.2f} ms, "
        f"device busy {busy_us / iters / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{sum(e.count for e in device) / iters:.0f} device ops per tick")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / iters / 1e3:8.3f} ms/tick {e.count / iters:6.1f}x  "
              f"{e.key[:90]}", flush=True)


def phase_ssd_times(n_layers: int):
    """The SSD kernel per width-512 prefill tick: one launch per layer at
    the tick's shape (4 slots, 2 chunks), each layer on its own copy of the
    operands as in the tick (cold in L2)."""
    import torch

    from repro_torch.kernels import checks
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import grid_blocks, head_slice, ssd_chunk_cuda

    case = checks.SsdCase("tick", SERVE_BATCH, SERVE_PREFILL, 32, 64, 1, 128, 256, "model")
    base = checks.ssd_chunk_inputs(case, "cuda")
    layers = [tuple(t.clone() for t in base) for _ in range(n_layers)]

    def run_kernel():
        for ins in layers:
            ssd_chunk_cuda(*ins)

    def run_plain():
        for ins in layers:
            ssd_chunk_ref(*ins)

    x, dt, da, b, c = base
    bsz, nc, q, h, p = x.shape
    g, n = b.shape[3], b.shape[4]
    tri = q * (q + 1) // 2
    # ops: C B^T once per (batch, chunk, group) on the causal half; per
    # head the causal half of W X, exp / mask / dt on W, the state product
    # and its scaling, the decay, and the cumsum
    ops = (bsz * nc * g * tri * n * 2
           + bsz * nc * h * (tri * p * 2 + tri * 3 + q * n * p * 2 + q * n + 3 * q))
    nbytes = 4 * (2 * x.numel() + dt.numel() + da.numel() + b.numel() + c.numel()
                  + bsz * nc * h * p * n)
    t_bytes = n_layers * nbytes / HBM_BYTES_PER_S * 1e3
    t_fp32 = n_layers * ops / FP32_OPS_PER_S * 1e3
    # the kernel's route, and so its bound: the three products (C B^T, W X,
    # the state) on the tensor cores, TF32_PASSES TF32 products each; the
    # fp32 CUDA-core bound above is printed beside it
    products = bsz * nc * (g * tri * n + h * (tri * p + q * n * p))
    t_ops = n_layers * 2 * products * TF32_PASSES / TF32_OPS_PER_S * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hs = head_slice(bsz * nc, q, h, g, n, sms)
    slices = -(-(h // g) // hs)
    kernel = (graph_ms(run_kernel, 10), cuda_ms(run_kernel, 5))
    plain = cuda_ms(run_plain, 2, warmup=1)
    out = {"ms": kernel[0], "eager_ms": kernel[1], "plain_ms": plain,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}
    log(f"ssd_chunk: {kernel[0]:.4f} ms per width-512 tick on the device ({n_layers} launches "
        f"at B={bsz} NC={nc} Q={q} H={h} P={p} G={g} N={n}; eager {kernel[1]:.4f} ms) vs bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}, 3xTF32 on the tensor cores: "
        f"{n_layers * 2 * products * TF32_PASSES / 1e9:.2f} GFLOP at {TF32_OPS_PER_S / 1e12} "
        f"TFLOP/s TF32 = {t_ops:.4f} ms; {n_layers * nbytes / 1e6:.0f} MB at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s = {t_bytes:.4f} ms), kernel at "
        f"{out['bound_ms'] / kernel[0]:.3f} of it; plain {plain:.3f} ms (eager); "
        f"no single PyTorch call computes this function")
    log(f"ssd_chunk fp32 CUDA-core bound: {max(t_bytes, t_fp32):.4f} ms "
        f"({n_layers * ops / 1e9:.2f} GFLOP at {FP32_OPS_PER_S / 1e12:.0f} TFLOP/s fp32 = "
        f"{t_fp32:.4f} ms), kernel at {max(t_bytes, t_fp32) / kernel[0]:.3f} of it; {hs} heads "
        f"per block: C B^T {slices} times per (b*z, group), not {h // g}; "
        f"{grid_blocks(bsz * nc, q, h, g, n, hs)} blocks per launch")
    return out


# ---------------------------------------------------------------------------
# phase 10: dense-attention serving (slice 7)
# ---------------------------------------------------------------------------

DENSE_ARCH = "llama3_8b"
DENSE_PREFILL = 256
DENSE_ARCHS = ("llama3_8b", "starcoder2_3b", "chatglm3_6b", "granite_20b", "internvl2_2b")
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
# The fp32 check of each dense arch at full width and 2 layers: the card's
# engine against the same engine on the CPU (2 slots, prompts of 64 and 40
# tokens, 4 new tokens), tokens equal and every tick's logits within
# FP32_CARD_TOL of max|logits|: fp32 products over up to 24,576 terms
# summed in other orders by cuBLAS and the CPU's BLAS (the CPU tests hold
# the reduced configs, K <= 256, to 1e-5 of max and measure ~1e-6).
FP32_CHECK_LAYERS, FP32_CHECK_PROMPTS, FP32_CHECK_NEW = 2, (64, 40), 4
FP32_CARD_TOL = 1e-4
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


def _tick_work(cfg, plan, matmul_params, other_param_bytes, elt):
    """What one engine tick must do, from its plan: bytes (params read
    once, the embed rows it gathers, the K/V of the positions its live
    queries attend to, the K/V and logits it writes), bf16 product FLOPs of
    its live tokens, and the FLOPs of the attention products (QK^T and PV,
    causal keys only)."""
    w = plan.width
    per_tok_kv = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * elt
    live = len(plan.active) * w
    keys = sum(int(plan.pos[i]) + w for i in plan.active)          # K/V rows read
    qk = sum(w * int(plan.pos[i]) + w * (w + 1) // 2 for i in plan.active)  # sum of (t + 1)
    nbytes = (other_param_bytes + elt * matmul_params + live * cfg.d_model * elt
              + keys * per_tok_kv + live * per_tok_kv + live * cfg.vocab_size * elt)
    mm_flops = 2 * live * matmul_params
    attn_flops = 4 * cfg.n_layers * cfg.n_heads * cfg.head_dim * qk
    return nbytes, mm_flops, attn_flops


def _timed_server(*args, keep_logits=False, **kw):
    """A BatchedServer whose ticks are timed (host clock around
    synchronize), with the peak memory over its ticks and the count of
    admissions at which the queue's head waited for blocks with a slot
    free; ``keep_logits``: each tick's logits of its active rows, copied to
    the host after the timing."""
    import torch

    from repro_torch.serve import BatchedServer

    class Timed(BatchedServer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.ticks = []      # (plan, seconds)
            self.logits = []
            self.peak = 0
            self.blocked = 0

        def _admit(self):
            admitted = super()._admit()
            if self.scheduler.queue and None in self.scheduler.slots:
                self.blocked += 1
            return admitted

        def tick(self):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ran = super().tick()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.peak = max(self.peak, torch.cuda.max_memory_allocated())
            if ran:
                rec = self.last_tick
                if not torch.isfinite(rec.logits[rec.plan.active]).all():
                    fail(f"{self.cfg.name} tick {len(self.ticks)}: logits not finite")
                self.ticks.append((rec.plan, dt))
                if keep_logits:
                    self.logits.append(rec.logits[rec.plan.active].cpu())
            return ran

    return Timed(*args, **kw)


def _serve_stream(serve, params, cfg, keep_logits=False, admit_blocks=None, **kw):
    """Phase 6's 8 requests through a timed server on 4 slots of 1,024
    (prefill chunk 256) after a one-request warm-up, drained strictly;
    ``kw`` picks the cache. ``admit_blocks``: a dense server admits as if
    it had a pool of that many blocks of 16 (its scheduler takes an
    allocator), so its tick plans are a paged server's. Returns
    ``(server, completed)``."""
    import numpy as np

    from repro_torch.serve import BatchedServer, BlockAllocator, Request

    def requests(n, new):
        rng = np.random.default_rng(0)
        return [Request(uid, rng.integers(0, cfg.vocab_size, size=SERVE_PROMPTS[uid % 4])
                        .astype(np.int32), new) for uid in range(n)]

    kw = dict(kw, prefill_chunk=DENSE_PREFILL)
    t0 = time.perf_counter()
    warm = BatchedServer(serve, params, cfg, SERVE_BATCH, SERVE_MAX_SEQ, **kw)
    warm.submit(requests(1, 2)[0])
    warm.drain(strict=True)
    del warm
    log(f"warm-up (one request, 2 new tokens): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    srv = _timed_server(serve, params, cfg, SERVE_BATCH, SERVE_MAX_SEQ,
                        keep_logits=keep_logits, **kw)
    if admit_blocks:
        srv.allocator = srv.scheduler.allocator = BlockAllocator(admit_blocks, 16)
    for r in requests(SERVE_REQUESTS, SERVE_NEW):
        srv.submit(r)
    done, pending = srv.drain(strict=True)
    log(f"drain: {time.perf_counter() - t0:.1f} s")
    if len(done) != SERVE_REQUESTS or pending:
        fail(f"{cfg.name}: served {len(done)} of {SERVE_REQUESTS}, pending {pending}")
    for r in done:
        if len(r["tokens"]) != SERVE_NEW or not all(0 <= t < cfg.vocab_size for t in r["tokens"]):
            fail(f"{cfg.name} request {r['uid']}: bad completion {r['tokens']}")
    return srv, done


def phase_dense_serve(card):
    """llama3_8b at full width and depth in bf16 served by BatchedServer on
    the dense cache; ms per tick of each width beside the tick's bounds;
    profiles; the bf16 reduced-precision reduction switch; then the fp32
    check of the five dense archs at 2 layers against the CPU. Returns the
    run's tokens, tick plans and logits (on the host) for phase 12."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_flatten_with_paths
    from repro_torch.models import build
    from repro_torch.serve import build_serve
    from repro_torch.train.step import resolve_device

    torch.use_deterministic_algorithms(False)
    dev = resolve_device("cuda")
    log(f"bf16 reduced-precision reduction: "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}; TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    cfg = get_config(DENSE_ARCH)
    model = build(cfg)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    paths, leaves, _ = tree_flatten_with_paths(params)
    n_params = sum(x.numel() for x in leaves)
    param_bytes = sum(x.numel() * x.element_size() for x in leaves)
    elt = leaves[0].element_size()
    matmul_params = sum(x.numel() for p, x in zip(paths, leaves)
                        if p.split("/")[-1] in MATMUL_LEAVES)
    # read once per tick besides the matmul weights: the norm scales (the
    # embed table is gathered row by row: counted per token)
    other_bytes = sum(x.numel() * x.element_size() for p, x in zip(paths, leaves)
                      if p.split("/")[-1] not in MATMUL_LEAVES + ("embed",))
    log(f"{DENSE_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, GQA "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n_params} "
        f"params, {param_bytes} bytes ({cfg.param_dtype}); init {init_s:.2f} s, peak "
        f"{init_peak} bytes during init")
    serve = build_serve(model)

    srv, done = _serve_stream(serve, params, cfg, paged=False, keep_logits=True)
    stats = srv.cache_stats()
    kv_bytes = stats["cache_bytes"]
    widths = [p.width for p, _ in srv.ticks]
    engine_s = sum(t for _, t in srv.ticks)
    mix = ", ".join(f"{widths.count(w)} of width {w}" for w in sorted(set(widths), reverse=True))
    log(f"dense serving: {len(done)} requests drained strictly in {len(widths)} ticks ({mix}); "
        f"KV cache {kv_bytes} bytes (dense, {stats['cache_dtype']})")
    out = {"per_width_ms": {}, "decode_tok_s": stats["decode_tokens"] / engine_s,
           "peak": srv.peak, "kv_bytes": kv_bytes, "init_s": init_s, "param_bytes": param_bytes,
           "tokens": {r["uid"]: r["tokens"] for r in done},
           "plans": [p for p, _ in srv.ticks], "logits": srv.logits}
    for w in sorted(set(widths), reverse=True):
        ticks = [(p, t) for p, t in srv.ticks if p.width == w]
        ms = statistics.median(t for _, t in ticks) * 1e3
        work = [_tick_work(cfg, p, matmul_params, other_bytes, elt) for p, _ in ticks]
        t_bytes = statistics.median(b for b, _, _ in work) / HBM_BYTES_PER_S * 1e3
        t_mm = statistics.median(f for _, f, _ in work) / BF16_OPS_PER_S * 1e3
        t_attn = statistics.median(a for _, _, a in work) / FP32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_mm)
        out["per_width_ms"][w] = ms
        log(f"  width {w:3d}: {len(ticks):2d} ticks, median {ms:.2f} ms (host clock around "
            f"synchronize); bound {bound:.3f} ms ({'bytes' if t_bytes >= t_mm else 'bf16 products'}"
            f": bytes {t_bytes:.3f} ms at {HBM_BYTES_PER_S / 1e12} TB/s, bf16 products "
            f"{t_mm:.3f} ms at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s), {bound / ms:.3f} of it")
        log(f"  width {w:3d}: fp32 attention products (causal keys) {t_attn:.3f} ms at "
            f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s on the CUDA cores")
    log(f"params alone at {HBM_BYTES_PER_S / 1e12} TB/s: {param_bytes / HBM_BYTES_PER_S * 1e3:.3f} "
        f"ms; decode {stats['decode_tokens']} tokens in {engine_s:.3f} s of ticks = "
        f"{out['decode_tok_s']:.1f} tok/s; peak memory {srv.peak} bytes")
    t0 = time.perf_counter()
    profile_tick(model, params, DENSE_PREFILL, 2)
    profile_tick(model, params, 1, 5)
    log(f"profiles: {time.perf_counter() - t0:.1f} s")
    # cuBLAS's bf16 reduced-precision reduction (the port turns it off):
    # one width-256 tick from a fresh cache with it off and on, timed in
    # turns off, on, on, off
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, DENSE_PREFILL), generator=gen,
                           device=dev, dtype=torch.int32)
    pos = torch.zeros((SERVE_BATCH,), dtype=torch.int32, device=dev)
    cache = model.init_cache(SERVE_BATCH, SERVE_MAX_SEQ, dev)
    logits, times = {}, {False: [], True: []}
    for flag in (False, True, True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
        logits[flag] = model.decode_step(params, cache, tokens, pos)[0].float()
        times[flag].append(cuda_ms(lambda: model.decode_step(params, cache, tokens, pos), 3,
                                   warmup=1))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    off, on = logits[False], logits[True]
    log(f"bf16 reduced-precision reduction on vs off, one width-{DENSE_PREFILL} tick: max "
        f"|logits diff| {float((on - off).abs().max() / off.abs().max()):.4g} of max |logits|, "
        f"argmax agrees on {100 * float((on.argmax(-1) == off.argmax(-1)).float().mean()):.2f}% "
        f"of positions; ms per tick (CUDA events, in turns off, on, on, off): off "
        f"{times[False][0]:.2f}, {times[False][1]:.2f}; on {times[True][0]:.2f}, "
        f"{times[True][1]:.2f}")
    del params, srv, cache, logits, off, on
    torch.cuda.empty_cache()
    log(f"card {card}: serving {DENSE_ARCH} (bf16, dense cache): "
        + ", ".join(f"width {w} {ms:.2f} ms/tick" for w, ms in out["per_width_ms"].items())
        + f", {out['decode_tok_s']:.1f} tok/s, peak memory {out['peak']} bytes, KV cache "
        f"{kv_bytes} bytes, init {init_s:.2f} s")
    out["fp32"] = _dense_fp32_checks(dev)
    return out


def _dense_fp32_checks(dev):
    """Each dense arch at full width, 2 layers, fp32: the card's engine
    against the CPU's on the same plan, one arch at a time."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_map
    from repro_torch.models import build
    from repro_torch.serve import BatchedServer, Request, build_serve

    class Recording(BatchedServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.records = []

        def tick(self):
            ran = super().tick()
            if ran:
                self.records.append(self.last_tick)
            return ran

    worst = {}
    for arch in DENSE_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=FP32_CHECK_LAYERS,
                                  param_dtype="float32", compute_dtype="float32")
        model = build(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        host = tree_map(lambda x: x.cpu(), params)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in FP32_CHECK_PROMPTS]
        runs = {}
        for where, p in (("cuda", params), ("cpu", host)):
            srv = Recording(build_serve(model), p, cfg, len(prompts), 128, paged=False,
                            prefill_chunk=64)
            for uid, prompt in enumerate(prompts):
                srv.submit(Request(uid, prompt, FP32_CHECK_NEW))
            done, _ = srv.drain(strict=True)
            runs[where] = ({r["uid"]: r["tokens"] for r in done}, srv.records)
        (tok_c, rec_c), (tok_h, rec_h) = runs["cuda"], runs["cpu"]
        if tok_c != tok_h or len(rec_c) != len(rec_h):
            fail(f"fp32 {arch}: the card's tokens {tok_c} differ from the CPU's {tok_h}")
        ratio = 0.0
        for rc, rh in zip(rec_c, rec_h):
            act = rh.plan.active
            a, b = rc.logits.cpu()[act], rh.logits[act]
            if rc.plan.active != act or not torch.isfinite(a).all():
                fail(f"fp32 {arch}: tick plans differ or logits not finite")
            err = float((a - b).abs().max() / b.abs().max())
            if not err <= FP32_CARD_TOL:
                fail(f"fp32 {arch} width {rh.plan.width}: logits differ by {err:.3g} of max "
                     f"> {FP32_CARD_TOL}")
            ratio = max(ratio, err)
        extra = ""
        if cfg.frontend == "patch_embed":   # the VLM prefix through prefill
            prefix = torch.from_numpy(rng.normal(size=(1, 16, cfg.d_model)).astype(np.float32))
            batch = {"tokens": torch.from_numpy(prompts[1][None]), "patch_embeds": prefix}
            lc, _ = model.prefill(params, {k: v.to(dev) for k, v in batch.items()})
            lh, _ = model.prefill(host, batch)
            err = float((lc.cpu() - lh).abs().max() / lh.abs().max())
            if not err <= FP32_CARD_TOL:
                fail(f"fp32 {arch}: prefill with a 16-token prefix differs by {err:.3g}")
            ratio, extra = max(ratio, err), f"; prefill with a 16-embedding prefix {err:.3g}"
        worst[arch] = ratio
        log(f"fp32 {arch} ({FP32_CHECK_LAYERS} of {get_config(arch).n_layers} layers, d_model "
            f"{cfg.d_model}, kv {cfg.n_kv_heads}, rope {cfg.rope_style}, {cfg.mlp_variant}): "
            f"{len(rec_c)} ticks, tokens equal, logits max diff {ratio:.3g} of max |logits| "
            f"(tolerance {FP32_CARD_TOL}){extra}; {time.perf_counter() - t0:.1f} s")
        del params, host, runs, rec_c, rec_h
        torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# phase 11: training a reduced LM with SASG through the top-k kernel (slice 7)
# ---------------------------------------------------------------------------

# lr 1.0: top-1% steps with error feedback; at the JAX launcher's 0.01 every
# worker skips after the first step, at 1.0 workers send and skip (13 of 40
# uploads sent on the CPU) and the loss falls 5.96 -> 4.66 in 10 steps
LM_WORKERS, LM_BATCH, LM_SEQ, LM_STEPS, LM_LR = 4, 8, 64, 10, 1.0


def phase_lm_training(arch=DENSE_ARCH):
    """A reduced LM (llama3_8b; in phase 12 mixtral_8x7b, whose expert
    leaves (n_units, E, d, f) join the segments), SASG, through
    ``repro_torch.launch.train``: one grouped EF + top-k launch per encode
    over the LM's leaves, counted; then the kernel run against
    ``topk_impl="reference"`` in lockstep."""
    import torch

    from repro_torch.core.compressors import CompressorConfig, leaf_geometry
    from repro_torch.core.types import tree_flatten_with_paths
    from repro_torch.kernels.block_topk import block_topk
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch import train as launch

    extra = ["--reduced", "--seq-len", str(LM_SEQ)]
    argv = ["--arch", arch, "--algo", "sasg", "--workers", str(LM_WORKERS),
            "--global-batch", str(LM_BATCH), "--steps", str(LM_STEPS), "--lr", str(LM_LR),
            "--device", "cuda", *extra]
    torch.use_deterministic_algorithms(True)
    for counter in (topk_ef.LAUNCHES, topk_ef.SEGMENTS, block_topk.LAUNCHES):
        counter.reset()
    _reset_ssd_launches()
    trainer, state = launch.train(argv, log_fn=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    launches, segments = topk_ef.LAUNCHES.count, topk_ef.SEGMENTS.count
    from repro_torch.configs import get_config

    ssd = _check_ssd_launches(get_config(arch).reduced(), trainer, LM_STEPS, arch)
    _check_topk_launches(state.params, LM_WORKERS, LM_STEPS, launches, segments, arch)
    log(f"{arch} training launches: block_topk {block_topk.LAUNCHES.count}")
    hist = trainer.history
    if len(hist) != LM_STEPS or not all(math.isfinite(r["loss"]) for r in hist):
        fail(f"{arch} training: loss not finite")
    bits = trainer.built.bits_paper
    rounds = _counters_exact(hist, bits, trainer.built.bits_wire, f"{arch} training")
    if hist[0]["num_sent"] != LM_WORKERS:
        fail(f"{arch} training: {hist[0]['num_sent']} first-step sends, expected {LM_WORKERS}")
    log(f"{arch} training: {LM_STEPS} steps, loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, "
        f"rounds {rounds:.0f}/{LM_WORKERS * LM_STEPS}, counters exact (bits(paper) = rounds x "
        f"{bits:.0f})")
    med = phase_lockstep(arch, LM_LR, state_main=state, want_skips=True,
                         workers=LM_WORKERS,
                         global_batch=LM_BATCH, steps=LM_STEPS, extra=extra)
    return {"launches": launches, "segments": segments, "step_ms": med, **ssd}


def _check_topk_launches(params, workers, steps, launches, segments, what):
    """One grouped EF + top-k launch per encode over the leaves of
    ``params`` at ``workers`` workers (``steps`` encodes and the zero
    payload's), covering one segment per leaf."""
    from repro_torch.core.compressors import CompressorConfig, leaf_geometry
    from repro_torch.core.types import tree_flatten_with_paths
    from repro_torch.kernels.topk_ef.topk_ef import plan_segments

    paths, leaves, _ = tree_flatten_with_paths(params)
    views = []
    for path, x in zip(paths, leaves):
        blocked, kb = leaf_geometry(CompressorConfig(), tuple(x.shape), path)
        views.append((workers * x.numel() // blocked[-1], blocked[-1], kb))
    per_encode = len(plan_segments(views, [(0, 0)] * len(views)).launches)
    encodes = steps + 1   # one encode per step + one zero_payload
    log(f"{what} training launches: topk_ef {launches} covering {segments} segments (expected "
        f"{per_encode * encodes} = {per_encode} per encode x {encodes} encodes, covering "
        f"{len(views) * encodes} = {len(views)} leaves x {encodes})")
    if launches != per_encode * encodes or segments != len(views) * encodes:
        fail(f"{what}: topk_ef launched {launches} times over {segments} segments")


def _reset_ssd_launches():
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd

    ssd_scan.LAUNCHES.reset()
    ssd_scan_bwd.LAUNCHES.reset()


def _check_ssd_launches(cfg, trainer, steps, what):
    """The SSD forward and backward kernels' launches of a training run: one
    of each per SSD layer per gradient evaluation (the workers folded into
    one call), 1 + 1 evaluations a step with selection on (the fresh and
    the stale-params gradients; 1 + 2 with a probe sub-batch), 1 without."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd

    sel = trainer.built.exchange.config.selection
    evals = 1 + (0 if not sel.enabled else 2 if sel.probe_fraction < 1.0 else 1)
    want = sum(cfg.layer_kind(i) == "ssd" for i in range(cfg.n_layers)) * evals * steps
    got = {"ssd_chunk": ssd_scan.LAUNCHES.count, "ssd_chunk_bwd": ssd_scan_bwd.LAUNCHES.count}
    if want:
        log(f"{what} training launches: ssd_chunk {got['ssd_chunk']}, ssd_chunk_bwd "
            f"{got['ssd_chunk_bwd']} (expected {want} each = SSD layers x {evals} gradient "
            f"evaluations a step x {steps} steps)")
    if got != {"ssd_chunk": want, "ssd_chunk_bwd": want}:
        fail(f"{what}: SSD launches {got}, expected {want} each")
    return got


# ---------------------------------------------------------------------------
# phase 12: the paged KV cache, MoE and sliding-window layers (slice 8)
# ---------------------------------------------------------------------------

SMALL_POOL = 64                # blocks of 16: a quarter of the dense-equivalent 256
# The bf16 cache codec on a model that computes in fp32: 2 layers of
# llama3_8b at full width, a chain of 2 rows x 64 prompt tokens + 8 decode
# steps on the paged cache, bf16 blocks against fp32 blocks, held to the
# JAX package's tolerance for it (tests/test_paged_cache.py: atol = rtol =
# 0.15 elementwise).
CODEC_TOL, CODEC_PROMPT, CODEC_STEPS = 0.15, 64, 8
MOE_ARCHS = ("mixtral_8x7b", "kimi_k2")
# mixtral_8x7b at full width, 2 of 32 layers, fp32 (3.1 B params, 12.4 GB):
# the card's engine against the CPU's on 2 prompts of 32 and 20 tokens
MOE_FULL_PROMPTS, MOE_FULL_NEW = (32, 20), 3


def _record_router():
    """Wrap ``layers.moe_apply`` so that every call appends the router's
    top-k picks (on the host) and the smallest gap between the k-th and
    the (k+1)-th probability of its tokens, from the full probabilities:
    a model-axis rank that holds E / t of the router's columns gathers its
    logits first (logged as ``router_record``, apart from the forward's
    collectives). Returns ``(records, undo)``."""
    import torch

    from repro_torch.models import layers as L

    orig, records = L.moe_apply, []

    def moe_apply(params, cfg, x, tp=None):
        x2 = x.reshape(-1, x.shape[-1])
        if tp is not None and params["router"].shape[-1] < cfg.moe.num_experts:
            probs = torch.softmax(tp.gather(x2.float() @ params["router"].float(), -1,
                                            op="router_record"), dim=-1)
        else:
            probs = L._router_probs(params, x2)
        vals, idx = L._top_k(probs, cfg.moe.top_k + 1)
        records.append((idx[:, :-1].cpu(), float((vals[:, -2] - vals[:, -1]).min())))
        return orig(params, cfg, x, tp=tp)

    def undo():
        L.moe_apply = orig

    L.moe_apply = moe_apply
    return records, undo


def _dropped(cfg, picks) -> int:
    """Choices past their expert's capacity in the recorded ``picks`` (each
    call's (tokens, k) top-k experts, routed in groups as
    ``layers.moe_apply`` routes them)."""
    import torch

    from repro_torch.models import layers as L

    out = 0
    for idx, _ in picks:
        group, cap = L.moe_capacity(cfg, idx.shape[0])
        for row in idx.reshape(idx.shape[0] // group, -1):
            out += int((torch.bincount(row, minlength=cfg.moe.num_experts) - cap)
                       .clamp(min=0).sum())
    return out


def _engine_runs(model, params, host, cfg, prompts, new, chunk):
    """The engine on the card and on the CPU over the same requests, each
    tick recorded, the router's picks too. Returns {where: (tokens,
    records, picks)}."""
    from repro_torch.serve import BatchedServer, Request, build_serve

    runs = {}
    for where, p in (("cuda", params), ("cpu", host)):
        picks, undo = _record_router()
        try:
            srv = BatchedServer(build_serve(model), p, cfg, len(prompts), 128,
                                prefill_chunk=chunk)
            for uid, prompt in enumerate(prompts):
                srv.submit(Request(uid, prompt, new))
            records = []
            while srv.tick():
                records.append(srv.last_tick)
        finally:
            undo()
        if srv.scheduler.n_pending:
            fail(f"{cfg.name} on {where}: requests left over")
        runs[where] = ({r["uid"]: r["tokens"] for r in srv.completed}, records, picks, srv.paged)
    return runs


def _hold_engine_runs(name, runs, tol):
    """Router picks first, for an MoE model (a near-tie flip is
    discontinuous), then tokens, then every tick's logits within ``tol`` of
    max|logits|."""
    import torch

    (tok_c, rec_c, pk_c, _), (tok_h, rec_h, pk_h, _) = runs["cuda"], runs["cpu"]
    if len(pk_c) != len(pk_h):
        fail(f"{name}: {len(pk_c)} MoE calls on the card, {len(pk_h)} on the CPU")
    if pk_h:
        margin = min(m for _, m in pk_h)
        flips = [i for i, ((a, _), (b, _)) in enumerate(zip(pk_c, pk_h))
                 if not torch.equal(a, b)]
        log(f"{name}: router top-k picks of {len(pk_c)} MoE calls "
            + ("equal on the card and the CPU" if not flips else f"DIFFER from call {flips[0]}")
            + f"; smallest gap between the k-th and (k+1)-th probability {margin:.3g}")
        if flips:
            fail(f"{name}: router picks differ at MoE call {flips[0]} (gap {margin:.3g})")
    if tok_c != tok_h or len(rec_c) != len(rec_h):
        fail(f"{name}: the card's tokens {tok_c} differ from the CPU's {tok_h}")
    worst = 0.0
    for rc, rh in zip(rec_c, rec_h):
        act = rh.plan.active
        a, b = rc.logits.cpu()[act], rh.logits[act]
        if rc.plan.active != act or not torch.isfinite(a).all():
            fail(f"{name}: tick plans differ or logits not finite")
        worst = max(worst, float((a - b).abs().max() / b.abs().max()))
    if not worst <= tol:
        fail(f"{name}: logits differ by {worst:.3g} of max > {tol}")
    return worst


def _same_ticks(name, srv, ref):
    """``srv``'s tick plans equal ``ref``'s (a timed server, or phase 10's
    record) and every tick's logits bitwise equal."""
    import numpy as np
    import torch

    plans = [p for p, _ in srv.ticks]
    ref_plans = ref["plans"] if isinstance(ref, dict) else [p for p, _ in ref.ticks]
    ref_logits = ref["logits"] if isinstance(ref, dict) else ref.logits
    if len(plans) != len(ref_plans) or any(
            a.width != b.width or a.active != b.active or not np.array_equal(a.pos, b.pos)
            for a, b in zip(plans, ref_plans)):
        fail(f"{name}: tick plans differ from the dense run's")
    unequal = [i for i, (a, b) in enumerate(zip(srv.logits, ref_logits))
               if not torch.equal(a, b)]
    if unequal:
        i = unequal[0]
        diff = float((srv.logits[i].float() - ref_logits[i].float()).abs().max())
        fail(f"{name}: logits of {len(unequal)} ticks differ from the dense run's, first tick "
             f"{i} (width {plans[i].width}) by {diff:.4g}")


def phase_paged_serve(card, dense):
    """(a) llama3_8b at full width on the paged cache, phase 10's stream,
    tokens and every tick's logits against phase 10's dense run; (b) the
    same stream from a 64-block pool; (c) the bf16 cache codec on a 2-layer
    fp32 llama3_8b; (d) the MoE archs, card against CPU."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_leaves, tree_map
    from repro_torch.models import build
    from repro_torch.serve import build_serve
    from repro_torch.train.step import resolve_device

    torch.use_deterministic_algorithms(False)
    dev = resolve_device("cuda")
    cfg = get_config(DENSE_ARCH)
    model = build(cfg)
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)   # phase 10's params
    serve = build_serve(model)
    out = {}

    # (a) the default pool (the dense-equivalent 256 blocks of 16)
    srv, done = _serve_stream(serve, params, cfg, paged=True, block_size=16, keep_logits=True)
    tokens = {r["uid"]: r["tokens"] for r in done}
    if tokens != dense["tokens"]:
        fail(f"paged {DENSE_ARCH}: tokens differ from the dense run's")
    _same_ticks(f"paged {DENSE_ARCH}", srv, dense)
    st = srv.cache_stats()
    widths = [p.width for p, _ in srv.ticks]
    log(f"paged {DENSE_ARCH} ({cfg.compute_dtype}, block 16, {st['num_blocks']} blocks): "
        f"{len(widths)} ticks, tick plans and tokens equal and every tick's logits bitwise "
        f"equal to the dense run's")
    for w in sorted(set(widths), reverse=True):
        ms = statistics.median(t for p, t in srv.ticks if p.width == w) * 1e3
        log(f"  width {w:3d}: {widths.count(w):2d} ticks, median {ms:.2f} ms paged vs "
            f"{dense['per_width_ms'][w]:.2f} ms dense (host clock around synchronize)")
        out.setdefault("per_width_ms", {})[w] = ms
    hw_ratio = st["high_water_bytes"] / st["dense_equiv_bytes"]
    log(f"  block high-water {st['block_high_water']}/{st['num_blocks']}: "
        f"{st['high_water_bytes']:.0f} bytes vs dense-equivalent {st['dense_equiv_bytes']:.0f} "
        f"({hw_ratio:.3f}x; {st['kv_bits_per_token'] / 8:.0f} bytes a token); cache "
        f"{st['cache_bytes']} bytes (dense {dense['kv_bytes']}); peak memory {srv.peak} bytes "
        f"(dense {dense['peak']})")
    if not st["high_water_bytes"] < st["dense_equiv_bytes"]:
        fail("paged high-water is not below the dense bytes")
    if srv.allocator.free_blocks != st["num_blocks"]:
        fail(f"{st['num_blocks'] - srv.allocator.free_blocks} blocks not returned")
    out.update(high_water=st["block_high_water"], high_water_bytes=st["high_water_bytes"],
               dense_bytes=st["dense_equiv_bytes"], peak=srv.peak)
    del srv, dense["logits"]
    # one tick of each cache on fresh caches, all 4 slots live, timed in
    # turns dense, paged, paged, dense (host clock around synchronize)
    gen = torch.Generator(device=dev).manual_seed(1)
    for w in (DENSE_PREFILL, 1):
        tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, w), generator=gen, device=dev,
                               dtype=torch.int32)
        pos = torch.zeros((SERVE_BATCH,), dtype=torch.int32, device=dev)
        caches = {False: _fresh_cache(model, False, dev), True: _fresh_cache(model, True, dev)}
        ms = {False: [], True: []}
        for paged in (False, True, True, False):
            model.decode_step(params, caches[paged], tokens, pos)
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.decode_step(params, caches[paged], tokens, pos)
                torch.cuda.synchronize()
                ms[paged].append((time.perf_counter() - t0) * 1e3)
        log(f"  width {w:3d} x {SERVE_BATCH} slots in turns dense, paged, paged, dense (5 ticks "
            f"each): median {statistics.median(ms[True]):.2f} ms paged vs "
            f"{statistics.median(ms[False]):.2f} ms dense")
        out.setdefault("turns_ms", {})[w] = (statistics.median(ms[True]),
                                              statistics.median(ms[False]))
        del caches
    profile_tick(model, params, 1, 5, paged=True)

    # (b) a 64-block pool: requests wait for blocks. Its plans differ from
    # the unconstrained run's (admission order, and so the widths a prompt
    # is fed in), and bf16 results depend on those widths, so the run is
    # held tick by tick to a dense server admitting under the same budget
    twin, twin_done = _serve_stream(serve, params, cfg, paged=False, keep_logits=True,
                                    admit_blocks=SMALL_POOL)
    small, done = _serve_stream(serve, params, cfg, paged=True, block_size=16,
                                num_blocks=SMALL_POOL, keep_logits=True)
    st = small.cache_stats()
    tokens = {r["uid"]: r["tokens"] for r in done}
    if tokens != {r["uid"]: r["tokens"] for r in twin_done}:
        fail(f"{SMALL_POOL}-block pool: tokens differ from the dense run's under the same "
             "admissions")
    _same_ticks(f"{SMALL_POOL}-block pool", small, twin)
    if small.allocator.free_blocks != SMALL_POOL or small.blocked == 0:
        fail(f"{SMALL_POOL}-block pool: {small.allocator.free_blocks} blocks back, "
             f"{small.blocked} admissions waited for blocks")
    if not small.peak < twin.peak:
        fail(f"{SMALL_POOL}-block pool: peak memory {small.peak} not below the dense "
             f"{twin.peak}")
    same = sum(tokens[u] == dense["tokens"][u] for u in tokens)
    widths = [p.width for p, _ in small.ticks]
    log(f"paged {DENSE_ARCH}, {SMALL_POOL}-block pool: {len(widths)} ticks, {small.blocked} "
        f"admissions waited for blocks, high-water {st['block_high_water']}/{SMALL_POOL}, every "
        f"block returned; tokens and every tick's logits bitwise equal to a dense run admitting "
        f"under the same budget; {same} of {len(tokens)} requests' tokens equal to the "
        f"unconstrained dense run's")
    for w in sorted(set(widths), reverse=True):
        ms = [statistics.median(t for p, t in srv_.ticks if p.width == w) * 1e3
              for srv_ in (twin, small)]
        log(f"  width {w:3d}: {widths.count(w):2d} ticks, median {ms[1]:.2f} ms paged vs "
            f"{ms[0]:.2f} ms dense on the same plans (dense run first)")
    log(f"  cache {st['cache_bytes']} bytes (dense {dense['kv_bytes']}); peak memory "
        f"{small.peak} bytes (dense on the same plans {twin.peak}, default pool {out['peak']})")
    out["small_peak"], out["small_ticks"], out["twin_peak"] = small.peak, len(widths), twin.peak
    del small, twin, params
    torch.cuda.empty_cache()

    # (c) the bf16 cache codec on a model that computes in fp32
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, n_layers=FP32_CHECK_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    m32 = build(cfg32)
    p32 = m32.init(torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, CODEC_PROMPT + CODEC_STEPS), generator=gen,
                         device=dev, dtype=torch.int32)
    nb = (CODEC_PROMPT + CODEC_STEPS + 15) // 16
    chains = {}
    for cache_dtype in (None, "bfloat16"):
        cache = m32.init_paged_cache(2, nb * 16, 2 * nb, 16, cache_dtype, dev)
        cache["bt"] = torch.arange(2 * nb, dtype=torch.int32, device=dev).reshape(2, nb)
        logits, cache = m32.decode_step(p32, cache, toks[:, :CODEC_PROMPT],
                                        torch.zeros(2, dtype=torch.int32, device=dev))
        outs = [logits]
        for t in range(CODEC_PROMPT, CODEC_PROMPT + CODEC_STEPS):
            logits, cache = m32.decode_step(p32, cache, toks[:, t:t + 1],
                                            torch.full((2,), t, dtype=torch.int32, device=dev))
            outs.append(logits)
        chains[cache_dtype] = torch.cat(outs, 1).float()
        if cache_dtype and cache["unit"][0]["pk"].dtype != torch.bfloat16:
            fail("the bf16 codec did not store bf16 blocks")
    f32, b16 = chains[None], chains["bfloat16"]
    excess = float(((b16 - f32).abs() - CODEC_TOL * (1 + f32.abs())).max())
    rel = float((b16 - f32).abs().max() / f32.abs().max())
    agree = float((b16.argmax(-1) == f32.argmax(-1)).float().mean())
    log(f"bf16 cache codec, {DENSE_ARCH} {FP32_CHECK_LAYERS} layers fp32: bf16 blocks vs fp32 "
        f"blocks over {CODEC_PROMPT} + {CODEC_STEPS} tokens x 2 rows, max |diff| {rel:.4g} of "
        f"max |logits| (tolerance atol = rtol = {CODEC_TOL}), argmax agrees on "
        f"{100 * agree:.2f}%; {time.perf_counter() - t0:.1f} s")
    if excess > 0:
        fail(f"bf16 cache codec: beyond atol = rtol = {CODEC_TOL}")
    out["codec_rel"] = rel
    del m32, p32, chains, f32, b16
    torch.cuda.empty_cache()

    # (d) MoE: the reduced configs, then mixtral at full width, 2 layers, fp32
    out["moe"] = {}
    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        mcfg = get_config(arch).reduced()
        mm = build(mcfg)
        mp = mm.init(torch.Generator(device=dev).manual_seed(0), dev)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, mcfg.vocab_size, size=n).astype(np.int32)
                   for n in FP32_CHECK_PROMPTS]
        runs = _engine_runs(mm, mp, tree_map(lambda x: x.cpu(), mp), mcfg, prompts,
                            FP32_CHECK_NEW, 64)
        err = _hold_engine_runs(f"reduced {arch}", runs, FP32_CARD_TOL)
        log(f"reduced {arch} ({'paged' if runs['cuda'][3] else 'dense'} cache): "
            f"{len(runs['cuda'][1])} ticks, tokens equal to the CPU engine's, logits max diff "
            f"{err:.3g} of max |logits| (tolerance {FP32_CARD_TOL}); "
            f"{time.perf_counter() - t0:.1f} s")
        out["moe"][arch] = err
    t0 = time.perf_counter()
    fcfg = dataclasses.replace(get_config("mixtral_8x7b"), n_layers=FP32_CHECK_LAYERS,
                               param_dtype="float32", compute_dtype="float32")
    fm = build(fcfg)
    fp = fm.init(torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(x.numel() for x in tree_leaves(fp))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, fcfg.vocab_size, size=n).astype(np.int32)
               for n in MOE_FULL_PROMPTS]
    runs = _engine_runs(fm, fp, tree_map(lambda x: x.cpu(), fp), fcfg, prompts, MOE_FULL_NEW,
                        32)
    err = _hold_engine_runs("mixtral_8x7b full width", runs, FP32_CARD_TOL)
    full_s = time.perf_counter() - t0
    log(f"mixtral_8x7b at full width, {FP32_CHECK_LAYERS} of 32 layers, fp32 ({n_params} "
        f"params): {len(runs['cuda'][1])} ticks, tokens equal to the CPU engine's, logits max "
        f"diff {err:.3g} of max |logits| (tolerance {FP32_CARD_TOL}); {full_s:.1f} s with the "
        f"CPU's run")
    out["moe"]["mixtral_8x7b full width"] = err
    del fm, fp, runs
    torch.cuda.empty_cache()
    log(f"card {card}: paged serving {DENSE_ARCH}: "
        + ", ".join(f"width {w} {ms:.2f} ms/tick" for w, ms in out["per_width_ms"].items())
        + f"; high-water {out['high_water']} blocks, {out['high_water_bytes']:.0f} of "
        f"{out['dense_bytes']:.0f} bytes; peak memory {out['peak']} (default pool; dense "
        f"{dense['peak']}), {out['small_peak']} ({SMALL_POOL} blocks; dense on its plans "
        f"{out['twin_peak']})")
    return out


# ---------------------------------------------------------------------------
# phase 13: the RG-LRU hybrid and the encoder-decoder (slice 9)
# ---------------------------------------------------------------------------

RG_ARCH = "recurrentgemma_9b"
# 26 RG-LRU states (h fp32, conv 3 x 4,096 bf16) and 12 local-attention
# rings of min(1,024, 2 x 2,048) slots, at 4 slots
RG_CACHE_BYTES = 54_788_096
RG_PARAMS = 10_444_664_832
RG_BF16_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head", "w_in",
                  "w_out")
RG_FP32_LEAVES = ("wa", "wx")       # the gates' products run in fp32
# one unit (rglru, rglru, local) at full width in fp32; the chained prefill
# + decode against the full forward within 1e-4 of max|logits|, as the JAX
# package's test_parity_rglru_close (the scan against the one-step
# recurrence); the CPU tests measure ~1e-6 at the reduced width
RG_CHECK_LAYERS, RG_CHAIN_TOL = 3, 1e-4
RG_CHAIN_PROMPT, RG_CHAIN_STEPS = 64, 8
ED_ARCH = "seamless_m4t_v2"
ED_PARAMS = 1_632_131_072
ED_ROWS, ED_FRAMES, ED_PROMPT, ED_NEW, ED_MAX_SEQ = 4, 512, 64, 16, 128
# generation (the chain: self cache written a token at a time, attended in
# one block) against a teacher-forced decode over the same tokens (the
# streaming full forward), of max|logits|: in fp32 the same algebra summed
# in other orders (measured 1.44e-6 at full depth on the H100); in bf16
# the chain also stores RoPE'd keys rounded to bf16 where the full forward
# keeps them in fp32, as the reference does (its own gap at the reduced
# size on the CPU: 6.1e-3, tests/test_torch_encdec.py; measured 1.22e-2 at
# full depth on the H100, held with a 4x margin)
ED_FP32_TOL = 1e-4
ED_BF16_TOL = 5e-2
# the card against the CPU at full width, 2 + 2 layers, fp32
ED_CHECK_LAYERS, ED_CHECK_ROWS, ED_CHECK_FRAMES, ED_CHECK_PROMPT, ED_CHECK_NEW = 2, 2, 256, 32, 4


def _rg_tick_work(cfg, plan, bf16_params, fp32_params, other_bytes, elt):
    """What one recurrentgemma tick must do, from its plan: bytes (params
    read once, the embed rows it gathers, each local layer's ring rows its
    live queries attend to and the K/V it writes, each RG-LRU state read and
    written, the logits), the bf16 products' FLOPs, the fp32 gate products'
    FLOPs and the fp32 attention products' FLOPs (causal keys: the window
    is wider than the cache)."""
    w = plan.width
    live = len(plan.active) * w
    n_local = sum(cfg.layer_kind(i) == "local" for i in range(cfg.n_layers))
    n_rec = cfg.n_layers - n_local
    width = cfg.rglru.lru_width
    per_tok_kv = n_local * 2 * cfg.n_kv_heads * cfg.head_dim * elt
    keys = sum(int(plan.pos[i]) + w for i in plan.active)
    qk = sum(w * int(plan.pos[i]) + w * (w + 1) // 2 for i in plan.active)
    state = n_rec * len(plan.active) * 2 * (4 * width + (cfg.rglru.d_conv - 1) * width * elt)
    nbytes = (other_bytes + elt * (bf16_params + fp32_params) + live * cfg.d_model * elt
              + keys * per_tok_kv + live * per_tok_kv + state + live * cfg.vocab_size * elt)
    attn = 4 * n_local * cfg.n_heads * cfg.head_dim * qk
    return nbytes, 2 * live * bf16_params, 2 * live * fp32_params, attn


def phase_rg_serve(card):
    """(a) recurrentgemma_9b at full width and depth in bf16 served by
    BatchedServer on the dense cache (nothing to page): phase 10's stream,
    ms per tick of each width beside its bounds, cache bytes, profiles."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_flatten_with_paths
    from repro_torch.models import build
    from repro_torch.serve import build_serve
    from repro_torch.train.step import resolve_device

    torch.use_deterministic_algorithms(False)
    dev = resolve_device("cuda")
    cfg = get_config(RG_ARCH)
    model = build(cfg)
    if model.init_paged_cache is not None:
        fail(f"{RG_ARCH}: a paged cache offered for a pattern with no global layer")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    paths, leaves, _ = tree_flatten_with_paths(params)
    names = [p.split("/")[-1] for p in paths]
    n_params = sum(x.numel() for x in leaves)
    param_bytes = sum(x.numel() * x.element_size() for x in leaves)
    elt = 2
    bf16_params = sum(x.numel() for n, x in zip(names, leaves) if n in RG_BF16_LEAVES)
    fp32_params = sum(x.numel() for n, x in zip(names, leaves) if n in RG_FP32_LEAVES)
    other_bytes = sum(x.numel() * x.element_size() for n, x in zip(names, leaves)
                      if n not in RG_BF16_LEAVES + RG_FP32_LEAVES + ("embed",))
    log(f"{RG_ARCH}: {cfg.n_layers} layers {cfg.attn_pattern} x 12 + 2, d_model "
        f"{cfg.d_model}, MQA {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, window "
        f"{cfg.window}, lru width {cfg.rglru.lru_width}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}: {n_params} params, {param_bytes} bytes ({cfg.param_dtype}); init "
        f"{init_s:.2f} s, peak {init_peak} bytes during init")
    if n_params != RG_PARAMS:
        fail(f"{RG_ARCH}: {n_params} params, the JAX config has {RG_PARAMS}")
    srv, done = _serve_stream(build_serve(model), params, cfg, paged=None)
    stats = srv.cache_stats()
    if srv.paged or stats["cache_bytes"] != RG_CACHE_BYTES:
        fail(f"{RG_ARCH}: cache {stats['cache_bytes']} bytes (paged {srv.paged}), expected "
             f"the dense {RG_CACHE_BYTES}")
    widths = [p.width for p, _ in srv.ticks]
    engine_s = sum(t for _, t in srv.ticks)
    mix = ", ".join(f"{widths.count(w)} of width {w}" for w in sorted(set(widths), reverse=True))
    log(f"{RG_ARCH} serving: {len(done)} requests drained strictly in {len(widths)} ticks "
        f"({mix}); cache {stats['cache_bytes']} bytes (dense: RG-LRU states and local rings)")
    out = {"per_width_ms": {}, "decode_tok_s": stats["decode_tokens"] / engine_s,
           "peak": srv.peak, "init_s": init_s}
    for w in sorted(set(widths), reverse=True):
        ticks = [(p, t) for p, t in srv.ticks if p.width == w]
        ms = statistics.median(t for _, t in ticks) * 1e3
        work = [_rg_tick_work(cfg, p, bf16_params, fp32_params, other_bytes, elt)
                for p, _ in ticks]
        t_bytes = statistics.median(x[0] for x in work) / HBM_BYTES_PER_S * 1e3
        t_bf16 = statistics.median(x[1] for x in work) / BF16_OPS_PER_S * 1e3
        t_gate = statistics.median(x[2] for x in work) / FP32_OPS_PER_S * 1e3
        t_attn = statistics.median(x[3] for x in work) / FP32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_bf16 + t_gate)
        out["per_width_ms"][w] = ms
        log(f"  width {w:3d}: {len(ticks):2d} ticks, median {ms:.2f} ms (host clock around "
            f"synchronize); bound {bound:.3f} ms "
            f"({'bytes' if t_bytes >= t_bf16 + t_gate else 'operations'}: bytes {t_bytes:.3f} "
            f"ms at {HBM_BYTES_PER_S / 1e12} TB/s; bf16 products {t_bf16:.3f} ms at "
            f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s + fp32 gate products {t_gate:.3f} ms at "
            f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s), {bound / ms:.3f} of it; fp32 attention "
            f"products (causal keys) {t_attn:.3f} ms")
    log(f"params alone at {HBM_BYTES_PER_S / 1e12} TB/s: {param_bytes / HBM_BYTES_PER_S * 1e3:.3f} "
        f"ms; decode {stats['decode_tokens']} tokens in {engine_s:.3f} s of ticks = "
        f"{out['decode_tok_s']:.1f} tok/s; peak memory {srv.peak} bytes")
    t0 = time.perf_counter()
    profile_tick(model, params, DENSE_PREFILL, 2)
    profile_tick(model, params, 1, 5)
    log(f"profiles: {time.perf_counter() - t0:.1f} s")
    del params, srv
    torch.cuda.empty_cache()
    log(f"card {card}: serving {RG_ARCH} (bf16, dense cache): "
        + ", ".join(f"width {w} {ms:.2f} ms/tick" for w, ms in out["per_width_ms"].items())
        + f", {out['decode_tok_s']:.1f} tok/s, peak memory {out['peak']} bytes, cache "
        f"{stats['cache_bytes']} bytes, init {init_s:.2f} s")
    return out


def phase_rg_checks():
    """(b) recurrentgemma_9b at full width, one unit (3 layers), fp32: the
    card's engine against the CPU's; on the card the chained prefill +
    decode against the full forward."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_map
    from repro_torch.models import build
    from repro_torch.models import lm as LM

    dev = "cuda"
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(RG_ARCH), n_layers=RG_CHECK_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in FP32_CHECK_PROMPTS]
    runs = _engine_runs(model, params, tree_map(lambda x: x.cpu(), params), cfg, prompts,
                        FP32_CHECK_NEW, 64)
    err = _hold_engine_runs(f"fp32 {RG_ARCH}", runs, FP32_CARD_TOL)
    log(f"fp32 {RG_ARCH} ({RG_CHECK_LAYERS} of {get_config(RG_ARCH).n_layers} layers, full "
        f"width, {'paged' if runs['cuda'][3] else 'dense'} cache): {len(runs['cuda'][1])} "
        f"ticks, tokens equal to the CPU engine's, logits max diff {err:.3g} of max |logits| "
        f"(tolerance {FP32_CARD_TOL}); {time.perf_counter() - t0:.1f} s with the CPU's run")
    gen = torch.Generator(device=dev).manual_seed(2)
    n = RG_CHAIN_PROMPT + RG_CHAIN_STEPS
    toks = torch.randint(0, cfg.vocab_size, (2, n), generator=gen, device=dev,
                         dtype=torch.int32)
    full, _ = LM.lm_forward(params, cfg, toks)
    cache = model.init_cache(2, n, dev)
    logits, cache = model.decode_step(params, cache, toks[:, :RG_CHAIN_PROMPT],
                                      torch.zeros(2, dtype=torch.int32, device=dev))
    outs = [logits]
    for t in range(RG_CHAIN_PROMPT, n):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1],
                                          torch.full((2,), t, dtype=torch.int32, device=dev))
        outs.append(logits)
    chain = torch.cat(outs, 1)
    rel = float((chain - full).abs().max() / full.abs().max())
    log(f"fp32 {RG_ARCH} on the card: prefill {RG_CHAIN_PROMPT} + {RG_CHAIN_STEPS} decode "
        f"steps against the full forward, max diff {rel:.3g} of max |logits| (tolerance "
        f"{RG_CHAIN_TOL})")
    if not rel <= RG_CHAIN_TOL:
        fail(f"{RG_ARCH}: the chain differs from the full forward by {rel:.3g}")
    del params, runs, cache, full, chain
    torch.cuda.empty_cache()
    return {"card_vs_cpu": err, "chain": rel}


def _ed_generate(model, params, cfg, frames, prompt, new, max_seq, timed=False):
    """Generation as the reference's functions define it: ``init_cache``
    with its ``"xkv"`` replaced by ``cross_kv(encode(frames))``, the prompt
    through ``decode_step`` at position 0, then ``new`` greedy tokens one at
    a time. Returns ``(step logits, tokens (B, new), xkv, step seconds)``."""
    import torch

    from repro_torch.models import encdec as ED

    cache = model.init_cache(prompt.shape[0], max_seq, prompt.device)
    cache["xkv"] = ED.cross_kv(params, cfg, ED.encode(params, cfg, frames))
    logits, cache = model.decode_step(params, cache, prompt, 0)
    outs, tokens, secs = [logits], [], []
    for t in range(new):
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        tokens.append(nxt)
        if timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, nxt, prompt.shape[1] + t)
        if timed:
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        outs.append(logits)
    return outs, torch.cat(tokens, 1), cache["xkv"], secs


def _ed_forced_gap(model, params, cfg, prompt, outs, tokens, xkv):
    """Max |chain - teacher-forced decode| over every step's logits, of the
    forced run's max|logits|."""
    import torch

    from repro_torch.models import encdec as ED

    seq = torch.cat([prompt, tokens[:, :-1]], 1)
    forced, _ = ED.decode(params, cfg, seq, xkv)
    chain = torch.cat(outs[:-1], 1).float()
    forced = forced.float()
    if not torch.isfinite(chain).all():
        fail(f"{cfg.name}: generated logits not finite")
    return float((chain - forced).abs().max() / forced.abs().max())


def phase_ed(card):
    """(c) seamless_m4t_v2 at full width and depth: generation against a
    teacher-forced decode in fp32, then in bf16 with encode and decode-step
    times; then 2 + 2 layers in fp32, the card against the CPU."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_flatten_with_paths, tree_map
    from repro_torch.models import build
    from repro_torch.models import encdec as ED

    dev = "cuda"
    base = get_config(ED_ARCH)
    gen = torch.Generator(device=dev).manual_seed(4)
    frames = torch.randn((ED_ROWS, ED_FRAMES, base.d_model), generator=gen, device=dev)
    prompt = torch.randint(0, base.vocab_size, (ED_ROWS, ED_PROMPT), generator=gen, device=dev,
                           dtype=torch.int32)
    out = {}
    for dtype, tol in (("float32", ED_FP32_TOL), ("bfloat16", ED_BF16_TOL)):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(base, param_dtype=dtype, compute_dtype=dtype)
        model = build(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        paths, leaves, _ = tree_flatten_with_paths(params)
        n_params = sum(x.numel() for x in leaves)
        if n_params != ED_PARAMS:
            fail(f"{ED_ARCH}: {n_params} params, the JAX config has {ED_PARAMS}")
        outs, tokens, xkv, secs = _ed_generate(model, params, cfg, frames, prompt, ED_NEW,
                                               ED_MAX_SEQ, timed=True)
        gap = _ed_forced_gap(model, params, cfg, prompt, outs, tokens, xkv)
        log(f"{ED_ARCH} {dtype} ({base.encoder_layers} + {base.n_layers} layers, full width, "
            f"{n_params} params): {ED_ROWS} rows x {ED_FRAMES} frames, {ED_PROMPT}-token "
            f"prompts, {ED_NEW} greedy tokens; every step's logits against a teacher-forced "
            f"decode over the same tokens: max diff {gap:.3g} of max |logits| (tolerance {tol})")
        if not gap <= tol:
            fail(f"{ED_ARCH} {dtype}: generation differs from the teacher-forced decode by "
                 f"{gap:.3g} of max > {tol}")
        out[dtype] = gap
        if dtype == "bfloat16":
            elt = 2
            enc_ms = cuda_ms(lambda: ED.encode(params, cfg, frames), 5, warmup=1)
            step_ms = statistics.median(secs) * 1e3
            dec_bytes = sum(x.numel() * x.element_size() for p, x in zip(paths, leaves)
                            if not p.startswith("enc") and p != "embed")
            kv_read = xkv["k"].numel() * elt * 2
            self_kv = (cfg.n_layers * ED_ROWS * (ED_PROMPT + ED_NEW) * 2 * cfg.n_kv_heads
                       * cfg.head_dim * elt)
            step_bytes = dec_bytes + kv_read + self_kv + ED_ROWS * cfg.vocab_size * elt
            enc_bytes = sum(x.numel() * x.element_size() for p, x in zip(paths, leaves)
                            if p.startswith("enc")) + frames.numel() * 4
            enc_flops = 2 * ED_ROWS * ED_FRAMES * sum(
                x.numel() for p, x in zip(paths, leaves)
                if p.startswith("enc_stack") and x.dim() == 3)
            enc_attn = 4 * base.encoder_layers * ED_ROWS * ED_FRAMES ** 2 * cfg.n_heads * cfg.head_dim
            enc_bound = max(enc_bytes / HBM_BYTES_PER_S, enc_flops / BF16_OPS_PER_S
                            + enc_attn / FP32_OPS_PER_S) * 1e3
            step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
            out.update(encode_ms=enc_ms, step_ms=step_ms, step_bound=step_bound,
                       peak=torch.cuda.max_memory_allocated())
            log(f"  encode {enc_ms:.2f} ms (CUDA events) against {enc_bound:.3f} ms (bf16 "
                f"products at {BF16_OPS_PER_S / 1e12:.0f} + fp32 attention products at "
                f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s, or bytes); decode step median "
                f"{step_ms:.2f} ms (host clock around synchronize) against a bytes bound of "
                f"{step_bound:.3f} ms ({step_bytes} bytes: decoder params and head, cross K/V, "
                f"self cache, logits); peak memory {out['peak']} bytes")
        del params, paths, leaves, outs, xkv
        torch.cuda.empty_cache()
        log(f"  {dtype} run: {time.perf_counter() - t0:.1f} s")

    # the card against the CPU, 2 + 2 layers, fp32
    t0 = time.perf_counter()
    cfg = dataclasses.replace(base, n_layers=ED_CHECK_LAYERS, encoder_layers=ED_CHECK_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    host = tree_map(lambda x: x.cpu(), params)
    f, p = frames[:ED_CHECK_ROWS, :ED_CHECK_FRAMES], prompt[:ED_CHECK_ROWS, :ED_CHECK_PROMPT]
    oc, tc, _, _ = _ed_generate(model, params, cfg, f, p, ED_CHECK_NEW, 64)
    oh, th, _, _ = _ed_generate(model, host, cfg, f.cpu(), p.cpu(), ED_CHECK_NEW, 64)
    if not torch.equal(tc.cpu(), th):
        fail(f"fp32 {ED_ARCH}: the card's tokens {tc.tolist()} differ from the CPU's "
             f"{th.tolist()}")
    err = max(float((a.cpu() - b).abs().max() / b.abs().max()) for a, b in zip(oc, oh))
    log(f"fp32 {ED_ARCH} ({ED_CHECK_LAYERS} + {ED_CHECK_LAYERS} layers, full width): "
        f"{ED_CHECK_ROWS} rows x {ED_CHECK_FRAMES} frames, {ED_CHECK_PROMPT}-token prompts, "
        f"{ED_CHECK_NEW} tokens: tokens equal to the CPU's, logits max diff {err:.3g} of max "
        f"|logits| (tolerance {FP32_CARD_TOL}); {time.perf_counter() - t0:.1f} s with the "
        f"CPU's run")
    if not err <= FP32_CARD_TOL:
        fail(f"fp32 {ED_ARCH}: logits differ by {err:.3g} of max > {FP32_CARD_TOL}")
    out["card_vs_cpu"] = err
    del params, host
    torch.cuda.empty_cache()
    log(f"card {card}: {ED_ARCH} (bf16): encode {out['encode_ms']:.2f} ms for {ED_ROWS} x "
        f"{ED_FRAMES} frames, decode step {out['step_ms']:.2f} ms ({out['step_bound']:.3f} ms "
        f"bytes bound), peak memory {out['peak']} bytes")
    return out


# ---------------------------------------------------------------------------
# phase 14: training the Mamba-2 stack through the SSD kernels (slice 10)
# ---------------------------------------------------------------------------

SSD_ARCH = "mamba2_370m"
SSD_WORKERS, SSD_BATCH, SSD_SEQ, SSD_STEPS = 4, 4, 512, 4
SSD_GRAD_LAYERS = 4
# (b): the kernel path's per-worker gradients against the oracle's, at full
# width, 4 layers, fp32. The two differ only in the chunk term (fp32 sums
# in other orders, held to SSD_TOL forward and SSD_BWD_TOL backward), which
# the 4 layers carry to every leaf: each leaf within SSD_GRAD_TOL of its
# largest magnitude, the backward kernel's tolerance.
SSD_GRAD_TOL = 1e-3


def phase_ssd_bwd_kernels():
    """(a) the backward kernel against its plain version on every case of
    ``checks.ssd_cases()`` and ``checks.ssd_tp_cases()`` (phase 15's
    shapes), and a second launch bitwise equal to the first."""
    from repro_torch.kernels import checks

    err = 0.0
    cases = checks.ssd_cases() + checks.ssd_tp_cases()
    for case in cases:
        e = checks.check_ssd_chunk_bwd(case)
        err = max(err, e)
        log(f"within tol: ssd_chunk_bwd {case.name:40s} {e:.3g} (5 gradients at the "
            f"wrapper's head slice, a second launch bitwise equal, and at "
            f"{checks.ssd_bwd_head_slices(case) or 'no other'} heads per block)")
    log(f"phase 14 (a): {len(cases)} SSD cases, the backward within "
        f"{checks.SSD_BWD_TOL} x max(1, max|plain|) of its plain version (largest error "
        f"{err:.3g}), repeat launches bitwise")
    return err


def phase_ssd_grad_full_width():
    """(b) mamba2_370m at full width, SSD_GRAD_LAYERS layers, fp32: one
    per-worker gradient of the SASG step (``per_worker_grad_fn``, the
    workers under ``torch.func.vmap``) through ``build(cfg)`` (both SSD
    kernels) against ``build(cfg, use_kernel=False)`` (the oracle under
    autograd), every leaf; one forward and one backward launch per layer."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.sasg import per_worker_grad_fn
    from repro_torch.core.types import tree_flatten_with_paths
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.launch import train as launch
    from repro_torch.models import build
    from repro_torch.train.step import worker_batch

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(SSD_ARCH), n_layers=SSD_GRAD_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    params = build(cfg).init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = worker_batch(launch.data_stream(cfg, SSD_BATCH, SSD_SEQ).batch_at(0), SSD_WORKERS,
                         "cuda")
    _reset_ssd_launches()
    loss_k, grads_k = per_worker_grad_fn(build(cfg).loss_fn)(params, batch, False)
    torch.cuda.synchronize()
    launches = (ssd_scan.LAUNCHES.count, ssd_scan_bwd.LAUNCHES.count)
    loss_o, grads_o = per_worker_grad_fn(build(cfg, use_kernel=False).loss_fn)(params, batch,
                                                                              False)
    torch.cuda.synchronize()
    if launches != (cfg.n_layers, cfg.n_layers) or (ssd_scan.LAUNCHES.count,
                                                    ssd_scan_bwd.LAUNCHES.count) != launches:
        fail(f"{SSD_ARCH} gradient: SSD launches {launches}, expected {cfg.n_layers} each "
             "(one per layer, the workers folded into one call), none on the oracle path")
    paths, leaves_k, _ = tree_flatten_with_paths(grads_k)
    _, leaves_o, _ = tree_flatten_with_paths(grads_o)
    gaps = {}
    for path, a, b in zip(paths, leaves_k, leaves_o):
        scale = float(b.float().abs().max())
        gaps[path] = float((a.float() - b.float()).abs().max()) / scale if scale else 0.0
        if not (torch.isfinite(a).all() and gaps[path] <= SSD_GRAD_TOL):
            fail(f"{SSD_ARCH} gradient, leaf {path}: the kernel path differs from the oracle "
                 f"by {gaps[path]:.3g} of its max > {SSD_GRAD_TOL}")
    loss_gap = float((loss_k - loss_o).abs().max() / loss_o.abs().max())
    if not loss_gap <= SSD_GRAD_TOL:
        fail(f"{SSD_ARCH} gradient: losses differ by {loss_gap:.3g}")
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
    log(f"phase 14 (b): {SSD_ARCH} full width, {cfg.n_layers} layers, fp32, {SSD_WORKERS} "
        f"workers x {SSD_BATCH // SSD_WORKERS} x {SSD_SEQ} tokens: per-worker gradients through "
        f"the SSD kernels against the oracle's, {len(paths)} leaves within {SSD_GRAD_TOL} of "
        f"their max (largest: " + ", ".join(f"{p} {g:.3g}" for p, g in worst)
        + f"); losses {loss_gap:.3g} apart; SSD launches {launches[0]} forward + {launches[1]} "
        f"backward = one each per layer; {time.perf_counter() - t0:.1f} s")
    del params, grads_k, grads_o
    torch.cuda.empty_cache()
    return max(gaps.values())


def phase_ssd_training(card):
    """(c) mamba2_370m at full width and depth (48 layers, bf16), SASG, 4
    workers x 1 sequence of 512 tokens, SSD_STEPS steps through
    ``repro_torch.launch.train``: loss finite, counters exact, the SSD
    forward / backward and the top-k launches as the step's structure
    predicts; ms per step and peak memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch import train as launch

    argv = ["--arch", SSD_ARCH, "--algo", "sasg", "--workers", str(SSD_WORKERS),
            "--global-batch", str(SSD_BATCH), "--seq-len", str(SSD_SEQ), "--steps",
            str(SSD_STEPS), "--device", "cuda"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for counter in (topk_ef.LAUNCHES, topk_ef.SEGMENTS):
        counter.reset()
    _reset_ssd_launches()
    stamps = []

    def log_fn(msg):
        stamps.append((time.perf_counter(), msg))
        print(msg, flush=True)

    t0 = time.perf_counter()
    deterministic = torch.are_deterministic_algorithms_enabled()
    trainer, state = launch.train(argv, log_fn=log_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    what = f"{SSD_ARCH} full-width training"
    ssd = _check_ssd_launches(get_config(SSD_ARCH), trainer, SSD_STEPS, what)
    launches, segments = topk_ef.LAUNCHES.count, topk_ef.SEGMENTS.count
    _check_topk_launches(state.params, SSD_WORKERS, SSD_STEPS, launches, segments, what)
    hist = trainer.history
    if len(hist) != SSD_STEPS or not all(math.isfinite(r["loss"]) for r in hist):
        fail(f"{what}: loss not finite")
    rounds = _counters_exact(hist, trainer.built.bits_paper, trainer.built.bits_wire, what)
    if hist[0]["num_sent"] != SSD_WORKERS:
        fail(f"{what}: {hist[0]['num_sent']} first-step sends, expected {SSD_WORKERS}")
    # the trainer logs every step after its metrics are on the host
    steps = [t for t, m in stamps if m.startswith("[trainer] step")]
    step_ms = [(b - a) * 1e3 for a, b in zip(steps, steps[1:])]
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    log(f"phase 14 (c): {what}: {n_params} params (bf16), {SSD_STEPS} steps of {SSD_WORKERS} "
        f"workers x {SSD_BATCH // SSD_WORKERS} x {SSD_SEQ} tokens, loss {hist[0]['loss']:.4f} -> "
        f"{hist[-1]['loss']:.4f}, sends {[int(r['num_sent']) for r in hist]}, rounds "
        f"{rounds:.0f}, counters exact; ms per step (host clock between the trainer's step "
        f"lines, steps 1..{SSD_STEPS - 1}) {', '.join(f'{x:.1f}' for x in step_ms)}, median "
        f"{statistics.median(step_ms):.1f}; {wall:.1f} s with the build and init; peak memory "
        f"{peak} bytes")
    params = state.params   # phase 16 (a) holds its remat runs to these
    del trainer, state
    torch.cuda.empty_cache()
    return {"launches": launches, "segments": segments, "step_ms": statistics.median(step_ms),
            "step_ms_all": step_ms, "peak": peak, "params": params,
            "deterministic": deterministic, **ssd}


def phase_ssd_bwd_times(n_layers: int):
    """The backward kernel per gradient evaluation of phase 14 (c): one
    launch per layer at its shape (4 workers x 1 sequence of 512 tokens: B
    = 4, NC = 2), each layer on its own copy of the operands (cold in L2)."""
    import torch

    from repro_torch.kernels import checks
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_bwd_ref
    from repro_torch.kernels.ssd_scan.ssd_scan_bwd import (blocks_per_launch, head_slice,
                                                           ssd_chunk_bwd_cuda)

    case = checks.SsdCase("train", SSD_BATCH, SSD_SEQ, 32, 64, 1, 128, 256, "model")
    base = checks.ssd_bwd_inputs(case, "cuda")
    layers = [tuple(t.clone() for t in base) for _ in range(n_layers)]

    def run_kernel():
        for ins in layers:
            ssd_chunk_bwd_cuda(*ins)

    def run_plain():
        for ins in layers:
            ssd_chunk_bwd_ref(*ins)

    x, dt, da, b, c, gy, gst = base
    bsz, nc, q, h, p = x.shape
    g, n = b.shape[3], b.shape[4]
    bnc, tri = bsz * nc, q * (q + 1) // 2
    # the products, on the kernel's route (the tensor cores, TF32_PASSES TF32
    # products each): C B^T, dC and dB per group on the causal half; gW and
    # W^T gy per head; the two state products per head
    products = bnc * (3 * g * tri * n + h * (2 * tri * p + 2 * q * n * p))
    # on the CUDA cores: r (q p per head); per head and causal pair,
    # exp(cum_i - cum_j), the products for L, W, S, dCB and gW CB L, three
    # sums (11); the sums over heads of dCB and of the state term of dB
    elem = bnc * h * (2 * q * p + 12 * tri + q * n)
    t_tc = n_layers * 2 * products * TF32_PASSES / TF32_OPS_PER_S * 1e3
    t_elem = n_layers * elem / FP32_OPS_PER_S * 1e3
    t_fp32 = n_layers * (2 * products + elem) / FP32_OPS_PER_S * 1e3
    # x, gy, dx; dt, da, ddt, dda; b, c, db, dc; gst: each read or written once
    nbytes = n_layers * 4 * (3 * x.numel() + 4 * dt.numel() + 4 * b.numel() + gst.numel())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hs = head_slice(bnc, q, h, g, n, sms)
    kernel = (graph_ms(run_kernel, 5), cuda_ms(run_kernel, 3, warmup=1))
    plain = cuda_ms(run_plain, 1, warmup=1)
    out = {"ms": kernel[0], "eager_ms": kernel[1], "plain_ms": plain,
           "bound_ms": max(t_bytes, t_tc),
           "bound_by": "bytes" if t_bytes >= t_tc else "operations", "library_ms": None}
    log(f"ssd_chunk_bwd: {kernel[0]:.4f} ms per gradient evaluation on the device "
        f"({n_layers} launches at B={bsz} NC={nc} Q={q} H={h} P={p} G={g} N={n}; eager "
        f"{kernel[1]:.4f} ms) vs bound {out['bound_ms']:.4f} ms ({out['bound_by']}, 3xTF32 on "
        f"the tensor cores: {n_layers * 2 * products * TF32_PASSES / 1e9:.2f} GFLOP at "
        f"{TF32_OPS_PER_S / 1e12} TFLOP/s TF32 = {t_tc:.4f} ms, the elementwise work beside "
        f"it {n_layers * elem / 1e9:.2f} GFLOP at {FP32_OPS_PER_S / 1e12:.0f} TFLOP/s fp32 = "
        f"{t_elem:.4f} ms; {nbytes / 1e6:.0f} MB at {HBM_BYTES_PER_S / 1e12} TB/s = "
        f"{t_bytes:.4f} ms), kernel at {out['bound_ms'] / kernel[0]:.3f} of it; plain "
        f"{plain:.3f} ms (eager); no single PyTorch call computes this function")
    log(f"ssd_chunk_bwd fp32 CUDA-core bound: {max(t_bytes, t_fp32):.4f} ms "
        f"({n_layers * (2 * products + elem) / 1e9:.2f} GFLOP at {FP32_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s fp32 = {t_fp32:.4f} ms), kernel at {max(t_bytes, t_fp32) / kernel[0]:.3f} of "
        f"it; {hs} heads per block ({-(-(h // g) // hs)} slices per group); blocks per launch "
        + ", ".join(f"{k} {v}" for k, v in blocks_per_launch(bnc, q, h, g, n, hs).items())
        + f" on {sms} SMs")
    del layers
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 16: remat and the pipeline (slice 13)
# ---------------------------------------------------------------------------

PIPE_STAGES = 2
PIPE_N_MICRO = 2             # microbatches of each worker's 10 samples (0 -> stages)
RING = {"wire_dtype": "float32", "k_ratio": 0.05, "block_size": 256}
PIPE_LOSS_RTOL = 1e-5        # step 0 against phase 4: only the sums' order differs
# Step 0's per-worker gradients, pipelined against the flat ones, are held
# in float64 (params, batch, the ring's wire and the loss): each leaf
# within PIPE_F64_TOL of its max. The fp32 gradient of the full-width CNN
# at init is ill-conditioned (every fp32 form sits up to ~5e-3 of a leaf's
# max from float64), so the fp32 pipelined-vs-flat gap is printed against
# PIPE_GRAD_TOL and gates nothing: in float64 the conditioning leaves
# ~1e-16 x its amplification, and the check sees the schedule alone.
PIPE_F64_TOL = 1e-10
PIPE_GRAD_TOL = 1e-4
PIPE_SSD_BATCH = 8           # (d): 4 workers x 2 sequences of 512 tokens
PIPE_SSD_STEPS = 1           # each step moves ~1.6 GB of embedding gradients through the host


def _pipe_argv(*extra):
    return ["--arch", "cnn_cifar", "--algo", "sasg", "--workers", str(WORKERS),
            "--global-batch", str(WORKERS * PER_WORKER), "--lr", str(LR), "--steps",
            str(STEPS), "--device", "cuda", "--mesh-shape", "1,1", "--stages",
            str(PIPE_STAGES), *extra]


def _flat_params(params) -> dict:
    """A tree's leaves on the host by path, as numpy (bf16 as its int16 bits)."""
    import torch

    from repro_torch.core.types import tree_flatten_with_paths

    paths, leaves, _ = tree_flatten_with_paths(params)
    out = {}
    for p, x in zip(paths, leaves):
        x = x.detach().cpu()
        out[p] = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return out


def _same_arrays(a: dict, b: dict) -> bool:
    import numpy as np

    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8))
        for k in a)


def _remat_memory(model_of, params, batch) -> dict:
    """One gradient evaluation of the SASG step (``per_worker_grad_fn``,
    params shared by the workers) for each remat policy, on the same params
    and batch: the bytes allocated when the forward has returned the loss
    (what the backward will read), the peak above the start, and the bytes
    the gradients hold after it, each beside what was allocated before."""
    import torch

    from repro_torch.core.sasg import per_worker_grad_fn

    out = {}
    for remat in ("none", "full"):
        loss_fn, held = model_of(remat).loss_fn, {}

        def probe(p, b, loss_fn=loss_fn, held=held):
            loss = loss_fn(p, b)
            held["fwd"] = torch.cuda.memory_allocated()
            return loss

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = per_worker_grad_fn(probe)(params, batch, False)
        torch.cuda.synchronize()
        out[remat] = {"after_forward": held["fwd"] - base,
                      "peak": torch.cuda.max_memory_allocated() - base,
                      "grads": torch.cuda.memory_allocated() - base,
                      "loss": loss.float().cpu()}
        del loss, grads
    if not torch.equal(out["none"]["loss"], out["full"]["loss"]):
        fail("remat memory probe: the loss with remat differs from the loss without")
    return out


def phase_remat(card, ssd_train):
    """(a) phase 14 (c)'s cell with ``--remat full``: loss finite, counters
    exact, params after the run bitwise 14 (c)'s, 48 forward launches + 48
    for the recompute and 48 backward per gradient evaluation; ms per step
    and peak memory beside 14 (c)'s; then one gradient evaluation of the
    cell with and without remat, the memory held after the forward, the
    peak and the gradients' bytes of each."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_flatten_with_paths, tree_leaves
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch import train as launch
    from repro_torch.models import build
    from repro_torch.train.step import worker_batch

    cfg = get_config(SSD_ARCH)
    layers = sum(cfg.layer_kind(i) == "ssd" for i in range(cfg.n_layers))
    want = ssd_train["params"]
    torch.use_deterministic_algorithms(ssd_train["deterministic"])   # as 14 (c) ran
    out = {"ssd_chunk": 0, "ssd_chunk_bwd": 0, "launches": 0}
    remat = "full"
    argv = ["--arch", SSD_ARCH, "--algo", "sasg", "--workers", str(SSD_WORKERS),
            "--global-batch", str(SSD_BATCH), "--seq-len", str(SSD_SEQ), "--steps",
            str(SSD_STEPS), "--device", "cuda", "--remat", remat]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for counter in (topk_ef.LAUNCHES, topk_ef.SEGMENTS):
        counter.reset()
    _reset_ssd_launches()
    stamps = []

    def log_fn(msg):
        stamps.append((time.perf_counter(), msg))
        print(msg, flush=True)

    trainer, state = launch.train(argv, log_fn=log_fn)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    what = f"{SSD_ARCH} --remat {remat}"
    sel = trainer.built.exchange.config.selection
    evals = 1 + (0 if not sel.enabled else 2 if sel.probe_fraction < 1.0 else 1)
    got = (ssd_scan.LAUNCHES.count, ssd_scan_bwd.LAUNCHES.count)
    expect = (2 * layers * evals * SSD_STEPS, layers * evals * SSD_STEPS)
    if got != expect:
        fail(f"{what}: SSD launches {got}, expected {expect} (forward + recompute, "
             "backward)")
    hist = trainer.history
    if len(hist) != SSD_STEPS or not all(math.isfinite(r["loss"]) for r in hist):
        fail(f"{what}: loss not finite")
    rounds = _counters_exact(hist, trainer.built.bits_paper, trainer.built.bits_wire, what)
    paths, got_leaves, _ = tree_flatten_with_paths(state.params)
    for path, a, b in zip(paths, got_leaves, tree_leaves(want)):
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            diff = float((a.float() - b.float()).abs().max())
            fail(f"{what}: params differ from phase 14 (c)'s after {SSD_STEPS} steps, "
                 f"first at {path} by {diff:.3g}")
    steps = [t for t, m in stamps if m.startswith("[trainer] step")]
    step_ms = [(b - a) * 1e3 for a, b in zip(steps, steps[1:])]
    out[remat] = {"step_ms": statistics.median(step_ms), "peak": peak}
    out["ssd_chunk"] += got[0]
    out["ssd_chunk_bwd"] += got[1]
    out["launches"] += topk_ef.LAUNCHES.count
    log(f"phase 16 (a): {what}: params bitwise phase 14 (c)'s after {SSD_STEPS} steps, "
        f"sends {[int(r['num_sent']) for r in hist]}, rounds {rounds:.0f}, counters exact; "
        f"SSD launches {got[0]} forward ({layers} + {layers} recompute per gradient "
        f"evaluation x {evals} x {SSD_STEPS} steps) and {got[1]} backward; ms per step "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} (median {statistics.median(step_ms):.1f}; "
        f"14 (c): {', '.join(f'{x:.1f}' for x in ssd_train['step_ms_all'])}); peak memory "
        f"{peak} bytes (14 (c): {ssd_train['peak']})")
    # what remat frees: one gradient evaluation on the trained params and
    # step 0's batch, the worker state and the optimizer's gone
    params = state.params
    del trainer, state
    batch = worker_batch(launch.data_stream(cfg, SSD_BATCH, SSD_SEQ).batch_at(0),
                         SSD_WORKERS, "cuda")
    mem = _remat_memory(lambda r: build(cfg, remat=r), params, batch)
    del params, batch
    if not (mem["full"]["after_forward"] < mem["none"]["after_forward"]
            and mem["full"]["peak"] < mem["none"]["peak"]):
        fail(f"{what}: remat frees nothing in a gradient evaluation: held after the forward "
             f"{mem['full']['after_forward']} vs {mem['none']['after_forward']} bytes, peak "
             f"{mem['full']['peak']} vs {mem['none']['peak']}")
    torch.cuda.empty_cache()
    out["memory"] = mem
    log(f"card {card}: {SSD_ARCH} training peak memory none / full: {ssd_train['peak']} / "
        f"{out['full']['peak']} bytes; ms per step {ssd_train['step_ms']:.1f} / "
        f"{out['full']['step_ms']:.1f}; one gradient evaluation ({SSD_WORKERS} workers x "
        f"{SSD_BATCH // SSD_WORKERS} x {SSD_SEQ} tokens), bytes above its start, none / full: "
        f"held after the forward {mem['none']['after_forward']} / "
        f"{mem['full']['after_forward']}, peak {mem['none']['peak']} / {mem['full']['peak']}, "
        f"gradients {mem['none']['grads']} / {mem['full']['grads']}")
    return out


def _pipe_stage_rank(group, argv):
    """One rank of phase 16 (b): ``_mesh_rank``'s run, plus its resident
    trunk bytes."""
    r = _mesh_rank(group, argv)
    r["trunk_bytes"] = sum(4 * math.prod(s) for p, s in r["local_shapes"].items()
                           if p.startswith("trunk/"))
    return r


def phase_pipeline(card, trainer_main):
    """(b) phase 4's cell over 2 stages, identity ring: stacked, then as 2
    gloo ranks on cuda:0; (c) the compressed ring through the block_topk
    kernel; (d) a pipelined mamba2_370m. Returns the kernels' launch counts
    and times."""
    import torch

    from repro_torch.comm import process_group
    from repro_torch.comm.collectives import StageAxis
    from repro_torch.comm.transport import ActivationLayout
    from repro_torch.configs import get_config
    from repro_torch.core.sasg import per_worker_grad_fn
    from repro_torch.core.types import tree_flatten_with_paths, tree_map
    from repro_torch.dist.pipeline import build_pipelined_vag
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch import train as launch
    from repro_torch.models import build
    from repro_torch.models import paper_nets as PN
    from repro_torch.train.step import worker_batch

    torch.use_deterministic_algorithms(True)   # as phase 4 ran; the ranks inherit it
    keys = ("num_sent", "rounds_total", "bits_paper_total", "bits_wire_total")
    encodes = STEPS + 1
    out = {"topk_ef": 0, "block_topk": 0, "ssd_chunk": 0, "ssd_chunk_bwd": 0}

    # (b) stacked: the launcher on a stacked (1, 2, 1) data x stage x model mesh
    torch.cuda.empty_cache()
    topk_ef.LAUNCHES.reset()
    topk_ef.SEGMENTS.reset()
    trainer = launch.build_trainer(launch.parse_args(_pipe_argv()), print)
    step, step_s = trainer.built.step, []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        res = step(*a, **kw)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return res

    trainer.built = trainer.built._replace(step=timed)
    state_b = trainer.run(seed=0)
    torch.cuda.synchronize()
    built_b = trainer.built
    hist_b = trainer.history
    launches_b, segments_b = topk_ef.LAUNCHES.count, topk_ef.SEGMENTS.count
    strat = built_b.strategy
    if not (strat.pipelined and strat.pipeline_stages == PIPE_STAGES):
        fail(f"pipeline (b): strategy {strat} is not pipelined over {PIPE_STAGES} stages")
    if launches_b != encodes:
        fail(f"pipeline (b) stacked: topk_ef launched {launches_b} times, expected {encodes}")
    ms_b = statistics.median(step_s[1:]) * 1e3
    out["topk_ef"] += launches_b
    params_b = _flat_params(state_b.params)

    # against phase 4's flat run: step 0's loss and per-worker gradients
    cfg = get_config("cnn_cifar")
    model = build(cfg)
    init = trainer.built.init(seed=0).params
    batch0 = worker_batch(launch.data_stream(cfg, WORKERS * PER_WORKER).batch_at(0), WORKERS,
                          "cuda")
    loss_f, grads_f = per_worker_grad_fn(model.loss_fn)(init, batch0, False)
    loss_p, grads_p = build_pipelined_vag(model.pipeline, StageAxis(PIPE_STAGES),
                                          PIPE_N_MICRO)(init, batch0, False)

    # the same two in float64: the model's loss (fp32 cross-entropy) and the
    # ring's fp32 wire swapped for float64 ones
    def ce64(logits, labels):
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        return (torch.logsumexp(logits, -1) - gold).mean()

    def loss64(p, b):
        return ce64(PN.cnn_apply(p, cfg, b["x"]), b["labels"])

    pdef64 = model.pipeline._replace(
        finish=lambda p, h, b: ce64(PN.cnn_head(p, h.permute(0, 3, 1, 2)), b["labels"]))
    init64 = tree_map(lambda x: x.double(), init)
    batch64 = {"x": batch0["x"].double(), "labels": batch0["labels"]}
    _, grads_64 = per_worker_grad_fn(loss64)(init64, batch64, False)
    _, grads_p64 = build_pipelined_vag(pdef64, StageAxis(PIPE_STAGES), PIPE_N_MICRO,
                                       act_layout=ActivationLayout(wire_dtype=torch.float64))(
        init64, batch64, False)
    torch.cuda.synchronize()
    l0_main, l0_pipe = trainer_main.history[0]["loss"], hist_b[0]["loss"]
    loss_gap = abs(l0_pipe - l0_main) / abs(l0_main)
    if not loss_gap <= PIPE_LOSS_RTOL:
        fail(f"pipeline (b): step-0 loss {l0_pipe} vs phase 4's {l0_main}: {loss_gap:.3g} "
             f"relative > {PIPE_LOSS_RTOL}")
    paths, lf, _ = tree_flatten_with_paths(grads_f)
    lp = tree_flatten_with_paths(grads_p)[1]
    l64 = tree_flatten_with_paths(grads_64)[1]
    lp64 = tree_flatten_with_paths(grads_p64)[1]

    def rel(a, b):
        scale = float(b.abs().max())
        return float((a.double() - b.double()).abs().max()) / scale if scale else 0.0

    gaps64 = {}
    for path, a, b in zip(paths, lp64, l64):
        if a.dtype != torch.float64 or b.dtype != torch.float64:
            fail(f"pipeline (b): the float64 gradient {path} came out {a.dtype} / {b.dtype}")
        gaps64[path] = rel(a, b)
        if not gaps64[path] <= PIPE_F64_TOL:
            fail(f"pipeline (b): step-0 float64 gradient {path}, pipelined, differs from the "
                 f"flat one by {gaps64[path]:.3g} of its max > {PIPE_F64_TOL}")
    gaps = {path: rel(a, b) for path, a, b in zip(paths, lp, lf)}
    f64 = {path: (rel(a, c), rel(b, c)) for path, a, b, c in zip(paths, lp, lf, l64)}
    flat64 = max(v[1] for v in f64.values())
    sends_main = [h["num_sent"] for h in trainer_main.history]
    sends_b = [h["num_sent"] for h in hist_b]
    first = next((i for i, (a, b) in enumerate(zip(sends_b, sends_main)) if a != b), None)
    worst = max(gaps.items(), key=lambda kv: kv[1])
    worst64 = max(f64.items(), key=lambda kv: kv[1][0])
    worst_p64 = max(gaps64.items(), key=lambda kv: kv[1])
    log(f"phase 16 (b) stacked: cnn_cifar over {PIPE_STAGES} stages (1F1B, identity ring, "
        f"{PIPE_N_MICRO} microbatches of {PER_WORKER // PIPE_N_MICRO}), {STEPS} steps: topk_ef "
        f"{launches_b} launches covering {segments_b} segments ({segments_b // encodes} per "
        f"encode); step 0 against phase 4: loss {loss_gap:.3g} relative; per-worker gradients "
        f"in float64 within {worst_p64[1]:.3g} of a leaf's max ({worst_p64[0]}; gate "
        f"{PIPE_F64_TOL}); in fp32 (a reading) within {worst[1]:.3g} ({worst[0]}; "
        f"{sum(g > PIPE_GRAD_TOL for g in gaps.values())} of {len(gaps)} leaves above "
        f"{PIPE_GRAD_TOL}), and the fp32 pipelined gradient within {worst64[1][0]:.3g} of the "
        f"float64 one ({worst64[0]}, the flat one there {worst64[1][1]:.3g}; the flat one's "
        f"largest {flat64:.3g}); sends "
        + ("equal phase 4's every step" if first is None else
           f"first differ at step {first}: {sends_b[first]} vs {sends_main[first]}")
        + f"; {ms_b:.2f} ms a step")
    del grads_f, grads_p, grads_64, grads_p64, trainer

    # (b) 2 gloo ranks on cuda:0, one stage a rank
    t0 = time.perf_counter()
    ranks = process_group.spawn(_pipe_stage_rank, 2, "gloo", "cuda", args=(
        _pipe_argv("--procs", "2", "--backend", "gloo"),))
    took = time.perf_counter() - t0
    want_hist = [{k: h[k] for k in keys} for h in hist_b]
    full_trunk = sum(4 * v.size for p, v in params_b.items() if p.startswith("trunk/"))
    for r in ranks:
        if [{k: h[k] for k in keys} for h in r["history"]] != want_hist:
            fail(f"pipeline (b) rank {r['rank']}: sends / counters differ from the stacked run")
        if not _same_arrays(r["params"], params_b):
            fail(f"pipeline (b) rank {r['rank']}: params differ from the stacked run")
        if r["launches"] != encodes:
            fail(f"pipeline (b) rank {r['rank']}: topk_ef launched {r['launches']} times, "
                 f"expected {encodes}")
        if 2 * r["trunk_bytes"] != full_trunk:
            fail(f"pipeline (b) rank {r['rank']}: holds {r['trunk_bytes']} trunk bytes of "
                 f"{full_trunk}")
        out["topk_ef"] += r["launches"]
    ms_ranks = statistics.median(s for r in ranks for s in r["step_s"][1:]) * 1e3
    log(f"phase 16 (b) 2 gloo ranks on cuda:0, one stage each: sends, rounds, bits and "
        f"params == the stacked run bitwise on both ranks; topk_ef "
        f"{[r['launches'] for r in ranks]} launches ({encodes} a rank, one grouped launch "
        f"per encode on its stage-local slice: "
        + ", ".join(f"{r['segments']} segments" for r in ranks)
        + f"); resident trunk bytes per rank {[r['trunk_bytes'] for r in ranks]} of "
        f"{full_trunk}; {ms_ranks:.2f} ms a step against the stacked {ms_b:.2f}; "
        f"{took:.1f} s with the processes' start")
    ring = _pipeline_ring(card, built_b, params_b)
    mamba = _pipeline_mamba()
    for k in ("topk_ef", "block_topk", "ssd_chunk", "ssd_chunk_bwd"):
        out[k] += ring.get(k, 0) + mamba.get(k, 0)
    out["ms"] = {"stacked": ms_b, "ranks": ms_ranks, "ring": ring["ms"]}
    out["ring_encode"] = ring["ring_encode"]
    log(f"card {card}: cnn_cifar over {PIPE_STAGES} stages ms per step: stacked "
        f"{ms_b:.2f}, 2 gloo ranks {ms_ranks:.2f}, compressed ring (overlap) "
        f"{ring['ms']:.2f}")
    return out


def _ring_checked(real, plain, seen):
    """``block_topk_rows`` through the kernel, each call held to the plain
    version on the same input (bitwise); the plain calls launch nothing."""
    import torch

    def rows(x2d, kb):
        vals, idx = real(x2d, kb)
        pv, pi = plain(x2d, kb)
        if not (torch.equal(vals, pv) and torch.equal(idx, pi)):
            fail(f"ring encode: the block_topk kernel differs from its plain version on a "
                 f"{tuple(x2d.shape)} view, kb {kb}")
        seen.append(tuple(x2d.shape))
        return vals, idx

    return rows


def _pipeline_ring(card, built_b, params_b):
    """(c) (b)'s stacked run with the compressed ring (fp32 values, k 0.05,
    blocks of 256; 1F1B) and ``overlap=True`` (the synchronous exchange),
    every ring encode held to the plain selection in lockstep; the stage
    traffic against ``PipelineCommModel``; the ring encode's time beside
    its bytes bound, its plain version and a library call."""
    import dataclasses

    import torch

    from repro_torch.comm.transport import ActivationLayout
    from repro_torch.configs import get_config
    from repro_torch.core import metrics as CM
    from repro_torch.kernels.block_topk import block_topk, ops as bops
    from repro_torch.kernels.block_topk.ref import block_topk_ref
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch import train as launch
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import build_train_step

    args = launch.parse_args(_pipe_argv())
    cfg = get_config("cnn_cifar")
    layout = ActivationLayout(**RING)
    real = bops.block_topk_rows
    seen = []   # the ring encodes held to the plain version
    scfg = dataclasses.replace(launch.sasg_config_from_args(args), act_layout=layout,
                               overlap=True)
    built = build_train_step(build(cfg), scfg, WORKERS, constant(LR), device="cuda",
                             mesh=built_b.mesh, strategy=built_b.strategy)
    stream = launch.data_stream(cfg, WORKERS * PER_WORKER)
    state = built.init(seed=0)
    block_topk.LAUNCHES.reset()
    topk_ef.LAUNCHES.reset()
    hist, step_s = [], []
    bops.block_topk_rows = _ring_checked(real, block_topk_ref, seen)
    try:
        for i in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = built.step(state, stream.batch_at(i))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            hist.append({k: float(v) for k, v in m.items()})
    finally:
        bops.block_topk_rows = real
    launches = block_topk.LAUNCHES.count
    ms = statistics.median(step_s[1:]) * 1e3
    out = {"block_topk": launches, "topk_ef": topk_ef.LAUNCHES.count}
    # the traffic model from the shapes: each worker's 10 rows in 2
    # microbatches of 5 NHWC activations of 32 x 32 x 64
    act = (PER_WORKER // PIPE_N_MICRO) * 32 * 32 * cfg.d_model
    model = CM.PipelineCommModel(stages=PIPE_STAGES, n_micro=PIPE_N_MICRO, act_elems=act,
                                 engine="1f1b", hop_payload_bits=layout.payload_bits(act),
                                 bcast_payload_bits=layout.payload_bits(PIPE_N_MICRO * act))
    t = built.exchange.transport
    trunk_wire = sum(b.bits_wire for b in t.bits_report(state.params).buckets
                     if b.bucket.startswith("trunk/"))
    prep = sum(32 * v.size for p, v in params_b.items()
               if any(p == q or p.startswith(q + "/") for q in ("stem", "gn0")))
    s = PIPE_STAGES
    gather = (s - 1) / s * trunk_wire + 2 * 2 * (s - 1) / s * prep
    for h in hist:
        if (h["pipe_ring_bits_step"], h["pipe_gather_bits_step"]) != (
                model.ring_bits_per_step(), gather):
            fail(f"pipeline (c): stage traffic {h['pipe_ring_bits_step']} ring + "
                 f"{h['pipe_gather_bits_step']} gather bits a step, the model "
                 f"{model.ring_bits_per_step()} + {gather}")
    evals = 2   # the fresh and the stale-params gradients of each SASG step
    per_eval = 2 * (s - 1) * PIPE_N_MICRO + 1   # carries, cotangents, the broadcast
    if launches != evals * per_eval * STEPS:
        fail(f"pipeline (c): block_topk launched {launches} times, expected "
             f"{evals * per_eval * STEPS} (one a ring encode)")
    if len(seen) != launches:
        fail(f"pipeline (c): {len(seen)} encodes held to the plain version, {launches} "
             "launches")
    # the ring encode alone: one hop's activation of the 10 workers
    x = torch.randn((WORKERS, PER_WORKER // PIPE_N_MICRO, 32, 32, cfg.d_model),
                    device="cuda")
    rows = x.reshape(-1, RING["block_size"])
    kb = layout.kb()
    k_ms = cuda_ms(lambda: bops.block_topk_rows(rows, kb), 50)
    p_ms = cuda_ms(lambda: block_topk_ref(rows, kb), 3, warmup=1)
    lib_ms = cuda_ms(lambda: rows.gather(-1, torch.topk(rows.abs(), kb, dim=-1).indices), 50)
    nbytes = rows.numel() * 4 + 2 * rows.shape[0] * kb * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = rows.numel() * kb / FP32_OPS_PER_S * 1e3   # a compare per element per round
    bound = max(t_bytes, t_ops)
    log(f"phase 16 (c): compressed ring ({RING}, 1F1B, overlap): {STEPS} steps, every ring "
        f"encode through the block_topk kernel held to its plain version bitwise ({len(seen)} "
        f"encodes of {sorted(set(seen))} rows x block); stage traffic "
        f"{hist[0]['pipe_ring_bits_step']:.0f} ring + {hist[0]['pipe_gather_bits_step']:.0f} "
        f"gather bits a step == PipelineCommModel's ({model.ring_bits_per_step():.0f} + "
        f"{gather:.0f}); block_topk {launches} launches ({per_eval} a gradient evaluation: "
        f"{2 * (s - 1) * PIPE_N_MICRO} carries and cotangents + 1 broadcast); sends "
        f"{[int(h['num_sent']) for h in hist]}; {ms:.2f} ms a step")
    log(f"card {card}: ring encode (block_topk, {rows.shape[0]} blocks of 256, kb {kb}): "
        f"{k_ms:.4f} ms on the device vs bound {bound:.4f} ms (bytes {t_bytes:.4f}: "
        f"{nbytes / 1e6:.2f} MB at {HBM_BYTES_PER_S / 1e12} TB/s; compares {t_ops:.4f}; "
        f"kernel at {bound / k_ms:.3f} of it); plain {p_ms:.3f} ms; library (torch.topk of "
        f"|x| + gather) {lib_ms:.4f} ms")
    out["ms"] = ms
    out["ring_encode"] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                          "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                          "library_ms": lib_ms}
    return out


def _stage_digests(params, stages: int, trunk: str, local: bool) -> list:
    """sha256 of each stage's params as a rank holds them: its slice of the
    trunk leaves and every other leaf whole; ``local``: ``params`` are this
    rank's (one digest), else the full tree (one digest per stage)."""
    import hashlib

    import torch

    from repro_torch.core.types import tree_flatten_with_paths

    paths, leaves, _ = tree_flatten_with_paths(params)
    out = []
    for s in range(1 if local else stages):
        h = hashlib.sha256()
        for path, x in zip(paths, leaves):
            x = x.to_local() if hasattr(x, "to_local") else x
            if not local and (path == trunk or path.startswith(trunk + "/")):
                n = x.shape[0] // stages
                x = x[s * n:(s + 1) * n]
            h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        out.append(h.hexdigest())
    return out


def _pipe_mamba_run(group=None):
    """(d): mamba2_370m at full width, SSD_GRAD_LAYERS layers, fp32, remat
    full, over a (1, 2) data x stage mesh (stacked, or the device mesh of
    ``group``'s 2 ranks), 4 workers x 2 sequences of 512 tokens,
    PIPE_SSD_STEPS steps. Returns the metrics, the params' per-stage
    digests, the SSD and top-k launches."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.sasg import PRESETS
    from repro_torch.dist.strategy import choose_strategy
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import build_train_step

    cfg = dataclasses.replace(get_config(SSD_ARCH), n_layers=SSD_GRAD_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    model = build(cfg, remat="full")
    mesh = make_test_mesh((1, PIPE_STAGES), ("data", "stage"), group=group,
                          device_type="cuda")
    strategy = choose_strategy(mesh, pipeline_stages=PIPE_STAGES,
                               trunk_layers=model.pipeline.n_layers)
    built = build_train_step(model, PRESETS["sasg"](), SSD_WORKERS, constant(0.01),
                             device="cuda" if group is None else group.device, group=group,
                             mesh=mesh, strategy=strategy)
    stream = launch.data_stream(cfg, PIPE_SSD_BATCH, SSD_SEQ)
    _reset_ssd_launches()
    topk_ef.LAUNCHES.reset()
    state = built.init(seed=0)
    hist, step_s = [], []
    for i in range(PIPE_SSD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = built.step(state, stream.batch_at(i))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        hist.append({k: float(v) for k, v in m.items()})
    trunk = "/".join(str(k) for k in model.pipeline.trunk_path)
    return {"hist": hist, "digests": _stage_digests(state.params, PIPE_STAGES, trunk,
                                                    group is not None),
            "step_s": step_s, "ssd": (ssd_scan.LAUNCHES.count, ssd_scan_bwd.LAUNCHES.count),
            "topk_ef": topk_ef.LAUNCHES.count, "rank": None if group is None else group.rank}


def _pipeline_mamba():
    """(d) the pipelined mamba2_370m: the stacked run, the 2 gloo ranks
    bitwise equal to it; the step-0 per-worker gradients of the pipeline
    within SSD_GRAD_TOL of the unpipelined step's."""
    import dataclasses

    import torch

    from repro_torch.comm import process_group
    from repro_torch.comm.collectives import StageAxis
    from repro_torch.comm.transport import ActivationLayout
    from repro_torch.configs import get_config
    from repro_torch.core.sasg import per_worker_grad_fn
    from repro_torch.core.types import tree_flatten_with_paths
    from repro_torch.dist.pipeline import build_pipelined_vag
    from repro_torch.launch import train as launch
    from repro_torch.models import build
    from repro_torch.train.step import worker_batch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    stacked = _pipe_mamba_run()
    torch.cuda.empty_cache()
    ranks = process_group.spawn(_pipe_mamba_run, 2, "gloo", "cuda")
    for r in ranks:
        if r["hist"] != stacked["hist"] or r["digests"] != [stacked["digests"][r["rank"]]]:
            fail(f"pipeline (d): rank {r['rank']}'s run differs from the stacked run")
    cfg = dataclasses.replace(get_config(SSD_ARCH), n_layers=SSD_GRAD_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    model = build(cfg, remat="full")
    # the runs' init (BuiltStep.init(seed=0))
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    paths = tree_flatten_with_paths(params)[0]
    batch = worker_batch(launch.data_stream(cfg, PIPE_SSD_BATCH, SSD_SEQ).batch_at(0),
                         SSD_WORKERS, "cuda")
    loss_f, grads_f = per_worker_grad_fn(model.loss_fn)(params, batch, False)
    loss_p, grads_p = build_pipelined_vag(model.pipeline, StageAxis(PIPE_STAGES))(
        params, batch, False)
    gaps = {}
    for path, a, b in zip(paths, tree_flatten_with_paths(grads_p)[1],
                          tree_flatten_with_paths(grads_f)[1]):
        scale = float(b.abs().max())
        gaps[path] = float((a - b).abs().max()) / scale if scale else 0.0
        if not gaps[path] <= SSD_GRAD_TOL:
            fail(f"pipeline (d): step-0 gradient {path} differs from the unpipelined one by "
                 f"{gaps[path]:.3g} of its max > {SSD_GRAD_TOL}")
    loss_gap = float((loss_p - loss_f).abs().max() / loss_f.abs().max())
    if not loss_gap <= SSD_GRAD_TOL:
        fail(f"pipeline (d): step-0 losses differ by {loss_gap:.3g}")
    worst = max(gaps.items(), key=lambda kv: kv[1])
    ms = statistics.median(stacked["step_s"]) * 1e3
    ms_r = statistics.median(s for r in ranks for s in r["step_s"]) * 1e3
    log(f"phase 16 (d): {SSD_ARCH} full width, {SSD_GRAD_LAYERS} layers, fp32, remat full, "
        f"{PIPE_STAGES} stages, {SSD_WORKERS} workers x {PIPE_SSD_BATCH // SSD_WORKERS} x "
        f"{SSD_SEQ} tokens, {PIPE_SSD_STEPS} step: 2 gloo ranks == the stacked run bitwise "
        f"(metrics; each rank's params, sha256); step-0 per-worker gradients within {worst[1]:.3g} "
        f"of a leaf's max ({worst[0]}; tolerance {SSD_GRAD_TOL}), losses {loss_gap:.3g} apart; "
        f"SSD launches stacked {stacked['ssd']}, ranks {[r['ssd'] for r in ranks]}; ms per "
        f"step stacked {ms:.1f}, ranks {ms_r:.1f}; {time.perf_counter() - t0:.1f} s")
    del grads_f, grads_p, params
    torch.cuda.empty_cache()
    return {"ssd_chunk": stacked["ssd"][0] + sum(r["ssd"][0] for r in ranks),
            "ssd_chunk_bwd": stacked["ssd"][1] + sum(r["ssd"][1] for r in ranks),
            "topk_ef": stacked["topk_ef"] + sum(r["topk_ef"] for r in ranks)}


# ---------------------------------------------------------------------------
# phase 17: elasticity and chaos (slice 14)
# ---------------------------------------------------------------------------

# Phase 4's cell through the launcher with membership events and faults:
# 10 -> 5 workers at step 6 and back to 10 at 13, a straggler at 5 (10
# workers) and at 9 (5 workers), a checkpoint every 4 steps. The crash at 7
# restores step 4, saved at 10 workers BEFORE the shrink at 6: the replay
# rebuilds at 10, meets the straggler at 5 again and shrinks again at 6. The
# restart legs save only at their ends (--ckpt-every past their last step):
# leg 1 ends at 6 with 10 workers, leg 2 restores it at 5 and ends at 13,
# leg 3 restores that at 10. They pass the same --resize and --faults, so
# each straggler keeps its index in the plan, and so its drawn worker.
ELASTIC_RESIZE = ((6, 5), (13, 10))
ELASTIC_STRAGGLERS = (5, 9)
ELASTIC_CRASH = 7
ELASTIC_EVERY = 4


def _elastic_argv(ckpt_dir, workers, steps, every, crash=False, arch="cnn_cifar",
                  per_worker=PER_WORKER, device="cuda"):
    resize = ",".join(f"{s}:{m}" for s, m in ELASTIC_RESIZE)
    faults = [f"straggler@{s}" for s in ELASTIC_STRAGGLERS] + (
        [f"crash@{ELASTIC_CRASH}"] if crash else [])
    top = max(m for _, m in ELASTIC_RESIZE)
    return ["--arch", arch, "--algo", "sasg", "--workers", str(workers), "--global-batch",
            str(top * per_worker), "--lr", str(LR), "--steps", str(steps), "--device", device,
            "--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(every), "--resize", resize,
            "--faults", ",".join(faults)]


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _allocated(peak=False) -> int:
    import torch

    if not torch.cuda.is_available():
        return 0
    return torch.cuda.max_memory_allocated() if peak else torch.cuda.memory_allocated()


def _instrument(trainer, marks):
    """Record, for every step the trainer runs: its index, worker count, the
    host clock at the start of its fault hooks (after a synchronize), at the
    start and end of ``built.step`` (synchronized), and the bytes allocated
    before the hooks and at the peak since."""
    import torch

    pre = trainer._pre_step

    def timed_pre(state, step):
        _sync()
        marks.append({"step": step, "pre": time.perf_counter(), "before": _allocated()})
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        return pre(state, step)

    def timed(built):
        fn = built.step

        def step(state, batch, force_skip=None):
            _sync()
            t0 = time.perf_counter()
            out = fn(state, batch, force_skip)
            _sync()
            marks[-1].update(workers=built.num_workers, t0=t0, t1=time.perf_counter(),
                             peak=_allocated(peak=True))
            return out

        return built._replace(step=step)

    trainer._pre_step = timed_pre
    trainer.built = timed(trainer.built)
    build = trainer.membership.build
    trainer.membership.build = lambda n: timed(build(n))


def _elastic_run(argv, marks=None):
    """The launcher's trainer for ``argv`` run from seed 0, batches recorded;
    returns it, the final state, its log lines and its top-k launches and
    segments."""
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch import train as launch

    logs = []
    trainer = launch.build_trainer(launch.parse_args(argv), logs.append)
    trainer.cfg.record_batches = True
    if marks is not None:
        _instrument(trainer, marks)
    topk_ef.LAUNCHES.reset()
    topk_ef.SEGMENTS.reset()
    state = trainer.run(seed=0)
    _sync()
    return trainer, state, logs, topk_ef.LAUNCHES.count, topk_ef.SEGMENTS.count


def _elastic_checks(what, trainer, state, logs, launches, segments, per_encode, n_leaves,
                    before=None):
    """Counters against the per-step history (with ``before``, the sends
    per step of the run a restart leg restored from), and the top-k
    launches against the encodes the run made: one per executed step
    (replays included) and one zero payload per worker-state start (the
    run's start, each in-run resize, each recovery's restore template, each
    restore at another worker count). Returns the sends per step."""
    steps_done = len(trainer.history)
    kinds = [e["kind"] for e in trainer.events]
    cold = sum("re-initialized SASG worker state" in m for m in logs)
    starts = 1 + kinds.count("resize") + kinds.count("recovery") + cold
    encodes = steps_done + starts
    log(f"{what}: {steps_done} steps executed, {starts} worker-state starts; topk_ef "
        f"{launches} launches over {segments} segments (expected {per_encode * encodes} = "
        f"{per_encode} per encode x {encodes} encodes, {n_leaves * encodes} = {n_leaves} "
        f"leaves x {encodes})")
    if launches != per_encode * encodes or segments != n_leaves * encodes:
        fail(f"{what}: topk_ef launched {launches} times over {segments} segments")
    first = trainer.batch_log[0][0]
    sent = {s: v for s, v in (before or {}).items() if s < first}
    for (step, _), h in zip(trainer.batch_log, trainer.history):
        sent[step] = h["num_sent"]     # a replayed step counts once, as run last
    rounds = sum(sent.values())
    last = trainer.history[-1]
    bits = (trainer.built.bits_paper, trainer.built.bits_wire)
    got = (float(state.counters.rounds), float(state.counters.bits_paper),
           float(state.counters.bits_wire))
    want = (rounds, rounds * bits[0], rounds * bits[1])
    if got != want or (last["rounds_total"], last["bits_paper_total"],
                       last["bits_wire_total"]) != want:
        fail(f"{what}: counters {got}, last step {last}, expected {want} from the history")
    if not all(math.isfinite(h["loss"]) for h in trainer.history):
        fail(f"{what}: loss not finite")
    return sent


def phase_elastic(card, arch="cnn_cifar", device="cuda"):
    """(a) the elastic bench; (b) phase 4's cell with in-run resizes, a
    straggler and a crash before the shrink, held bitwise to the run
    without the crash and to restart elasticity; (c) what it costs.
    Returns the top-k launches of its runs."""
    import shutil

    import torch

    from repro_torch.benchmarks import elastic_bench
    from repro_torch.core.compressors import CompressorConfig, leaf_geometry
    from repro_torch.core.types import tree_flatten_with_paths
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.kernels.topk_ef.topk_ef import _plan, plan_segments

    torch.use_deterministic_algorithms(True)   # as phase 4 ran
    root = ROOT / "build" / "elastic"
    shutil.rmtree(root, ignore_errors=True)
    out = {"launches": 0}

    # (a) the bench: the chaos matrix and 4 -> 2 -> 4 on fc_mnist
    topk_ef.LAUNCHES.reset()
    t0 = time.perf_counter()
    try:
        bench = elastic_bench.run(out_dir=str(root / "bench"), device=device)["elastic"]
    except RuntimeError as e:
        fail(str(e))
    out["launches"] += topk_ef.LAUNCHES.count
    log(f"phase 17 (a): elastic bench, {len(bench['cells'])} cells within their bounds in "
        f"{time.perf_counter() - t0:.1f} s, topk_ef {topk_ef.LAUNCHES.count} launches; "
        + ", ".join(f"{c['plan']} steps_lost {c['steps_lost']} recovery "
                    f"{c['recovery_latency_s'] * 1e3:.1f} ms "
                    + ("bitexact" if c["bitexact_vs_clean"] else "deterministic")
                    for c in bench["cells"]))

    # (b) the slice's path at full width
    top, low = ELASTIC_RESIZE[1][1], ELASTIC_RESIZE[0][1]
    kw = dict(arch=arch, device=device)
    plan_before = _plan.cache_info()
    marks = []
    t0 = time.perf_counter()
    faulted = _elastic_run(_elastic_argv(root / "faulted", top, STEPS, ELASTIC_EVERY,
                                         crash=True, **kw))
    t_faulted = time.perf_counter() - t0
    clean = _elastic_run(_elastic_argv(root / "clean", top, STEPS, ELASTIC_EVERY, **kw), marks)
    legs = []
    for workers, upto in ((top, ELASTIC_RESIZE[0][0]), (low, ELASTIC_RESIZE[1][0]),
                          (top, STEPS)):
        legs.append(_elastic_run(_elastic_argv(root / "restart", workers, upto, STEPS + 1,
                                               **kw)))
    plan_after = _plan.cache_info()

    paths, leaves, _ = tree_flatten_with_paths(faulted[1].params)
    per_m = {}
    for m in (top, low):
        views = []
        for path, x in zip(paths, leaves):
            blocked, kb = leaf_geometry(CompressorConfig(), tuple(x.shape), path)
            views.append((m * x.numel() // blocked[-1], blocked[-1], kb))
        per_m[m] = len(plan_segments(views, [(0, 0)] * len(views)).launches)
    if len(set(per_m.values())) != 1:
        fail(f"top-k launches per encode differ by worker count: {per_m}")
    per_encode = per_m[top]
    runs = {"faulted": faulted, "no crash": clean, **{f"restart leg {i + 1}": leg
                                                     for i, leg in enumerate(legs)}}
    sent, prev = {}, None
    for what, (tr, st, logs, launches, segments) in runs.items():
        # a restart leg goes on from the sends of the leg before it
        prev = sent[what] = _elastic_checks(
            f"phase 17 (b) {what}", tr, st, logs, launches, segments, per_encode,
            len(leaves), before=prev if what.startswith("restart") else None)
        out["launches"] += launches
    events = [(e["kind"], e.get("step", e.get("failed_step"))) for e in faulted[0].events]
    want_events = [("straggler", 5), ("resize", 6), ("crash", 7), ("recovery", 7),
                   ("straggler", 5), ("resize", 6), ("straggler", 9), ("resize", 13)]
    if events != want_events:
        fail(f"phase 17 (b): events {faulted[0].events}")
    rec = [e for e in faulted[0].events if e["kind"] == "recovery"][0]
    if (rec["restored_step"], rec["steps_lost"]) != (ELASTIC_EVERY, 3):
        fail(f"phase 17 (b): recovery {rec}, expected a restore of step {ELASTIC_EVERY}")
    if not any(f"rebuilding at the checkpoint's {top} workers" in m for m in faulted[2]):
        fail("phase 17 (b): the recovery did not rebuild at the checkpoint's worker count")
    for s in ELASTIC_STRAGGLERS:
        m = top if s < ELASTIC_RESIZE[0][0] or s >= ELASTIC_RESIZE[1][0] else low
        if not sent["no crash"][s] < m:
            fail(f"phase 17 (b): the straggler at step {s} forced no skip")
    if not _states_equal(faulted[1], clean[1]):
        fail("phase 17 (b): the run with the crash differs from the run without it")
    if not _states_equal(clean[1], legs[-1][1]):
        fail("phase 17 (b): the in-run resizes differ from restart elasticity")
    if dict(faulted[0].batch_log) != dict(clean[0].batch_log):
        fail("phase 17 (b): the faulted run applied other batches")
    grown = plan_after.currsize - plan_before.currsize
    if grown > 2:
        fail(f"phase 17 (b): the top-k plan cache grew by {grown} over the resizes")
    log(f"phase 17 (b): {arch} {top} -> {low} -> {top} workers in-run with stragglers at "
        f"{ELASTIC_STRAGGLERS} and a crash at {ELASTIC_CRASH} restoring step {ELASTIC_EVERY} "
        f"(saved at {top} workers, before the shrink): final state bitwise the run without "
        "the crash and bitwise the 3 restart legs; counters exact; sends per step "
        f"{[int(v) for v in sent['no crash'].values()]}; top-k plan cache "
        f"{plan_before.currsize} -> {plan_after.currsize} entries (misses "
        f"+{plan_after.misses - plan_before.misses}); faulted run {t_faulted:.1f} s")

    # (c) what it costs, from the run without the crash
    by_m = {}
    resize_steps = {s for s, _ in ELASTIC_RESIZE}
    for mk in marks:
        if mk["step"] not in resize_steps and mk["step"] > 0 and "t1" in mk:
            by_m.setdefault(mk["workers"], []).append((mk["t1"] - mk["t0"]) * 1e3)
    step_ms = {m: statistics.median(v) for m, v in by_m.items()}
    lines = [f"ms per step (median, host clock around synchronize) {top} workers "
             f"{step_ms[top]:.2f}, {low} workers {step_ms[low]:.2f}"]
    for mk, nxt in zip(marks, marks[1:]):
        if mk["step"] in resize_steps and "t1" in mk:
            lines.append(
                f"resize at step {mk['step']} to {mk['workers']} workers: "
                f"{(mk['t1'] - mk['pre']) * 1e3:.2f} ms from the event to the end of the "
                f"step (its step alone {(mk['t1'] - mk['t0']) * 1e3:.2f} ms); bytes allocated "
                f"{mk['before']} before the event, {mk['peak']} at the peak of the event and "
                f"its step, {nxt['before']} at the next step's start")
    ckpts = {}
    for step in sorted(int(p.name.split("_")[1]) for p in (root / "clean").glob("step_*")):
        d = root / "clean" / f"step_{step}"
        ckpts[step] = sum(f.stat().st_size for f in d.iterdir())
    lines.append(f"recovery latency {rec['latency_s'] * 1e3:.1f} ms (restore of step "
                 f"{rec['restored_step']}: verify, rebuild at {top}, read, place)")
    lines.append("checkpoint bytes " + ", ".join(f"step_{s} {b}" for s, b in ckpts.items())
                 + f" (step_12 holds {low} workers' state, the others {top})")
    for line in lines:
        log(f"phase 17 (c) {card}: {line}")
    out.update(step_ms=step_ms, ckpt_bytes=ckpts, recovery_s=rec["latency_s"])
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 18: analysis (slice 15)
# ---------------------------------------------------------------------------

ANALYSIS_STEPS = 5           # (b): steps under the wire log, and as many without it
ANALYSIS_RING_STEPS = 2      # (c): the compressed ring's steps under the log


def _audit_line(what, rec):
    """One printed row of an audit record: the numbers the gates read."""
    keys = ("expected_exchange_wire_bytes", "logged_exchange_wire_bytes", "drift",
            "exchange_collectives", "dsized_threshold_bytes", "total_collectives",
            "moved_bytes", "ring_wire_bytes", "ring_model_wire_bytes",
            "stage_grad_wire_bytes", "stage_grad_bound_bytes", "stage_gather_wire_bytes",
            "stage_gather_model_wire_bytes", "pipe_model_bytes_per_step")
    row = {k: rec[k] for k in keys if k in rec}
    row["dsized_collectives"] = len(rec["dsized_collectives"])
    log(f"{what}: {json.dumps(row)}")


def _logged_steps(built, stream, steps, log_on):
    """``steps`` steps from ``init(0)``; with ``log_on`` each under its own
    wire log. Returns (state, rows per step, ms per step)."""
    import torch

    from repro_torch.comm import collectives

    state = built.init(seed=0)
    rows, ms = [], []
    for i in range(steps):
        batch = stream.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if log_on:
            with collectives.wire_log() as got:
                state, _ = built.step(state, batch)
            rows.append(got)
        else:
            state, _ = built.step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, rows, ms


def phase_analysis(card):
    """(a) ``python -m repro_torch.analysis --check`` on the card (its
    ``main``): the lint sweep, the registry rule on CUDA tensors, the five
    audit cells, and the bench gates over phase 17's elastic record; (b)
    phase 4's cell, ``ANALYSIS_STEPS`` steps under the wire log and as many
    without it: params bitwise equal, every step's exchange bytes the
    counters' (M-1) x bits_wire / 8 and nothing d-sized, the topk_ef kernel
    launched by every encode; (c) phase 16 (c)'s compressed ring, 2 steps
    under the log: ring bytes PipelineCommModel's, the stage gradient
    traffic k-sized and its gather pipeline_gather_bits', the block_topk
    kernel launched by every ring encode. Returns the kernels' launches."""
    import dataclasses

    import torch

    from repro_torch.analysis import comm_audit
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.comm.transport import ActivationLayout
    from repro_torch.configs import get_config
    from repro_torch.kernels.block_topk import block_topk
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch import train as launch
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import build_train_step

    torch.use_deterministic_algorithms(True)   # as phase 4 ran
    out = {"topk_ef": 0, "block_topk": 0}

    # (a) the CLI's gate on the card
    report_path = ROOT / "build" / "analysis" / "comm_audit.json"
    t0 = time.perf_counter()
    rc = analysis_main(["--check", "--device", "cuda", "--report", str(report_path),
                        "--bench-dir", str(ROOT / "build" / "elastic" / "bench")])
    if rc != 0:
        fail(f"phase 18 (a): python -m repro_torch.analysis --check exited {rc}")
    report = json.loads(report_path.read_text())
    for name, rec in sorted(report["cells"].items()):
        _audit_line(f"phase 18 (a) audit {name} ({report['device']})", rec)
    log(f"phase 18 (a): the analysis gate passed on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    # (b) phase 4's cell with the wire log on and off
    cfg = get_config("cnn_cifar")
    argv = ["--arch", "cnn_cifar", "--algo", "sasg", "--workers", str(WORKERS),
            "--global-batch", str(WORKERS * PER_WORKER), "--lr", str(LR),
            "--steps", str(ANALYSIS_STEPS), "--device", "cuda"]
    built = launch.build_trainer(launch.parse_args(argv), lambda m: None).built
    stream = launch.data_stream(cfg, WORKERS * PER_WORKER)
    model = build(cfg)
    topk_ef.LAUNCHES.reset()
    state_on, rows, ms_on = _logged_steps(built, stream, ANALYSIS_STEPS, True)
    launches_on = topk_ef.LAUNCHES.count
    state_off, _, ms_off = _logged_steps(built, stream, ANALYSIS_STEPS, False)
    launches = topk_ef.LAUNCHES.count
    out["topk_ef"] += launches
    encodes = ANALYSIS_STEPS + 1   # a step's encode each, and the zero payload of init
    if (launches_on, launches) != (encodes, 2 * encodes):
        fail(f"phase 18 (b): topk_ef launched {launches_on} / {launches} times, expected "
             f"{encodes} with the log and {encodes} without (one per encode)")
    if not _final_params_equal(state_on.params, state_off.params):
        fail("phase 18 (b): params with the wire log differ from the run without it")
    want = (WORKERS - 1) * built.bits_wire / 8
    for i, step_rows in enumerate(rows):
        rec = comm_audit.audit_step(model, built, stream.batch_at(i), step_rows)
        if rec["logged_exchange_wire_bytes"] != want or rec["expected_exchange_wire_bytes"] != want:
            fail(f"phase 18 (b) step {i}: exchange {rec['logged_exchange_wire_bytes']} B "
                 f"logged, counters {want} B")
        problems = comm_audit.check_report({"cells": {f"step {i}": rec}})
        if problems:
            fail(f"phase 18 (b): {problems}")
    _audit_line("phase 18 (b) audit, step 0", comm_audit.audit_step(
        model, built, stream.batch_at(0), rows[0]))
    ex_rows = [r for r in rows[0] if r["op"] == "exchange"]
    log(f"phase 18 (b) rows of step 0: {len(rows[0])} ({len(ex_rows)} exchange all-gathers "
        f"over {ex_rows[0]['axes']} of {ex_rows[0]['group_size']} devices, the largest "
        f"{max(r['result_bytes'] for r in ex_rows)} B; "
        + ", ".join(f"{r['op']} {r['kind']} {r['shapes']}" for r in rows[0]
                    if r["op"] != "exchange") + ")")
    on, off = statistics.median(ms_on[1:]), statistics.median(ms_off[1:])
    log(f"card {card}: phase 18 (b) cnn_cifar M={WORKERS}: {on:.2f} ms per step with the "
        f"wire log, {off:.2f} ms without ({ANALYSIS_STEPS} steps each, median of the last "
        f"{ANALYSIS_STEPS - 1}); params bitwise equal; exchange {want:.0f} B a step per "
        f"device = ({WORKERS} - 1) x bits_wire {built.bits_wire:.0f} / 8; topk_ef "
        f"{launches} launches")

    # (c) phase 16 (c)'s compressed ring under the log
    pipe = launch.build_trainer(launch.parse_args(_pipe_argv()), lambda m: None).built
    scfg = dataclasses.replace(pipe.exchange.config, act_layout=ActivationLayout(**RING),
                               overlap=True)
    ring = build_train_step(model, scfg, WORKERS, constant(LR), device="cuda",
                            mesh=pipe.mesh, strategy=pipe.strategy)
    block_topk.LAUNCHES.reset()
    topk_ef.LAUNCHES.reset()
    _, rows_c, ms_c = _logged_steps(ring, stream, ANALYSIS_RING_STEPS, True)
    out["block_topk"] += block_topk.LAUNCHES.count
    out["topk_ef"] += topk_ef.LAUNCHES.count
    per_step = 2 * (2 * (PIPE_STAGES - 1) * PIPE_N_MICRO + 1)   # two gradient passes
    if block_topk.LAUNCHES.count != ANALYSIS_RING_STEPS * per_step:
        fail(f"phase 18 (c): block_topk launched {block_topk.LAUNCHES.count} times, "
             f"expected {ANALYSIS_RING_STEPS * per_step} (one per ring encode)")
    for i, step_rows in enumerate(rows_c):
        rec = comm_audit.audit_step(model, ring, stream.batch_at(i), step_rows)
        problems = comm_audit.check_report({"cells": {f"step {i}": rec}})
        if problems or rec["ring_wire_bytes"] != rec["ring_model_wire_bytes"]:
            fail(f"phase 18 (c) step {i}: {problems or rec}")
        _audit_line(f"phase 18 (c) audit, step {i}", rec)
    for r in comm_audit._count_rows([r for r in rows_c[0] if "stage" in r["axes"]]):
        log(f"phase 18 (c) stage row: {json.dumps(r)}")
    log(f"phase 18 (c): compressed ring ({RING}) {ANALYSIS_RING_STEPS} steps under the wire "
        f"log, ring and stage gather equal to the models, block_topk "
        f"{block_topk.LAUNCHES.count} launches, topk_ef {topk_ef.LAUNCHES.count}; "
        f"{statistics.median(ms_c):.1f} ms per step with the log")
    return out


def main() -> int:
    global PARENT_TREE
    args = sys.argv[1:]
    tree, cells = ROOT, args[:1] == ["--tp-cells"]
    if cells and len(args) == 2:
        tree = Path(args[1]).resolve()
    elif args[:1] == ["--parent"] and len(args) == 2:
        PARENT_TREE = Path(args[1]).resolve()
    elif args:
        fail(f"usage: chip_smoke.py [--parent DIR | --tp-cells DIR], got {args}")
    src = tree / "src"
    if not (src / "repro_torch" / "csrc" / "topk_ef.cu").is_file():
        fail(f"no checkout around {tree}: src/repro_torch is missing")
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    if cells:
        print(json.dumps({"tp_cells": tp_cells(str(tree))}), flush=True)
        return 0

    t_start = time.perf_counter()
    name, card = phase_environment()
    phase_build()
    errs = phase_kernels()
    trainer, state, launches, peak = phase_main_path()
    step_ms = phase_lockstep("cnn_cifar", LR, state_main=state)
    # fc_mnist at lr 0.1 skips uploads within 20 steps: the stale-payload
    # branch of the exchange runs on the card too
    phase_lockstep("fc_mnist", 0.1, want_skips=True)
    phase_identity_exchange()
    times = phase_times()
    log(f"card {card}: step {step_ms['kernel']:.2f} ms, peak memory {peak} bytes")
    t_opts = time.perf_counter()
    phase_training_options(card)
    log(f"training options phase: {time.perf_counter() - t_opts:.1f} s")
    t_tables = time.perf_counter()
    tables = phase_tables(card)
    log(f"tables phase: {time.perf_counter() - t_tables:.1f} s")
    t_procs = time.perf_counter()
    procs = phase_procs(card, trainer, state)
    log(f"processes phase: {time.perf_counter() - t_procs:.1f} s")
    log(f"topk_ef launches over the main paths: {launches['topk_ef']} (phase 4) + "
        f"{tables['launches']} (tables) + {procs['launches']} (processes)")
    launches["topk_ef"] += tables["launches"] + procs["launches"]
    served = phase_serve()
    profile_tick(served["model"], served["params"], SERVE_PREFILL, 2)
    profile_tick(served["model"], served["params"], 1, 5)
    del served["model"], served["params"]
    phase_free_running()
    times["ssd_chunk"] = phase_ssd_times(48)
    launches["ssd_chunk"] = served["launches"]
    log(f"card {card}: serving {SERVE_ARCH}: "
        + ", ".join(f"width {w} {ms:.2f} ms/tick" for w, ms in served["per_width_ms"].items())
        + f", {served['decode_tok_s']:.1f} tok/s, peak memory {served['peak']} bytes; "
        f"SSD kernel {served['launches'] // served['n_prefill']} launches per prefill tick")
    t_dense = time.perf_counter()
    dense = phase_dense_serve(card)
    log(f"dense serving phase: {time.perf_counter() - t_dense:.1f} s")
    t_lm = time.perf_counter()
    lm = phase_lm_training()
    log(f"LM training phase: {time.perf_counter() - t_lm:.1f} s")
    log(f"topk_ef launches over the main paths: {launches['topk_ef']} (phases 4, 8, 9) + "
        f"{lm['launches']} (LM training)")
    launches["topk_ef"] += lm["launches"]
    t_paged = time.perf_counter()
    phase_paged_serve(card, dense)
    del dense
    moe = phase_lm_training("mixtral_8x7b")
    log(f"phase 12 (paged cache, MoE, sliding window): {time.perf_counter() - t_paged:.1f} s")
    log(f"topk_ef launches over the main paths: {launches['topk_ef']} (phases 4, 8, 9, 11) + "
        f"{moe['launches']} (MoE training, {moe['segments']} segments)")
    launches["topk_ef"] += moe["launches"]
    t_rg = time.perf_counter()
    phase_rg_serve(card)
    phase_rg_checks()
    phase_ed(card)
    rg = phase_lm_training(RG_ARCH)
    log(f"phase 13 (RG-LRU hybrid, encoder-decoder): {time.perf_counter() - t_rg:.1f} s")
    log(f"topk_ef launches over the main paths: {launches['topk_ef']} (phases 4, 8, 9, 11, 12) "
        f"+ {rg['launches']} (RG-LRU training, {rg['segments']} segments)")
    launches["topk_ef"] += rg["launches"]
    t_ssd = time.perf_counter()
    errs["ssd_chunk_bwd"] = phase_ssd_bwd_kernels()
    phase_ssd_grad_full_width()
    ssd_train = phase_ssd_training(card)
    ssd_lm = phase_lm_training(SSD_ARCH)
    times["ssd_chunk_bwd"] = phase_ssd_bwd_times(48)
    log(f"phase 14 (Mamba-2 training): {time.perf_counter() - t_ssd:.1f} s")
    for k in ("ssd_chunk", "ssd_chunk_bwd"):
        log(f"{k} launches over the main paths: {launches.get(k, 0)} (phase 6) + "
            f"{ssd_train[k]} (phase 14 (c)) + {ssd_lm[k]} (phase 14 (d))")
        launches[k] = launches.get(k, 0) + ssd_train[k] + ssd_lm[k]
    log(f"topk_ef launches over the main paths: {launches['topk_ef']} (phases 4, 8, 9, 11-13) "
        f"+ {ssd_train['launches']} (phase 14 (c), {ssd_train['segments']} segments) + "
        f"{ssd_lm['launches']} (phase 14 (d), {ssd_lm['segments']} segments)")
    launches["topk_ef"] += ssd_train["launches"] + ssd_lm["launches"]
    log(f"card {card}: {SSD_ARCH} trained at full width: {ssd_train['step_ms']:.1f} ms per "
        f"step, peak memory {ssd_train['peak']} bytes; ssd_chunk_bwd "
        f"{times['ssd_chunk_bwd']['ms']:.4f} ms per gradient evaluation")
    t_mesh = time.perf_counter()
    mesh = phase_mesh(card, trainer, state)
    log(f"phase 15 (strategies and sharding): {time.perf_counter() - t_mesh:.1f} s")
    log(f"topk_ef launches over the main paths: {launches['topk_ef']} (phases 4, 8, 9, 11-14) "
        f"+ {mesh['launches']} (phase 15)")
    launches["topk_ef"] += mesh["launches"]
    for k in ("ssd_chunk", "ssd_chunk_bwd"):
        log(f"{k} launches over the main paths: {launches[k]} (phases 6, 14) + {mesh[k]} "
            f"(phase 15 (f), (h))")
        launches[k] += mesh[k]
    t_pipe = time.perf_counter()
    remat = phase_remat(card, ssd_train)
    del ssd_train["params"]
    pipe = phase_pipeline(card, trainer)
    log(f"phase 16 (remat and the pipeline): {time.perf_counter() - t_pipe:.1f} s")
    for k in ("ssd_chunk", "ssd_chunk_bwd"):
        log(f"{k} launches over the main paths: {launches[k]} (phases 6, 14, 15) + "
            f"{remat[k]} (phase 16 (a)) + {pipe[k]} (phase 16 (d))")
        launches[k] += remat[k] + pipe[k]
    log(f"topk_ef launches over the main paths: {launches['topk_ef']} (phases 4, 8, 9, 11-15) "
        f"+ {remat['launches'] + pipe['topk_ef']} (phase 16); block_topk: "
        f"{launches['block_topk']} (phase 4) + {pipe['block_topk']} (phase 16 (c)'s ring "
        f"encodes)")
    launches["topk_ef"] += remat["launches"] + pipe["topk_ef"]
    launches["block_topk"] += pipe["block_topk"]
    t_elastic = time.perf_counter()
    elastic = phase_elastic(card)
    log(f"phase 17 (elasticity and chaos): {time.perf_counter() - t_elastic:.1f} s")
    log(f"topk_ef launches over the main paths: {launches['topk_ef']} (phases 4, 8, 9, 11-16) "
        f"+ {elastic['launches']} (phase 17)")
    launches["topk_ef"] += elastic["launches"]
    t_analysis = time.perf_counter()
    analysis = phase_analysis(card)
    log(f"phase 18 (analysis): {time.perf_counter() - t_analysis:.1f} s")
    log(f"topk_ef launches over the main paths: {launches['topk_ef']} (phases 4, 8, 9, 11-17) "
        f"+ {analysis['topk_ef']} (phase 18); block_topk: {launches['block_topk']} (phases "
        f"4, 16 (c)) + {analysis['block_topk']} (phase 18 (c)'s ring encodes)")
    launches["topk_ef"] += analysis["topk_ef"]
    launches["block_topk"] += analysis["block_topk"]
    # block_topk's only main path is the ring: its row times one hop's encode
    # (phase 5's time of the cnn_cifar gradient encode stays on its own line)
    times["block_topk"] = pipe["ring_encode"]

    sources = {
        "topk_ef": ("src/repro_torch/csrc/topk_ef.cu", "src/repro/kernels/topk_ef/topk_ef.py:32"),
        "block_topk": ("src/repro_torch/csrc/topk_ef.cu",
                       "src/repro/kernels/block_topk/block_topk.py:23"),
        "ssd_chunk": ("src/repro_torch/csrc/ssd_scan.cu",
                      "src/repro/kernels/ssd_scan/ssd_scan.py:27"),
        "ssd_chunk_bwd": ("src/repro_torch/csrc/ssd_scan_bwd.cu",
                          "src/repro/models/ssd.py:74 ssd_chunked under jax.grad, no Pallas "
                          "kernel"),
    }
    kernels = [
        {
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k],
            "max_abs_err": errs[k], "ms": times[k]["ms"],
            "plain_ms": times[k]["plain_ms"], "bound_ms": times[k]["bound_ms"],
            "bound_by": times[k]["bound_by"], "library_ms": times[k]["library_ms"],
        }
        for k, (src, replaces) in sources.items()
    ]
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
