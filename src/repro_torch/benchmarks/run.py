"""The paper's tables and figures on the port, one after the other:

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--full] \
      [--device cuda|cpu] [--topk-impl kernel|sharded]
  PYTHONPATH=src python -m repro_torch.benchmarks.run --serve [--smoke] \
      [--device cuda|cpu]
  PYTHONPATH=src python -m repro_torch.benchmarks.run --stages 2 [--device cuda|cpu]
  PYTHONPATH=src python -m repro_torch.benchmarks.run --elastic [--smoke] \
      [--device cuda|cpu]
  PYTHONPATH=src python -m repro_torch.benchmarks.run --compressors [--smoke] \
      [--device cuda|cpu]

Table 1 (cost model), Table 2 (rounds and bits to a target accuracy;
fc_mnist, and with ``--full`` fc_mnist at 800 steps and cnn_cifar), Table 3
(communication time from Table 2's skip fraction, the auxiliary gradient
timed on the device) and Figures 2-4 (sparklines of Table 2's curves),
written into ``artifacts/bench_torch/``. Runs on the card unless
``--device cpu``, and raises without one.

``--serve`` runs the continuous-batching serve bench instead
(``serve_bench.py``: dense vs paged cells, ``serve.json``; ``--smoke``
for one arch at one concurrency); ``--stages S`` the pipelined-vs-flat
step bench (``pipeline_bench.py``, ``pipeline.json``); ``--elastic`` the
chaos matrix and the in-run resize on fc_mnist (``elastic_bench.py``,
``elastic.json``; exits non-zero when a cell fails its bounds;
``--smoke``: the crash and worker_drop cells); ``--compressors`` the
compressor x layout sweep (``compressor_bench.py``, ``compressors.json``;
``--smoke``: one timed step).

Counterpart of the JAX repo's ``benchmarks/run.py`` but for
``roofline.py``, which reads TPU dry-run artifacts and has no torch
counterpart.
"""
import argparse
import sys
import time

from . import (compressor_bench, elastic_bench, fig_curves, pipeline_bench, serve_bench,
               table1_comm_model, table2_rounds_bits, table3_comm_time)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="fc_mnist at 800 steps and the cnn_cifar comparison (slower)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--topk-impl", default="kernel", choices=["kernel", "sharded"],
                    help="top-k of Sparse and SASG: the fused kernel or the "
                         "reference's per-shard unfused selection")
    ap.add_argument("--serve", action="store_true",
                    help="the serve bench (dense vs paged KV cache) instead of the tables")
    ap.add_argument("--smoke", action="store_true",
                    help="with --serve: one arch at one concurrency; with --elastic: the "
                         "crash and worker_drop cells; with --compressors: one timed step")
    ap.add_argument("--stages", type=int, default=0,
                    help="the pipelined-vs-flat step bench at this many stages instead")
    ap.add_argument("--elastic", action="store_true",
                    help="the elasticity and chaos bench instead of the tables")
    ap.add_argument("--compressors", action="store_true",
                    help="the compressor x layout sweep instead of the tables")
    ap.add_argument("--out-dir", default=table2_rounds_bits.OUT_DIR)
    args = ap.parse_args(argv)

    from repro_torch.train.step import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        import torch

        print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.time()
    if args.serve:
        serve_bench.run(smoke=args.smoke, out_dir=args.out_dir, device=device)
        print(f"repro_torch.benchmarks.run --serve complete in {time.time() - t0:.1f}s",
              flush=True)
        return 0
    if args.elastic:
        elastic_bench.run(smoke=args.smoke, out_dir=args.out_dir, device=device)
        print(f"repro_torch.benchmarks.run --elastic complete in {time.time() - t0:.1f}s",
              flush=True)
        return 0
    if args.compressors:
        compressor_bench.run(steps=1 if args.smoke else 10, rounds=1 if args.smoke else 3,
                             out_dir=args.out_dir, device=device)
        print(f"repro_torch.benchmarks.run --compressors complete in "
              f"{time.time() - t0:.1f}s", flush=True)
        return 0
    if args.stages:
        pipeline_bench.run(stages=args.stages, out_dir=args.out_dir, device=device)
        print(f"repro_torch.benchmarks.run --stages complete in {time.time() - t0:.1f}s",
              flush=True)
        return 0
    table1_comm_model.run()
    table2_rounds_bits.run(quick=not args.full, out_dir=args.out_dir,
                           topk_impl=args.topk_impl, device=device)
    table3_comm_time.run(out_dir=args.out_dir, device=device)
    fig_curves.run(out_dir=args.out_dir)
    print(f"repro_torch.benchmarks.run complete in {time.time() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
