"""End-to-end training driver of the port (M simulated workers).

  PYTHONPATH=src python -m repro_torch.launch.train --arch cnn_cifar \
      --algo sasg --workers 10 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch cnn_cifar \
      --algo sasg --mesh-shape 10,2 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b --reduced \
      --algo sasg --workers 4 --global-batch 8 --seq-len 64 --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_370m \
      --algo sasg --workers 4 --global-batch 4 --seq-len 512 --steps 3

The paper nets train on the synthetic classification stream, the LMs
(``--reduced`` for the smoke-test width) on the replayable bigram token
stream of ``--seq-len`` tokens, as in the JAX launcher (recurrentgemma_9b
and mamba2_370m too: its SSD chunk term through the CUDA forward and
backward kernels; ``--seq-len`` must be a multiple of its chunk size, a
``ValueError`` otherwise). ``--remat full`` recomputes each unit of an
LM's layer stack in the backward (``models/remat.py``; the gradients are
the run without it, bitwise); ``--remat dots`` is accepted and runs as
``full``. An encoder-decoder (seamless_m4t_v2) is
refused with a ``ValueError``: the token stream has no frames (the JAX
launcher fails at its first step).

Runs on the card (``--device cuda``, the default) and exits non-zero
without one; ``--device cpu`` runs the plain versions of the kernels. The
M workers are a stacked leading dim on one device (``--workers``, 10 by
default). ``--mesh-shape data,model`` (or ``pod,data,model``) is the JAX
launcher's: ``dist.strategy.choose_strategy`` picks flat, hierarchical or
plain (``--algo sgd``) on it and the step prints its strategy line.
Without ``--procs`` the mesh is stacked in this process (the exchange's
block geometry follows the TP specs); with ``--procs`` (the mesh's size)
it is a device mesh of that many ranks, each holding its TP shard.
``--workers`` then defaults to the worker axis's size and may be a
multiple of it. ``--stages S`` (with ``--mesh-shape``) inserts a stage
axis of size S before the last mesh entry, as the JAX launcher does, and
pipelines the model's trunk over it (``dist/pipeline.py``, the 1F1B
engine; ``--microbatches``, 0 -> S): stacked in this process without
``--procs``, one stage a rank with it, each rank holding its stage's
trunk slice:

  PYTHONPATH=src python -m repro_torch.launch.train --arch cnn_cifar \
      --algo sasg --mesh-shape 1,1 --stages 2 --workers 10 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch cnn_cifar \
      --algo sasg --mesh-shape 1,1 --stages 2 --procs 2 --backend gloo \
      --workers 10 --steps 20

The compressor, wire and checkpoint flags are the JAX launcher's, spelled
and checked as there:

  PYTHONPATH=src python -m repro_torch.launch.train --arch cnn_cifar \
      --algo sasg --compressor qsgd --ckpt-dir /tmp/ck --ckpt-every 2 \
      --workers 2 --global-batch 4 --steps 4 --device cpu

Elasticity and chaos (``train/elastic.py``, ``train/faults.py``), with the
JAX launcher's flags: ``--resize STEP:WORKERS,...`` resizes the worker
count in-run at those steps (state carried, worker state started cold
from the carried params), ``--faults KIND@STEP,...`` injects crash,
straggler, corrupt_ckpt, save_fail or data_hiccup faults; either flag
runs an ``ElasticTrainer``. ``--global-batch`` must divide over every
worker count of the plan:

  PYTHONPATH=src python -m repro_torch.launch.train --arch cnn_cifar \
      --algo sasg --workers 10 --steps 20 --resize 6:5,13:10 \
      --faults straggler@5,crash@7 --ckpt-dir /tmp/ck --ckpt-every 4

Workers as processes: ``--procs P`` spawns P processes of one worker group
(``comm.process_group``), each holding M/P of the ``--workers`` M, with
``--backend gloo`` (the default on the CPU; payloads staged to the host)
or ``nccl`` (the default on the card; one rank per card). Rank r runs on
``cuda:(r % device_count)``, so gloo ranks may share one card. Under
``torchrun`` the group comes from its environment instead:

  PYTHONPATH=src python -m repro_torch.launch.train --arch fc_mnist \
      --algo sasg --workers 4 --procs 2 --steps 6 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch cnn_cifar \
      --algo sasg --mesh-shape 1,2 --procs 2 --workers 4 --steps 3 --device cpu
"""
import argparse
import dataclasses
import sys


def parse_k_ratio_per_layer(ap, spec: str) -> tuple:
    """``'pattern=ratio,...'`` -> ((pattern, ratio), ...), with the JAX
    launcher's error messages."""
    schedule = []
    for item in spec.split(","):
        pattern, sep, ratio = item.partition("=")
        if not sep or not pattern:
            ap.error(f"--k-ratio-per-layer entry {item!r} is not 'pattern=ratio'")
        try:
            schedule.append((pattern, float(ratio)))
        except ValueError:
            ap.error(f"--k-ratio-per-layer ratio {ratio!r} is not a float")
    return tuple(schedule)


def parse_resize(ap, spec: str) -> tuple:
    """``'STEP:WORKERS,...'`` -> ((step, workers), ...), with the JAX
    launcher's error message."""
    events = []
    for item in spec.split(","):
        step_s, sep, workers_s = item.partition(":")
        if not sep:
            ap.error(f"--resize entry {item!r} is not 'STEP:WORKERS'")
        try:
            events.append((int(step_s), int(workers_s)))
        except ValueError as e:
            ap.error(str(e))
    return tuple(events)


def parse_faults(ap, spec: str) -> tuple:
    """``'KIND@STEP,...'`` -> (Fault, ...), with the JAX launcher's error
    messages (an unknown kind, a negative step, a resize without a
    target)."""
    from repro_torch.train.faults import Fault

    faults = []
    for item in spec.split(","):
        kind, sep, step_s = item.partition("@")
        if not sep:
            ap.error(f"--faults entry {item!r} is not 'KIND@STEP'")
        try:
            faults.append(Fault(kind, int(step_s)))
        except ValueError as e:
            ap.error(str(e))
    return tuple(faults)


def parse_args(argv=None):
    from repro_torch.configs import ARCH_IDS, PAPER_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="cnn_cifar", choices=PAPER_IDS + ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--algo", default="sasg", choices=["sgd", "sparse", "lasg", "sasg"])
    ap.add_argument("--k-ratio", type=float, default=0.01)
    ap.add_argument("--compressor", default=None,
                    help="override the preset's compressor (topk_ef, randk, "
                         "qsgd, signsgd_ef, terngrad, identity)")
    ap.add_argument("--topk-impl", default=None,
                    help="topk_ef impl: kernel (fused CUDA kernel, default) | "
                         "reference | exact")
    ap.add_argument("--layout", default=None,
                    help="wire layout: per_shard | per_tensor | flat")
    ap.add_argument("--wire-dtype", default=None,
                    help="payload value dtype on the wire (e.g. bfloat16)")
    ap.add_argument("--k-ratio-per-layer", default=None,
                    help="layer-wise k schedule: 'pattern=ratio,...' matched "
                         "against leaf paths (Shi et al., 2019)")
    ap.add_argument("--max-delay", type=int, default=10,
                    help="staleness cap D of the selection rule (lasg, sasg)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--global-batch", type=int, default=0,
                    help="global batch; 0 -> 10 samples per worker (paper §5.1)")
    ap.add_argument("--seq-len", type=int, default=64,
                    help="tokens per sequence of an LM's batches")
    ap.add_argument("--workers", type=int, default=None,
                    help="number of simulated workers M (paper §5.1: 10; with "
                         "--mesh-shape the worker axis's size, or a multiple of it)")
    ap.add_argument("--mesh-shape", default=None,
                    help="data,model (or pod,data,model) sizes: the strategy of "
                         "dist.strategy on a stacked mesh in this process, or with "
                         "--procs (the mesh's size) on a device mesh of that many ranks")
    ap.add_argument("--stages", type=int, default=1,
                    help="pipeline stages; >1 inserts a stage axis of that size before "
                         "the LAST --mesh-shape entry (e.g. --mesh-shape 2,1 --stages 2)")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="pipeline microbatches per worker (0 -> stages)")
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"],
                    help="recompute each layer-stack unit in the backward")
    ap.add_argument("--resize", default=None,
                    help="in-run elastic membership events: 'STEP:WORKERS,STEP:WORKERS,...' "
                         "(e.g. '50:2,100:4' shrinks the worker count to 2 at step 50 and "
                         "grows it back to 4 at 100; no restart, state carried per "
                         "DESIGN.md §5)")
    ap.add_argument("--faults", default=None,
                    help="chaos injection: 'KIND@STEP,...' with KIND in crash, straggler, "
                         "corrupt_ckpt, save_fail, data_hiccup (e.g. 'crash@30,data_hiccup@70')")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--procs", type=int, default=None,
                    help="processes of the worker group, each holding workers/procs "
                         "of the workers (with --mesh-shape: the ranks of the device "
                         "mesh, as many as its size)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="collectives of the worker group (default: nccl on cuda, "
                         "gloo on cpu)")
    args = ap.parse_args(argv)
    if args.k_ratio_per_layer:
        args.k_ratio_per_layer = parse_k_ratio_per_layer(ap, args.k_ratio_per_layer)
    args.resize = parse_resize(ap, args.resize) if args.resize else ()
    args.faults = parse_faults(ap, args.faults) if args.faults else ()
    args.device_mesh = args.mesh_shape is not None and args.procs is not None
    if args.procs is None:
        args.procs = 1
    if args.mesh_shape is not None:
        from repro_torch.launch.mesh import parse_mesh_shape

        try:
            args.mesh_shape, args.mesh_axes = parse_mesh_shape(args.mesh_shape)
        except ValueError as e:
            ap.error(str(e))
        if args.stages > 1:
            shape = args.mesh_shape
            args.mesh_shape = shape[:-1] + (args.stages, shape[-1])
            args.mesh_axes = ("pod", "data", "stage", "model")[-len(args.mesh_shape):]
        size = 1
        for d in args.mesh_shape:
            size *= d
        if args.device_mesh and args.procs != size:
            ap.error(f"--procs {args.procs} must equal the mesh's size {size}")
        return args
    if args.stages > 1:
        ap.error("--stages inserts a stage axis into --mesh-shape: give --mesh-shape "
                 "(e.g. --mesh-shape 1,1 --stages 2)")
    if args.workers is None:
        args.workers = 10
    if args.procs < 1 or args.workers % args.procs:
        ap.error(f"--workers {args.workers} must divide by --procs {args.procs}")
    return args


def sasg_config_from_args(args):
    from repro_torch.core.sasg import PRESETS

    kw = {}
    if args.algo in ("sasg", "sparse"):
        kw["k_ratio"] = args.k_ratio
    if args.algo in ("sasg", "lasg"):
        kw["max_delay"] = args.max_delay
    scfg = PRESETS[args.algo](**kw)
    overrides = {}
    if args.compressor:
        overrides["name"] = args.compressor
    if args.topk_impl:
        overrides["topk_impl"] = args.topk_impl
    if args.layout:
        overrides["layout"] = args.layout
    if args.wire_dtype:
        overrides["wire_dtype"] = args.wire_dtype
    if args.k_ratio_per_layer:
        overrides["k_ratio_per_layer"] = args.k_ratio_per_layer
    if overrides:
        scfg = dataclasses.replace(
            scfg, compressor=dataclasses.replace(scfg.compressor, **overrides)
        )
    return scfg


def data_stream(cfg, global_batch: int, seq_len: int = 64):
    """The synthetic classification stream of the paper nets, or the
    bigram token stream of an LM (replayable: batch t is a pure function
    of the seed and t)."""
    from repro_torch.data import (indexed_classification_stream, indexed_token_stream,
                                  synthetic_classification)

    if cfg.family not in ("mlp", "cnn"):
        return indexed_token_stream(cfg.vocab_size, global_batch, seq_len, seed=0)
    img = (28, 28, 1) if cfg.family == "mlp" else (32, 32, 3)
    xs, ys = synthetic_classification(2048, cfg.vocab_size, img, seed=0)
    return indexed_classification_stream(xs, ys, global_batch, seed=0)


def _device_type(args) -> str:
    return "cuda" if str(args.device).startswith("cuda") else str(args.device)


def choose_kwargs(args, model) -> dict:
    """``choose_strategy``'s arguments of the command line: SASG unless
    ``--algo sgd``, the replica budget the device's memory."""
    import torch

    from repro_torch.core.types import tree_leaves

    shapes = model.init(torch.Generator().manual_seed(0), device="meta")
    params_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(shapes))
    return dict(sasg_enabled=args.algo != "sgd", params_bytes=params_bytes,
                pipeline_stages=args.stages, microbatches=args.microbatches,
                trunk_layers=model.pipeline.n_layers if model.pipeline else 0)


def mesh_strategy(args, model, group=None):
    """The mesh of ``--mesh-shape`` (a device mesh over ``group``'s ranks
    with ``--procs``, else stacked) and the strategy ``choose_strategy``
    picks on it."""
    from repro_torch.dist.strategy import choose_strategy
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(args.mesh_shape, args.mesh_axes,
                          group=group if args.device_mesh else None,
                          device_type=_device_type(args))
    return mesh, choose_strategy(mesh, **choose_kwargs(args, model))


def fault_plan(args, num_workers: int):
    """The FaultPlan of ``--resize`` and ``--faults`` (None without them):
    the resizes first, a drop below the starting ``num_workers`` and a join
    otherwise, then the faults, as the JAX launcher orders them (a
    straggler's drawn worker depends on its index in the plan)."""
    from repro_torch.train.faults import FaultPlan

    if not args.resize and not args.faults:
        return None
    plan = FaultPlan()
    for step, target in args.resize:
        plan = (plan.worker_drop(step, to=target) if target < num_workers
                else plan.worker_join(step, to=target))
    for fault in args.faults:
        plan = plan._with(fault)
    return plan


def membership_of(args, model, scfg, mesh, strategy, group=None):
    """The WorkerMembership of the command line. With ``--mesh-shape`` a
    resize keeps the mesh's other axes and retargets its worker axis on a
    stacked mesh, as the JAX launcher does; a device mesh keeps its ranks
    (M a multiple of the worker axis's size). Without it, the 1-D ``data``
    mesh of ``build_train_step``."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import constant
    from repro_torch.train.elastic import WorkerMembership

    mesh_fn = None
    if mesh is not None:
        def mesh_fn(n):
            if args.device_mesh:
                return mesh
            sizes = dict(zip(args.mesh_axes, args.mesh_shape))
            sizes[strategy.worker_axes[0] if strategy.worker_axes else "data"] = n
            return make_test_mesh(tuple(sizes.values()), tuple(sizes),
                                  device_type=_device_type(args))

    return WorkerMembership(model, scfg, constant(args.lr), mesh_fn=mesh_fn,
                            device=args.device, group=group,
                            **(choose_kwargs(args, model) if mesh is not None else {}))


def build_trainer(args, log_fn=print, group=None):
    """The Trainer of parsed arguments; with a ``WorkerGroup``, this
    process's share of the workers (only rank 0 logs)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import Trainer, TrainerConfig, build_train_step

    cfg = get_config(args.arch)
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name} is an encoder-decoder: the launcher's token stream "
                         "has no frames")
    if args.reduced:
        cfg = cfg.reduced()
    if "ssd" in cfg.attn_pattern and args.seq_len % cfg.ssm.chunk_size:
        raise ValueError(f"--seq-len {args.seq_len} is not a multiple of {cfg.name}'s SSD "
                         f"chunk size {cfg.ssm.chunk_size}")
    model = build(cfg, remat=args.remat)
    scfg = sasg_config_from_args(args)
    mesh = strategy = None
    if args.mesh_shape is not None:
        mesh, strategy = mesh_strategy(args, model, group)
    built = build_train_step(model, scfg, args.workers, constant(args.lr),
                             device=args.device, group=group, mesh=mesh, strategy=strategy)
    global_batch = args.global_batch or 10 * built.num_workers
    plan = fault_plan(args, built.num_workers)
    for m in sorted({built.num_workers, *(t for _, t in args.resize)}):
        if global_batch % m:
            raise ValueError(f"--global-batch {global_batch} does not divide over {m} "
                             "workers (a worker count of --resize)")
    if group is None or group.rank == 0:
        procs = "" if group is None else (f" procs={group.world_size} "
                                          f"backend={group.backend}")
        if mesh is not None:
            log_fn(f"[train] arch={cfg.name} algo={args.algo} "
                   f"mesh={dict(zip(args.mesh_axes, args.mesh_shape))} "
                   f"strategy={strategy.name} workers={built.num_workers} "
                   f"stages={strategy.pipeline_stages} tp_compute={built.tp_compute}")
        log_fn(f"[train] arch={cfg.name} algo={args.algo} workers={built.num_workers}{procs} "
               f"global_batch={global_batch} device={built.device}")
        if built.exchange is not None:
            t = built.exchange.transport
            log_fn(f"[train] transport kind={t.kind} layout={t.layout} "
                   f"bits/upload paper={built.bits_paper:.3e} wire={built.bits_wire:.3e}")
    stream = data_stream(cfg, global_batch, args.seq_len)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, log_every=max(args.steps // 20, 1))
    if plan is None:
        return Trainer(built, stream, tcfg, log_fn=log_fn)
    from repro_torch.train.elastic import ElasticTrainer

    return ElasticTrainer(built, stream, tcfg,
                          membership=membership_of(args, model, scfg, mesh, strategy, group),
                          plan=plan, log_fn=log_fn)


def train(argv=None, log_fn=print, group=None):
    """Build and run a training from command-line arguments; returns
    ``(trainer, final_state)``. Without a group this process holds all the
    workers (``--procs`` must be 1; ``train_procs`` spawns the others)."""
    args = parse_args(argv)
    if group is None and (args.procs != 1 or args.device_mesh):
        raise ValueError("--procs: run through train_procs (or main), which "
                         "spawns the processes")
    trainer = build_trainer(args, log_fn, group)
    state = trainer.run(seed=0)
    procs = "" if group is None else f" on {group.world_size} processes"
    trainer.log(f"[train] done: {args.steps} steps{procs}; total rounds "
                f"{float(state.counters.rounds):.0f}; bits(paper) "
                f"{float(state.counters.bits_paper):.3e}")
    return trainer, state


def _rank_main(group, argv):
    """One rank of ``train_procs``: train its share of the workers."""
    train(argv, group=group)


def train_procs(argv=None):
    """Run the training of ``argv`` (the command line's when None) on
    ``--procs`` spawned processes of one worker group (any ``--procs``, 1
    included: a group of one)."""
    from repro_torch.comm import process_group

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    process_group.spawn(_rank_main, args.procs, args.backend, _device_type(args),
                        args=(argv,))


def main(argv=None):
    args = parse_args(argv)
    from repro_torch.comm import process_group

    if process_group.launched_by_torchrun():
        group = process_group.from_env(args.backend, args.device.split(":")[0])
        try:
            if args.procs not in (1, group.world_size):
                raise ValueError(f"--procs {args.procs} differs from torchrun's "
                                 f"world size {group.world_size}")
            train(argv, group=group)
        finally:
            process_group.destroy()
    elif args.procs > 1 or args.device_mesh:
        train_procs(argv)
    else:
        train(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
