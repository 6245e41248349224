"""Where a training step's time goes on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile --arch cnn_cifar \
      --algo sasg --workers 10 --lr 0.02

Takes the training flags of ``launch/train.py`` (``--steps`` is the number
of profiled steps, after 3 unprofiled ones; ``--reduced`` and ``--seq-len``
as there, e.g. ``--arch mamba2_370m --workers 4 --global-batch 4
--seq-len 512``). Runs the steps under
``torch.profiler`` and prints the wall time per step (host clock around
``torch.cuda.synchronize()``), the device's busy and idle shares of it
(the sum of kernel and copy times on the card over the wall time; one
stream, so kernels do not overlap), and the device ops that take the
most time.
"""
import sys
import time

WARMUP = 3


def main(argv=None):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import build_train_step

    args = launch.parse_args(argv)
    if args.mesh_shape is not None:
        raise ValueError("profile times the stacked step without a mesh: drop --mesh-shape")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    built = build_train_step(build(cfg, remat=args.remat),
                             launch.sasg_config_from_args(args), args.workers,
                             constant(args.lr), device=args.device)
    if built.device.type != "cuda":
        raise RuntimeError("profile measures the card: run it with --device cuda")
    stream = launch.data_stream(cfg, args.global_batch or 10 * args.workers, args.seq_len)
    state = built.init(seed=0)
    for step in range(WARMUP):
        state, _ = built.step(state, stream.batch_at(step))
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for step in range(WARMUP, WARMUP + args.steps):
            state, _ = built.step(state, stream.batch_at(step))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    n = args.steps
    print(f"[profile] {cfg.name} {args.algo} workers={args.workers} on "
          f"{torch.cuda.get_device_name(0)}: {n} steps, wall {wall_us / n / 1e3:.2f} ms/step, "
          f"device busy {busy_us / n / 1e3:.2f} ms/step "
          f"({100 * busy_us / wall_us:.1f}%), idle {100 * (1 - busy_us / wall_us):.1f}%, "
          f"{sum(e.count for e in device) / n:.0f} device ops/step, peak memory "
          f"{torch.cuda.max_memory_allocated()} bytes")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[profile]   {e.self_device_time_total / n / 1e3:8.3f} ms/step "
              f"{e.count / n:6.1f}x  {e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
