#!/usr/bin/env python3
"""Replay pytest-xdist's ``--dist load`` schedule from measured durations.

    PYTHONPATH=src python -m pytest --collect-only -q > collect.txt
    python3 tools/xdist_schedule.py --junit run.xml --collect collect.txt \
        [--workers 6] [--set 'tests/test_x.py::test_y=240' ...]

``run.xml`` is the ``--junitxml`` of an earlier run (each item's time);
``collect.txt`` the collection, in order, of the tree to schedule. Items
the junit file lacks take ``--default-s`` (or a ``--set`` time). The
replay follows ``xdist/scheduler/load.py``: every worker first gets a
chunk of ``(N // workers) // 4`` consecutive items; a worker whose queue
falls below ``max(2, pending // workers // 4)`` items is topped up to
``max(2, pending // workers // 2)``, unless its last item took 0.1 s or
more and two items are still queued. Prints the makespan, each worker's
busy seconds, and the heavy items of each first chunk. It ignores
workers that crash and restart, and the run's start-up.
"""
import argparse
import heapq
import xml.etree.ElementTree as ET


def durations(junit_path: str) -> dict:
    out = {}
    for case in ET.parse(junit_path).iter("testcase"):
        path = case.get("classname").replace(".", "/") + ".py"
        out[f"{path}::{case.get('name')}"] = float(case.get("time"))
    return out


def simulate(times: list, workers: int) -> tuple:
    """(makespan, busy seconds per worker, first chunks) of one replay."""
    pending = list(range(len(times)))
    queues = {w: [] for w in range(workers)}

    def send(w, k):
        for _ in range(min(k, len(pending))):
            queues[w].append(pending.pop(0))

    chunk = max((len(times) // workers) // 4, 2)
    for w in range(workers):
        send(w, chunk)
    first = {w: list(q) for w, q in queues.items()}
    busy = {w: 0.0 for w in range(workers)}
    events, end = [], 0.0
    for w in range(workers):
        if queues[w]:
            heapq.heappush(events, (times[queues[w][0]], w))
    while events:
        t, w = heapq.heappop(events)
        i = queues[w].pop(0)
        busy[w] += times[i]
        end = max(end, t)
        if pending:
            lo = max(2, len(pending) // workers // 4)
            hi = max(2, len(pending) // workers // 2)
            if len(queues[w]) < lo and not (times[i] >= 0.1 and len(queues[w]) >= 2):
                send(w, hi - len(queues[w]))
        if queues[w]:
            heapq.heappush(events, (t + times[queues[w][0]], w))
    return end, busy, first


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--junit", required=True)
    ap.add_argument("--collect", required=True)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--default-s", type=float, default=0.5)
    ap.add_argument("--set", action="append", default=[],
                    help="ITEM=SECONDS for an item the junit file lacks")
    ap.add_argument("--heavy-s", type=float, default=60.0)
    args = ap.parse_args(argv)
    known = durations(args.junit)
    for spec in args.set:
        item, _, secs = spec.rpartition("=")
        known[item] = float(secs)
    with open(args.collect) as f:
        items = [line.strip() for line in f if "::" in line]
    times = [known.get(i, args.default_s) for i in items]
    end, busy, first = simulate(times, args.workers)
    print(f"{len(items)} items, first chunk {len(first[0])}, makespan {end:.1f} s "
          f"(busy {sum(busy.values()):.1f} s over {args.workers} workers)")
    for w in range(args.workers):
        heavy = [f"{items[i]} {times[i]:.0f} s" for i in first[w] if times[i] >= args.heavy_s]
        print(f"  worker {w}: busy {busy[w]:.1f} s; first chunk items "
              f"{first[w][0]}-{first[w][-1]}" + (f", heavy: {'; '.join(heavy)}" if heavy else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
