"""CLI for the repro_torch.analysis passes.

Gate mode (exit non-zero on any non-baselined lint finding, a stale
baseline entry, any exchange wire drift > 1%, any unaccounted d-sized
collective, any activation ring or stage gather diverging from
``PipelineCommModel`` on a 1F1B cell, stage gradient traffic above two
compressed uploads, or a bench record of the port that breaks its
baseline bounds):

  PYTHONPATH=src python -m repro_torch.analysis --check            # on the card
  PYTHONPATH=src python -m repro_torch.analysis --check --device cpu

Other modes:

  --lint-only / --audit-only     run just one pass
  --write-baseline               refresh analysis/baseline.json from the
                                 current sweep (new entries get a TODO
                                 reason to replace before commit)
  --report PATH                  where to write the audit report (default
                                 artifacts/bench_torch/comm_audit.json)
  --lint-report PATH             dump the lint findings as JSON (sorted and
                                 stable: two runs are byte-equal)
  --device DEVICE                where the audit's steps and the registry
                                 rule's tensors run (default cuda)

The bench gates read the port's bench records in ``--bench-dir``
(``artifacts/bench_torch``: ``pipeline.json``, ``serve.json``,
``elastic.json``, from ``python -m repro_torch.benchmarks.run``) where
they exist, against the bounds in ``analysis/baseline.json``.
"""
import argparse
import json
import os
import sys

BENCH_DIR = os.path.join("artifacts", "bench_torch")


def _load(path):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def bench_problems(baseline, bench_dir: str = BENCH_DIR) -> tuple:
    """(problems, notes) of the port's bench records against the baseline's
    bounds; a record that is not there is not checked."""
    problems, notes = [], []
    ceiling = baseline.pipeline_bench.get("max_ring_bits_per_step")
    path = os.path.join(bench_dir, "pipeline.json")
    if ceiling is not None and os.path.exists(path):
        ring = _load(path).get("pipelined", {}).get("pipe_ring_bits_per_step")
        if ring is None:
            problems.append(f"{path} has no pipelined.pipe_ring_bits_per_step: regenerate "
                            "it with python -m repro_torch.benchmarks.run --stages 2")
        elif ring > ceiling:
            problems.append(f"pipeline bench ring {ring:.0f} bits/step exceeds the "
                            f"compressed baseline ceiling {ceiling:.0f} (analysis/"
                            "baseline.json pipeline_bench.max_ring_bits_per_step)")
        else:
            notes.append(f"pipeline ring {ring:.0f} bits/step <= ceiling {ceiling:.0f}")

    sb = baseline.serve_bench
    path = os.path.join(bench_dir, "serve.json")
    if sb and os.path.exists(path):
        ratio = float(sb.get("max_paged_over_dense_bytes_ratio", 1.0))
        paged = [c for c in _load(path).get("cells", []) if c.get("paged")]
        if sb.get("require_paged_cells") and not paged:
            problems.append(f"{path} has no paged cells: regenerate it with python -m "
                            "repro_torch.benchmarks.run --serve")
        bad = len(problems)
        for c in paged:
            cell = f"{c.get('arch')}@conc{c.get('concurrency')}"
            if sb.get("require_bitexact") and not c.get("bitexact_vs_dense"):
                problems.append(f"serve bench {cell}: paged tokens diverge from the dense "
                                f"engine on the identity cache dtype ({c.get('cache_dtype')})")
            hw, de = c.get("high_water_bytes"), c.get("dense_equiv_bytes")
            if hw is not None and de and hw > de * ratio:
                problems.append(f"serve bench {cell}: paged high-water {hw:.0f} B exceeds "
                                f"{ratio:.2f}x the dense-equivalent {de:.0f} B")
        if paged and len(problems) == bad:
            notes.append(f"serve: {len(paged)} paged cell(s) bit-exact, high-water <= "
                         f"{ratio:.2f}x dense")

    eb = baseline.elastic_bench
    path = os.path.join(bench_dir, "elastic.json")
    if eb and os.path.exists(path):
        cells = _load(path).get("cells", [])
        if eb.get("require_cells") and not cells:
            problems.append(f"{path} has no cells: regenerate it with python -m "
                            "repro_torch.benchmarks.run --elastic")
        max_lost = eb.get("max_steps_lost")
        bad = len(problems)
        for c in cells:
            cell = c.get("plan", "?")
            if not c.get("completed"):
                problems.append(f"elastic bench {cell}: run did not reach its total steps "
                                f"(restarts={c.get('restarts')})")
            if max_lost is not None and c.get("steps_lost", 0) > max_lost:
                problems.append(f"elastic bench {cell}: {c.get('steps_lost')} steps lost to "
                                f"replay exceeds the ceiling {max_lost} (analysis/"
                                "baseline.json elastic_bench.max_steps_lost)")
            if (eb.get("require_bitexact") and c.get("expect_bitexact")
                    and not c.get("bitexact_vs_clean")):
                problems.append(f"elastic bench {cell}: recovery promised bit-identity but "
                                f"final params diverge by {c.get('max_param_diff_vs_clean')}")
            if eb.get("require_replay_exact") and not c.get("replay_exact"):
                problems.append(f"elastic bench {cell}: batch replay skipped or duplicated "
                                "data (replay_exact=false)")
        if cells and len(problems) == bad:
            notes.append(f"elastic: {len(cells)} chaos cell(s) recovered, steps_lost <= "
                         f"{max_lost}, promised bit-identity held")
    return problems, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--check", action="store_true",
                    help="gate mode: non-zero exit on findings/drift")
    ap.add_argument("--lint-only", action="store_true")
    ap.add_argument("--audit-only", action="store_true")
    ap.add_argument("--write-baseline", action="store_true")
    ap.add_argument("--report", default=os.path.join(BENCH_DIR, "comm_audit.json"))
    ap.add_argument("--lint-report", default=None)
    ap.add_argument("--root", default=None,
                    help="package directory to lint (default: this repro_torch)")
    ap.add_argument("--tol", type=float, default=None,
                    help="exchange drift tolerance (default 0.01)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bench-dir", default=BENCH_DIR)
    args = ap.parse_args(argv)

    from repro_torch.analysis.findings import load_baseline, split_by_baseline, write_baseline
    from repro_torch.analysis.lint import report_rows, run_lint

    failed = False
    findings = []
    if not args.audit_only:
        findings = run_lint(root=args.root, device=args.device)
        baseline = load_baseline()
        new, accepted = split_by_baseline(findings, baseline)
        stale = baseline.stale(findings)
        print(f"[lint] {len(findings)} finding(s): {len(new)} new, "
              f"{len(accepted)} baselined, {len(stale)} stale baseline "
              f"entr{'y' if len(stale) == 1 else 'ies'}")
        for f in new:
            print(f"  NEW  {f}")
        for fp in stale:
            ent = baseline.entries[fp]
            print(f"  STALE baseline entry {fp} ({ent.get('rule')} "
                  f"{ent.get('path')}) no longer fires: prune it")
        if args.lint_report:
            with open(args.lint_report, "w", encoding="utf-8") as fh:
                fh.write(json.dumps({"findings": report_rows(findings)}, indent=1,
                                    sort_keys=True) + "\n")
        if new or stale:
            failed = True

    audit_report = None
    if not args.lint_only:
        from repro_torch.analysis import comm_audit

        tol = args.tol if args.tol is not None else comm_audit.DEFAULT_TOL
        audit_report = comm_audit.run_audit(tol=tol, device=args.device)
        problems = comm_audit.check_report(audit_report)
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump(audit_report, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"[audit] {len(audit_report['cells'])} cell(s) on {args.device} -> "
              f"{args.report}")
        for name, rec in sorted(audit_report["cells"].items()):
            line = (f"  {name}: exchange {rec['logged_exchange_wire_bytes']:.0f} B vs "
                    f"counters {rec['expected_exchange_wire_bytes']:.0f} B (drift "
                    f"{100 * rec['drift']:.3f}%), {len(rec['dsized_collectives'])} d-sized "
                    f"op(s) {'allowed' if rec['allow_dsized'] else 'forbidden'}")
            if "ring_wire_bytes" in rec:
                line += (f"; ring {rec['ring_wire_bytes']:.0f} B vs model "
                         f"{rec.get('ring_model_wire_bytes', float('nan')):.0f} B, stage gradient "
                         f"{rec['stage_grad_wire_bytes']:.0f} B (gather "
                         f"{rec['stage_gather_wire_bytes']:.0f} B vs "
                         f"{rec['stage_gather_model_wire_bytes']:.0f} B)")
            print(line)
        bench_fail, notes = bench_problems(load_baseline(), args.bench_dir)
        for n in notes:
            print(f"[bench] {n}")
        for p in problems + bench_fail:
            print(f"  FAIL {p}")
        if problems or bench_fail:
            failed = True

    if args.write_baseline:
        audit_summary = None
        if audit_report is not None:
            audit_summary = {
                name: {"drift": rec["drift"], "dsized_collectives": rec["dsized_collectives"]}
                for name, rec in sorted(audit_report["cells"].items())
            }
        path = write_baseline(findings, audit=audit_summary)
        print(f"[baseline] wrote {len(findings)} entr"
              f"{'y' if len(findings) == 1 else 'ies'} -> {path}")
        return 0

    if args.check and failed:
        print("analysis: FAILED (see findings above)")
        return 1
    print("analysis: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
