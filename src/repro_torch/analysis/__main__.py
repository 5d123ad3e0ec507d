"""CLI driver: ``PYTHONPATH=src python -m repro_torch.analysis --all``.

Families are opt-in flags (``--lint`` / ``--contracts`` / ``--jaxpr``);
``--all`` (or no flag) runs the three. Exit code 1 iff any error-severity
finding survives; a family that cannot run raises, so the CLI never exits
0 over a family that did not run. ``--json PATH`` also writes the
aggregated machine-readable report.

The traced families run on fake CUDA tensors (``--device cpu`` for fake
CPU ones). A build of PyTorch without CUDA traces them through the dry
run's preloaded shim: the CLI then re-runs itself under
``launch.dryrun.tracer_env()``, as ``python -m repro_torch.launch.dryrun``
does.
"""

import argparse
import os
import subprocess
import sys

from repro_torch.analysis.findings import print_findings, to_json


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis of the port: AST lints, registry contract checks on "
                    "fake tensors, round-fn audits and the collective gate")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files/dirs to lint (default: the port's files, "
                         "lints.default_paths())")
    ap.add_argument("--lint", action="store_true", help="run the AST lints")
    ap.add_argument("--contracts", action="store_true",
                    help="run every preset and stage through the seams on fake tensors")
    ap.add_argument("--jaxpr", action="store_true",
                    help="audit the pinned configs' round fns + collective counts vs the "
                         "committed baseline")
    ap.add_argument("--all", action="store_true", help="all three families")
    ap.add_argument("--rule", action="append", default=None,
                    help="restrict lints to these rule ids (repeatable)")
    ap.add_argument("--baseline", default=None,
                    help="collective baseline path (default: "
                         "src/repro_torch/analysis/collectives_baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the collective baseline instead of checking it")
    ap.add_argument("--device", default="cuda",
                    help="the device of the traced families' fake tensors")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the machine-readable report here")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the lint-rule catalog and exit")
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)

    if args.list_rules:
        from repro_torch.analysis import lints
        for r in lints.RULES.values():
            print(f"{r.id}  {r.name}\n    catches: {r.doc}\n    history: {r.history}")
        return 0

    if not (args.lint or args.contracts or args.jaxpr or args.all):
        args.all = True
    traced = args.contracts or args.jaxpr or args.all or args.write_baseline
    if traced and args.device.startswith("cuda"):
        from repro_torch.launch import dryrun

        if not dryrun.can_trace():
            if os.environ.get(dryrun._SHIM_MARK):
                raise RuntimeError("the fake CUDA shim is preloaded but PyTorch reports no "
                                   "CUDA accelerator")
            env = dict(os.environ, **dryrun.tracer_env())
            return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *argv],
                                  env=env, check=False).returncode

    findings = []
    extra = {}

    if args.lint or args.all:
        from repro_torch.analysis import lints
        paths = args.paths or lints.default_paths()
        paths = [p for p in paths if os.path.exists(p)]
        rule_ids = tuple(args.rule) if args.rule else None
        findings += lints.lint_paths(paths, rule_ids=rule_ids)

    if args.contracts or args.all:
        from repro_torch.analysis import contracts
        findings += contracts.check_all(device=args.device)

    if args.jaxpr or args.all or args.write_baseline:
        from repro_torch.analysis import jaxpr_audit
        baseline = args.baseline or jaxpr_audit.DEFAULT_BASELINE
        audit_findings, reports = jaxpr_audit.audit_all(device=args.device)
        findings += audit_findings
        extra["collectives"] = reports
        if args.write_baseline:
            jaxpr_audit.write_baseline(reports, baseline)
            print(f"wrote {baseline}")
        else:
            findings += jaxpr_audit.check_baseline(reports, baseline)

    print_findings(findings)
    if args.json:
        with open(args.json, "w") as f:
            f.write(to_json(findings, extra=extra))
    errors = [f for f in findings if f.severity == "error"]
    print(f"{len(findings)} finding(s), {len(errors)} error(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
