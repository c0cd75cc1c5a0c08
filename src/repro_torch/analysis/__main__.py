"""CLI: ``python -m repro_torch.analysis [lint|conformance|all]``.

Exit status is nonzero when any lint violation (a finding no allowlist
marks) or failing conformance cell exists.  The conformance sweep runs
every registry cell on ``--p`` stacked ranks of ``--device`` (the card
unless the caller asks for the CPU).  A report is written only where
``--report`` names a path.
"""
import argparse
import sys


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's invariant linter + schedule conformance")
    ap.add_argument("command", nargs="?", default="lint",
                    choices=("lint", "conformance", "all"))
    ap.add_argument("--root", default=None,
                    help="src directory to lint (default: the one holding "
                         "the repro_torch package)")
    ap.add_argument("--report", default=None,
                    help="write the JSON report to this path (default: "
                         "no report)")
    ap.add_argument("--family", default=None,
                    help="restrict conformance to one registry family")
    ap.add_argument("--comm", default=None, choices=("dense", "sparse"),
                    help="restrict conformance to one wire format")
    ap.add_argument("--device", default=None,
                    help="device of the stacked ranks (default: cuda)")
    ap.add_argument("--p", type=int, default=8,
                    help="stacked ranks for conformance")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    report = {"schema": 1}
    failed = False

    if args.command in ("lint", "all"):
        from repro_torch.analysis import lint
        findings, scanned = lint.run_lint(src_root=args.root)
        print(lint.render_findings(findings))
        report["lint"] = lint.make_lint_report(findings, scanned)
        failed |= bool(lint.violations(findings))

    if args.command in ("conformance", "all"):
        from repro_torch.analysis import conformance
        from repro_torch.core import device as _device
        comms = (args.comm,) if args.comm else ("dense", "sparse")

        def progress(row):
            words = ("" if row["modeled_words"] is None else
                     f" modeled={row['modeled_words']:.0f}"
                     f" measured={row['measured_words']:.0f}")
            print(f"{row['verdict']:4s} {row['cell']:32s} "
                  f"[{row['mode']}] collectives={row['collectives']}"
                  + words)
            for err in row["errors"]:
                print(f"     ! {err}")

        dev = _device.resolve(args.device)
        conf = conformance.run_conformance(
            family=args.family, comms=comms, devices=[dev] * args.p,
            progress=progress)
        report["conformance"] = conf
        print(f"conformance: {conf['pass']} pass, {conf['fail']} fail "
              f"({conf['structural']} structural) on p={conf['p']}")
        failed |= conf["fail"] > 0

    if args.report:
        from repro_torch.analysis.findings import write_report
        write_report(report, args.report)
        print(f"wrote {args.report}")

    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
