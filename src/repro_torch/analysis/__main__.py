"""CLI: ``python -m repro_torch.analysis --report analysis_report.json``.

Exits 0 iff no unwaived findings; the JSON report carries every audited
kernel launch (grid, threads, shared memory, joined with the roofline's
FLOPs and bytes), every trace-audit entry and every finding (waived ones
included, marked)."""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static kernel-geometry, trace and concurrency audit")
    parser.add_argument("--report", default=None, metavar="PATH",
                        help="write the full JSON report here")
    parser.add_argument("--archs", default=None,
                        help="comma-separated arch subset (default: all)")
    args = parser.parse_args(argv)

    from repro_torch.analysis import run_all

    findings, report = run_all(
        archs=args.archs.split(",") if args.archs else None)

    print(f"kernel launches audited: {len(report['kernel_tables'])}")
    for row in report["kernel_tables"]:
        print(f"  {row['kernel']:<16} {row['arch']:<22} "
              f"{row['shape']:<12} grid={tuple(row['grid'])!s:<20} "
              f"threads={row['threads']:>4} smem={row['smem_bytes']:>6} B  "
              f"flops={row['roofline']['flops']:.3g}")
    print(f"trace entries audited: {len(report['trace_entries'])}")
    for row in report["trace_entries"]:
        facts = " ".join(f"{k}={v}" for k, v in row.items()
                         if k not in ("entry", "ok"))
        print(f"  {row['entry']:<44} {facts}  "
              f"{'ok' if row['ok'] else 'FAIL'}")
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"report written to {args.report}")

    waived = [f for f in findings if f.waived]
    unwaived = [f for f in findings if not f.waived]
    for f in waived:
        print(f"WAIVED  {f}")
    for f in unwaived:
        print(f"FAIL    {f}")
    print(f"{len(unwaived)} unwaived finding(s), {len(waived)} waived")
    return 1 if unwaived else 0


if __name__ == "__main__":
    sys.exit(main())
