"""Static kernel, trace and concurrency audit of the port
(``python -m repro_torch.analysis``), after the reference's
``analysis/``.

Gates the contracts the CPU tests cannot execute: the CUDA kernels'
launch geometry against an H100's limits (``kernel_audit``: grid, threads
and shared memory a block, and what each ``.cu`` was compiled for, over
every arch and input shape); the compiled and in-place entries
(``trace_audit``: the compiled session's cache keyed by the config's
value, one graph key per shape, the donated state updated in place, and
every partition spec naming live mesh axes); and thread safety and host
syncs in the threaded and hot-path modules (``concurrency_lint``). All
run on the CPU by arithmetic, reduced-width calls or AST inspection: no
card, no kernel build. Unwaived findings fail the CLI nonzero; waive with
an inline ``# analysis: ignore[rule]`` on the flagged line.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.analysis.common import Finding, apply_waivers
from repro_torch.analysis.concurrency_lint import lint_tree
from repro_torch.analysis.kernel_audit import audit_kernels
from repro_torch.analysis.trace_audit import audit_traces

__all__ = ["Finding", "apply_waivers", "audit_kernels", "audit_traces",
           "lint_tree", "run_all"]


def run_all(*, archs=None) -> Tuple[List[Finding], Dict]:
    """Run every analyzer; returns (waiver-resolved findings, report)."""
    kernel_findings, kernel_tables = audit_kernels(archs)
    trace_findings, trace_entries = audit_traces(archs)
    lint_findings = lint_tree()
    findings = apply_waivers(kernel_findings + trace_findings
                             + lint_findings)
    unwaived = [f for f in findings if not f.waived]
    report = {
        "kernel_tables": kernel_tables,
        "trace_entries": trace_entries,
        "findings": [f.to_dict() for f in findings],
        "num_findings": len(findings),
        "num_unwaived": len(unwaived),
    }
    return findings, report
