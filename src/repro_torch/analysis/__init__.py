"""Static kernel and concurrency audit of the port
(``python -m repro_torch.analysis``), after the reference's
``analysis/``.

Gates the contracts the CPU tests cannot execute: the CUDA kernels'
launch geometry against an H100's limits (``kernel_audit``: grid, threads
and shared memory a block, and what each ``.cu`` was compiled for, over
every arch and input shape), and thread safety and host syncs in the
threaded and hot-path modules (``concurrency_lint``). Both run by
arithmetic or AST inspection: no card, no kernel build. Unwaived findings
fail the CLI nonzero; waive with an inline ``# analysis: ignore[rule]``
on the flagged line. The reference's third analyzer, ``trace_audit``,
audits retraces of ``jax.jit`` entries; the port traces nothing yet, so
it has no counterpart.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.analysis.common import Finding, apply_waivers
from repro_torch.analysis.concurrency_lint import lint_tree
from repro_torch.analysis.kernel_audit import audit_kernels

__all__ = ["Finding", "apply_waivers", "audit_kernels", "lint_tree",
           "run_all"]


def run_all(*, archs=None) -> Tuple[List[Finding], Dict]:
    """Run every analyzer; returns (waiver-resolved findings, report)."""
    kernel_findings, kernel_tables = audit_kernels(archs)
    lint_findings = lint_tree()
    findings = apply_waivers(kernel_findings + lint_findings)
    unwaived = [f for f in findings if not f.waived]
    report = {
        "kernel_tables": kernel_tables,
        "findings": [f.to_dict() for f in findings],
        "num_findings": len(findings),
        "num_unwaived": len(unwaived),
    }
    return findings, report
