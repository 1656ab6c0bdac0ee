"""Shared finding/waiver infrastructure for the port's static analyzers
(the port's own copy of the reference's ``analysis/common.py``).

Every analyzer emits ``Finding`` records anchored to a (file, line). A
finding is waived when the anchored line, or the line directly above it,
carries an inline waiver comment naming its rule:

    x = t.cpu()   # analysis: ignore[host-sync]

Waivers are resolved once over the final finding list (``apply_waivers``),
so analyzers stay pure emitters; the CLI exits nonzero only on unwaived
findings.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional

# the repository root: paths in findings are made relative to it
REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))

_WAIVER_RE = re.compile(r"#\s*analysis:\s*ignore\[([A-Za-z0-9_\-, ]+)\]")


@dataclasses.dataclass
class Finding:
    rule: str          # e.g. "kernel-smem", "thread-shared-write"
    file: str          # path (made repo-relative in reports when possible)
    line: int          # 1-indexed anchor line (0 = whole-file/abstract)
    message: str
    waived: bool = False

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        mark = " (waived)" if self.waived else ""
        return f"{self.file}:{self.line}: [{self.rule}]{mark} {self.message}"


def relpath(path: str) -> str:
    try:
        rel = os.path.relpath(os.path.abspath(path), REPO_ROOT)
    except ValueError:            # another drive: keep the path as it is
        return path
    return path if rel.startswith("..") else rel


def waived_rules(source_lines: List[str], line: int) -> set:
    """Rules waived at ``line`` (1-indexed): inline or on the line above."""
    rules: set = set()
    for ln in (line, line - 1):
        if 1 <= ln <= len(source_lines):
            m = _WAIVER_RE.search(source_lines[ln - 1])
            if m:
                rules.update(r.strip() for r in m.group(1).split(",")
                             if r.strip())
    return rules


class _SourceCache:
    def __init__(self):
        self._cache: Dict[str, Optional[List[str]]] = {}

    def lines(self, path: str) -> Optional[List[str]]:
        if path not in self._cache:
            try:
                with open(path, encoding="utf-8") as f:
                    self._cache[path] = f.read().splitlines()
            except OSError:
                self._cache[path] = None
        return self._cache[path]


def apply_waivers(findings: List[Finding]) -> List[Finding]:
    """Mark findings whose anchor line carries a matching inline waiver."""
    cache = _SourceCache()
    for f in findings:
        if not f.file or f.line <= 0:
            continue
        lines = cache.lines(f.file if os.path.isabs(f.file)
                            else os.path.join(REPO_ROOT, f.file))
        if lines is None:
            continue
        if f.rule in waived_rules(lines, f.line):
            f.waived = True
    for f in findings:
        f.file = relpath(f.file)
    return findings
