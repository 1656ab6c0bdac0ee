"""AST concurrency lint over the port's ``core/`` and ``launch/`` (and the
checkpoint writer and the data iterator), after the reference's
``analysis/concurrency_lint.py``.

Three rules, each aimed at a failure that the threaded actor, batcher,
checkpoint and server machinery shows only under load:

  * ``thread-shared-write``: an attribute assigned inside a method
    reachable from a spawned thread's ``target=self.<m>`` callee chain,
    outside any ``with self.<lock>:`` block, while some *other* method of
    the class (outside that chain) reads it: a data race. Writes and
    reads under a ``with self.<x>:`` context count as lock-guarded.
  * ``thread-no-join``: a class stores started ``threading.Thread``s but
    no method ever calls ``.join``: its stop path leaks the thread.
    Functions that *return* the thread they start hand it to the caller.
  * ``host-sync``: a call that makes the host wait for the card (torch's
    ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` and
    ``torch.cuda.synchronize``) inside a hot module: the actor pool, the
    batcher, ``HostLoopSource``, the checkpoint writer, the server and
    the data iterator. Each serializes the pipeline; they belong at the
    declared host boundary (``HOT_ALLOWLIST``) or under an inline
    ``# analysis: ignore[host-sync]`` waiver that says why.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.common import REPO_ROOT, Finding

LINT_DIRS = ("src/repro_torch/core", "src/repro_torch/launch")
LINT_FILES = ("src/repro_torch/checkpoint/writer.py",
              "src/repro_torch/data/synthetic.py")

# the hot modules: path -> the classes whose methods are hot (None: the
# whole module)
HOT_MODULES: Dict[str, Optional[Set[str]]] = {
    "src/repro_torch/core/actor_pool.py": None,
    "src/repro_torch/core/batcher.py": None,
    "src/repro_torch/core/sources.py": {"HostLoopSource"},
    "src/repro_torch/checkpoint/writer.py": None,
    "src/repro_torch/launch/serve.py": None,
    "src/repro_torch/data/synthetic.py": None,
}

# the declared host boundary: qualified name -> why it may wait for the
# card
HOT_ALLOWLIST: Dict[str, str] = {
    "HostLoopSource._policy": "host API: the host actors step their envs "
                              "on the CPU, so each batched policy call's "
                              "logits come back to the host",
}

# methods of a tensor that copy it to the host and wait for the card
HOST_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")


def _attr_chain(node) -> List[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    parts.reverse()
    return parts


def _is_self_attr(node) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _ModuleAliases(ast.NodeVisitor):
    """import graph: local name -> top-level module ('np' -> 'numpy')."""

    def __init__(self):
        self.aliases: Dict[str, str] = {}

    def visit_Import(self, node):
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = \
                a.name.split(".")[0]

    def visit_ImportFrom(self, node):
        if node.module:
            top = node.module.split(".")[0]
            for a in node.names:
                self.aliases[a.asname or a.name] = f"{top}.{a.name}"


def _is_thread_ctor(call: ast.Call, aliases: Dict[str, str]) -> bool:
    chain = _attr_chain(call.func)
    if not chain:
        return False
    if chain[-1] != "Thread":
        return False
    root = aliases.get(chain[0], chain[0])
    return root.startswith("threading") or chain == ["Thread"]


# ---------------------------------------------------------------------------
# per-method facts
# ---------------------------------------------------------------------------

class _MethodFacts(ast.NodeVisitor):
    """Attribute reads/writes (lock-aware), self-calls, thread spawns."""

    def __init__(self, aliases: Dict[str, str]):
        self.aliases = aliases
        self.lock_depth = 0
        self.writes: Dict[str, Tuple[int, bool]] = {}   # attr -> (line, locked)
        self.reads: Dict[str, Tuple[int, bool]] = {}
        self.calls: Set[str] = set()                    # self.<m>() callees
        self.thread_targets: Set[str] = set()           # target=self.<m>
        self.spawned_attrs: Set[str] = set()            # self.<a> = Thread()
        self.spawns_local_returned = False
        self.has_join = False
        self._local_threads: Set[str] = set()
        self._returned: Set[str] = set()

    def visit_With(self, node):
        guards = any(_is_self_attr(i.context_expr) is not None
                     or (isinstance(i.context_expr, ast.Call)
                         and _is_self_attr(i.context_expr.func))
                     for i in node.items)
        if guards:
            self.lock_depth += 1
        self.generic_visit(node)
        if guards:
            self.lock_depth -= 1

    def _record_write(self, attr: str, line: int):
        prev = self.writes.get(attr)
        locked = self.lock_depth > 0
        if prev is None or (prev[1] and not locked):
            self.writes[attr] = (line, locked)

    def visit_Attribute(self, node):
        attr = _is_self_attr(node)
        if attr is not None:
            if isinstance(node.ctx, ast.Store):
                self._record_write(attr, node.lineno)
            elif isinstance(node.ctx, ast.Load):
                prev = self.reads.get(attr)
                locked = self.lock_depth > 0
                if prev is None or (prev[1] and not locked):
                    self.reads[attr] = (node.lineno, locked)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        attr = _is_self_attr(node.target)
        if attr is not None:
            self._record_write(attr, node.lineno)
            # an unlocked augmented assign is also an unlocked read
            prev = self.reads.get(attr)
            locked = self.lock_depth > 0
            if prev is None or (prev[1] and not locked):
                self.reads[attr] = (node.lineno, locked)
        self.generic_visit(node)

    def visit_Call(self, node):
        chain = _attr_chain(node.func)
        if len(chain) >= 2 and chain[0] == "self":
            self.calls.add(chain[1])
        if chain and chain[-1] == "join":
            # str.join takes exactly one positional iterable; thread join
            # takes none (or a timeout kwarg)
            if len(node.args) == 0:
                self.has_join = True
        if isinstance(node.func, (ast.Attribute, ast.Name)) \
                and _is_thread_ctor(node, self.aliases):
            for kw in node.keywords:
                if kw.arg == "target":
                    t = _is_self_attr(kw.value)
                    if t:
                        self.thread_targets.add(t)
        self.generic_visit(node)

    def visit_Assign(self, node):
        if isinstance(node.value, ast.Call) \
                and _is_thread_ctor(node.value, self.aliases):
            for tgt in node.targets:
                a = _is_self_attr(tgt)
                if a is not None:
                    self.spawned_attrs.add(a)
                elif isinstance(tgt, ast.Name):
                    self._local_threads.add(tgt.id)
        self.generic_visit(node)

    def visit_Return(self, node):
        if isinstance(node.value, ast.Name):
            self._returned.add(node.value.id)
        self.generic_visit(node)

    def finish(self):
        kept = self._local_threads - self._returned
        self.spawns_local_returned = bool(
            self._local_threads & self._returned)
        # local threads neither stored on self nor returned: treated as
        # fire-and-forget on the method — covered by thread-no-join only
        # if the class never joins anything
        self.spawned_attrs |= {f"<local:{n}>" for n in kept}


def _class_findings(path: str, cls: ast.ClassDef,
                    aliases: Dict[str, str]) -> List[Finding]:
    findings: List[Finding] = []
    methods: Dict[str, _MethodFacts] = {}
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            facts = _MethodFacts(aliases)
            facts.visit(item)
            facts.finish()
            methods[item.name] = facts

    # transitive closure of methods reachable from any thread target
    roots = {t for f in methods.values() for t in f.thread_targets
             if t in methods}
    threaded: Set[str] = set()
    frontier = list(roots)
    while frontier:
        m = frontier.pop()
        if m in threaded:
            continue
        threaded.add(m)
        frontier.extend(c for c in methods[m].calls
                        if c in methods and c not in threaded)

    # rule: thread-shared-write
    for m in sorted(threaded):
        for attr, (line, locked) in methods[m].writes.items():
            if locked:
                continue
            for other, facts in methods.items():
                if other in threaded or other == "__init__":
                    continue
                read = facts.reads.get(attr)
                if read is not None and not read[1]:
                    findings.append(Finding(
                        rule="thread-shared-write", file=path, line=line,
                        message=(
                            f"{cls.name}.{m} writes self.{attr} on the "
                            f"spawned-thread path without a lock, while "
                            f"{cls.name}.{other} reads it (line "
                            f"{read[0]}) from outside that thread — "
                            "torn/stale reads under load")))
                    break

    # rule: thread-no-join
    spawns = {m: f.spawned_attrs for m, f in methods.items()
              if f.spawned_attrs}
    if spawns and not any(f.has_join for f in methods.values()):
        m, attrs = next(iter(sorted(spawns.items())))
        line = cls.lineno
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and item.name == m:
                line = item.lineno
        findings.append(Finding(
            rule="thread-no-join", file=path, line=line,
            message=(
                f"{cls.name}.{m} stores started thread(s) "
                f"({', '.join(sorted(attrs))}) but no method of "
                f"{cls.name} ever joins a thread — the stop path leaks "
                "a live thread running against freed state")))
    return findings


# ---------------------------------------------------------------------------
# host-sync rule
# ---------------------------------------------------------------------------

class _HostSyncVisitor(ast.NodeVisitor):
    def __init__(self, path: str, aliases: Dict[str, str],
                 classes: Optional[Set[str]]):
        self.path = path
        self.aliases = aliases
        self.classes = classes
        self.scope: List[str] = []
        self.findings: List[Finding] = []

    def _qualname(self) -> str:
        return ".".join(self.scope)

    def _enter(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_ClassDef = _enter
    visit_FunctionDef = _enter
    visit_AsyncFunctionDef = _enter

    def _hot(self) -> bool:
        return self.classes is None or bool(
            self.scope and self.scope[0] in self.classes)

    def _flag(self, node, what: str):
        qual = self._qualname()
        if qual in HOT_ALLOWLIST or not self._hot():
            return
        self.findings.append(Finding(
            rule="host-sync", file=self.path, line=node.lineno,
            message=(
                f"{what} in hot-path module "
                f"{os.path.basename(self.path)}"
                + (f" ({qual})" if qual else "")
                + " makes the host wait for the card; move it to the host "
                "boundary or waive it with the reason")))

    def visit_Call(self, node):
        chain = _attr_chain(node.func)
        if chain[-2:] == ["cuda", "synchronize"] and \
                self.aliases.get(chain[0], chain[0]).split(".")[0] == "torch":
            self._flag(node, "torch.cuda.synchronize host sync")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in HOST_SYNC_METHODS \
                and not node.args and not node.keywords:
            self._flag(node, f".{node.func.attr}() host sync")
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def lint_file(path: str, *, hot=None) -> List[Finding]:
    """The findings of one file. ``hot``: True (the whole module is hot),
    a set of hot class names, False, or None (``HOT_MODULES`` decides)."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="parse-error", file=path,
                        line=e.lineno or 0, message=str(e.msg))]
    imports = _ModuleAliases()
    imports.visit(tree)
    aliases = imports.aliases

    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_class_findings(path, node, aliases))

    rel = os.path.relpath(os.path.abspath(path), REPO_ROOT).replace(
        os.sep, "/")
    if hot is None:
        hot = HOT_MODULES[rel] if rel in HOT_MODULES else False
        hot = True if hot is None else hot
    if hot is not False:
        hs = _HostSyncVisitor(path, aliases, None if hot is True else hot)
        hs.visit(tree)
        findings.extend(hs.findings)
    return findings


def lint_tree(root: str = REPO_ROOT) -> List[Finding]:
    findings: List[Finding] = []
    paths = []
    for d in LINT_DIRS:
        full = os.path.join(root, d)
        if os.path.isdir(full):
            paths += [os.path.join(full, n) for n in sorted(os.listdir(full))
                      if n.endswith(".py")]
    paths += [os.path.join(root, f) for f in LINT_FILES
              if os.path.isfile(os.path.join(root, f))]
    for path in paths:
        findings.extend(lint_file(path))
    return findings
