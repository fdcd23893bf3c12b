"""Resource-lifetime checker for the repo's refcounted resources.

Three resources are manually refcounted and leak silently when an exit
path skips their release: ``BlockAllocator`` block tables (today only
caught by ``check_leaks`` teardown tripwires, i.e. at runtime, after
the fact), ``AdapterPool`` bindings, and the pending/idempotency-cache
entries handlers install while a request is in flight. This pass does
intraprocedural lifetime tracking:

RES101  a local bound from ``<allocator>.alloc/fork/fork_n(...)``
        reaches a ``raise``/``return``/function end without being
        released, returned, stored, or handed to another call
RES102  same for ``<pool>.retain(...)`` bindings
RES103  a ``self.<cache/pending/inflight>[k] = ...`` entry is
        installed by a class that has NO completion path for that
        attribute (no ``del``/``.pop``/``.popitem``/``.clear``
        anywhere in the class) — entries that can only accumulate

The tracker is deliberately forgiving: ANY later mention of the bound
name (call argument, return value, attribute/subscript store, alias)
counts as consumption — ownership went somewhere visible. What it
flags is the case nothing can excuse: a table bound and then never
mentioned again on some exit path.

Escape hatch, explicit at the site: ``# ownership: transferred-to
<symbol>`` on the binding (or installing) line declares the resource
is owned elsewhere — mirroring lock_lint's ``# guarded-by:``.

Pure AST + tokenize; nothing is imported.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, List, Optional, Set, Tuple

from .findings import Finding
from .jit_lint import _iter_py_files

RULES: Dict[str, str] = {
    "RES101": "allocated KV block table can leak on an exit path",
    "RES102": "adapter-pool binding retained without release/transfer",
    "RES103": "cache/pending entry installed without a completion path",
}

_OWNERSHIP_RE = re.compile(r"#\s*ownership:\s*transferred-to\s+(\S+)")
_PRODUCERS = (
    ("RES101", frozenset({"alloc", "fork", "fork_n"}), "alloc"),
    ("RES102", frozenset({"retain"}), "pool"),
)
_CACHE_ATTR_RE = re.compile(r"cache|pending|inflight", re.IGNORECASE)
_COMPLETION_METHODS = {"pop", "popitem", "clear"}


def _comment_lines(source: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except tokenize.TokenError:      # pragma: no cover - parse catches it
        pass
    return out


def _recv_hint(node: ast.AST, cls_name: str) -> str:
    """Lower-cased name of a call's receiver, for producer matching;
    ``self`` stands in for the enclosing class (``self.alloc(...)``
    inside BlockAllocator is still an allocation)."""
    if isinstance(node, ast.Name):
        return cls_name.lower() if node.id == "self" else node.id.lower()
    if isinstance(node, ast.Attribute):
        return node.attr.lower()
    return ""


def _producer_rule(call: ast.Call, cls_name: str) -> Optional[str]:
    if not isinstance(call.func, ast.Attribute):
        return None
    for rule, attrs, hint in _PRODUCERS:
        if call.func.attr in attrs \
                and hint in _recv_hint(call.func.value, cls_name):
            return rule
    return None


def _find_producer(expr: ast.AST, cls_name: str) -> Optional[str]:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            rule = _producer_rule(node, cls_name)
            if rule is not None:
                return rule
    return None


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _call_names(node: ast.AST) -> Set[str]:
    """Names that flow into a call somewhere in ``node`` — a bare read
    in a comparison (``if binding is None:``) transfers nothing."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            out |= _names_in(n)
    return out


class _Live:
    """name -> (rule, binding line) for unconsumed resources."""

    def __init__(self) -> None:
        self.bound: Dict[str, Tuple[str, int]] = {}

    def copy(self) -> "_Live":
        out = _Live()
        out.bound = dict(self.bound)
        return out

    def consume(self, names: Set[str]) -> None:
        for name in names:
            self.bound.pop(name, None)

    def merge_branches(self, *branches: "_Live") -> None:
        """A name consumed on ANY branch is consumed (optimistic —
        partial-path leaks are the dynamic tripwires' jurisdiction)."""
        self.bound = {k: v for k, v in self.bound.items()
                      if all(k in b.bound for b in branches)}


class _FunctionScan:
    def __init__(self, *, path: str, qual: str, cls_name: str,
                 comments: Dict[int, str], findings: List[Finding]):
        self.path = path
        self.qual = qual
        self.cls_name = cls_name
        self.comments = comments
        self.findings = findings

    def _transferred(self, stmt: ast.stmt) -> bool:
        end = getattr(stmt, "end_lineno", stmt.lineno)
        return any(_OWNERSHIP_RE.search(self.comments.get(line, ""))
                   for line in range(stmt.lineno, end + 1))

    def _report(self, live: _Live, node: ast.AST, how: str) -> None:
        for name, (rule, bind_line) in sorted(live.bound.items()):
            what = ("block table" if rule == "RES101"
                    else "adapter binding")
            self.findings.append(Finding(
                rule=rule, path=self.path,
                line=getattr(node, "lineno", 0), symbol=self.qual,
                message=f"{what} `{name}` (bound at line {bind_line}) "
                        f"is still owned here at {how} — it leaks on "
                        "this exit path",
                hint="release it (or hand it off) on every exit path — "
                     "try/finally, or declare `# ownership: "
                     "transferred-to <symbol>` on the binding line"))
        live.bound.clear()

    def run(self, fn: ast.AST) -> None:
        live = _Live()
        self._block(fn.body, live)
        if live.bound:
            end = ast.Pass()
            end.lineno = getattr(fn, "end_lineno", fn.lineno)
            self._report(live, end, "function end")

    # -- statement walk ---------------------------------------------------
    def _block(self, stmts: List[ast.stmt], live: _Live) -> None:
        for stmt in stmts:
            self._stmt(stmt, live)

    def _bind_or_consume(self, stmt: ast.stmt, targets: List[ast.AST],
                         value: Optional[ast.AST], live: _Live) -> None:
        if value is not None:
            live.consume(_names_in(value))
            rule = _find_producer(value, self.cls_name)
            if rule is not None and not self._transferred(stmt):
                if len(targets) == 1 and isinstance(targets[0], ast.Name):
                    live.bound[targets[0].id] = (rule, stmt.lineno)
                # a non-Name target (self.x = .../d[k] = ...) stores the
                # resource somewhere reachable: consumed on the spot
        for tgt in targets:
            if not isinstance(tgt, ast.Name):
                live.consume(_names_in(tgt))

    def _stmt(self, stmt: ast.stmt, live: _Live) -> None:
        if isinstance(stmt, ast.Assign):
            self._bind_or_consume(stmt, stmt.targets, stmt.value, live)
        elif isinstance(stmt, ast.AnnAssign):
            self._bind_or_consume(stmt, [stmt.target], stmt.value, live)
        elif isinstance(stmt, ast.AugAssign):
            live.consume(_names_in(stmt.value))
            live.consume(_names_in(stmt.target))
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                live.consume(_names_in(stmt.value))
            self._report(live, stmt, "`return`")
        elif isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                live.consume(_names_in(stmt.exc))
            self._report(live, stmt, "`raise`")
        elif isinstance(stmt, ast.If):
            live.consume(_call_names(stmt.test))
            then = live.copy()
            other = live.copy()
            self._block(stmt.body, then)
            self._block(stmt.orelse, other)
            live.merge_branches(then, other)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            live.consume(_names_in(stmt.iter))
            self._block(stmt.body, live)
            self._block(stmt.orelse, live)
        elif isinstance(stmt, ast.While):
            live.consume(_call_names(stmt.test))
            self._block(stmt.body, live)
            self._block(stmt.orelse, live)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                live.consume(_names_in(item.context_expr))
            self._block(stmt.body, live)
        elif isinstance(stmt, (ast.Try, getattr(ast, "TryStar", ast.Try))):
            self._block(stmt.body, live)
            for handler in stmt.handlers:
                branch = live.copy()
                self._block(handler.body, branch)
            self._block(stmt.orelse, live)
            self._block(stmt.finalbody, live)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            pass        # nested defs run later; their scan is separate
        else:
            live.consume(_names_in(stmt))


def _functions_with_quals(tree: ast.Module
                          ) -> List[Tuple[str, str, ast.AST]]:
    """(qualname, enclosing class name, node) for every def."""
    out: List[Tuple[str, str, ast.AST]] = []

    def visit(node: ast.AST, prefix: str, cls: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", child.name)
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                out.append((f"{prefix}{child.name}", cls, child))
                visit(child, f"{prefix}{child.name}.", cls)

    visit(tree, "", "")
    return out


def _lint_res103(tree: ast.Module, path: str,
                 comments: Dict[int, str]) -> List[Finding]:
    findings: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        stores: Dict[str, int] = {}          # attr -> first install line
        completes: Set[str] = set()
        for node in ast.walk(cls):
            tgt_lists = []
            if isinstance(node, ast.Assign):
                tgt_lists = node.targets
            elif isinstance(node, ast.AugAssign):
                tgt_lists = [node.target]
            for tgt in tgt_lists:
                if (isinstance(tgt, ast.Subscript)
                        and isinstance(tgt.value, ast.Attribute)
                        and isinstance(tgt.value.value, ast.Name)
                        and tgt.value.value.id == "self"
                        and _CACHE_ATTR_RE.search(tgt.value.attr)):
                    attr = tgt.value.attr
                    end = getattr(node, "end_lineno", node.lineno)
                    hatch = any(_OWNERSHIP_RE.search(
                        comments.get(line, ""))
                        for line in range(node.lineno, end + 1))
                    if not hatch and attr not in stores:
                        stores[attr] = node.lineno
            if isinstance(node, ast.Delete):
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Subscript)
                            and isinstance(tgt.value, ast.Attribute)
                            and isinstance(tgt.value.value, ast.Name)
                            and tgt.value.value.id == "self"):
                        completes.add(tgt.value.attr)
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _COMPLETION_METHODS
                    and isinstance(node.func.value, ast.Attribute)
                    and isinstance(node.func.value.value, ast.Name)
                    and node.func.value.value.id == "self"):
                completes.add(node.func.value.attr)
        for attr, line in sorted(stores.items(), key=lambda x: x[1]):
            if attr in completes:
                continue
            findings.append(Finding(
                rule="RES103", path=path, line=line,
                symbol=f"{cls.name}.{attr}",
                message=f"`self.{attr}[...]` entries are installed but "
                        f"{cls.name} has no completion path (no "
                        "del/.pop/.popitem/.clear) — the table can only "
                        "grow",
                hint="evict on completion or bound the table "
                     "(OrderedDict + popitem), or declare `# ownership: "
                     "transferred-to <symbol>` at the install site"))
    return findings


def lint_source(source: str, path: str = "<snippet>.py"
                ) -> List[Finding]:
    """Lint one source string (library + unit-test surface)."""
    tree = ast.parse(source, filename=path)
    comments = _comment_lines(source)
    findings: List[Finding] = []
    for qual, cls_name, fn in _functions_with_quals(tree):
        _FunctionScan(path=path, qual=qual, cls_name=cls_name,
                      comments=comments, findings=findings).run(fn)
    findings.extend(_lint_res103(tree, path, comments))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_package(package_root: str,
                 repo_root: Optional[str] = None) -> List[Finding]:
    repo_root = repo_root or os.path.dirname(
        os.path.abspath(package_root))
    findings: List[Finding] = []
    for path in _iter_py_files(package_root):
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as f:
            findings.extend(lint_source(f.read(), rel))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
