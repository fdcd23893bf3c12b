"""Lock-discipline checker: the ``# guarded-by:`` convention.

The serve/ fleet, obs/ registry, and trace/training loops share state
across threads behind per-object locks. The convention that makes that
auditable: the ``__init__`` line that creates a shared attribute carries
a trailing comment naming its lock —

    self._requests = {}          # guarded-by: _lock

and this pass then verifies, per class, that every WRITE to an annotated
attribute (assignment, augmented assignment, ``del``, subscript store,
or a mutating method call like ``.append``/``.pop``/``.update``) happens
lexically inside ``with self.<lock>:``.

Two escape hatches, both explicit at the definition site:

* a method whose docstring contains "caller holds the lock" (the
  existing idiom, e.g. ``EngineReplica._update_decode_gauge``) or whose
  body carries a ``# guarded-by: caller`` comment is a private helper
  the owning class only invokes under its lock — writes inside it pass.
* ``__init__`` (and ``__post_init__``) construct the object before it
  is shared; writes there pass.

Rules:

LOCK101  write to a guarded attribute outside ``with self.<lock>`` in
         the owning class
LOCK102  cross-object write ``other.attr = …`` where ``attr`` is
         guarded in some class — another object's lock can't be held
         by grabbing your own (go through a locked method on the owner)

Like jit_lint this is pure AST + tokenize: nothing is imported, so it
runs on any checkout in milliseconds.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import Finding
from .jit_lint import _iter_py_files, _resolve_relative

RULES: Dict[str, str] = {
    "LOCK101": "write to a guarded attribute outside its lock",
    "LOCK102": "cross-object write to another object's guarded attribute",
}

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_.]*)")
_CALLER_HOLDS_DOC = re.compile(r"caller\s+holds\s+the\s+lock",
                               re.IGNORECASE)

_MUTATORS = {"append", "extend", "insert", "pop", "popleft", "remove",
             "clear", "update", "setdefault", "add", "discard",
             "appendleft", "rotate"}

_CTOR_NAMES = {"__init__", "__post_init__", "__enter__"}


def _comment_map(source: str) -> Dict[int, str]:
    """line number -> guard target for every ``# guarded-by:`` comment."""
    out: Dict[int, str] = {}
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in toks:
            if tok.type == tokenize.COMMENT:
                m = _GUARDED_RE.search(tok.string)
                if m:
                    out[tok.start[0]] = m.group(1)
    except tokenize.TokenError:     # pragma: no cover - parse catches it
        pass
    return out


def _self_attr_target(node: ast.AST) -> Optional[str]:
    """``self.x`` (possibly through a subscript) → "x"."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _ClassGuards:
    """attr -> lock name, collected from annotated __init__ lines."""

    def __init__(self, cls: ast.ClassDef, comments: Dict[int, str]):
        self.name = cls.name
        self.guards: Dict[str, str] = {}
        for node in ast.walk(cls):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                guard = comments.get(node.lineno)
                if guard is None:
                    continue
                targets = (node.targets
                           if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    attr = _self_attr_target(tgt)
                    if attr is not None:
                        self.guards[attr] = guard


def _caller_holds(fn: ast.AST, comments: Dict[int, str]) -> bool:
    doc = ast.get_docstring(fn) or ""
    if _CALLER_HOLDS_DOC.search(doc):
        return True
    end = getattr(fn, "end_lineno", fn.lineno)
    for line in range(fn.lineno, end + 1):
        if comments.get(line) == "caller":
            return True
    return False


def _with_locks(stack: Sequence[ast.With]) -> Set[str]:
    """Lock attribute names held by the enclosing ``with`` statements:
    ``with self._lock:`` → {"_lock"}. Also accepts local aliases created
    as ``lock = self._lock`` — we only track the syntactic common case.
    """
    held: Set[str] = set()
    for w in stack:
        for item in w.items:
            attr = _self_attr_target(item.context_expr)
            if attr is not None:
                held.add(attr)
    return held


class _MethodChecker(ast.NodeVisitor):
    def __init__(self, *, path: str, cls: _ClassGuards,
                 method: ast.AST, exempt: bool,
                 all_guarded: Dict[str, Set[str]],
                 findings: List[Finding]):
        self.path = path
        self.cls = cls
        self.method = method
        self.exempt = exempt
        self.all_guarded = all_guarded      # attr -> {class names}
        self.findings = findings
        self._with_stack: List[ast.With] = []
        self.qual = f"{cls.name}.{method.name}"

    # -- helpers -----------------------------------------------------------
    def _held(self) -> Set[str]:
        return _with_locks(self._with_stack)

    def _check_self_write(self, node: ast.AST, attr: str,
                          how: str) -> None:
        lock = self.cls.guards.get(attr)
        if lock is None or self.exempt:
            return
        if lock.startswith("self."):
            lock = lock[len("self."):]
        if lock in self._held():
            return
        self.findings.append(Finding(
            rule="LOCK101", path=self.path,
            line=getattr(node, "lineno", 0), symbol=self.qual,
            message=f"{how} `self.{attr}` (guarded-by: {lock}) outside "
                    f"`with self.{lock}`",
            hint=f"wrap the write in `with self.{lock}:`, or mark the "
                 "method caller-holds (docstring 'Caller holds the "
                 "lock.' / `# guarded-by: caller`)"))

    def _check_cross_write(self, node: ast.AST, obj: str,
                           attr: str) -> None:
        owners = self.all_guarded.get(attr, set())
        owners = owners - {self.cls.name}
        if not owners or self.exempt:
            return
        self.findings.append(Finding(
            rule="LOCK102", path=self.path,
            line=getattr(node, "lineno", 0), symbol=self.qual,
            message=f"writes `{obj}.{attr}` directly, but `{attr}` is "
                    f"lock-guarded in {', '.join(sorted(owners))} — "
                    "holding this object's lock doesn't guard that one",
            hint="add a locked mutator method on the owning class and "
                 "call it instead"))

    # -- visitors ----------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        self._with_stack.append(node)
        self.generic_visit(node)
        self._with_stack.pop()

    def _targets(self, node) -> Iterable[ast.AST]:
        if isinstance(node, ast.Assign):
            return node.targets
        return [node.target]

    def _handle_store(self, node, tgt: ast.AST) -> None:
        sub = isinstance(tgt, ast.Subscript)
        attr = _self_attr_target(tgt)
        if attr is not None:
            how = "subscript-assigns" if sub else "assigns"
            self._check_self_write(node, attr, how)
            return
        # other.attr = ... (cross-object, plain attribute only)
        base = tgt
        while isinstance(base, ast.Subscript):
            base = base.value
        if (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id not in ("self", "cls")):
            self._check_cross_write(node, base.value.id, base.attr)

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._handle_store(node, tgt)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._handle_store(node, node.target)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._handle_store(node, node.target)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            attr = _self_attr_target(tgt)
            if attr is not None:
                self._check_self_write(node, attr, "deletes from")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            attr = _self_attr_target(f.value)
            if attr is not None:
                self._check_self_write(node, attr,
                                       f"mutates (`.{f.attr}`)")
        self.generic_visit(node)

    # nested defs get their own checker pass is NOT done: a nested
    # function inherits the enclosing with-context only dynamically, so
    # flag its writes conservatively with the current stack — in this
    # codebase nested defs in locked classes are callbacks run elsewhere.
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node is self.method:
            self.generic_visit(node)
        # skip nested defs: they execute later, under unknown locks;
        # writes inside them are the dynamic recorder's jurisdiction.

    visit_AsyncFunctionDef = visit_FunctionDef


def lint_source(source: str, path: str = "<snippet>.py"
                ) -> List[Finding]:
    """Lint one source string (library + unit-test surface)."""
    tree = ast.parse(source, filename=path)
    comments = _comment_map(source)
    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    guards = {c.name: _ClassGuards(c, comments) for c in classes}
    # attr -> owning class names (for LOCK102)
    all_guarded: Dict[str, Set[str]] = {}
    for g in guards.values():
        for attr in g.guards:
            all_guarded.setdefault(attr, set()).add(g.name)

    findings: List[Finding] = []
    for cls in classes:
        g = guards[cls.name]
        for node in cls.body:
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            exempt = (node.name in _CTOR_NAMES
                      or _caller_holds(node, comments))
            checker = _MethodChecker(path=path, cls=g, method=node,
                                     exempt=exempt,
                                     all_guarded=all_guarded,
                                     findings=findings)
            checker.visit(node)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_package(package_root: str,
                 repo_root: Optional[str] = None) -> List[Finding]:
    """LOCK101 per file; LOCK102 against a package-wide guarded-attr
    index (a cross-object write in frontend.py to an attr guarded in
    replica.py must still fire)."""
    repo_root = repo_root or os.path.dirname(
        os.path.abspath(package_root))
    parsed: List[Tuple[str, str, ast.Module, Dict[int, str]]] = []
    for path in _iter_py_files(package_root):
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        modname = rel[:-3].replace("/", ".")
        if modname.endswith(".__init__"):
            modname = modname[: -len(".__init__")]
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        parsed.append((rel, modname, ast.parse(source, filename=rel),
                       _comment_map(source)))

    # per-module attr -> owning classes (for LOCK102 an attr name only
    # counts against modules that actually IMPORT the owner — `version`
    # on an unrelated dataclass elsewhere is not WeightPublisher's)
    guarded_by_module: Dict[str, Dict[str, Set[str]]] = {}
    imports_of: Dict[str, Set[str]] = {}
    per_file_classes: List[Tuple[str, str, List[ast.ClassDef],
                                 Dict[str, _ClassGuards],
                                 Dict[int, str]]] = []
    for rel, modname, tree, comments in parsed:
        classes = [n for n in ast.walk(tree)
                   if isinstance(n, ast.ClassDef)]
        guards = {c.name: _ClassGuards(c, comments) for c in classes}
        mod_guarded: Dict[str, Set[str]] = {}
        for g in guards.values():
            for attr in g.guards:
                mod_guarded.setdefault(attr, set()).add(g.name)
        guarded_by_module[modname] = mod_guarded
        imp: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                imp.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                src_mod = _resolve_relative(modname, node.level,
                                            node.module or "")
                imp.add(src_mod)
                # `from .pkg import module` also reaches pkg.module
                imp.update(f"{src_mod}.{a.name}" for a in node.names)
        imports_of[modname] = imp
        per_file_classes.append((rel, modname, classes, guards,
                                 comments))

    findings: List[Finding] = []
    for rel, modname, classes, guards, comments in per_file_classes:
        visible = {modname} | imports_of[modname]
        all_guarded: Dict[str, Set[str]] = {}
        for m in visible:
            for attr, owners in guarded_by_module.get(m, {}).items():
                all_guarded.setdefault(attr, set()).update(owners)
        for cls in classes:
            g = guards[cls.name]
            for node in cls.body:
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                exempt = (node.name in _CTOR_NAMES
                          or _caller_holds(node, comments))
                checker = _MethodChecker(path=rel, cls=g, method=node,
                                         exempt=exempt,
                                         all_guarded=all_guarded,
                                         findings=findings)
                checker.visit(node)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
