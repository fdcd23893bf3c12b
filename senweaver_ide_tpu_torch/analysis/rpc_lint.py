"""RPC replay-discipline checker: idempotency and lease fencing.

Every ``serve.remote_server.RpcHandlerBase`` subclass is a dispatch
table whose retry safety rests on hand-curated method classification:
``mutating_methods`` consult the idempotency cache (a retried call
REPLAYS its first outcome), ``readonly_methods`` must see fresh state,
and ``reexecute_safe_methods`` are mutating-but-deliberately-uncached
(the lease family: re-execution is safe, replay is the PR-7
zombie-grant bug). One wrong entry re-creates a split-brain, so this
pass makes the classification machine-checked:

RPC101  ``_m_*`` method dispatchable over the wire but absent from all
        of ``mutating_methods`` / ``readonly_methods`` /
        ``reexecute_safe_methods`` (or present in more than one) —
        unclassified means unreviewed replay semantics
RPC102  client-side ``transport.call("<mutating method>", ...)`` with
        no idempotency key (``request_id`` missing or ``None``) — a
        timeout retry would double-execute
RPC103  lease-shaped method (``acquire``/``renew``/``release``/
        ``steal`` + ``lease``) inside a CACHED ``mutating_methods``
        set — the exact PR-7 zombie-lease-grant class: a restarted
        client replaying a previous incarnation's grant runs at a
        zombie epoch. Lease ops belong in ``reexecute_safe_methods``.
RPC104  ad-hoc ``while``/``for`` retry loop around a transport call in
        a function that never touches ``resilience/retry.py`` (no
        RetryBudget, no Retry-After floor)
RPC105  mutating (or reexecute-safe) handler method whose docstring /
        ``# replay:`` comment lacks a replay-semantics justification —
        the convention learner_server's hand-written comments carried

Escape hatches, all explicit at the site:

* ``# replay: <why>`` trailing/body comment satisfies RPC105 when a
  docstring is not the right home (e.g. a mixin method).
* ``# retry: <why>`` inside a function exempts its loops from RPC104
  (for transports with their own bespoke taxonomy).

Pure AST + tokenize like jit_lint/lock_lint: nothing is imported, so
it runs on any checkout in milliseconds.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding
from .jit_lint import _iter_py_files

RULES: Dict[str, str] = {
    "RPC101": "dispatchable rpc method with unreviewed replay class",
    "RPC102": "client call to a mutating method without idempotency key",
    "RPC103": "lease-shaped method in a cached mutating set",
    "RPC104": "ad-hoc retry loop bypassing resilience/retry.py",
    "RPC105": "mutating handler without replay-semantics justification",
}

_BASE_NAME = "RpcHandlerBase"
_SET_ATTRS = ("mutating_methods", "readonly_methods",
              "reexecute_safe_methods")
_LEASE_VERBS = ("acquire", "renew", "release", "steal")
_RETRY_TOKENS = {"RetryBudget", "RetryPolicy", "next_delay",
                 "parse_retry_after"}
_REPLAY_RE = re.compile(r"#\s*replay:")
_RETRY_HATCH_RE = re.compile(r"#\s*retry:")
_REPLAY_DOC_RE = re.compile(r"replay|re-?exec", re.IGNORECASE)


def _comment_lines(source: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except tokenize.TokenError:      # pragma: no cover - parse catches it
        pass
    return out


def _as_str(node: ast.AST, env: Dict[str, Tuple[str, object]]
            ) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        kind, val = env.get(node.id, (None, None))
        if kind == "str":
            return val           # type: ignore[return-value]
    return None


def _as_str_set(node: ast.AST, env: Dict[str, Tuple[str, object]]
                ) -> Optional[Set[str]]:
    """``{"a"}`` / ``frozenset({...})`` / module-level name / ``A | B``
    → the literal string set, or None when unresolvable."""
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        out: Set[str] = set()
        for elt in node.elts:
            s = _as_str(elt, env)
            if s is None:
                return None
            out.add(s)
        return out
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("frozenset", "set")
            and not node.keywords):
        if not node.args:
            return set()
        if len(node.args) == 1:
            return _as_str_set(node.args[0], env)
        return None
    if isinstance(node, ast.Name):
        kind, val = env.get(node.id, (None, None))
        if kind == "set":
            return set(val)      # type: ignore[arg-type]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        left = _as_str_set(node.left, env)
        right = _as_str_set(node.right, env)
        if left is not None and right is not None:
            return left | right
    return None


def _module_env(tree: ast.Module) -> Dict[str, Tuple[str, object]]:
    env: Dict[str, Tuple[str, object]] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            name = node.targets[0].id
            s = _as_str_set(node.value, env)
            if s is not None:
                env[name] = ("set", s)
                continue
            lit = _as_str(node.value, env)
            if lit is not None:
                env[name] = ("str", lit)
    return env


class _ClassInfo:
    def __init__(self, cls: ast.ClassDef, path: str,
                 env: Dict[str, Tuple[str, object]]):
        self.name = cls.name
        self.path = path
        self.lineno = cls.lineno
        self.bases: List[str] = []
        for base in cls.bases:
            if isinstance(base, ast.Name):
                self.bases.append(base.id)
            elif isinstance(base, ast.Attribute):
                self.bases.append(base.attr)
        # wire method name (no ``_m_`` prefix) -> def node
        self.methods: Dict[str, ast.AST] = {}
        for node in cls.body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name.startswith("_m_")):
                self.methods[node.name[3:]] = node
        # attr -> (assign line, resolved set or None-if-unresolvable)
        self.sets: Dict[str, Tuple[int, Optional[Set[str]]]] = {}
        for node in cls.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id in _SET_ATTRS):
                self.sets[node.targets[0].id] = (
                    node.lineno, _as_str_set(node.value, env))


def _is_handler(info: _ClassInfo,
                index: Dict[str, _ClassInfo]) -> bool:
    seen: Set[str] = set()
    stack = list(info.bases)
    while stack:
        name = stack.pop()
        if name == _BASE_NAME:
            return True
        if name in seen:
            continue
        seen.add(name)
        base = index.get(name)
        if base is not None:
            stack.extend(base.bases)
    return False


def _ancestry(info: _ClassInfo, index: Dict[str, _ClassInfo]
              ) -> List[_ClassInfo]:
    """self + in-index ancestors, nearest first (BFS over base names)."""
    out, seen = [info], {info.name}
    queue = list(info.bases)
    while queue:
        name = queue.pop(0)
        if name in seen:
            continue
        seen.add(name)
        base = index.get(name)
        if base is not None:
            out.append(base)
            queue.extend(base.bases)
    return out


def _effective_set(info: _ClassInfo, attr: str,
                   index: Dict[str, _ClassInfo]
                   ) -> Tuple[Optional[Set[str]], bool]:
    """(resolved set, declared-anywhere). The base class defaults every
    classification attr to empty, so undeclared resolves to set()."""
    for cls in _ancestry(info, index):
        if attr in cls.sets:
            return cls.sets[attr][1], True
    return set(), False


def _effective_methods(info: _ClassInfo, index: Dict[str, _ClassInfo]
                       ) -> Dict[str, Tuple[_ClassInfo, ast.AST]]:
    out: Dict[str, Tuple[_ClassInfo, ast.AST]] = {}
    for cls in reversed(_ancestry(info, index)):   # nearest wins
        for name, node in cls.methods.items():
            out[name] = (cls, node)
    return out


def _lease_shaped(entry: str) -> bool:
    """``acquire_lease`` yes; ``release_slot`` no — the lease noun must
    be its own token ("lease" is a substring of "release")."""
    tokens = entry.split("_")
    has_noun = any(t == "lease" or (t != "release" and "lease" in t)
                   for t in tokens)
    return has_noun and any(t in _LEASE_VERBS for t in tokens)


def _has_replay_doc(node: ast.AST, comments: Dict[int, str]) -> bool:
    doc = ast.get_docstring(node) or ""
    if _REPLAY_DOC_RE.search(doc):
        return True
    end = getattr(node, "end_lineno", node.lineno)
    return any(_REPLAY_RE.search(comments.get(line, ""))
               for line in range(node.lineno, end + 1))


def _is_transport(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return "transport" in node.id
    if isinstance(node, ast.Attribute):
        return "transport" in node.attr
    return False


def _transport_calls(node: ast.AST) -> List[ast.Call]:
    return [n for n in ast.walk(node)
            if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "call"
            and _is_transport(n.func.value)]


def _functions_with_quals(tree: ast.Module
                          ) -> List[Tuple[str, ast.AST]]:
    out: List[Tuple[str, ast.AST]] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                out.append((f"{prefix}{child.name}", child))
                visit(child, f"{prefix}{child.name}.")

    visit(tree, "")
    return out


class _FileUnit:
    def __init__(self, path: str, source: str):
        self.path = path
        self.tree = ast.parse(source, filename=path)
        self.comments = _comment_lines(source)
        self.env = _module_env(self.tree)
        self.classes = [
            _ClassInfo(n, path, self.env)
            for n in ast.walk(self.tree)
            if isinstance(n, ast.ClassDef)]


def _lint_units(units: Sequence[_FileUnit]) -> List[Finding]:
    index: Dict[str, _ClassInfo] = {}
    for unit in units:
        for info in unit.classes:
            index.setdefault(info.name, info)

    handlers = [info for unit in units for info in unit.classes
                if info.name != _BASE_NAME and _is_handler(info, index)]

    # package-wide replay-sensitive unions, for RPC102/RPC105
    mutating_union: Set[str] = set()
    replay_union: Set[str] = set()
    for info in handlers:
        mut, _ = _effective_set(info, "mutating_methods", index)
        reex, _ = _effective_set(info, "reexecute_safe_methods", index)
        if mut:
            mutating_union |= mut
            replay_union |= mut
        if reex:
            replay_union |= reex

    findings: List[Finding] = []

    # -- RPC101 / RPC103: per handler class ------------------------------
    for info in handlers:
        sets = {attr: _effective_set(info, attr, index)[0]
                for attr in _SET_ATTRS}
        if any(s is None for s in sets.values()):
            continue            # unresolvable declaration: stay quiet
        methods = _effective_methods(info, index)
        for name in sorted(methods):
            def_cls, node = methods[name]
            memberships = [attr for attr in _SET_ATTRS
                           if name in sets[attr]]
            line = (node.lineno if def_cls is info else info.lineno)
            if not memberships:
                findings.append(Finding(
                    rule="RPC101", path=info.path, line=line,
                    symbol=f"{info.name}._m_{name}",
                    message=f"rpc method {name!r} is dispatchable but in "
                            "none of mutating_methods / readonly_methods "
                            "/ reexecute_safe_methods — its replay "
                            "semantics were never reviewed",
                    hint="classify it: cached-mutating, readonly (fresh "
                         "state), or reexecute-safe (mutating but "
                         "deliberately uncached, e.g. lease ops)"))
            elif len(memberships) > 1:
                findings.append(Finding(
                    rule="RPC101", path=info.path, line=line,
                    symbol=f"{info.name}._m_{name}",
                    message=f"rpc method {name!r} is classified in "
                            f"multiple sets ({', '.join(memberships)}) — "
                            "replay behavior is ambiguous",
                    hint="keep it in exactly one classification set"))
        own_mut = info.sets.get("mutating_methods")
        if own_mut is not None and own_mut[1] is not None:
            for entry in sorted(own_mut[1]):
                if _lease_shaped(entry):
                    findings.append(Finding(
                        rule="RPC103", path=info.path, line=own_mut[0],
                        symbol=f"{info.name}.{entry}",
                        message=f"lease-shaped method {entry!r} is in the "
                                "CACHED mutating_methods set — a "
                                "restarted client replaying a previous "
                                "incarnation's grant would run at a "
                                "zombie epoch (the PR-7 bug class)",
                        hint="move it to reexecute_safe_methods: lease "
                             "ops are safe to re-execute, never to "
                             "replay from cache"))

    # -- RPC105: replay docs at the defining method ----------------------
    for unit in units:
        for info in unit.classes:
            for name in sorted(info.methods):
                if name not in replay_union:
                    continue
                node = info.methods[name]
                if _has_replay_doc(node, unit.comments):
                    continue
                findings.append(Finding(
                    rule="RPC105", path=unit.path, line=node.lineno,
                    symbol=f"{info.name}._m_{name}",
                    message=f"mutating rpc method {name!r} carries no "
                            "replay-semantics justification (docstring "
                            "or `# replay:` comment)",
                    hint="state why a retried request may replay the "
                         "cached outcome (or why re-execution is safe) "
                         "in the docstring, or add `# replay: <why>`"))

    # -- RPC102 / RPC104: per function -----------------------------------
    for unit in units:
        for qual, fn in _functions_with_quals(unit.tree):
            calls = _transport_calls(fn)
            if not calls:
                continue
            for call in calls:
                method = (_as_str(call.args[0], unit.env)
                          if call.args else None)
                if method is None or method not in mutating_union:
                    continue
                rid = next((kw.value for kw in call.keywords
                            if kw.arg == "request_id"), None)
                if rid is None or (isinstance(rid, ast.Constant)
                                   and rid.value is None):
                    findings.append(Finding(
                        rule="RPC102", path=unit.path,
                        line=call.lineno, symbol=qual,
                        message=f"calls mutating rpc {method!r} without "
                                "an idempotency key — a timeout retry "
                                "would execute it twice",
                        hint="pass request_id=<stable id> (derive it "
                             "from the logical operation, not the "
                             "attempt)"))
            end = getattr(fn, "end_lineno", fn.lineno)
            tokens = {n.id for n in ast.walk(fn)
                      if isinstance(n, ast.Name)}
            tokens |= {n.attr for n in ast.walk(fn)
                       if isinstance(n, ast.Attribute)}
            if tokens & _RETRY_TOKENS:
                continue
            if any(_RETRY_HATCH_RE.search(unit.comments.get(line, ""))
                   for line in range(fn.lineno, end + 1)):
                continue
            for loop in ast.walk(fn):
                if not isinstance(loop, (ast.While, ast.For)):
                    continue
                if not _transport_calls(loop):
                    continue
                findings.append(Finding(
                    rule="RPC104", path=unit.path, line=loop.lineno,
                    symbol=qual,
                    message="hand-rolled retry loop around a transport "
                            "call — no RetryBudget, no Retry-After "
                            "floor, no deadline accounting",
                    hint="drive retries through resilience/retry.py "
                         "(RetryBudget.next_delay), or justify the "
                         "bespoke loop with `# retry: <why>`"))
                break           # one finding per function is enough

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_source(source: str, path: str = "<snippet>.py"
                ) -> List[Finding]:
    """Lint one source string (library + unit-test surface)."""
    return _lint_units([_FileUnit(path, source)])


def lint_package(package_root: str,
                 repo_root: Optional[str] = None) -> List[Finding]:
    """Whole-package pass: handler classification is resolved across
    modules (a mixin's ``_m_scrape`` counts for every handler that
    inherits it; the mutating union for client checks spans all
    handlers)."""
    repo_root = repo_root or os.path.dirname(
        os.path.abspath(package_root))
    units: List[_FileUnit] = []
    for path in _iter_py_files(package_root):
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as f:
            units.append(_FileUnit(rel, f.read()))
    return _lint_units(units)
