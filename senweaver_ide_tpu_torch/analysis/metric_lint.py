"""Metric-contract checker: emissions vs docs/observability.md.

The observability contract is three-sided: code registers metrics
(``registry.counter/gauge/histogram`` call sites), docs/observability.md
tabulates them (the operator's index), and the dashboard reads them
back by name. Nothing enforced the sides against each other, so names
drifted silently. This pass builds the emitted-metric inventory —
(name, type, label set, help) per call site, f-strings becoming prefix
wildcards — parses every ``| `senweaver_...` | type | ... |`` doc-table
row, and cross-checks:

MET101  emitted but undocumented (or documented with a conflicting
        type/label set — the row no longer describes the emission)
MET102  documented (or dashboard-read) but never emitted — a stale doc
        row / dead tile field
MET103  one name registered with conflicting type or labels in two
        call sites — the registry would raise at runtime, but only on
        the process that happens to load both
MET104  name outside the ``senweaver_<subsystem>_<what>`` grammar
        (counters additionally end ``_total``), or a dynamic name the
        pass cannot resolve

Dynamic names: an f-string with a constant ``senweaver_`` prefix
becomes the wildcard ``<prefix>*`` and matches wildcard doc rows
(``senweaver_spec_draft_kv_*``, ``senweaver_grpo_health_<signal>``)
by prefix. A registration whose name is computed some other way must
carry a ``# metric-name: <pattern>`` comment on the call — the escape
hatch mirroring lock_lint's ``# guarded-by:``.

MET findings are deliberately not baselineable policy-wise (the tests
pin zero MET baseline entries): a drifted doc row costs one line to
fix, so the ledger never needs to carry it.

Pure AST + tokenize; the doc side is plain markdown-table parsing.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding
from .jit_lint import _iter_py_files

RULES: Dict[str, str] = {
    "MET101": "emitted metric missing from docs/observability.md",
    "MET102": "documented or dashboard-read metric never emitted",
    "MET103": "metric registered with conflicting type/labels",
    "MET104": "metric name outside the senweaver_* grammar",
}

_METRIC_TYPES = ("counter", "gauge", "histogram")
_NAME_RE = re.compile(r"^senweaver_[a-z0-9]+(_[a-z0-9]+)+$")
_ANNOT_RE = re.compile(r"#\s*metric-name:\s*(\S+)")
_DOC_NAME_RE = re.compile(r"`([^`]+)`")
_CELL_SPLIT_RE = re.compile(r"(?<!\\)\|")
_CONSUMER_FILE = "services/dashboard.py"
_DOC_FILE = "docs/observability.md"


@dataclasses.dataclass(frozen=True)
class EmitSite:
    """One registration call. ``name`` is exact, or a prefix when
    ``wildcard``; None when unresolvable (no annotation either)."""

    name: Optional[str]
    wildcard: bool
    mtype: str
    labels: Optional[Tuple[str, ...]]   # None = unresolvable
    help: str
    path: str
    line: int


@dataclasses.dataclass(frozen=True)
class DocRow:
    name: str                           # prefix when wildcard
    wildcard: bool
    types: str                          # raw type cell ("gauge/counter")
    labels: Optional[Tuple[str, ...]]
    path: str
    line: int


@dataclasses.dataclass(frozen=True)
class ConsumerRef:
    name: str
    wildcard: bool
    path: str
    line: int


def _comment_lines(source: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except tokenize.TokenError:      # pragma: no cover - parse catches it
        pass
    return out


def _str_tuple(node: ast.AST) -> Optional[Tuple[str, ...]]:
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)):
                return None
            out.append(elt.value)
        return tuple(sorted(out))
    return None


def _fstring_prefix(node: ast.JoinedStr) -> Optional[str]:
    if node.values and isinstance(node.values[0], ast.Constant) \
            and isinstance(node.values[0].value, str):
        prefix = node.values[0].value
        if prefix.startswith("senweaver_"):
            return prefix
    return None


def scan_source(source: str, path: str
                ) -> Tuple[List[EmitSite], List[ConsumerRef]]:
    """All registration call sites + all ``senweaver_*`` string
    references (the consumer side) in one file."""
    tree = ast.parse(source, filename=path)
    comments = _comment_lines(source)
    sites: List[EmitSite] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_TYPES
                and node.args):
            continue
        name_arg = node.args[0]
        annot = None
        for line in range(node.lineno,
                          getattr(node, "end_lineno", node.lineno) + 1):
            m = _ANNOT_RE.search(comments.get(line, ""))
            if m:
                annot = m.group(1)
                break
        name: Optional[str] = None
        wildcard = False
        if annot is not None:
            name, wildcard = annot.rstrip("*"), annot.endswith("*")
        elif isinstance(name_arg, ast.Constant) \
                and isinstance(name_arg.value, str):
            name = name_arg.value
        elif isinstance(name_arg, ast.JoinedStr):
            prefix = _fstring_prefix(name_arg)
            if prefix is not None:
                name, wildcard = prefix, True
        else:
            # a Name/expr argument: not a metric registration we can
            # see through — only registry-ish receivers count, so a
            # helper forwarding its own ``name`` param stays quiet
            recv = node.func.value
            recv_name = (recv.id if isinstance(recv, ast.Name)
                         else recv.attr if isinstance(recv, ast.Attribute)
                         else "")
            if "reg" not in recv_name:
                continue
        help_text = ""
        if len(node.args) > 1 and isinstance(node.args[1], ast.Constant) \
                and isinstance(node.args[1].value, str):
            help_text = node.args[1].value
        labels: Optional[Tuple[str, ...]] = ()
        if len(node.args) > 2:
            labels = _str_tuple(node.args[2])
        for kw in node.keywords:
            if kw.arg == "labelnames":
                labels = _str_tuple(kw.value)
            elif kw.arg == "help_text" and labels == () \
                    and isinstance(kw.value, ast.Constant):
                help_text = str(kw.value.value)
        sites.append(EmitSite(name=name, wildcard=wildcard,
                              mtype=node.func.attr, labels=labels,
                              help=help_text, path=path,
                              line=node.lineno))

    consumers: List[ConsumerRef] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith("senweaver_"):
            consumers.append(ConsumerRef(node.value, False, path,
                                         node.lineno))
        elif isinstance(node, ast.JoinedStr):
            prefix = _fstring_prefix(node)
            if prefix is not None:
                consumers.append(ConsumerRef(prefix, True, path,
                                             node.lineno))
    return sites, consumers


def _doc_labels(raw: str) -> Tuple[Optional[Tuple[str, ...]], str]:
    """``name{a,b=x\\|y}`` → (("a","b"), "name")."""
    m = re.search(r"\{([^}]*)\}", raw)
    if m is None:
        return (), raw
    labels = tuple(sorted(part.split("=")[0].strip()
                          for part in m.group(1).split(",")
                          if part.strip()))
    return labels, raw[:m.start()] + raw[m.end():]


def parse_doc_markdown(text: str, path: str = _DOC_FILE) -> List[DocRow]:
    """Every metric row in every markdown table: first cell holds one
    or more backticked names, second cell the type. Rows whose type
    cell names no metric type (e.g. "engine stats") are not registry
    metrics and are skipped."""
    rows: List[DocRow] = []
    for lineno, line in enumerate(text.splitlines(), start=1):
        stripped = line.strip()
        if not stripped.startswith("|"):
            continue
        cells = [c.strip() for c in
                 _CELL_SPLIT_RE.split(stripped.strip("|"))]
        if len(cells) < 2 or set(cells[0]) <= {"-", " ", ":"}:
            continue
        types = cells[1]
        if not any(t in types for t in _METRIC_TYPES):
            continue
        for raw in _DOC_NAME_RE.findall(cells[0]):
            if not raw.startswith("senweaver_"):
                continue
            labels, bare = _doc_labels(raw)
            wildcard = False
            for marker in ("*", "<"):
                if marker in bare:
                    bare = bare[:bare.index(marker)]
                    wildcard = True
            rows.append(DocRow(name=bare, wildcard=wildcard, types=types,
                               labels=labels, path=path, line=lineno))
    return rows


def _matches(a_name: str, a_wild: bool, b_name: str, b_wild: bool
             ) -> bool:
    if not a_wild and not b_wild:
        return a_name == b_name
    if a_wild and not b_wild:
        return b_name.startswith(a_name)
    if not a_wild and b_wild:
        return a_name.startswith(b_name)
    return a_name.startswith(b_name) or b_name.startswith(a_name)


def _grammar_findings(sites: Sequence[EmitSite]) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[str, bool]] = set()
    for s in sites:
        if s.name is None:
            findings.append(Finding(
                rule="MET104", path=s.path, line=s.line,
                symbol=f"<dynamic {s.mtype}>",
                message="metric name is computed and unresolvable — "
                        "the contract checker cannot see it",
                hint="add `# metric-name: <pattern>` on the "
                     "registration (trailing `*` for a family)"))
            continue
        if (s.name, s.wildcard) in seen:
            continue
        seen.add((s.name, s.wildcard))
        if s.wildcard:
            if not s.name.startswith("senweaver_"):
                findings.append(Finding(
                    rule="MET104", path=s.path, line=s.line,
                    symbol=s.name + "*",
                    message="dynamic metric family outside the "
                            "senweaver_* namespace",
                    hint="prefix the family senweaver_<subsystem>_"))
            continue
        if not _NAME_RE.match(s.name):
            findings.append(Finding(
                rule="MET104", path=s.path, line=s.line, symbol=s.name,
                message=f"{s.name!r} is outside the "
                        "senweaver_<subsystem>_<what> grammar",
                hint="rename to senweaver_<subsystem>_<what> "
                     "(lowercase, >= 2 segments after the prefix)"))
        elif s.mtype == "counter" and not s.name.endswith("_total"):
            findings.append(Finding(
                rule="MET104", path=s.path, line=s.line, symbol=s.name,
                message=f"counter {s.name!r} does not end `_total`",
                hint="counters are monotone totals; name them "
                     "senweaver_..._total"))
    return findings


def cross_check(sites: Sequence[EmitSite], rows: Sequence[DocRow],
                consumers: Sequence[ConsumerRef] = ()
                ) -> List[Finding]:
    """MET101/MET102/MET103 over a scanned inventory."""
    findings: List[Finding] = []
    resolved = [s for s in sites if s.name is not None]

    # MET103: conflicting registrations of one exact name
    by_name: Dict[str, EmitSite] = {}
    for s in sorted(resolved, key=lambda s: (s.path, s.line)):
        if s.wildcard:
            continue
        first = by_name.setdefault(s.name, s)
        if first is s:
            continue
        if first.mtype != s.mtype:
            findings.append(Finding(
                rule="MET103", path=s.path, line=s.line, symbol=s.name,
                message=f"{s.name!r} registered as {s.mtype} here but "
                        f"as {first.mtype} at {first.path}:{first.line}",
                hint="one name, one type — rename one of them"))
        elif (first.labels is not None and s.labels is not None
                and first.labels != s.labels):
            findings.append(Finding(
                rule="MET103", path=s.path, line=s.line, symbol=s.name,
                message=f"{s.name!r} registered with labels "
                        f"{list(s.labels)} here but {list(first.labels)} "
                        f"at {first.path}:{first.line}",
                hint="label sets must agree everywhere the name is "
                     "registered"))

    # MET101: every distinct emission needs a doc row that agrees
    seen: Set[Tuple[str, bool]] = set()
    for s in sorted(resolved, key=lambda s: (s.path, s.line)):
        if (s.name, s.wildcard) in seen:
            continue
        seen.add((s.name, s.wildcard))
        matched = [r for r in rows
                   if _matches(s.name, s.wildcard, r.name, r.wildcard)]
        if not matched:
            findings.append(Finding(
                rule="MET101", path=s.path, line=s.line, symbol=s.name,
                message=f"{s.name + ('*' if s.wildcard else '')!r} is "
                        "emitted but not documented in "
                        f"{_DOC_FILE}",
                hint=f"add a `| \\`{s.name}\\` | {s.mtype} | ... |` row "
                     "to the metric table (or fix the name)"))
            continue
        if s.wildcard:
            continue
        exact = [r for r in matched if not r.wildcard]
        if exact and not any(s.mtype in r.types for r in exact):
            r = exact[0]
            findings.append(Finding(
                rule="MET101", path=s.path, line=s.line, symbol=s.name,
                message=f"{s.name!r} is emitted as {s.mtype} but "
                        f"documented as {r.types!r} "
                        f"({r.path}:{r.line})",
                hint="make the doc row's type match the registration"))
        elif exact and s.labels is not None and not any(
                r.labels == s.labels for r in exact
                if r.labels is not None):
            r = exact[0]
            findings.append(Finding(
                rule="MET101", path=s.path, line=s.line, symbol=s.name,
                message=f"{s.name!r} is emitted with labels "
                        f"{list(s.labels)} but documented with "
                        f"{list(r.labels or ())} ({r.path}:{r.line})",
                hint="make the doc row's label set match the "
                     "registration"))

    # MET102: every doc row / dashboard read needs an emission
    doc_seen: Set[Tuple[str, bool]] = set()
    for r in rows:
        if (r.name, r.wildcard) in doc_seen:
            continue
        doc_seen.add((r.name, r.wildcard))
        if not any(_matches(s.name, s.wildcard, r.name, r.wildcard)
                   for s in resolved):
            findings.append(Finding(
                rule="MET102", path=r.path, line=r.line, symbol=r.name,
                message=f"doc row {r.name + ('*' if r.wildcard else '')!r}"
                        " matches no registration call site — stale",
                hint="delete the row, or restore the emission it "
                     "described"))
    con_seen: Set[Tuple[str, bool]] = set()
    for c in consumers:
        if (c.name, c.wildcard) in con_seen:
            continue
        con_seen.add((c.name, c.wildcard))
        if not any(_matches(s.name, s.wildcard, c.name, c.wildcard)
                   for s in resolved):
            findings.append(Finding(
                rule="MET102", path=c.path, line=c.line, symbol=c.name,
                message=f"dashboard reads "
                        f"{c.name + ('*' if c.wildcard else '')!r} but "
                        "nothing emits it — the tile field is dead",
                hint="drop the read, or restore the emission"))
    return findings


def lint_source(source: str, path: str = "<snippet>.py",
                doc_markdown: str = "",
                doc_path: str = _DOC_FILE) -> List[Finding]:
    """Lint one source string against one markdown string (fixture
    surface). The file is treated as emitter AND consumer."""
    sites, consumers = scan_source(source, path)
    emitted = {(s.name, s.wildcard) for s in sites}
    consumers = [c for c in consumers
                 if (c.name, c.wildcard) not in emitted]
    rows = parse_doc_markdown(doc_markdown, doc_path)
    findings = _grammar_findings(sites)
    findings.extend(cross_check(sites, rows, consumers))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def build_inventory(package_root: str, repo_root: Optional[str] = None
                    ) -> Tuple[List[EmitSite], List[ConsumerRef],
                               List[DocRow]]:
    """(emissions, dashboard consumers, doc rows) for the package —
    also the data source for ``scripts/obs_report.py --contract``."""
    repo_root = repo_root or os.path.dirname(
        os.path.abspath(package_root))
    sites: List[EmitSite] = []
    consumers: List[ConsumerRef] = []
    for path in _iter_py_files(package_root):
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        file_sites, file_consumers = scan_source(source, rel)
        sites.extend(file_sites)
        if rel.endswith(_CONSUMER_FILE):
            consumers.extend(file_consumers)
    doc = os.path.join(repo_root, _DOC_FILE)
    rows: List[DocRow] = []
    if os.path.exists(doc):
        with open(doc, "r", encoding="utf-8") as f:
            rows = parse_doc_markdown(f.read(), _DOC_FILE)
    return sites, consumers, rows


def lint_package(package_root: str,
                 repo_root: Optional[str] = None) -> List[Finding]:
    sites, consumers, rows = build_inventory(package_root, repo_root)
    findings = _grammar_findings(sites)
    findings.extend(cross_check(sites, rows, consumers))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
