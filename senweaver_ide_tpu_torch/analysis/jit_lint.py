"""JIT purity + host-sync linter.

The perf contract of this codebase (PAPERS.md Podracer/RLAX lineage) is
that everything inside ``jax.jit`` / ``pjit`` / ``shard_map`` stays pure
and device-resident, and the host-side decode drivers wrapped around the
jitted steps sync at most ONCE per step. Silent host syncs and retrace
storms are the dominant perf cliffs at scale and leave no stack trace —
so this pass turns them into findings with file:line and a fix hint.

How it works (pure AST, no imports of the target code):

1. every module in the package is parsed and indexed (functions,
   methods, imports);
2. jit ENTRY POINTS are discovered: ``@jax.jit`` / ``@pjit`` /
   ``@functools.partial(jax.jit, ...)`` decorations, ``name =
   jax.jit(fn)`` rebinds (through ``jax.vmap``/``partial`` wrappers),
   and functions passed to ``shard_map``;
3. a call graph (same-module names, ``self.``-methods, and cross-module
   ``from x import y`` edges) closes the entry points into the full
   TRACED set — code that executes under tracing;
4. traced functions get the purity rules (JIT1xx/JIT2xx below); host
   functions in the configured HOT modules (the decode drivers) get the
   sync-budget rule JIT110; jit decoration sites get JIT301.

Rule catalog (docs/static_analysis.md):

JIT101  host-sync call inside traced code (``.item()``, ``.tolist()``,
        ``np.asarray``, ``jax.device_get``, ``.block_until_ready()``)
JIT102  Python ``int()/float()/bool()`` cast of a traced value inside
        traced code (implicit device sync + ConcretizationTypeError)
JIT103  ``print``/logging side effect inside traced code (fires at
        trace time only — use ``jax.debug.print``)
JIT104  mutation of global/nonlocal/closure state inside traced code
        (runs once at trace time, silently absent from the compiled fn)
JIT110  hot host decode path performs >1 separate device→host syncs per
        step (each is a blocking roundtrip — batch into one
        ``jax.device_get`` of a tuple)
JIT201  Python ``if``/``while`` on a traced value (concretization —
        use ``jnp.where``/``lax.cond``)
JIT202  Python loop bounded by a traced value (retraces per bound —
        use ``lax.scan``/``fori_loop``)
JIT203  iteration over a ``set`` while tracing (pytree/argument order
        is nondeterministic across processes → retrace/cache misses)
JIT301  ``static_argnames`` naming a parameter with an unhashable
        annotation/default (list/dict/set → TypeError or retrace storm)

Taint model: inside a jit-decorated function every parameter NOT named
in ``static_argnames`` is a tracer; in reachable helpers a parameter is
a tracer when its annotation looks array-like (``jax.Array``,
``jnp.ndarray``, ``KVCache``, ``Params`` …). ``.shape``/``.dtype``/
``.ndim`` and ``len()`` of a tracer are static metadata (safe to branch
on); results of ``jnp.``/``jax.`` calls are tracers; ``np.`` results
and cast results live on the host.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import Finding

RULES: Dict[str, str] = {
    "JIT101": "host-sync call inside jit-traced code",
    "JIT102": "Python cast of a traced value inside jit-traced code",
    "JIT103": "print/logging side effect inside jit-traced code",
    "JIT104": "mutation of nonlocal/global/closure state in traced code",
    "JIT110": "multiple separate host syncs per step in a hot decode path",
    "JIT201": "Python branch on a traced value",
    "JIT202": "Python loop bounded by a traced value",
    "JIT203": "iteration over a set while tracing",
    "JIT301": "non-hashable static_argnames entry",
}

# Host modules whose decode/step drivers get the JIT110 sync budget.
HOT_MODULES: Tuple[str, ...] = (
    "senweaver_ide_tpu_torch/obs/runtime_profile.py",
    "senweaver_ide_tpu_torch/ops/paged_attention.py",
    "senweaver_ide_tpu_torch/rollout/adapter_pool.py",
    "senweaver_ide_tpu_torch/rollout/engine.py",
    "senweaver_ide_tpu_torch/rollout/group_tree.py",
    "senweaver_ide_tpu_torch/rollout/kv_pressure.py",
    "senweaver_ide_tpu_torch/rollout/migration.py",
    "senweaver_ide_tpu_torch/rollout/paged_kv.py",
    "senweaver_ide_tpu_torch/rollout/sampler.py",
    "senweaver_ide_tpu_torch/rollout/spec_controller.py",
    "senweaver_ide_tpu_torch/rollout/speculative.py",
    "senweaver_ide_tpu_torch/serve/replica.py",
    "senweaver_ide_tpu_torch/training/draft_distill.py",
    "senweaver_ide_tpu_torch/training/experience.py",
)

# Attribute reads that are STATIC under tracing even on a tracer:
# metadata JAX resolves at trace time, not device data.
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "sharding",
                 "quantized", "hi_layers", "device", "devices",
                 "itemsize"}

# Annotation substrings that mark a parameter as (containing) arrays.
_ARRAYISH = ("jax.Array", "jnp.ndarray", "ndarray", "Array", "KVCache",
             "Params", "TrainState", "PyTree")
# ...unless it is one of these obviously-host annotations.
_HOSTISH = ("int", "float", "bool", "str", "bytes", "ModelConfig",
            "SampleParams", "List[int]", "List[float]", "Optional[int]",
            "np.ndarray", "numpy.ndarray")

_SYNC_METHODS = {"item", "tolist", "block_until_ready"}
_MUTATORS = {"append", "extend", "insert", "pop", "popleft", "remove",
             "clear", "update", "setdefault", "add", "discard",
             "appendleft"}


def _dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` → "a.b.c" (None for anything not a pure name chain)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def _ann_str(node: Optional[ast.AST]) -> str:
    if node is None:
        return ""
    try:
        return ast.unparse(node)
    except Exception:       # pragma: no cover - unparse is total on 3.9+
        return ""


@dataclasses.dataclass
class FnInfo:
    qualname: str               # "fn" or "Class.fn"
    node: ast.AST               # FunctionDef / AsyncFunctionDef
    module: "ModuleInfo"
    cls: Optional[str] = None
    static_args: Optional[Set[str]] = None   # set ⇔ jit-decorated
    jit_root: bool = False

    @property
    def name(self) -> str:
        return self.node.name


@dataclasses.dataclass
class ModuleInfo:
    path: str                   # repo-relative posix path
    modname: str                # dotted module name
    tree: ast.Module
    functions: Dict[str, FnInfo] = dataclasses.field(default_factory=dict)
    # local name -> (module dotted name, symbol) for `from m import s`
    imports: Dict[str, Tuple[str, str]] = dataclasses.field(
        default_factory=dict)
    # local alias -> module dotted name for `import m [as a]`
    mod_aliases: Dict[str, str] = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------------------
# module indexing
# --------------------------------------------------------------------------

def _resolve_relative(modname: str, level: int, target: str) -> str:
    """Resolve `from ..x import y` relative to dotted ``modname``."""
    parts = modname.split(".")
    # a module's package is everything but its last component
    base = parts[: len(parts) - level] if level else parts
    return ".".join(base + ([target] if target else []))


def index_module(source: str, path: str, modname: str) -> ModuleInfo:
    tree = ast.parse(source, filename=path)
    mi = ModuleInfo(path=path, modname=modname, tree=tree)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                mi.mod_aliases[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom):
            src = _resolve_relative(modname, node.level, node.module or "")
            for a in node.names:
                mi.imports[a.asname or a.name] = (src, a.name)

    def add_fn(node, cls=None):
        qual = f"{cls}.{node.name}" if cls else node.name
        mi.functions[qual] = FnInfo(qualname=qual, node=node, module=mi,
                                    cls=cls)

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            add_fn(node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    add_fn(sub, cls=node.name)

    _mark_jit_roots(mi)
    return mi


def _jit_callable_name(call: ast.Call) -> Optional[str]:
    """Name of the jit-ish callable a Call applies, if any."""
    name = _dotted(call.func) or ""
    leaf = name.split(".")[-1]
    if leaf in ("jit", "pjit"):
        return name
    return None


def _unwrap_to_name(node: ast.AST) -> Optional[str]:
    """Peel partial/vmap/jit wrappers down to a plain function Name."""
    while isinstance(node, ast.Call):
        if not node.args:
            return None
        node = node.args[0]
    return node.id if isinstance(node, ast.Name) else None


def _static_argnames(call: ast.Call) -> Set[str]:
    for kw in call.keywords:
        if kw.arg == "static_argnames" and isinstance(
                kw.value, (ast.Tuple, ast.List)):
            return {e.value for e in kw.value.elts
                    if isinstance(e, ast.Constant)}
        if kw.arg == "static_argnames" and isinstance(
                kw.value, ast.Constant):
            return {kw.value.value}
    return set()


def _mark_jit_roots(mi: ModuleInfo) -> None:
    # decorated functions: @jax.jit / @pjit / @functools.partial(jax.jit,…)
    for fn in mi.functions.values():
        for dec in getattr(fn.node, "decorator_list", []):
            call = dec if isinstance(dec, ast.Call) else None
            target = call.func if call else dec
            name = _dotted(target) or ""
            leaf = name.split(".")[-1]
            if leaf in ("jit", "pjit"):
                fn.jit_root = True
                fn.static_args = _static_argnames(call) if call else set()
            elif leaf == "partial" and call and call.args:
                inner = call.args[0]
                if (_dotted(inner) or "").split(".")[-1] in ("jit",
                                                             "pjit"):
                    fn.jit_root = True
                    fn.static_args = _static_argnames(call)

    # rebinds and shard_map sites anywhere in the module
    for node in ast.walk(mi.tree):
        if not isinstance(node, ast.Call):
            continue
        callee = (_dotted(node.func) or "").split(".")[-1]
        if callee in ("jit", "pjit") and node.args:
            inner = _unwrap_to_name(node.args[0])
            if inner and inner in mi.functions:
                fn = mi.functions[inner]
                fn.jit_root = True
                if fn.static_args is None:
                    fn.static_args = _static_argnames(node)
        elif callee == "shard_map" and node.args:
            inner = _unwrap_to_name(node.args[0])
            if inner and inner in mi.functions:
                fn = mi.functions[inner]
                fn.jit_root = True
                if fn.static_args is None:
                    fn.static_args = set()


# --------------------------------------------------------------------------
# call graph / reachability
# --------------------------------------------------------------------------

def _callees(fn: FnInfo, modules: Dict[str, ModuleInfo]) -> List[FnInfo]:
    out: List[FnInfo] = []
    mi = fn.module
    for node in ast.walk(fn.node):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name):
            name = f.id
            if name in mi.functions:
                out.append(mi.functions[name])
            elif name in mi.imports:
                src_mod, sym = mi.imports[name]
                target = modules.get(src_mod)
                if target and sym in target.functions:
                    out.append(target.functions[sym])
        elif (isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)):
            if f.value.id == "self" and fn.cls:
                qual = f"{fn.cls}.{f.attr}"
                if qual in mi.functions:
                    out.append(mi.functions[qual])
            elif f.value.id in mi.mod_aliases:
                src_mod = mi.mod_aliases[f.value.id]
                target = modules.get(src_mod)
                if target and f.attr in target.functions:
                    out.append(target.functions[f.attr])
    return out


def traced_set(modules: Dict[str, ModuleInfo]) -> Set[Tuple[str, str]]:
    """(path, qualname) closure of the jit entry points."""
    roots = [fn for mi in modules.values()
             for fn in mi.functions.values() if fn.jit_root]
    seen: Set[Tuple[str, str]] = set()
    stack = list(roots)
    while stack:
        fn = stack.pop()
        key = (fn.module.path, fn.qualname)
        if key in seen:
            continue
        seen.add(key)
        stack.extend(_callees(fn, modules))
    return seen


# --------------------------------------------------------------------------
# the per-function checker
# --------------------------------------------------------------------------

def _is_arrayish_annotation(ann: str) -> bool:
    if not ann:
        return False
    if any(h == ann or ann.startswith(f"Optional[{h}")
           for h in _HOSTISH):
        return False
    return any(a in ann for a in _ARRAYISH)


class _FnChecker:
    """Walks one function body with a forward taint environment."""

    def __init__(self, fn: FnInfo, *, traced: bool,
                 modules: Dict[str, ModuleInfo]):
        self.fn = fn
        self.traced = traced
        self.modules = modules
        self.findings: List[Finding] = []
        self.sync_sites: List[Tuple[ast.AST, str]] = []
        self.device: Set[str] = set()
        self._seed_params()

    # -- taint -------------------------------------------------------------
    def _seed_params(self) -> None:
        node = self.fn.node
        args = node.args
        all_args = (args.posonlyargs + args.args + args.kwonlyargs
                    + ([args.vararg] if args.vararg else [])
                    + ([args.kwarg] if args.kwarg else []))
        static = self.fn.static_args
        for a in all_args:
            if a.arg in ("self", "cls"):
                continue
            ann = _ann_str(a.annotation)
            if static is not None and self.traced:
                # jit-decorated: every non-static arg is a tracer.
                if a.arg not in static:
                    self.device.add(a.arg)
            elif _is_arrayish_annotation(ann):
                self.device.add(a.arg)

    def _device(self, node: Optional[ast.AST]) -> bool:
        if node is None or isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.device
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self._device(node.value)
        if isinstance(node, (ast.Subscript, ast.Starred)):
            return self._device(node.value)
        if isinstance(node, ast.Call):
            return self._call_is_device(node)
        if isinstance(node, ast.BinOp):
            return self._device(node.left) or self._device(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._device(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self._device(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # `is (not) None` and `key in pytree` are STRUCTURE checks,
            # resolved at trace time — not device comparisons.
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                   ast.NotIn)) for op in node.ops):
                return False
            return (self._device(node.left)
                    or any(self._device(c) for c in node.comparators))
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self._device(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self._device(node.body) or self._device(node.orelse)
        if isinstance(node, ast.NamedExpr):
            return self._device(node.value)
        return False

    def _call_is_device(self, call: ast.Call) -> bool:
        name = _dotted(call.func) or ""
        head = name.split(".")[0]
        leaf = name.split(".")[-1]
        if head in ("jnp", "jax") or name.startswith("jax."):
            # jax.* produce device values — except the explicit host
            # transfers, whose RESULT is host (the call itself is the
            # sync, caught separately).
            return leaf not in ("device_get",)
        if leaf == "profiled_device_get":
            # obs.runtime_profile's transfer-accounted jax.device_get:
            # same semantics — the call is the sync, its result is host.
            return False
        if head in ("np", "numpy"):
            return False
        if leaf in ("len", "int", "float", "bool", "str", "range",
                    "enumerate", "zip", "min", "max", "sum", "abs"):
            # builtins: len/casts are host; min/max/sum of device args
            # stay device.
            if leaf in ("min", "max", "sum", "abs", "zip", "enumerate"):
                return any(self._device(a) for a in call.args)
            return False
        resolved = self._resolve_call(call)
        if resolved is not None:
            if resolved.jit_root:
                return True
            # A `-> bool`/`-> int` helper (config predicate) is host;
            # otherwise a call is device iff it computes ON device args.
            ret = _ann_str(getattr(resolved.node, "returns", None))
            if ret in ("bool", "int", "float", "str", "None"):
                return False
            return any(self._device(a) for a in call.args)
        # method call on a device value keeps the taint (x.astype(...))
        if isinstance(call.func, ast.Attribute):
            return self._device(call.func.value)
        return False

    def _resolve_call(self, call: ast.Call) -> Optional[FnInfo]:
        mi = self.fn.module
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in mi.functions:
                return mi.functions[f.id]
            if f.id in mi.imports:
                src_mod, sym = mi.imports[f.id]
                target = self.modules.get(src_mod)
                if target:
                    return target.functions.get(sym)
        elif (isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)):
            if f.value.id == "self" and self.fn.cls:
                return mi.functions.get(f"{self.fn.cls}.{f.attr}")
            if f.value.id in mi.mod_aliases:
                target = self.modules.get(mi.mod_aliases[f.value.id])
                if target:
                    return target.functions.get(f.attr)
        return None

    # -- sync detection ----------------------------------------------------
    def _sync_kind(self, call: ast.Call) -> Optional[str]:
        """Classify a call as a device→host sync site (or None)."""
        f = call.func
        name = _dotted(f) or ""
        leaf = name.split(".")[-1]
        head = name.split(".")[0]
        if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
            return f".{f.attr}()"
        if name.endswith("device_get") and head in ("jax",):
            return "jax.device_get"
        if leaf == "profiled_device_get":
            return "profiled_device_get"
        if head in ("np", "numpy") and leaf in ("asarray", "array"):
            if any(self._device(a) for a in call.args):
                return f"{head}.{leaf}"
            return None
        if (isinstance(f, ast.Name)
                and f.id in ("int", "float", "bool")
                and call.args and self._device(call.args[0])):
            return f"{f.id}()"
        return None

    # -- walk --------------------------------------------------------------
    def run(self) -> None:
        for stmt in self.fn.node.body:
            self._stmt(stmt)

    def _add(self, rule: str, node: ast.AST, message: str,
             hint: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.fn.module.path,
            line=getattr(node, "lineno", 0),
            symbol=self.fn.qualname, message=message, hint=hint))

    def _stmt(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested defs (scan bodies) trace under the same jit
            for sub in node.body:
                self._stmt(sub)
            return
        if isinstance(node, ast.Assign):
            self._exprs(node.value)
            dev = self._device(node.value)
            for tgt in node.targets:
                self._taint_target(tgt, dev, node.value)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._exprs(node.value)
                self._taint_target(node.target,
                                   self._device(node.value), node.value)
        elif isinstance(node, ast.AugAssign):
            self._exprs(node.value)
            if isinstance(node.target, ast.Name):
                if self._device(node.value):
                    self.device.add(node.target.id)
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            if self.traced:
                kind = ("global" if isinstance(node, ast.Global)
                        else "nonlocal")
                self._add("JIT104", node,
                          f"{kind} statement in traced code: the "
                          "rebind happens once at trace time, not per "
                          "call",
                          "return the value and thread it through the "
                          "jitted function's outputs")
        elif isinstance(node, ast.If):
            self._check_branch(node, "if")
            self._exprs(node.test)
            for sub in node.body + node.orelse:
                self._stmt(sub)
        elif isinstance(node, ast.While):
            self._check_branch(node, "while")
            self._exprs(node.test)
            for sub in node.body + node.orelse:
                self._stmt(sub)
        elif isinstance(node, ast.For):
            self._check_for(node)
            self._exprs(node.iter)
            self._taint_target(node.target, self._device(node.iter),
                               node.iter)
            for sub in node.body + node.orelse:
                self._stmt(sub)
        elif isinstance(node, ast.With):
            for item in node.items:
                self._exprs(item.context_expr)
            for sub in node.body:
                self._stmt(sub)
        elif isinstance(node, ast.Try):
            for sub in (node.body + node.orelse + node.finalbody):
                self._stmt(sub)
            for h in node.handlers:
                for sub in h.body:
                    self._stmt(sub)
        elif isinstance(node, (ast.Return, ast.Expr)):
            if node.value is not None:
                self._exprs(node.value)
        elif isinstance(node, ast.Raise):
            pass        # error paths abort tracing; casts in messages ok
        else:
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, ast.stmt):
                    self._stmt(sub)
                elif isinstance(sub, ast.expr):
                    self._exprs(sub)

    def _taint_target(self, tgt: ast.AST, dev: bool,
                      value: ast.AST) -> None:
        if isinstance(tgt, ast.Name):
            if dev:
                self.device.add(tgt.id)
            else:
                self.device.discard(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(tgt.elts):
                for t, v in zip(tgt.elts, value.elts):
                    self._taint_target(t, self._device(v), v)
            else:
                for t in tgt.elts:
                    self._taint_target(t, dev, value)

    def _check_branch(self, node, kw: str) -> None:
        if not self.traced:
            return
        test = node.test
        # `x is None` / `x is not None` are structure checks, static
        # under tracing.
        if isinstance(test, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return
        if self._device(test):
            self._add("JIT201", node,
                      f"`{kw}` on a traced value concretizes it "
                      "(ConcretizationTypeError or silent host sync)",
                      "use jnp.where / jax.lax.cond / jax.lax.select")

    def _check_for(self, node: ast.For) -> None:
        if not self.traced:
            return
        it = node.iter
        if isinstance(it, ast.Call):
            name = (_dotted(it.func) or "").split(".")[-1]
            if name == "range" and any(self._device(a)
                                       for a in it.args):
                self._add("JIT202", node,
                          "Python loop bounded by a traced value "
                          "retraces for every distinct bound",
                          "use jax.lax.scan / fori_loop with a static "
                          "bound, or hoist the bound out of the trace")
            if name in ("set", "frozenset"):
                self._add("JIT203", node,
                          "iterating a set while tracing: element order "
                          "is nondeterministic, so pytree/argument "
                          "order differs across processes",
                          "sort the elements or use a list/dict "
                          "(insertion-ordered)")
        if isinstance(it, ast.SetComp):
            self._add("JIT203", node,
                      "iterating a set comprehension while tracing",
                      "use a sorted list comprehension")

    def _exprs(self, node: ast.AST) -> None:
        """Scan an expression tree for sync sites and side effects."""
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            fname = _dotted(sub.func) or ""
            # bare print() only: jax.debug.print is the sanctioned
            # traced-code print and must stay clean
            if self.traced and isinstance(sub.func, ast.Name) \
                    and sub.func.id == "print":
                self._add("JIT103", sub,
                          "print() inside traced code fires at trace "
                          "time only",
                          "use jax.debug.print (or drop it)")
            if self.traced and fname.startswith("logging."):
                self._add("JIT103", sub,
                          "logging call inside traced code fires at "
                          "trace time only",
                          "log outside the jitted function")
            if (self.traced and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _MUTATORS
                    and isinstance(sub.func.value, ast.Name)
                    and sub.func.value.id not in self._local_names()):
                self._add("JIT104", sub,
                          f"mutating `.{sub.func.attr}()` on "
                          f"closure/module state "
                          f"`{sub.func.value.id}` inside traced code",
                          "return the value instead of mutating "
                          "enclosing state")
            kind = self._sync_kind(sub)
            if kind is not None:
                if self.traced:
                    rule = ("JIT102" if kind.endswith("()")
                            and kind[0] in "ifb" else "JIT101")
                    self._add(rule, sub,
                              f"{kind} forces a device→host sync "
                              "inside traced code",
                              "keep the value on device (jnp ops), or "
                              "move the sync outside the jitted "
                              "function")
                else:
                    self.sync_sites.append((sub, kind))

    def _local_names(self) -> Set[str]:
        """Names bound anywhere in this function (params + assigns)."""
        if not hasattr(self, "_locals_cache"):
            names: Set[str] = set()
            args = self.fn.node.args
            for a in (args.posonlyargs + args.args + args.kwonlyargs
                      + ([args.vararg] if args.vararg else [])
                      + ([args.kwarg] if args.kwarg else [])):
                names.add(a.arg)
            for sub in ast.walk(self.fn.node):
                if isinstance(sub, ast.Name) and isinstance(
                        sub.ctx, ast.Store):
                    names.add(sub.id)
                elif isinstance(sub, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    names.add(sub.name)
            self._locals_cache = names
        return self._locals_cache


def _check_static_argnames(fn: FnInfo) -> List[Finding]:
    """JIT301: static args must be hashable."""
    out: List[Finding] = []
    if not fn.jit_root or not fn.static_args:
        return out
    args = fn.node.args
    all_args = args.posonlyargs + args.args + args.kwonlyargs
    by_name = {a.arg: a for a in all_args}
    defaults = dict(zip([a.arg for a in all_args[len(all_args)
                                                 - len(args.defaults):]],
                        args.defaults))
    defaults.update({a.arg: d for a, d in zip(args.kwonlyargs,
                                              args.kw_defaults) if d})
    unhashable = ("List[", "Dict[", "Set[", "list[", "dict[", "set[",
                  "list", "dict", "set")
    for name in sorted(fn.static_args):
        a = by_name.get(name)
        ann = _ann_str(a.annotation) if a is not None else ""
        bad_ann = any(ann == u or ann.startswith(u) for u in unhashable
                      if u.endswith("["))
        bad_ann = bad_ann or ann in ("list", "dict", "set")
        d = defaults.get(name)
        bad_default = isinstance(d, (ast.List, ast.Dict, ast.Set))
        if bad_ann or bad_default:
            out.append(Finding(
                rule="JIT301", path=fn.module.path,
                line=fn.node.lineno, symbol=fn.qualname,
                message=f"static_argnames entry {name!r} is "
                        f"unhashable ({ann or 'mutable default'}): "
                        "jit raises TypeError or retraces per call",
                hint="use a tuple / frozen dataclass / NamedTuple for "
                     "static arguments"))
    return out


# --------------------------------------------------------------------------
# package entry points
# --------------------------------------------------------------------------

def _iter_py_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__",)]
        for f in sorted(filenames):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def index_package(package_root: str,
                  repo_root: Optional[str] = None
                  ) -> Dict[str, ModuleInfo]:
    """Parse every module under ``package_root`` (a directory that is
    itself the top-level package, e.g. ``.../senweaver_ide_tpu_torch``)."""
    repo_root = repo_root or os.path.dirname(
        os.path.abspath(package_root))
    pkg_name = os.path.basename(os.path.abspath(package_root))
    modules: Dict[str, ModuleInfo] = {}
    for path in _iter_py_files(package_root):
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        parts = os.path.relpath(path, os.path.dirname(
            os.path.abspath(package_root))).replace(os.sep, "/")
        modname = parts[:-3].replace("/", ".")
        if modname.endswith(".__init__"):
            modname = modname[: -len(".__init__")]
        assert modname.startswith(pkg_name)
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        try:
            modules[modname] = index_module(source, rel, modname)
        except SyntaxError as e:        # pragma: no cover
            raise SyntaxError(f"{rel}: {e}") from e
    return modules


def lint_modules(modules: Dict[str, ModuleInfo],
                 hot_modules: Sequence[str] = HOT_MODULES,
                 sync_budget: int = 1) -> List[Finding]:
    traced = traced_set(modules)
    findings: List[Finding] = []
    hot = set(hot_modules)
    for mi in modules.values():
        for fn in mi.functions.values():
            is_traced = (mi.path, fn.qualname) in traced
            findings.extend(_check_static_argnames(fn))
            checker = _FnChecker(fn, traced=is_traced, modules=modules)
            checker.run()
            findings.extend(checker.findings)
            if (not is_traced and mi.path in hot
                    and len(checker.sync_sites) > sync_budget):
                n = len(checker.sync_sites)
                for node, kind in checker.sync_sites:
                    findings.append(Finding(
                        rule="JIT110", path=mi.path,
                        line=getattr(node, "lineno", 0),
                        symbol=fn.qualname,
                        message=f"{kind}: one of {n} separate host "
                                f"syncs in hot path `{fn.qualname}` "
                                f"(budget {sync_budget} per step)",
                        hint="batch the transfers into one "
                             "jax.device_get((a, b, ...)) per step"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_source(source: str, path: str = "<snippet>.py", *,
                hot: bool = False,
                sync_budget: int = 1) -> List[Finding]:
    """Lint a standalone source string (unit-test surface). ``hot=True``
    applies the JIT110 sync budget to its host functions."""
    mi = index_module(source, path, "snippet")
    modules = {"snippet": mi}
    return lint_modules(modules,
                        hot_modules=(path,) if hot else (),
                        sync_budget=sync_budget)
