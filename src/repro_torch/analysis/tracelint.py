"""TraceLint for the eager port: host syncs inside its hot loops.

The JAX package's TraceLint walks what ``jax.jit``, ``lax.scan`` and
``shard_map`` reach.  The port jits nothing, so "traced" becomes "inside
a hot loop": a loop, comprehension or function marked in the source
with a ``# planecheck: hot-loop`` comment (on its first line or the
line above it), the counterpart of locklint's ``# guarded-by:``
annotation.  A marked loop's body (a comprehension's element and
conditions, a ``while``'s test) is hot; a marked function's whole body
is.  Every callee that a hot region calls and the analysis can resolve
inside the analyzed package (a module-level function through the alias
map, ``self.method``, a nested def, ``obj.method`` where the package
defines one method of that name) becomes hot in turn, as JAX's taint
follows ``lax.scan`` bodies and ``partial``; a function under
``functools.lru_cache`` or ``cache`` does not, since its body runs once
per key.

A value is a *tensor* when it comes from a ``torch.*`` call (but
``torch.cuda.*`` and a few metadata constructors), from a method of a
tensor, from ``.to()``/``.cuda()``, from a parameter or dataclass field
annotated ``torch.Tensor`` (or ``Optional[torch.Tensor]``), or from a
package function whose return is one (a per-function summary).  Shape
metadata (``.shape``, ``.ndim``, ``.dtype``, ``.device``, ``.size()``,
``.dim()``, ``.numel()``) is not a tensor, and ``.cpu()``, ``.numpy()``,
``.item()``, ``.tolist()`` hand back host values.  The rules, inside a
hot region:

* ``PC-H001`` host sync: ``.item()``/``.tolist()``/``.numpy()`` on a
  tensor, any ``.cpu()``, ``torch.cuda.synchronize()`` and any
  ``.synchronize()`` (a CUDA ``Event`` or ``Stream``).  JAX's T001.
* ``PC-H002`` host cast: ``float(t)``, ``int(t)``, ``bool(t)`` of a
  tensor.  JAX's T002.
* ``PC-H003`` Python control flow on a tensor's value: ``if``,
  ``while``, ``assert``, a ternary or a comprehension's condition.
  ``is None`` and membership tests do not fire.  JAX's T003.
* ``PC-H004`` a per-call host-to-device construction:
  ``torch.tensor(..., device=)``, ``torch.as_tensor(<host>, device=)``,
  and ``.to()``/``.cuda()`` of ``torch.from_numpy``, ``torch.tensor``
  or ``torch.as_tensor`` (the class of the rope table that once cost a
  llama decode step 32 of its 35 syncs).

JAX's T004-T007 have no eager counterpart.  Eager torch does not trace,
so nothing retraces (T007), and the one compile the port does, a kernel
library's build, is counted at run time (``runtime.record_trace``).
No sort or scatter runs inside a compiled XLA program, where T006's
cost lives: each is one kernel.  A numpy call on a tensor (T004) fails
on the card rather than syncing silently, and the port uses float64 on
purpose where XLA does (ROADMAP C6, C13), so T005 would only flag the
parity it is held to.

A designed sync is baselined with its justification
(``PLANECHECK_TORCH_BASELINE.json``), never silenced by widening a
rule; ``# planecheck: ignore[RULE]`` on or above a line suppresses one
finding.  Pure stdlib (``ast``); the module, alias and function
registry is a copy of ``repro.analysis.tracelint``'s.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Set

from .findings import Finding, relpath

_HOT_RE = re.compile(r"#\s*planecheck:\s*hot-loop\b")
_IGNORE_RE = re.compile(r"#\s*planecheck:\s*ignore\[([A-Z0-9-]+)\]")

# Attributes of a tensor that are host metadata.
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "nbytes", "itemsize", "names"}
# Methods of a tensor that return host metadata without a sync.
_META_METHODS = {"size", "dim", "numel", "nelement", "stride",
                 "element_size", "data_ptr", "is_contiguous", "get_device",
                 "storage_offset", "is_floating_point", "is_complex"}
# Builtins whose result is host metadata.
_STATIC_FUNCS = {"isinstance", "len", "type", "hasattr", "callable",
                 "id", "range", "repr", "issubclass", "getattr"}
_CAST_FUNCS = {"float", "int", "bool"}
# Methods that copy a tensor to the host: they sync when it is on a card.
_HOST_METHODS = {"item", "tolist", "numpy"}
# torch.* calls that return no tensor (and every torch.is_*, torch.get_*).
_TORCH_HOST = {"torch.device", "torch.dtype", "torch.Size", "torch.finfo",
               "torch.iinfo", "torch.no_grad", "torch.inference_mode",
               "torch.enable_grad"}
_CACHES = {"functools.lru_cache", "functools.cache"}
# Constructions from host data; with a device they copy per call.
_H2D_CTORS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}


# ---------------------------------------------------------------------------
# Module / function registry (as repro.analysis.tracelint's)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FuncInfo:
    module: "ModuleInfo"
    qualname: str
    node: ast.AST                        # FunctionDef | Lambda
    cls_name: Optional[str] = None
    parent: Optional["FuncInfo"] = None
    hot: bool = False                    # the whole body is hot
    cached: bool = False                 # its body runs once per key
    hot_loops: Set[int] = dataclasses.field(default_factory=set)
    param_taint: Dict[str, bool] = dataclasses.field(default_factory=dict)
    closure_taint: Set[str] = dataclasses.field(default_factory=set)
    returns_tensor: bool = False
    nested: Dict[str, "FuncInfo"] = dataclasses.field(default_factory=dict)

    @property
    def positional_params(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in list(a.posonlyargs) + list(a.args)]

    @property
    def all_params(self) -> List[str]:
        names = self.positional_params + [p.arg for p in
                                          self.node.args.kwonlyargs]
        if self.node.args.vararg:
            names.append(self.node.args.vararg.arg)
        if self.node.args.kwarg:
            names.append(self.node.args.kwarg.arg)
        return names


@dataclasses.dataclass
class ModuleInfo:
    name: str                           # dotted module name
    path: str                           # filesystem path
    tree: ast.Module
    lines: List[str]
    aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    top_funcs: Dict[str, FuncInfo] = dataclasses.field(default_factory=dict)
    class_methods: Dict[str, Dict[str, FuncInfo]] = dataclasses.field(
        default_factory=dict)
    # class name -> fields annotated as a tensor
    tensor_fields: Dict[str, Set[str]] = dataclasses.field(
        default_factory=dict)
    all_funcs: List[FuncInfo] = dataclasses.field(default_factory=list)
    by_node: Dict[int, FuncInfo] = dataclasses.field(default_factory=dict)

    def line_has_ignore(self, lineno: int, rule: str) -> bool:
        for ln in (lineno, lineno - 1):
            if 1 <= ln <= len(self.lines):
                m = _IGNORE_RE.search(self.lines[ln - 1])
                if m and m.group(1) in (rule, "ALL"):
                    return True
        return False

    def line_is_hot(self, lineno: int) -> bool:
        """A ``# planecheck: hot-loop`` pragma on the line or above it."""
        return any(1 <= ln <= len(self.lines) and
                   _HOT_RE.search(self.lines[ln - 1])
                   for ln in (lineno, lineno - 1))


def _dotted(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _module_name_for(path: str) -> str:
    """Dotted module name from the path, walking up ``__init__.py`` dirs."""
    path = os.path.abspath(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    d = os.path.dirname(path)
    while os.path.exists(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    if parts[0] == "__init__":
        parts = parts[1:]
    return ".".join(reversed(parts)) or os.path.basename(path)


def _collect_aliases(mod: ModuleInfo) -> None:
    pkg_parts = mod.name.split(".")

    def visit(stmts):
        for s in stmts:
            if isinstance(s, ast.Import):
                for a in s.names:
                    mod.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(s, ast.ImportFrom):
                if s.level:
                    base = pkg_parts[:-s.level] if s.level <= len(pkg_parts) \
                        else []
                    target = ".".join(base + ([s.module] if s.module else []))
                else:
                    target = s.module or ""
                for a in s.names:
                    if a.name == "*":
                        continue
                    mod.aliases[a.asname or a.name] = (
                        f"{target}.{a.name}" if target else a.name)
            elif isinstance(s, ast.Assign) and len(s.targets) == 1 and \
                    isinstance(s.targets[0], ast.Name):
                d = _dotted(s.value)
                if d:
                    resolved = resolve_dotted(mod, d)
                    if resolved:
                        mod.aliases[s.targets[0].id] = resolved
            elif isinstance(s, (ast.Try, ast.If)):
                visit(getattr(s, "body", []))
                visit(getattr(s, "orelse", []))
                for h in getattr(s, "handlers", []):
                    visit(h.body)
                visit(getattr(s, "finalbody", []))

    visit(mod.tree.body)


def resolve_dotted(mod: ModuleInfo, dotted: Optional[str]) -> Optional[str]:
    """Expand the leading component of ``dotted`` through the alias map."""
    if not dotted:
        return None
    head, _, rest = dotted.partition(".")
    target = mod.aliases.get(head, head)
    return f"{target}.{rest}" if rest else target


def _is_tensor_annotation(node: Optional[ast.AST]) -> bool:
    """``torch.Tensor``, ``Tensor`` or ``Optional[torch.Tensor]``."""
    if node is None:
        return False
    if isinstance(node, ast.Subscript) and _dotted(node.value) in (
            "Optional", "typing.Optional"):
        return _is_tensor_annotation(node.slice)
    return _dotted(node) in ("torch.Tensor", "Tensor")


class _Collector(ast.NodeVisitor):
    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.func_stack: List[FuncInfo] = []
        self.cls_stack: List[str] = []

    def _register(self, node, name: str) -> FuncInfo:
        parent = self.func_stack[-1] if self.func_stack else None
        cls = self.cls_stack[-1] if (self.cls_stack and not parent) else None
        qual = name
        if parent is not None:
            qual = f"{parent.qualname}.{name}"
        elif cls is not None:
            qual = f"{cls}.{name}"
        fi = FuncInfo(module=self.mod, qualname=qual, node=node,
                      cls_name=cls, parent=parent)
        self.mod.all_funcs.append(fi)
        self.mod.by_node[id(node)] = fi
        if parent is not None:
            parent.nested[name] = fi
        elif cls is not None:
            self.mod.class_methods.setdefault(cls, {})[name] = fi
        else:
            self.mod.top_funcs[name] = fi
        return fi

    def visit_ClassDef(self, node):
        self.mod.tensor_fields[node.name] = {
            s.target.id for s in node.body
            if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)
            and _is_tensor_annotation(s.annotation)}
        self.cls_stack.append(node.name)
        self.generic_visit(node)
        self.cls_stack.pop()

    def _visit_func(self, node, name):
        fi = self._register(node, name)
        decorators = getattr(node, "decorator_list", [])
        fi.cached = any(resolve_dotted(self.mod, _dotted(
            d.func if isinstance(d, ast.Call) else d)) in _CACHES
            for d in decorators)
        first = min([node.lineno] + [d.lineno for d in decorators])
        if not isinstance(node, ast.Lambda) and (
                self.mod.line_is_hot(node.lineno) or
                self.mod.line_is_hot(first)):
            fi.hot = True
        self.func_stack.append(fi)
        self.generic_visit(node)
        self.func_stack.pop()

    def visit_FunctionDef(self, node):
        self._visit_func(node, node.name)

    def visit_AsyncFunctionDef(self, node):
        self._visit_func(node, node.name)

    def visit_Lambda(self, node):
        self._visit_func(node, f"<lambda:{node.lineno}>")


def load_module(path: str) -> Optional[ModuleInfo]:
    try:
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        tree = ast.parse(src, filename=path)
    except (OSError, SyntaxError):
        return None
    mod = ModuleInfo(name=_module_name_for(path), path=path, tree=tree,
                     lines=src.splitlines())
    _collect_aliases(mod)
    _Collector(mod).visit(tree)
    for fi in mod.all_funcs:
        if isinstance(fi.node, ast.Lambda):
            continue
        for node in _walk_scope(fi.node):
            if isinstance(node, _LOOPS) and mod.line_is_hot(node.lineno):
                fi.hot_loops.add(id(node))
    return mod


def _walk_scope(node: ast.AST):
    """Yield nodes of one function/module scope in document order,
    not entering nested defs."""
    for n in ast.iter_child_nodes(node):
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        yield from _walk_scope(n)


def _python_files(paths: Sequence[str]) -> List[str]:
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for base, dirs, files in os.walk(p):
            dirs[:] = [d for d in dirs
                       if d not in ("__pycache__", ".git", ".tmp")]
            out.extend(os.path.join(base, f) for f in sorted(files)
                       if f.endswith(".py"))
    return out


_COMPS = (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)
_LOOPS = (ast.For, ast.While) + _COMPS


# ---------------------------------------------------------------------------
# The analysis engine
# ---------------------------------------------------------------------------

class HotLint:
    def __init__(self, paths: Sequence[str], root: Optional[str] = None):
        self.root = root or os.getcwd()
        self.modules: Dict[str, ModuleInfo] = {}
        for path in _python_files(paths):
            mod = load_module(path)
            if mod is not None:
                self.modules[mod.name] = mod
        self.findings: List[Finding] = []
        self._changed = False
        # method name -> the package's methods of that name
        self.methods: Dict[str, List[FuncInfo]] = {}
        for mod in self.modules.values():
            for meths in mod.class_methods.values():
                for name, fi in meths.items():
                    self.methods.setdefault(name, []).append(fi)

    def _funcs(self):
        for mod in self.modules.values():
            yield from mod.all_funcs

    def run(self) -> List[Finding]:
        # Every function is walked for its return summary; hot regions
        # also make their callees hot and carry argument taint into them.
        for _ in range(12):
            self._changed = False
            for fi in self._funcs():
                _Walker(self, fi, emit=False).walk()
            if not self._changed:
                break
        for fi in self._funcs():
            if fi.hot or fi.hot_loops:
                _Walker(self, fi, emit=True).walk()
        return self.findings

    # -- resolution ---------------------------------------------------------
    def resolve_callable(self, mod: ModuleInfo, fi: Optional[FuncInfo],
                         node: ast.AST) -> Optional[FuncInfo]:
        if isinstance(node, ast.Lambda):
            return mod.by_node.get(id(node))
        dotted = _dotted(node)
        if dotted is None:
            return None
        if "." not in dotted:
            return self._lookup_name(mod, fi, dotted)
        head, _, rest = dotted.partition(".")
        if head in ("self", "cls") and fi is not None and "." not in rest:
            owner = fi
            while owner.parent is not None:
                owner = owner.parent
            if owner.cls_name:
                return mod.class_methods.get(owner.cls_name, {}).get(rest)
            return None
        resolved = resolve_dotted(mod, dotted)
        if resolved:
            mmod, _, func = resolved.rpartition(".")
            target = self.modules.get(mmod)
            if target and func in target.top_funcs:
                return target.top_funcs[func]
            if target is None:
                # obj.method: the package's one method of that name
                found = self.methods.get(func, [])
                if len(found) == 1:
                    return found[0]
        return None

    def _lookup_name(self, mod: ModuleInfo, fi: Optional[FuncInfo],
                     name: str) -> Optional[FuncInfo]:
        f = fi
        while f is not None:
            if name in f.nested:
                return f.nested[name]
            f = f.parent
        if name in mod.top_funcs:
            return mod.top_funcs[name]
        target = mod.aliases.get(name)
        if target:
            mmod, _, func = target.rpartition(".")
            tm = self.modules.get(mmod)
            if tm and func in tm.top_funcs:
                return tm.top_funcs[func]
        return None

    def class_fields(self, mod: ModuleInfo,
                     annotation: Optional[ast.AST]) -> Set[str]:
        """Tensor fields of the package class an annotation names."""
        dotted = _dotted(annotation) if annotation is not None else None
        if dotted is None:
            return set()
        if dotted in mod.tensor_fields:
            return mod.tensor_fields[dotted]
        resolved = resolve_dotted(mod, dotted) or ""
        mmod, _, cls = resolved.rpartition(".")
        target = self.modules.get(mmod)
        return target.tensor_fields.get(cls, set()) if target else set()

    # -- propagation ----------------------------------------------------------
    def make_hot(self, callee: FuncInfo, node: ast.Call,
                 arg_taints: List[bool], kw_taints: Dict[str, bool]) -> None:
        if not callee.hot:
            callee.hot = True
            self._changed = True
        pos = callee.positional_params
        skip = 1 if (pos[:1] in (["self"], ["cls"]) and
                     isinstance(node.func, ast.Attribute)) else 0
        for i, taint in enumerate(arg_taints):
            idx = i + skip
            if idx < len(pos):
                self._taint_param(callee, pos[idx], taint)
            elif callee.node.args.vararg:
                self._taint_param(callee, callee.node.args.vararg.arg, taint)
        for name, taint in kw_taints.items():
            if name in callee.all_params:
                self._taint_param(callee, name, taint)

    def _taint_param(self, fi: FuncInfo, name: str, taint: bool) -> None:
        if taint and not fi.param_taint.get(name):
            fi.param_taint[name] = True
            self._changed = True

    def report(self, fi: FuncInfo, node: ast.AST, rule: str, message: str,
               hint: str = "") -> None:
        line = getattr(node, "lineno", 1)
        if fi.module.line_has_ignore(line, rule):
            return
        f = Finding(
            rule=rule, file=relpath(fi.module.path, self.root), line=line,
            symbol=fi.qualname, message=message, hint=hint)
        if f not in self.findings:
            self.findings.append(f)


# ---------------------------------------------------------------------------
# Per-function taint walk
# ---------------------------------------------------------------------------

class _Walker:
    def __init__(self, engine: HotLint, fi: FuncInfo, emit: bool):
        self.engine = engine
        self.fi = fi
        self.mod = fi.module
        self.emit = emit
        self.hot = 1 if fi.hot else 0
        self.env: Dict[str, bool] = {}
        self.fields: Dict[str, Set[str]] = {}   # name -> its tensor fields
        node = fi.node
        if not isinstance(node, ast.Lambda):
            a = node.args
            for p in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
                self.env[p.arg] = _is_tensor_annotation(p.annotation)
                fields = engine.class_fields(self.mod, p.annotation)
                if fields:
                    self.fields[p.arg] = fields
        for name, t in fi.param_taint.items():
            self.env[name] = self.env.get(name, False) or t
        for name in fi.closure_taint:
            self.env.setdefault(name, True)

    def walk(self) -> None:
        node = self.fi.node
        if isinstance(node, ast.Lambda):
            self.ret(self.ev(node.body))
            return
        self.block(node.body)

    def ret(self, taint: bool) -> None:
        if taint and not self.fi.returns_tensor:
            self.fi.returns_tensor = True
            self.engine._changed = True

    def flag(self, node: ast.AST, rule: str, message: str,
             hint: str = "") -> None:
        if self.emit and self.hot:
            self.engine.report(self.fi, node, rule, message, hint)

    def block(self, stmts) -> None:
        for s in stmts:
            self.stmt(s)

    # -- statements ---------------------------------------------------------
    def stmt(self, s: ast.stmt) -> None:
        marked = id(s) in self.fi.hot_loops
        if isinstance(s, ast.Assign):
            taint = self.ev(s.value)
            for t in s.targets:
                self.assign(t, taint, s.value)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self.assign(s.target, self.ev(s.value), s.value)
        elif isinstance(s, ast.AugAssign):
            taint = self.ev(s.value)
            if isinstance(s.target, ast.Name):
                self.env[s.target.id] = self.env.get(s.target.id,
                                                     False) or taint
        elif isinstance(s, ast.Expr):
            self.ev(s.value)
        elif isinstance(s, ast.Return):
            if s.value is not None:
                self.ret(self.ev(s.value))
        elif isinstance(s, ast.If):
            if self.ev(s.test):
                self.flag_branch(s, "if")
            self.block(s.body)
            self.block(s.orelse)
        elif isinstance(s, ast.While):
            self.hot += marked
            if self.ev(s.test):
                self.flag_branch(s, "while")
            self.block(s.body)
            self.hot -= marked
            self.block(s.orelse)
        elif isinstance(s, ast.For):
            self.assign(s.target, self.ev(s.iter), None)
            self.hot += marked
            self.block(s.body)
            self.hot -= marked
            self.block(s.orelse)
        elif isinstance(s, ast.Assert):
            if self.ev(s.test):
                self.flag_branch(s, "assert")
            if s.msg is not None:
                self.ev(s.msg)
        elif isinstance(s, ast.With):
            for item in s.items:
                taint = self.ev(item.context_expr)
                if item.optional_vars is not None:
                    self.assign(item.optional_vars, taint, None)
            self.block(s.body)
        elif isinstance(s, ast.Try):
            self.block(s.body)
            for h in s.handlers:
                self.block(h.body)
            self.block(s.orelse)
            self.block(s.finalbody)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested = self.mod.by_node.get(id(s))
            if nested is not None:
                snap = {n for n, t in self.env.items() if t}
                if not snap <= nested.closure_taint:
                    nested.closure_taint |= snap
                    self.engine._changed = True
        elif isinstance(s, ast.Raise):
            if s.exc is not None:
                self.ev(s.exc)

    def flag_branch(self, node: ast.AST, kind: str) -> None:
        self.flag(node, "PC-H003",
                  f"Python `{kind}` on a tensor's value waits for the device "
                  "every iteration",
                  hint="keep the decision on the device (torch.where), or "
                       "decide once outside the loop from host state")

    def assign(self, target: ast.AST, taint: bool,
               value: Optional[ast.AST]) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = taint
            self.fields.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and \
                    len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self.assign(t, self.ev(v), v)
            else:
                for t in target.elts:
                    self.assign(t, taint, None)
        elif isinstance(target, ast.Starred):
            self.assign(target.value, taint, None)

    # -- expressions ---------------------------------------------------------
    def ev(self, node: Optional[ast.AST]) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return self.env.get(node.id, False)
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            base = self.ev(node.value)
            if node.attr in _STATIC_ATTRS:
                return False
            if isinstance(node.value, ast.Name) and \
                    node.attr in self.fields.get(node.value.id, ()):
                return True
            return base
        if isinstance(node, ast.Subscript):
            return self.ev(node.value) | self.ev(node.slice)
        if isinstance(node, ast.Slice):
            return (self.ev(node.lower) | self.ev(node.upper)
                    | self.ev(node.step))
        if isinstance(node, ast.BinOp):
            return self.ev(node.left) | self.ev(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.ev(node.operand)
        if isinstance(node, ast.BoolOp):
            return self.boolop(node)
        if isinstance(node, ast.Compare):
            taints = [self.ev(node.left)] + [self.ev(c)
                                             for c in node.comparators]
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(taints)
        if isinstance(node, ast.IfExp):
            if self.ev(node.test):
                self.flag(node, "PC-H003",
                          "ternary on a tensor's value waits for the device",
                          hint="use torch.where")
            return self.ev(node.body) | self.ev(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any([self.ev(e) for e in node.elts])
        if isinstance(node, ast.Dict):
            return any([self.ev(v) for v in list(node.keys) +
                        list(node.values) if v is not None])
        if isinstance(node, ast.Starred):
            return self.ev(node.value)
        if isinstance(node, ast.Lambda):
            return False
        if isinstance(node, ast.NamedExpr):
            taint = self.ev(node.value)
            self.assign(node.target, taint, node.value)
            return taint
        if isinstance(node, ast.Call):
            return self.call(node)
        if isinstance(node, _COMPS):
            return self.comprehension(node)
        if isinstance(node, ast.Await):
            return self.ev(node.value)
        return False

    def boolop(self, node: ast.BoolOp) -> bool:
        """``isinstance(x, <host types>) and ...`` narrows ``x`` to a host
        value in the operands after the check."""
        saved = {}
        taint = False
        for v in node.values:
            taint |= self.ev(v)
            if isinstance(node.op, ast.And) and isinstance(v, ast.Call) \
                    and _dotted(v.func) == "isinstance" and \
                    len(v.args) == 2 and isinstance(v.args[0], ast.Name) \
                    and "Tensor" not in ast.unparse(v.args[1]):
                saved.setdefault(v.args[0].id, self.env.get(v.args[0].id))
                self.env[v.args[0].id] = False
        for name, t in saved.items():
            self.env[name] = bool(t)
        return taint

    def comprehension(self, node: ast.AST) -> bool:
        marked = int(id(node) in self.fi.hot_loops)
        for i, gen in enumerate(node.generators):
            self.assign(gen.target, self.ev(gen.iter), None)
            if i == 0:
                self.hot += marked     # the rest runs once per item
            for cond in gen.ifs:
                if self.ev(cond):
                    self.flag_branch(cond, "if")
        if isinstance(node, ast.DictComp):
            taint = self.ev(node.key) | self.ev(node.value)
        else:
            taint = self.ev(node.elt)
        self.hot -= marked
        return taint

    # -- calls ---------------------------------------------------------------
    def call(self, node: ast.Call) -> bool:
        arg_taints = [self.ev(a.value if isinstance(a, ast.Starred) else a)
                      for a in node.args]
        kw_taints = {kw.arg: self.ev(kw.value) for kw in node.keywords
                     if kw.arg}
        for kw in node.keywords:
            if kw.arg is None:
                self.ev(kw.value)
        any_taint = any(arg_taints) or any(kw_taints.values())
        fname = resolve_dotted(self.mod, _dotted(node.func)) or ""

        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            recv = self.ev(node.func.value)
            if attr == "synchronize" or fname == "torch.cuda.synchronize":
                self.flag(node, "PC-H001",
                          f"{fname or '.synchronize'}() waits for the device "
                          "inside a hot loop",
                          hint="order work with streams and events; wait "
                               "once outside the loop")
                return False
            if attr == "cpu" or (attr in _HOST_METHODS and recv):
                self.flag(node, "PC-H001",
                          f".{attr}() copies a tensor to the host and waits "
                          "for the device",
                          hint="keep the value on the device; read it back "
                               "once, after the loop")
                return False
            if attr in ("to", "cuda"):
                if isinstance(node.func.value, ast.Call) and resolve_dotted(
                        self.mod, _dotted(node.func.value.func)) in \
                        _H2D_CTORS:
                    self._flag_h2d(node)
                return True
            if recv:
                return attr not in _META_METHODS
        if fname in _CAST_FUNCS:
            if any_taint:
                self.flag(node, "PC-H002",
                          f"{fname}() of a tensor copies it to the host and "
                          "waits for the device",
                          hint="keep it a tensor, or take it from host "
                               "state outside the loop")
            return False
        if fname in _STATIC_FUNCS:
            return False
        if fname.startswith("numpy."):
            return False
        if fname in ("torch.tensor", "torch.as_tensor"):
            device = any(kw.arg == "device" for kw in node.keywords)
            if device and not (fname == "torch.as_tensor" and arg_taints and
                               arg_taints[0]):
                self._flag_h2d(node)
            return True
        if fname.startswith("torch."):
            base = fname.rpartition(".")[2]
            return not (fname.startswith("torch.cuda.") or
                        fname in _TORCH_HOST or
                        base.startswith(("is_", "get_")))

        callee = self.engine.resolve_callable(self.mod, self.fi, node.func)
        if callee is not None:
            if self.hot and callee is not self.fi and not callee.cached:
                self.engine.make_hot(callee, node, arg_taints, kw_taints)
            return callee.returns_tensor
        if isinstance(node.func, ast.Attribute):
            any_taint = any_taint or self.ev(node.func.value)
        return any_taint

    def _flag_h2d(self, node: ast.Call) -> None:
        self.flag(node, "PC-H004",
                  "a tensor built from host data on the device every "
                  "iteration (a host-to-device copy per call)",
                  hint="build it once and cache it per device (as "
                       "models.layers._frequency_table does), or keep "
                       "the value on the device")


def analyze_hot_loops(paths: Sequence[str],
                      root: Optional[str] = None) -> List[Finding]:
    """Run TraceLint over ``paths``; returns findings."""
    return HotLint(paths, root=root).run()
