"""LockLint: lock-acquisition graph + ``# guarded-by:`` field discipline
(a copy of ``repro.analysis.locklint``, its rules unchanged).

Model, in three steps, all pure ``ast``:

1. **Discovery** -- per class: lock attributes (``self.X =
   threading.Lock()/RLock()/Condition()``), thread attributes
   (``threading.Thread(...)`` assignments), and guarded fields declared
   with a trailing ``# guarded-by: <lock>`` comment on the assignment
   that introduces them (normally in ``__init__``).  Module-level
   ``_LOCK = threading.Lock()`` globals are tracked too.
2. **Summaries** -- a per-method fixpoint computes, for every method
   and top-level function, the set of locks it may acquire
   (transitively, through resolvable calls) and whether it may block
   (file I/O, ``time.sleep``, ``subprocess``, jit compilation, device
   sync, joining a thread).  ``self.m()`` resolves within the class;
   other ``obj.m()`` calls resolve by method name across all analyzed
   classes, *excluding* container-ish names (``append``, ``get``, ...)
   that would otherwise alias list/dict methods.
3. **Emission** -- a second walk tracks the locks held at each
   statement (``with self._lock:`` / ``.acquire()``), records
   held->acquired edges (including through callee summaries), and
   reports:

   * ``PC-L001`` -- a cycle in the global lock graph (two code paths
     acquiring the same pair of locks in opposite orders); self-loops
     are ignored (RLocks re-enter legally).
   * ``PC-L002`` -- a guarded field written, or mutated via
     ``append``/``pop``/... , with its declared lock not held
     (``__init__`` is exempt: the object is not yet shared).
   * ``PC-L003`` -- blocking work while holding any lock, directly or
     through a callee whose summary blocks.

Escape hatches: ``# locklint: holds <lock>`` on a ``def`` line asserts
a lock the analyzer cannot see (e.g. the caller holds it by contract);
``# planecheck: ignore[RULE]`` on or above a finding line suppresses
it; a ``guarded-by`` naming something that is not a known lock attr
(``join(_thread)``) is documentation-only and not enforced.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding, relpath
from .tracelint import (ModuleInfo, _dotted, _python_files, load_module,
                        resolve_dotted)

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition"}
_THREAD_CTORS = {"threading.Thread"}

#: dotted call targets that can block for unbounded / milliseconds+ time
_BLOCKING_CALLS = {
    "time.sleep": "time.sleep",
    "open": "file I/O (open)",
    "json.dump": "file I/O (json.dump)",
    "json.load": "file I/O (json.load)",
    "numpy.save": "file I/O (np.save)",
    "numpy.load": "file I/O (np.load)",
    "numpy.savez": "file I/O (np.savez)",
    "numpy.savez_compressed": "file I/O (np.savez_compressed)",
    "os.replace": "file I/O (os.replace)",
    "os.fsync": "file I/O (os.fsync)",
    "shutil.rmtree": "file I/O (shutil.rmtree)",
    "shutil.copy": "file I/O (shutil.copy)",
    "shutil.copy2": "file I/O (shutil.copy2)",
    "shutil.copytree": "file I/O (shutil.copytree)",
    "subprocess.run": "subprocess.run",
    "subprocess.Popen": "subprocess.Popen",
    "subprocess.check_output": "subprocess.check_output",
    "pickle.dump": "file I/O (pickle.dump)",
    "pickle.load": "file I/O (pickle.load)",
    "jax.jit": "jit compilation",
    "jax.block_until_ready": "device sync (jax.block_until_ready)",
    "jax.device_get": "device sync (jax.device_get)",
}

#: container/stdlib-ish method names excluded from cross-class resolution
_MUTATORS = {"append", "appendleft", "extend", "insert", "pop", "popleft",
             "remove", "clear", "update", "add", "discard", "setdefault",
             "popitem", "sort", "reverse"}
_GENERIC_METHODS = _MUTATORS | {
    "get", "items", "keys", "values", "copy", "read", "write", "close",
    "acquire", "release", "start", "join", "wait", "notify", "notify_all",
    "put", "index", "count", "split", "strip", "format", "encode",
    "decode", "item", "tolist", "mean", "sum", "astype", "reshape"}

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([\w().\[\]]+)")
_HOLDS_RE = re.compile(r"#\s*locklint:\s*holds\s+([\w.]+)")
_IGNORE_RE = re.compile(r"#\s*planecheck:\s*ignore\[([A-Z0-9-]+)\]")

MethodKey = Tuple[str, Optional[str], str]        # (module, class, method)


@dataclasses.dataclass
class ClassInfo:
    module: ModuleInfo
    name: str
    node: ast.ClassDef
    locks: Set[str] = dataclasses.field(default_factory=set)
    threads: Set[str] = dataclasses.field(default_factory=set)
    guarded: Dict[str, str] = dataclasses.field(default_factory=dict)
    methods: Dict[str, ast.FunctionDef] = dataclasses.field(
        default_factory=dict)

    def lock_id(self, attr: str) -> str:
        return f"{self.name}.{attr}"


@dataclasses.dataclass
class Summary:
    acquires: Set[str] = dataclasses.field(default_factory=set)
    blocks: Optional[str] = None       # reason string, None if non-blocking


class LockLint:
    def __init__(self, paths: Sequence[str], root: Optional[str] = None):
        self.root = root
        self.modules: Dict[str, ModuleInfo] = {}
        for path in _python_files(paths):
            mod = load_module(path)
            if mod is not None:
                self.modules[mod.name] = mod
        self.classes: Dict[Tuple[str, str], ClassInfo] = {}
        self.module_locks: Dict[str, Set[str]] = {}
        self.module_funcs: Dict[Tuple[str, str], ast.FunctionDef] = {}
        self.summaries: Dict[MethodKey, Summary] = {}
        self.method_index: Dict[str, List[MethodKey]] = {}
        self.edges: Dict[Tuple[str, str], Tuple[ModuleInfo, str, int]] = {}
        self.findings: List[Finding] = []
        self._discover()

    # -- discovery ----------------------------------------------------------
    def _discover(self) -> None:
        for mod in self.modules.values():
            self.module_locks[mod.name] = set()
            for stmt in mod.tree.body:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) and \
                        self._is_lock_ctor(mod, stmt.value):
                    self.module_locks[mod.name].add(stmt.targets[0].id)
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    self.module_funcs[(mod.name, stmt.name)] = stmt
            for stmt in mod.tree.body:
                if isinstance(stmt, ast.ClassDef):
                    self._discover_class(mod, stmt)
        for (mname, cname), ci in self.classes.items():
            for meth in ci.methods:
                if meth.startswith("__") or meth in _GENERIC_METHODS:
                    continue
                self.method_index.setdefault(meth, []).append(
                    (mname, cname, meth))

    def _is_lock_ctor(self, mod: ModuleInfo, node: ast.AST) -> bool:
        return isinstance(node, ast.Call) and \
            (resolve_dotted(mod, _dotted(node.func)) or "") in _LOCK_CTORS

    def _is_thread_ctor(self, mod: ModuleInfo, node: ast.AST) -> bool:
        return isinstance(node, ast.Call) and \
            (resolve_dotted(mod, _dotted(node.func)) or "") in _THREAD_CTORS

    def _discover_class(self, mod: ModuleInfo, node: ast.ClassDef) -> None:
        ci = ClassInfo(module=mod, name=node.name, node=node)
        self.classes[(mod.name, node.name)] = ci
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ci.methods[item.name] = item
                for sub in ast.walk(item):
                    tgt = None
                    if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                        tgt = sub.targets[0]
                    elif isinstance(sub, ast.AnnAssign):
                        tgt = sub.target
                    if not (isinstance(tgt, ast.Attribute) and
                            isinstance(tgt.value, ast.Name) and
                            tgt.value.id == "self"):
                        continue
                    value = getattr(sub, "value", None)
                    if value is not None and self._is_lock_ctor(mod, value):
                        ci.locks.add(tgt.attr)
                    if value is not None and self._is_thread_ctor(mod,
                                                                  value):
                        ci.threads.add(tgt.attr)
                    ann = getattr(sub, "annotation", None)
                    if ann is not None and "Thread" in ast.dump(ann):
                        ci.threads.add(tgt.attr)
                    end = getattr(sub, "end_lineno", sub.lineno) or \
                        sub.lineno
                    for ln in range(sub.lineno, min(end, len(mod.lines))
                                    + 1):
                        m = _GUARDED_RE.search(mod.lines[ln - 1])
                        if m:
                            ci.guarded[tgt.attr] = m.group(1)
                            break

    # -- summaries ----------------------------------------------------------
    def compute_summaries(self) -> None:
        keys: List[MethodKey] = []
        for (mname, cname), ci in self.classes.items():
            keys.extend((mname, cname, meth) for meth in ci.methods)
        keys.extend((mname, None, fname)
                    for (mname, fname) in self.module_funcs)
        for k in keys:
            self.summaries[k] = Summary()
        for _ in range(10):
            changed = False
            for k in keys:
                walker = _MethodWalker(self, k, emit=False)
                walker.walk()
                summ = self.summaries[k]
                if not walker.acquired <= summ.acquires:
                    summ.acquires |= walker.acquired
                    changed = True
                if walker.blocks and summ.blocks is None:
                    summ.blocks = walker.blocks
                    changed = True
            if not changed:
                break

    # -- the run ------------------------------------------------------------
    def run(self) -> List[Finding]:
        self.compute_summaries()
        for k in self.summaries:
            _MethodWalker(self, k, emit=True).walk()
        self._report_cycles()
        return self.findings

    def _report_cycles(self) -> None:
        graph: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            if a != b:
                graph.setdefault(a, set()).add(b)
        seen_cycles: Set[frozenset] = set()
        for start in sorted(graph):
            cyc = self._find_cycle(graph, start)
            if cyc is None or frozenset(cyc) in seen_cycles:
                continue
            seen_cycles.add(frozenset(cyc))
            pairs = list(zip(cyc, cyc[1:] + [cyc[0]]))
            mod, sym, line = self.edges.get(
                pairs[0], next(iter(self.edges.values())))
            chain = " -> ".join(cyc + [cyc[0]])
            sites = "; ".join(
                f"{a}->{b} at {self.edges[(a, b)][1]}"
                for a, b in pairs if (a, b) in self.edges)
            self._report(mod, sym, line, "PC-L001", chain,
                         f"lock-order inversion: {chain} ({sites})",
                         hint="pick one global order (tick -> plane -> "
                              "controller -> history) and acquire in "
                              "that order everywhere")

    def _find_cycle(self, graph: Dict[str, Set[str]],
                    start: str) -> Optional[List[str]]:
        path: List[str] = []
        on_path: Set[str] = set()
        visited: Set[str] = set()

        def dfs(n: str) -> Optional[List[str]]:
            path.append(n)
            on_path.add(n)
            for nxt in sorted(graph.get(n, ())):
                if nxt in on_path:
                    return path[path.index(nxt):]
                if nxt not in visited:
                    got = dfs(nxt)
                    if got is not None:
                        return got
            on_path.discard(n)
            visited.add(n)
            path.pop()
            return None

        return dfs(start)

    def _report(self, mod: ModuleInfo, symbol: str, line: int, rule: str,
                symbol_override: Optional[str], message: str,
                hint: str = "") -> None:
        if mod.line_has_ignore(line, rule):
            return
        f = Finding(
            rule=rule, file=relpath(mod.path, self.root), line=line,
            symbol=symbol_override or symbol, message=message, hint=hint)
        if not any(g.key == f.key and g.line == f.line
                   for g in self.findings):
            self.findings.append(f)


class _MethodWalker:
    def __init__(self, engine: LockLint, key: MethodKey, emit: bool):
        self.engine = engine
        self.key = key
        mname, cname, meth = key
        self.mod = engine.modules[mname]
        self.ci = engine.classes.get((mname, cname)) if cname else None
        self.node = (self.ci.methods[meth] if self.ci
                     else engine.module_funcs[(mname, meth)])
        self.symbol = f"{cname}.{meth}" if cname else meth
        self.emit = emit
        self.is_init = meth == "__init__"
        self.acquired: Set[str] = set()
        self.blocks: Optional[str] = None
        self.local_threads: Set[str] = set()
        self.held: List[str] = list(self._pragma_holds())

    def _pragma_holds(self) -> List[str]:
        line = self.mod.lines[self.node.lineno - 1] \
            if self.node.lineno <= len(self.mod.lines) else ""
        m = _HOLDS_RE.search(line)
        if not m:
            return []
        name = m.group(1)
        if "." in name:
            return [name]
        if self.ci and name in self.ci.locks:
            return [self.ci.lock_id(name)]
        return [name]

    # -- lock identification ------------------------------------------------
    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and self.ci and \
                expr.attr in self.ci.locks:
            return self.ci.lock_id(expr.attr)
        if isinstance(expr, ast.Name) and \
                expr.id in self.engine.module_locks.get(self.mod.name, ()):
            return f"{self.mod.name}.{expr.id}"
        return None

    def _thread_like(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self":
            if self.ci and expr.attr in self.ci.threads:
                return True
            return "thread" in expr.attr.lower()
        if isinstance(expr, ast.Name):
            return expr.id in self.local_threads or \
                "thread" in expr.id.lower()
        return False

    # -- walking ------------------------------------------------------------
    def walk(self) -> None:
        self.block(self.node.body)

    def block(self, stmts) -> None:
        for s in stmts:
            self.stmt(s)

    def _acquire(self, lock: str, node: ast.AST) -> int:
        for h in self.held:
            if h != lock:
                self.engine.edges.setdefault(
                    (h, lock), (self.mod, self.symbol, node.lineno))
        self.acquired.add(lock)
        self.held.append(lock)
        return 1

    def stmt(self, s: ast.stmt) -> None:
        if isinstance(s, ast.With):
            pushed = 0
            for item in s.items:
                lock = self._lock_of(item.context_expr)
                if lock is not None:
                    pushed += self._acquire(lock, s)
                else:
                    self.expr(item.context_expr)
            self.block(s.body)
            for _ in range(pushed):
                self.held.pop()
            return
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return                      # nested defs run later, not here
        if isinstance(s, ast.Assign):
            self.expr(s.value)
            if len(s.targets) == 1 and isinstance(s.targets[0], ast.Name) \
                    and self.engine._is_thread_ctor(self.mod, s.value):
                self.local_threads.add(s.targets[0].id)
            for t in s.targets:
                self.store(t, s)
            return
        if isinstance(s, ast.AugAssign):
            self.expr(s.value)
            self.store(s.target, s)
            return
        if isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self.expr(s.value)
                self.store(s.target, s)
            return
        if isinstance(s, ast.Expr):
            self.expr(s.value)
            return
        if isinstance(s, (ast.If, ast.While)):
            self.expr(s.test)
            self.block(s.body)
            self.block(s.orelse)
            return
        if isinstance(s, ast.For):
            self.expr(s.iter)
            self.block(s.body)
            self.block(s.orelse)
            return
        if isinstance(s, ast.Try):
            self.block(s.body)
            for h in s.handlers:
                self.block(h.body)
            self.block(s.orelse)
            self.block(s.finalbody)
            return
        if isinstance(s, ast.Return) and s.value is not None:
            self.expr(s.value)
            return
        if isinstance(s, ast.Raise) and s.exc is not None:
            self.expr(s.exc)
            return
        if isinstance(s, ast.Assert):
            self.expr(s.test)
            return

    def store(self, target: ast.AST, stmt: ast.stmt) -> None:
        """Check a write target against guarded-by declarations."""
        if isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                self.store(t, stmt)
            return
        attr = None
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self":
            attr = target.attr
        elif isinstance(target, ast.Subscript):
            base = target.value
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self":
                attr = base.attr
        if attr is not None:
            self._check_guard(attr, stmt)

    def _check_guard(self, attr: str, node: ast.AST) -> None:
        if not self.emit or self.is_init or self.ci is None:
            return
        guard = self.ci.guarded.get(attr)
        if guard is None or guard not in self.ci.locks:
            return                      # unknown guard = documentation only
        if self.ci.lock_id(guard) in self.held:
            return
        self.engine._report(
            self.mod, self.symbol, getattr(node, "lineno", 1), "PC-L002",
            None,
            f"self.{attr} is declared `# guarded-by: {guard}` but is "
            f"mutated without {self.ci.name}.{guard} held",
            hint=f"wrap the mutation in `with self.{guard}:` (or move it "
                 "into a method that already holds it)")

    def _blocking_reason(self, call: ast.Call) -> Optional[str]:
        fname = resolve_dotted(self.mod, _dotted(call.func)) or ""
        if fname in _BLOCKING_CALLS:
            return _BLOCKING_CALLS[fname]
        if isinstance(call.func, ast.Attribute):
            meth = call.func.attr
            recv = call.func.value
            if meth == "block_until_ready":
                return "device sync (.block_until_ready)"
            if meth == "join" and self._thread_like(recv):
                return "thread join"
            if meth in ("result", "get") and "future" in ast.dump(
                    recv).lower():
                return "future wait"
        return None

    def expr(self, node: Optional[ast.AST]) -> None:
        if node is None:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._call(sub)

    def _call(self, call: ast.Call) -> None:
        # in-place mutation of a guarded container: self.F.append(...)
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr in _MUTATORS:
            recv = call.func.value
            if isinstance(recv, ast.Attribute) and \
                    isinstance(recv.value, ast.Name) and \
                    recv.value.id == "self":
                self._check_guard(recv.attr, call)
        reason = self._blocking_reason(call)
        if reason is not None:
            if self.blocks is None:
                self.blocks = reason
            if self.held and self.emit:
                self.engine._report(
                    self.mod, self.symbol, call.lineno, "PC-L003", None,
                    f"blocking work ({reason}) while holding "
                    f"{', '.join(self.held)}",
                    hint="prepare outside the lock, commit inside "
                         "(the prewarm-outside/swap-inside discipline)")
            return

        # explicit .acquire() -- held for the remainder of the method
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr == "acquire":
            lock = self._lock_of(call.func.value)
            if lock is not None:
                self._acquire(lock, call)
                return

        for summ in self._resolve(call):
            if summ.blocks is not None:
                if self.blocks is None:
                    self.blocks = summ.blocks
                if self.held and self.emit:
                    self.engine._report(
                        self.mod, self.symbol, call.lineno, "PC-L003",
                        None,
                        f"call may block ({summ.blocks}) while holding "
                        f"{', '.join(self.held)}",
                        hint="hoist the blocking call out of the locked "
                             "region")
            for lock in summ.acquires:
                for h in self.held:
                    if h != lock:
                        self.engine.edges.setdefault(
                            (h, lock), (self.mod, self.symbol,
                                        call.lineno))

    def _resolve(self, call: ast.Call) -> List[Summary]:
        """Summaries of the callee(s), if resolvable."""
        func = call.func
        out: List[Summary] = []
        if isinstance(func, ast.Name):
            key = (self.mod.name, None, func.id)
            if key in self.engine.summaries:
                out.append(self.engine.summaries[key])
            else:
                target = resolve_dotted(self.mod, func.id) or ""
                mname, _, fname = target.rpartition(".")
                key = (mname, None, fname)
                if key in self.engine.summaries:
                    out.append(self.engine.summaries[key])
            return out
        if not isinstance(func, ast.Attribute):
            return out
        meth = func.attr
        recv = func.value
        # self.m() -- precise, in-class
        if isinstance(recv, ast.Name) and recv.id == "self" and self.ci:
            key = (self.mod.name, self.ci.name, meth)
            if key in self.engine.summaries:
                out.append(self.engine.summaries[key])
            return out
        # lock-object methods (cv.wait / lock.release) are not user code
        if self._lock_of(recv) is not None:
            return out
        # obj.m() -- by-name union across analyzed classes
        for key in self.engine.method_index.get(meth, ()):
            out.append(self.engine.summaries[key])
        return out


def analyze_locks(paths: Sequence[str],
                  root: Optional[str] = None) -> List[Finding]:
    """Run LockLint over ``paths``; returns findings."""
    return LockLint(paths, root=root).run()
