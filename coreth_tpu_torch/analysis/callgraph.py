"""Whole-repo call graph + lock-flow linker (the interprocedural layer).

Single-file AST rules (SA001–SA012) cannot see a lock-order inversion
between `core/blockchain.py` and `core/insert_pipeline.py`, or a
chainmu-taking method reached *transitively* from the read tier.  This
module makes the analyzer see the whole program in two phases:

1. **Extraction** (`extract_file`) — one pass per file producing a
   `FileGraph`: plain-data records (no AST references) of every
   function's call sites, lock acquisitions with the raw held-set at
   each site, lazy imports, and hard-impurity sites.  FileGraphs are
   picklable on purpose: the engine caches them per file keyed by
   (mtime, size), so warm lint runs never re-parse.

2. **Linking** (`build_program`) — resolves raw references across files
   into a `Program`: call edges (self-dispatch through the class/base
   chain, constructor-typed attributes, module aliases, unique-method
   fallback — the same name-based conventions SA010 half-implemented),
   canonical lock identities, per-function may-acquire summaries
   (fixed point over the call graph, with provenance so every derived
   fact can print a witness chain), the global lock-order edge set, and
   cycle detection over it.

Canonical lock identity: a raw expression like `chain.chainmu` or
`self._mu` resolves to `OwnerClass.attr` (`BlockChain.chainmu`,
`InsertPipeline._mu`) via the lock registry — every `self.<attr> =
threading.Lock()/RLock()/Condition()` assignment in the repo.  A lock
attr defined by exactly one class resolves from any receiver; generic
names (`lock`, `_mu`, `_lock`) defined by many classes resolve only
when the receiver's class is known (enclosing class for `self.`,
constructor/annotation-typed attributes, curated receiver-name hints),
otherwise the site is dropped from the order graph rather than risk a
bogus unification cycle.  Module-level locks canonicalize to
`module:NAME`.

Known blind spots (documented in ANALYSIS.md): calls through locals or
containers, `getattr` dispatch, `.acquire()` without a `with` does not
extend the held scope (it still records the acquisition edge), and
decorator-synthesized methods.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

# ------------------------------------------------------------ shared tables

# lock-like attribute names (same heuristic as SA002's `_is_lock_name`)
LOCK_ATTR_HINTS = ("lock", "mu", "cond", "_cv")

LOCK_CTORS = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition",
}

# Hard per-call impurities for the interprocedural SA003 promotion (the
# single-file rule keeps richer observability checks; transitive callees
# are held to the unarguable subset: wall clock, randomness, ctypes
# allocation).  rules.py re-exports these so there is one source table.
WALLCLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow",
}
RANDOM_ROOTS = ("random.", "np.random.", "numpy.random.", "secrets.")
CTYPES_ALLOC = {"ctypes.create_string_buffer", "ctypes.create_unicode_buffer",
                "create_string_buffer", "create_unicode_buffer"}

REPO_ROOT_PACKAGE = "coreth_tpu_torch"

# receiver-name → class hints for locks/calls through untyped locals
# (name-based, like SA010's `"chain" in recv` convention); a hint only
# applies when the named class exists in the linked program
RECEIVER_HINTS = {
    "chain": "BlockChain",
    "blockchain": "BlockChain",
    "pipeline": "InsertPipeline",
    "snaps": "Tree",
    "txpool": "TxPool",
}

# method names too generic for the unique-definition fallback — a call
# `obj.run()` through an untyped local must not resolve just because one
# repo class happens to define `run`
GENERIC_METHOD_NAMES = frozenset({
    "run", "close", "get", "put", "set", "add", "pop", "start", "stop",
    "send", "recv", "read", "write", "update", "commit", "reset", "clear",
    "append", "items", "keys", "values", "acquire", "release", "check",
    "flush", "join", "wait", "notify", "notify_all", "submit", "result",
    "done", "cancel", "shutdown", "copy", "encode", "decode", "hash",
    "root", "state", "name", "size", "next", "step", "apply", "load",
    "store", "open", "delete", "remove", "insert", "push", "emit",
})

_MAX_WITNESS_DEPTH = 12


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_lock_attr(attr: str) -> bool:
    low = attr.lower()
    return any(h in low for h in LOCK_ATTR_HINTS)


def _impure_kind(name: str) -> Optional[str]:
    if name in WALLCLOCK_CALLS:
        return "wall-clock"
    if any(name.startswith(r) for r in RANDOM_ROOTS):
        return "randomness"
    if name in CTYPES_ALLOC:
        return "ctypes-alloc"
    return None


def module_name(relpath: str) -> str:
    """'coreth_tpu_torch/core/blockchain.py' -> 'coreth_tpu_torch.core.blockchain'."""
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = [s for s in p.split("/") if s]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or "<anon>"


# --------------------------------------------------------- per-file records

@dataclass(frozen=True)
class CallRef:
    target: str                # raw dotted call expr ("self.chain.accept")
    line: int
    held: Tuple[str, ...]      # raw lock exprs held at the call site


@dataclass(frozen=True)
class AcquireRef:
    lock: str                  # raw dotted lock expr ("self.chainmu")
    line: int
    held: Tuple[str, ...]      # raw lock exprs already held
    scoped: bool = True        # with-statement (True) vs bare .acquire()


@dataclass(frozen=True)
class LazyImport:
    module: str                # resolved dotted repo module
    line: int


@dataclass(frozen=True)
class ImpureSite:
    kind: str                  # "wall-clock" | "randomness" | "ctypes-alloc"
    name: str                  # the call as written
    line: int


@dataclass
class FuncRec:
    qualname: str              # "Class.method" / "fn" (matches Finding keys)
    name: str
    cls: Optional[str]         # enclosing class name (None for functions)
    line: int
    hot: bool = False
    entry_locks: Tuple[str, ...] = ()       # raw exprs from `# guarded-by:`
    calls: Tuple[CallRef, ...] = ()
    acquires: Tuple[AcquireRef, ...] = ()
    lazy_imports: Tuple[LazyImport, ...] = ()
    impure: Tuple[ImpureSite, ...] = ()
    # function-scope import bindings (lazy imports), same shape as the
    # module-level maps; consulted first during call resolution
    mod_aliases: Dict[str, str] = field(default_factory=dict)
    sym_aliases: Dict[str, Tuple[str, str]] = field(default_factory=dict)


@dataclass
class ClassRec:
    name: str                  # possibly dotted for nested classes
    bases: Tuple[str, ...] = ()             # raw base expressions
    attr_types: Dict[str, str] = field(default_factory=dict)  # attr -> raw cls
    lock_attrs: Tuple[str, ...] = ()        # attrs assigned a Lock/RLock/Cond


@dataclass
class FileGraph:
    relpath: str
    module: str
    is_pkg: bool = False
    mod_aliases: Dict[str, str] = field(default_factory=dict)
    sym_aliases: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    module_imports: Tuple[Tuple[str, int], ...] = ()  # repo-internal, modscope
    classes: Dict[str, ClassRec] = field(default_factory=dict)
    module_locks: Tuple[str, ...] = ()
    funcs: Tuple[FuncRec, ...] = ()


# -------------------------------------------------------------- extraction

class _ImportCollector:
    """Shared import-binding logic for module scope and function scope."""

    def __init__(self, module: str, is_pkg: bool):
        self.module = module
        self.is_pkg = is_pkg
        self.mod_aliases: Dict[str, str] = {}
        self.sym_aliases: Dict[str, Tuple[str, str]] = {}
        self.internal: List[Tuple[str, int]] = []

    def _rel_base(self, level: int) -> str:
        parts = self.module.split(".")
        drop = level - 1 if self.is_pkg else level
        if drop > 0:
            parts = parts[: max(0, len(parts) - drop)]
        return ".".join(parts)

    def add(self, node: ast.AST) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    self.mod_aliases[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    self.mod_aliases.setdefault(root, root)
                if a.name.split(".")[0] == REPO_ROOT_PACKAGE:
                    self.internal.append((a.name, node.lineno))
        elif isinstance(node, ast.ImportFrom):
            if node.level > 0:
                base = self._rel_base(node.level)
                target = f"{base}.{node.module}" if node.module else base
            else:
                target = node.module or ""
            if not target:
                return
            internal = target.split(".")[0] == REPO_ROOT_PACKAGE
            if internal:
                self.internal.append((target, node.lineno))
            for a in node.names:
                if a.name == "*":
                    continue
                # `from pkg import sub` may bind a submodule; the linker
                # decides (it knows which dotted names are modules), and
                # the closure pass trims `pkg.symbol` back to the longest
                # real module prefix — so record the full candidate too
                if internal:
                    self.internal.append((f"{target}.{a.name}", node.lineno))
                self.sym_aliases[a.asname or a.name] = (target, a.name)


class _FuncWalker(ast.NodeVisitor):
    """One function body: held-lock scopes, call/acquire/import/impure
    sites.  Nested defs and lambdas fold into the enclosing record with
    the held set reset (a closure runs later, on some other thread)."""

    def __init__(self, src, module: str, is_pkg: bool, cls: Optional[str],
                 held: Sequence[str]):
        self.src = src
        self.module = module
        self.is_pkg = is_pkg
        self.cls = cls
        self.held: List[str] = list(held)
        self.calls: List[CallRef] = []
        self.acquires: List[AcquireRef] = []
        self.lazy: List[LazyImport] = []
        self.impure: List[ImpureSite] = []
        self.imports = _ImportCollector(module, is_pkg)
        self.attr_types: Dict[str, str] = {}
        self.attr_locks: Set[str] = set()

    # -- lock scopes -----------------------------------------------------
    def _visit_with(self, node) -> None:
        got = 0
        for item in node.items:
            d = _dotted(item.context_expr)
            if d is not None and _is_lock_attr(d.rsplit(".", 1)[-1]):
                self.acquires.append(AcquireRef(
                    d, item.context_expr.lineno, tuple(self.held), True))
                self.held.append(d)
                got += 1
            elif isinstance(item.context_expr, ast.Call):
                self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        if got:
            del self.held[len(self.held) - got:]

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    # -- nested defs -----------------------------------------------------
    def _visit_func(self, node) -> None:
        lock, _hot = self.src.def_annotation(node)
        entry = [self._entry_raw(lock)] if lock else []
        inner = _FuncWalker(self.src, self.module, self.is_pkg,
                            self.cls, entry)
        for stmt in node.body:
            inner.visit(stmt)
        self._merge(inner)

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Lambda(self, node: ast.Lambda) -> None:
        inner = _FuncWalker(self.src, self.module, self.is_pkg, self.cls, ())
        inner.visit(node.body)
        self._merge(inner)

    def _merge(self, inner: "_FuncWalker") -> None:
        self.calls.extend(inner.calls)
        self.acquires.extend(inner.acquires)
        self.lazy.extend(inner.lazy)
        self.impure.extend(inner.impure)
        self.imports.mod_aliases.update(inner.imports.mod_aliases)
        self.imports.sym_aliases.update(inner.imports.sym_aliases)
        self.attr_types.update(inner.attr_types)
        self.attr_locks.update(inner.attr_locks)

    def _entry_raw(self, lock: str) -> str:
        return f"self.{lock}" if self.cls else lock

    # -- sites -----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        d = _dotted(node.func)
        if d is not None:
            last = d.rsplit(".", 1)[-1]
            if last == "acquire" and "." in d:
                recv = d[: -len(".acquire")]
                if _is_lock_attr(recv.rsplit(".", 1)[-1]):
                    self.acquires.append(AcquireRef(
                        recv, node.lineno, tuple(self.held), False))
            elif last != "release":
                self.calls.append(CallRef(d, node.lineno, tuple(self.held)))
                kind = _impure_kind(d)
                if kind:
                    self.impure.append(ImpureSite(kind, d, node.lineno))
        self.generic_visit(node)

    def visit_Import(self, node: ast.Import) -> None:
        self.imports.add(node)
        self._note_lazy(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        self.imports.add(node)
        self._note_lazy(node)

    def _note_lazy(self, node: ast.AST) -> None:
        while self.imports.internal:
            mod, line = self.imports.internal.pop()
            self.lazy.append(LazyImport(mod, line))

    # -- attribute typing (constructor / annotation inference) -----------
    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._note_attr(t, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        d = _dotted(node.target)
        if d is not None and d.startswith("self.") and d.count(".") == 1:
            attr = d.split(".", 1)[1]
            ann = self._ann_class(node.annotation)
            if ann:
                self.attr_types.setdefault(attr, ann)
        if node.value is not None:
            self._note_attr(node.target, node.value)
        self.generic_visit(node)

    def _note_attr(self, target: ast.AST, value: ast.AST) -> None:
        d = _dotted(target)
        if d is None or not d.startswith("self.") or d.count(".") != 1:
            return
        attr = d.split(".", 1)[1]
        if isinstance(value, ast.Call):
            ctor = _dotted(value.func)
            if ctor is None:
                return
            if ctor in LOCK_CTORS:
                self.attr_locks.add(attr)
            elif ctor.rsplit(".", 1)[-1][:1].isupper():
                self.attr_types.setdefault(attr, ctor)

    @staticmethod
    def _ann_class(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value if node.value[:1].isupper() else None
        if isinstance(node, ast.Subscript):  # Optional[X] / "X | None"
            return _FuncWalker._ann_class(node.slice)
        d = _dotted(node)
        if d and d.rsplit(".", 1)[-1][:1].isupper():
            return d
        return None


def _iter_module_stmts(body) -> Iterable[ast.stmt]:
    """Top-level statements, descending into module-level If/Try blocks
    (optional-dependency gating) but skipping TYPE_CHECKING-only arms."""
    for stmt in body:
        if isinstance(stmt, ast.If):
            test = _dotted(stmt.test) or ""
            if "TYPE_CHECKING" not in test:
                yield from _iter_module_stmts(stmt.body)
            yield from _iter_module_stmts(stmt.orelse)
        elif isinstance(stmt, ast.Try):
            yield from _iter_module_stmts(stmt.body)
            for h in stmt.handlers:
                yield from _iter_module_stmts(h.body)
            yield from _iter_module_stmts(stmt.orelse)
            yield from _iter_module_stmts(stmt.finalbody)
        else:
            yield stmt


def extract_file(src) -> FileGraph:
    """SourceFile -> FileGraph (plain data, picklable, AST-free)."""
    module = module_name(src.relpath)
    is_pkg = src.relpath.endswith("__init__.py")
    imports = _ImportCollector(module, is_pkg)
    classes: Dict[str, ClassRec] = {}
    module_locks: List[str] = []
    funcs: List[FuncRec] = []

    def do_func(node, cls: Optional[str], qualname: str) -> _FuncWalker:
        lock, hot = src.def_annotation(node)
        w = _FuncWalker(src, module, is_pkg, cls,
                        [f"self.{lock}" if cls else lock] if lock else [])
        for stmt in node.body:
            w.visit(stmt)
        funcs.append(FuncRec(
            qualname=qualname, name=node.name, cls=cls, line=node.lineno,
            hot=hot,
            entry_locks=tuple([f"self.{lock}" if cls else lock]
                              if lock else []),
            calls=tuple(w.calls), acquires=tuple(w.acquires),
            lazy_imports=tuple(w.lazy), impure=tuple(w.impure),
            mod_aliases=dict(w.imports.mod_aliases),
            sym_aliases=dict(w.imports.sym_aliases)))
        return w

    def do_class(node: ast.ClassDef, prefix: str) -> None:
        cname = f"{prefix}.{node.name}" if prefix else node.name
        bases = tuple(b for b in (_dotted(x) for x in node.bases) if b)
        attr_types: Dict[str, str] = {}
        lock_attrs: Set[str] = set()
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                w = do_func(item, cname, f"{cname}.{item.name}")
                attr_types.update(w.attr_types)
                lock_attrs.update(w.attr_locks)
            elif isinstance(item, ast.ClassDef):
                do_class(item, cname)
            elif isinstance(item, ast.AnnAssign):
                d = _dotted(item.target)
                ann = _FuncWalker._ann_class(item.annotation)
                if d and "." not in d and ann:
                    attr_types.setdefault(d, ann)
            elif isinstance(item, ast.Assign) and isinstance(
                    item.value, ast.Call):
                ctor = _dotted(item.value.func)
                if ctor in LOCK_CTORS:
                    for t in item.targets:
                        d = _dotted(t)
                        if d and "." not in d:
                            lock_attrs.add(d)
        classes[cname] = ClassRec(cname, bases, attr_types,
                                  tuple(sorted(lock_attrs)))

    for stmt in _iter_module_stmts(src.tree.body):
        if isinstance(stmt, (ast.Import, ast.ImportFrom)):
            imports.add(stmt)
        elif isinstance(stmt, ast.ClassDef):
            do_class(stmt, "")
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            do_func(stmt, None, stmt.name)
        elif isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            ctor = _dotted(stmt.value.func)
            if ctor in LOCK_CTORS:
                for t in stmt.targets:
                    d = _dotted(t)
                    if d and "." not in d:
                        module_locks.append(d)

    return FileGraph(
        relpath=src.relpath, module=module, is_pkg=is_pkg,
        mod_aliases=dict(imports.mod_aliases),
        sym_aliases=dict(imports.sym_aliases),
        module_imports=tuple(imports.internal),
        classes=classes, module_locks=tuple(module_locks),
        funcs=tuple(funcs))


# ------------------------------------------------------------------ linking

@dataclass
class FuncNode:
    key: str                   # "relpath:qualname" (Finding-key shaped)
    relpath: str
    module: str
    rec: FuncRec
    callees: List[Tuple[str, int, FrozenSet[str]]] = field(default_factory=list)
    unresolved: List[Tuple[str, int]] = field(default_factory=list)
    acquires: List[Tuple[str, int, FrozenSet[str], bool]] = field(
        default_factory=list)
    entry_locks: FrozenSet[str] = frozenset()
    callers: List[Tuple[str, int]] = field(default_factory=list)

    @property
    def qualname(self) -> str:
        return self.rec.qualname

    @property
    def line(self) -> int:
        return self.rec.line


@dataclass
class LockEdge:
    src: str                   # canonical lock held
    dst: str                   # canonical lock acquired under it
    witness: List[Tuple[str, int, str]]  # (func key, line, action)


@dataclass
class LockCycle:
    locks: List[str]
    edges: List[LockEdge]
    # every lock in the strongly connected component; the rendered
    # concrete cycle may be a shorter loop through it (transitive
    # may-acquire edges shortcut multi-hop chains)
    scc: List[str] = field(default_factory=list)

    def render(self, funcs: Dict[str, "FuncNode"]) -> str:
        lines = [" -> ".join(self.locks + [self.locks[0]])]
        if len(self.scc) > len(self.locks):
            lines.append(
                f"  (strongly connected with: {', '.join(self.scc)})")
        for e in self.edges:
            lines.append(f"  edge {e.src} -> {e.dst}:")
            for key, ln, action in e.witness:
                node = funcs.get(key)
                where = (f"{node.relpath}:{ln}" if node else f"?:{ln}")
                qn = node.qualname if node else key
                lines.append(f"    {qn} ({where}) {action}")
        return "\n".join(lines)


class Program:
    """The linked whole-repo view handed to Rule.finalize_program()."""

    def __init__(self, files: Dict[str, FileGraph]):
        self.files = files
        self.modules: Dict[str, str] = {fg.module: fg.relpath
                                        for fg in files.values()}
        # class name -> [(module, ClassRec)]; bare names (incl. nested
        # "Outer.Inner") — collisions resolved via import bindings
        self.class_index: Dict[str, List[Tuple[str, ClassRec]]] = {}
        # (module, class, method) -> func key; (module, func) -> key
        self.methods: Dict[Tuple[str, str, str], str] = {}
        self.mod_funcs: Dict[Tuple[str, str], str] = {}
        self.funcs: Dict[str, FuncNode] = {}
        # lock registry: attr -> [(kind, owner)] where owner is a class
        # display name or module dotted name
        self.lock_owners: Dict[str, List[Tuple[str, str]]] = {}
        self._method_defs: Dict[str, List[str]] = {}
        self._lock_summary: Optional[Dict[str, Dict[str, Tuple]]] = None
        self._lock_edges: Optional[Dict[Tuple[str, str], LockEdge]] = None
        self._index()
        self._link()

    # -- indexing --------------------------------------------------------
    def _index(self) -> None:
        for fg in self.files.values():
            for cname, crec in fg.classes.items():
                self.class_index.setdefault(cname, []).append(
                    (fg.module, crec))
            for fr in fg.funcs:
                key = f"{fg.relpath}:{fr.qualname}"
                node = FuncNode(key=key, relpath=fg.relpath,
                                module=fg.module, rec=fr)
                self.funcs[key] = node
                if fr.cls:
                    self.methods[(fg.module, fr.cls, fr.name)] = key
                    self._method_defs.setdefault(fr.name, []).append(key)
                else:
                    self.mod_funcs[(fg.module, fr.qualname)] = key
            for cname, crec in fg.classes.items():
                for attr in crec.lock_attrs:
                    self.lock_owners.setdefault(attr, []).append(
                        ("class", self._class_display(cname, fg.module)))
            for lname in fg.module_locks:
                self.lock_owners.setdefault(lname, []).append(
                    ("module", fg.module))
        for owners in self.lock_owners.values():
            owners.sort()

    def _class_display(self, cname: str, module: str) -> str:
        entries = self.class_index.get(cname, [])
        if len(entries) <= 1:
            return cname
        return f"{module}.{cname}"

    # -- class / method resolution --------------------------------------
    def _resolve_class(self, raw: str, fg: FileGraph,
                       fr: Optional[FuncRec] = None
                       ) -> Optional[Tuple[str, ClassRec]]:
        """Raw class expr from [fg]'s namespace -> (module, ClassRec)."""
        if not raw:
            return None
        parts = raw.split(".")
        sym = dict(fg.sym_aliases)
        mods = dict(fg.mod_aliases)
        if fr is not None:
            sym.update(fr.sym_aliases)
            mods.update(fr.mod_aliases)
        # strip a module-alias head: "mod.Class" / "pkg.mod.Class"
        if parts[0] in mods and len(parts) >= 2:
            target = mods[parts[0]]
            rest = parts[1:]
            for cut in range(len(rest) - 1, -1, -1):
                cand_mod = ".".join([target] + rest[:cut])
                cand_cls = ".".join(rest[cut:])
                if cand_mod in self.modules and cand_cls:
                    hit = self._class_in_module(cand_mod, cand_cls)
                    if hit:
                        return hit
            return None
        head = parts[0]
        if head in sym:
            tmod, tsym = sym[head]
            cand = ".".join([tsym] + parts[1:])
            sub = f"{tmod}.{tsym}"
            if sub in self.modules and len(parts) >= 2:
                hit = self._class_in_module(sub, ".".join(parts[1:]))
                if hit:
                    return hit
            hit = self._class_in_module(tmod, cand)
            if hit:
                return hit
            return None
        # same module
        hit = self._class_in_module(fg.module, raw)
        if hit:
            return hit
        # globally unique bare name
        entries = self.class_index.get(raw, [])
        if len(entries) == 1:
            return entries[0]
        return None

    def _class_in_module(self, module: str,
                         cname: str) -> Optional[Tuple[str, ClassRec]]:
        for mod, crec in self.class_index.get(cname, []):
            if mod == module:
                return (mod, crec)
        return None

    def _mro(self, module: str, crec: ClassRec,
             _seen=None) -> List[Tuple[str, ClassRec]]:
        if _seen is None:
            _seen = set()
        if (module, crec.name) in _seen:
            return []
        _seen.add((module, crec.name))
        out = [(module, crec)]
        fg = self.files.get(self.modules.get(module, ""), None)
        for braw in crec.bases:
            hit = self._resolve_class(braw, fg) if fg else None
            if hit:
                out.extend(self._mro(hit[0], hit[1], _seen))
        return out

    def _method_on(self, module: str, crec: ClassRec,
                   name: str) -> Optional[str]:
        for mod, c in self._mro(module, crec):
            key = self.methods.get((mod, c.name, name))
            if key:
                return key
        return None

    def _unique_method(self, name: str) -> Optional[str]:
        if name.startswith("__") or name in GENERIC_METHOD_NAMES:
            return None
        keys = self._method_defs.get(name, [])
        return keys[0] if len(keys) == 1 else None

    def _hinted_class(self, recv: str) -> Optional[Tuple[str, ClassRec]]:
        cname = RECEIVER_HINTS.get(recv)
        if cname is None:
            # auto hint: receiver name == class name lowercased
            for cand, entries in self.class_index.items():
                if cand.lower() == recv and len(entries) == 1:
                    return entries[0]
            return None
        entries = self.class_index.get(cname, [])
        return entries[0] if len(entries) == 1 else None

    # -- lock canonicalization -------------------------------------------
    def canonical_lock(self, raw: str, fg: FileGraph,
                       fr: Optional[FuncRec]) -> Optional[str]:
        parts = raw.split(".")
        attr = parts[-1]
        recv = parts[:-1]
        owners = self.lock_owners.get(attr, [])
        if not recv:
            # bare name: module-level lock (local module wins)
            if attr in fg.module_locks:
                return f"{fg.module}:{attr}"
            mods = [o for k, o in owners if k == "module"]
            if len(mods) == 1 and not any(k == "class" for k, _ in owners):
                return f"{mods[0]}:{attr}"
            # guarded-by annotation on a method names the attr bare;
            # fall through to owner resolution
        cls_owners = [o for k, o in owners if k == "class"]
        if len(cls_owners) == 1 and not recv:
            return f"{cls_owners[0]}.{attr}"
        if recv and recv[0] == "self" and fr is not None and fr.cls:
            if len(recv) == 1:
                hit = self._class_in_module(fg.module, fr.cls)
                if hit:
                    for mod, c in self._mro(hit[0], hit[1]):
                        if attr in c.lock_attrs:
                            return (f"{self._class_display(c.name, mod)}"
                                    f".{attr}")
            elif len(recv) == 2:
                hit = self._typed_attr(fg, fr, recv[1])
                if hit:
                    mod, c = hit
                    for m2, c2 in self._mro(mod, c):
                        if attr in c2.lock_attrs:
                            return (f"{self._class_display(c2.name, m2)}"
                                    f".{attr}")
        if recv and recv[-1] != "self":
            hit = self._hinted_class(recv[-1])
            if hit:
                mod, c = hit
                for m2, c2 in self._mro(mod, c):
                    if attr in c2.lock_attrs:
                        return f"{self._class_display(c2.name, m2)}.{attr}"
        if len(cls_owners) == 1:
            return f"{cls_owners[0]}.{attr}"
        return None

    def _typed_attr(self, fg: FileGraph, fr: FuncRec,
                    attr: str) -> Optional[Tuple[str, ClassRec]]:
        hit = self._class_in_module(fg.module, fr.cls) if fr.cls else None
        if not hit:
            return None
        for mod, c in self._mro(hit[0], hit[1]):
            raw = c.attr_types.get(attr)
            if raw:
                mfg = self.files.get(self.modules.get(mod, ""))
                return self._resolve_class(raw, mfg or fg, fr)
        return None

    # -- call resolution -------------------------------------------------
    def _resolve_call(self, fg: FileGraph, fr: FuncRec,
                      target: str) -> Optional[str]:
        parts = target.split(".")
        sym = dict(fg.sym_aliases)
        sym.update(fr.sym_aliases)
        mods = dict(fg.mod_aliases)
        mods.update(fr.mod_aliases)
        name = parts[-1]

        if parts[0] == "self" and fr.cls:
            hit = self._class_in_module(fg.module, fr.cls)
            if len(parts) == 2 and hit:
                return self._method_on(hit[0], hit[1], name)
            if len(parts) == 3 and hit:
                thit = self._typed_attr(fg, fr, parts[1])
                if thit:
                    return self._method_on(thit[0], thit[1], name)
            return self._fallback(parts)

        if len(parts) == 1:
            key = self.mod_funcs.get((fg.module, name))
            if key:
                return key
            if name in sym:
                tmod, tsym = sym[name]
                key = self.mod_funcs.get((tmod, tsym))
                if key:
                    return key
                hit = self._class_in_module(tmod, tsym)
                if hit:
                    return self._method_on(hit[0], hit[1], "__init__")
                sub = f"{tmod}.{tsym}"
                if sub in self.modules:
                    return None  # bare call of a module alias — not a call
            hit = self._class_in_module(fg.module, name)
            if hit:
                return self._method_on(hit[0], hit[1], "__init__")
            return None  # builtin / stdlib

        # dotted: module alias head?
        if parts[0] in mods:
            target_mod = mods[parts[0]]
            rest = parts[1:]
            for cut in range(len(rest) - 1, -1, -1):
                cand_mod = ".".join([target_mod] + rest[:cut])
                if cand_mod not in self.modules:
                    continue
                tail = rest[cut:]
                if len(tail) == 1:
                    key = self.mod_funcs.get((cand_mod, tail[0]))
                    if key:
                        return key
                    hit = self._class_in_module(cand_mod, tail[0])
                    if hit:
                        return self._method_on(hit[0], hit[1], "__init__")
                elif len(tail) == 2:
                    hit = self._class_in_module(cand_mod, tail[0])
                    if hit:
                        return self._method_on(hit[0], hit[1], tail[1])
                break
            return self._fallback(parts)

        if parts[0] in sym:
            tmod, tsym = sym[parts[0]]
            sub = f"{tmod}.{tsym}"
            if sub in self.modules:
                # `from pkg import sub` then sub.f() / sub.C.m()
                if len(parts) == 2:
                    key = self.mod_funcs.get((sub, parts[1]))
                    if key:
                        return key
                    hit = self._class_in_module(sub, parts[1])
                    if hit:
                        return self._method_on(hit[0], hit[1], "__init__")
                elif len(parts) == 3:
                    hit = self._class_in_module(sub, parts[1])
                    if hit:
                        return self._method_on(hit[0], hit[1], parts[2])
            hit = self._class_in_module(tmod, tsym)
            if hit and len(parts) == 2:
                return self._method_on(hit[0], hit[1], parts[1])
            return self._fallback(parts)

        return self._fallback(parts)

    def _fallback(self, parts: List[str]) -> Optional[str]:
        """Receiver-hint then unique-method resolution for calls through
        untyped locals (`chain.accept(...)`)."""
        if len(parts) < 2:
            return None
        name = parts[-1]
        hit = self._hinted_class(parts[-2])
        if hit:
            key = self._method_on(hit[0], hit[1], name)
            if key:
                return key
        return self._unique_method(name)

    # -- linking ---------------------------------------------------------
    def _link(self) -> None:
        for key in sorted(self.funcs):
            node = self.funcs[key]
            fg = self.files[node.relpath]
            fr = node.rec
            entry = set()
            for raw in fr.entry_locks:
                c = self.canonical_lock(raw, fg, fr)
                if c:
                    entry.add(c)
            node.entry_locks = frozenset(entry)

            def canon_held(held_raw: Tuple[str, ...]) -> FrozenSet[str]:
                out = set(entry)
                for raw in held_raw:
                    c = self.canonical_lock(raw, fg, fr)
                    if c:
                        out.add(c)
                return frozenset(out)

            for acq in fr.acquires:
                c = self.canonical_lock(acq.lock, fg, fr)
                if c:
                    node.acquires.append(
                        (c, acq.line, canon_held(acq.held), acq.scoped))
            for call in fr.calls:
                ck = self._resolve_call(fg, fr, call.target)
                if ck and ck != key:
                    node.callees.append((ck, call.line,
                                         canon_held(call.held)))
                elif ck is None:
                    node.unresolved.append((call.target, call.line))
        for key in sorted(self.funcs):
            for ck, line, _held in self.funcs[key].callees:
                self.funcs[ck].callers.append((key, line))

    # -- lock summaries / edges / cycles ---------------------------------
    def lock_summaries(self) -> Dict[str, Dict[str, Tuple]]:
        """key -> {lock -> provenance}; provenance is ("acq", line) or
        ("call", callee_key, line). May-acquire, transitively."""
        if self._lock_summary is not None:
            return self._lock_summary
        summary: Dict[str, Dict[str, Tuple]] = {
            key: {} for key in self.funcs}
        for key in sorted(self.funcs):
            for lock, line, _held, _scoped in self.funcs[key].acquires:
                summary[key].setdefault(lock, ("acq", line))
        changed = True
        while changed:
            changed = False
            for key in sorted(self.funcs):
                mine = summary[key]
                for ck, line, _held in self.funcs[key].callees:
                    for lock in summary[ck]:
                        if lock not in mine:
                            mine[lock] = ("call", ck, line)
                            changed = True
        self._lock_summary = summary
        return summary

    def _expand_witness(self, key: str, lock: str,
                        depth: int = 0) -> List[Tuple[str, int, str]]:
        if depth > _MAX_WITNESS_DEPTH:
            return [(key, 0, f"... (witness truncated at depth {depth})")]
        prov = self.lock_summaries()[key].get(lock)
        if prov is None:
            return []
        if prov[0] == "acq":
            return [(key, prov[1], f"acquires {lock}")]
        _kind, ck, line = prov
        callee = self.funcs[ck]
        return ([(key, line, f"calls {callee.qualname}")]
                + self._expand_witness(ck, lock, depth + 1))

    def lock_edges(self) -> Dict[Tuple[str, str], LockEdge]:
        """Observed lock-order edges: held -> acquired-under-it.  Edges
        to a lock already in the held set are skipped (RLock
        reentrancy), as are self-edges."""
        if self._lock_edges is not None:
            return self._lock_edges
        summary = self.lock_summaries()
        edges: Dict[Tuple[str, str], LockEdge] = {}

        def add(a: str, b: str, witness) -> None:
            if a == b:
                return
            if (a, b) not in edges:
                edges[(a, b)] = LockEdge(a, b, witness)

        for key in sorted(self.funcs):
            node = self.funcs[key]
            for lock, line, held, _scoped in node.acquires:
                for h in sorted(held):
                    if h != lock:
                        add(h, lock, [(key, line, f"acquires {lock}")])
            for ck, line, held in node.callees:
                if not held:
                    continue
                for lock in sorted(summary[ck]):
                    if lock in held:
                        continue
                    for h in sorted(held):
                        add(h, lock,
                            [(key, line,
                              f"calls {self.funcs[ck].qualname}")]
                            + self._expand_witness(ck, lock))
        self._lock_edges = edges
        return edges

    def lock_cycles(self) -> List[LockCycle]:
        """SCCs of size >= 2 in the lock-order graph, each rendered as a
        deterministic concrete cycle with per-edge witnesses."""
        edges = self.lock_edges()
        adj: Dict[str, List[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        for v in adj.values():
            v.sort()
        sccs = _tarjan(adj)
        out: List[LockCycle] = []
        for scc in sccs:
            if len(scc) < 2:
                continue
            nodes = sorted(scc)
            start = nodes[0]
            cycle = _cycle_through(adj, set(scc), start)
            if not cycle:
                continue
            cyc_edges = [edges[(cycle[i], cycle[(i + 1) % len(cycle)])]
                         for i in range(len(cycle))]
            out.append(LockCycle(cycle, cyc_edges, nodes))
        out.sort(key=lambda c: c.locks)
        return out

    def lock_order(self) -> List[str]:
        """Deterministic topological order of the lock-order graph
        (stable Kahn); only meaningful when lock_cycles() is empty."""
        edges = self.lock_edges()
        nodes = sorted({n for e in edges for n in e})
        indeg = {n: 0 for n in nodes}
        for (_a, b) in edges:
            indeg[b] += 1
        order: List[str] = []
        ready = sorted(n for n in nodes if indeg[n] == 0)
        while ready:
            n = ready.pop(0)
            order.append(n)
            for (a, b) in sorted(edges):
                if a == n:
                    indeg[b] -= 1
                    if indeg[b] == 0 and b not in order:
                        ready.append(b)
            ready.sort()
        return order

    # -- reachability ------------------------------------------------------
    def reachable(self, seeds: Iterable[str],
                  skip: Optional[Sequence[str]] = None
                  ) -> Dict[str, Tuple[Optional[str], int]]:
        """BFS over call edges from [seeds] (func keys).  Returns
        {key: (parent_key, call_line)}; seeds map to (None, 0).  [skip]:
        relpath prefixes never entered."""
        skip = tuple(skip or ())
        seen: Dict[str, Tuple[Optional[str], int]] = {}
        queue: List[str] = []
        for s in seeds:
            if s in self.funcs and s not in seen:
                seen[s] = (None, 0)
                queue.append(s)
        while queue:
            key = queue.pop(0)
            for ck, line, _held in self.funcs[key].callees:
                if ck in seen:
                    continue
                node = self.funcs[ck]
                if any(node.relpath.startswith(p) for p in skip):
                    continue
                seen[ck] = (key, line)
                queue.append(ck)
        return seen

    def chain_to(self, seen: Dict[str, Tuple[Optional[str], int]],
                 key: str) -> List[str]:
        """Render the BFS parent chain seed -> ... -> key as qualnames."""
        chain: List[str] = []
        cur: Optional[str] = key
        while cur is not None and len(chain) <= _MAX_WITNESS_DEPTH + 2:
            node = self.funcs[cur]
            chain.append(f"{node.qualname} ({node.relpath}:{node.line})")
            cur = seen[cur][0]
        return list(reversed(chain))

    # -- module import closure (SA011 promotion) --------------------------
    def module_scope_imports(self, module: str) -> List[Tuple[str, int]]:
        rel = self.modules.get(module)
        if rel is None:
            return []
        out = []
        for target, line in self.files[rel].module_imports:
            out.append((self._nearest_module(target), line))
        return out

    def _nearest_module(self, dotted_target: str) -> str:
        """'coreth_tpu_torch.core.blockchain.BlockChain' -> the longest prefix
        that is a known module (an import of a symbol still executes the
        whole module)."""
        parts = dotted_target.split(".")
        for cut in range(len(parts), 0, -1):
            cand = ".".join(parts[:cut])
            if cand in self.modules:
                return cand
        return dotted_target

    # -- lookup for the CLI ----------------------------------------------
    def find(self, fragment: str) -> List[FuncNode]:
        """Functions whose key/qualname contains [fragment] (exact
        qualname match wins when present)."""
        exact = [n for n in self.funcs.values()
                 if n.qualname == fragment
                 or f"{n.relpath}:{n.qualname}" == fragment]
        if exact:
            return sorted(exact, key=lambda n: n.key)
        return sorted((n for n in self.funcs.values()
                       if fragment in n.key), key=lambda n: n.key)


def build_program(filegraphs: Iterable[FileGraph]) -> Program:
    return Program({fg.relpath: fg for fg in filegraphs})


# ---------------------------------------------------------------- plumbing

def _tarjan(adj: Dict[str, List[str]]) -> List[List[str]]:
    """Iterative Tarjan SCC (deterministic given sorted adjacency)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    for root in sorted(adj):
        if root in index:
            continue
        work = [(root, iter(adj[root]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(adj[w])))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                sccs.append(scc)
    return sccs


def _cycle_through(adj: Dict[str, List[str]], scc: Set[str],
                   start: str) -> Optional[List[str]]:
    """A concrete directed cycle within [scc] starting at [start]."""
    # BFS back to start restricted to the SCC
    parent: Dict[str, str] = {}
    queue = [start]
    seen = {start}
    while queue:
        v = queue.pop(0)
        for w in adj.get(v, []):
            if w == start and v != start:
                path = [start]
                cur = v
                back = []
                while cur != start:
                    back.append(cur)
                    cur = parent[cur]
                path.extend(reversed(back))
                return path
            if w in scc and w not in seen:
                seen.add(w)
                parent[w] = v
                queue.append(w)
    return None
