"""Repo-specific lint rules (the `go vet` analyzers this port needs).

SA001 silent-except    broad `except` that neither re-raises, logs, nor
                       counts — consensus-relevant failures must be loud
SA002 lock-discipline  attributes written under `self.<lock>` (or
                       annotated `# guarded-by: <lock>`) must never be
                       mutated outside it
SA003 hot-path-purity  `# hot-path` functions must not read wall-clock,
                       draw randomness, allocate ctypes buffers, or
                       construct metrics/spans per call (only the gated
                       phase_timer/expensive_timer/span helpers)
SA004 consensus-float  no float arithmetic where bit-exactness is the
                       product: trie/, rlp, evm gas, state hashing
SA005 unordered-iter   no set-order-dependent iteration feeding RLP or
                       hashing (bytes/str hashes are salted per process:
                       set order is not reproducible across nodes)
SA006 failpoint-hygiene  failpoint names are unique string literals
                       registered at module import; `failpoint()` only
                       fires registered names; no naked `time.sleep`
                       outside coreth_tpu_torch/fault/ (use fault.Backoff)
SA007 serving-bounded  no unbounded `queue.Queue()` / `SimpleQueue()` or
                       un-capped `ThreadPoolExecutor()` in serving-path
                       modules — bounded queues ARE the admission control
SA008 backend-isolation  trie/ and bintrie/ may not import each other —
                       commitment backends meet only at the
                       state/commitment.py seam
SA009 fold-order       fold-step loops in the optimistic executor must
                       iterate in tx-index order (range/sorted only) —
                       completion-order folds break deterministic commit
SA010 read-tier-locks  read-only RPC handler modules (eth/api,
                       eth/filters, eth/gasprice, eth/backend) must not
                       touch `chainmu` or call chainmu-taking chain
                       methods — reads resolve against the published
                       ReadView, never the write path's lock
SA011 shard-worker-isolation  modules imported inside forked execution
                       shards (core/shard_worker.py) must stay fork-clean:
                       no metrics/blockchain imports, no `chainmu`, no
                       `default_registry`, no module-level mutable state —
                       module scope is stdlib + coreth_tpu_torch.fault only,
                       EVM machinery is imported lazily per request
SA012 sharding-discipline  in the mesh-sharded commit modules
                       (ops/keccak_resident, coreth_tpu_torch/parallel)
                       every tensor constructor passes `device=`, no
                       device is the index-less "cuda", no bare `.cuda()`
                       (or a `# sharding:` justification) — the torch
                       counterpart of the reference's pinned jit
                       shardings: the port has no jit, so placement is
                       pinned where each tensor is made or moved
SA013 lock-order       the whole-program may-acquire graph must stay
                       acyclic — a cycle is a potential deadlock; the
                       acyclic order is mirrored at runtime by
                       racecheck.CANONICAL_LOCK_ORDER and its witness
SA014 metrics-family   Counter/Gauge/Meter/Timer/Histogram names created
                       outside metrics/ must match the documented
                       `^[a-z0-9_/]+$` namespace grammar (literal
                       f-string/concat fragments: charset only) and one
                       family name must never register under two
                       different metric types
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .engine import Finding, QualnameVisitor, Rule, SourceFile

__all__ = ["ALL_RULES", "default_rules"]


def dotted(node: ast.AST) -> Optional[str]:
    """'time.time' for Attribute chains / Names; None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def self_attr_base(node: ast.AST) -> Optional[str]:
    """The `X` in self.X / self.X[...] / self.X.setdefault(...)[...]:
    unwraps subscripts and call chains down to an attribute on `self`."""
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr
            node = node.value
        else:
            return None


# ------------------------------------------------------------------ SA001

BROAD_EXC_NAMES = {"Exception", "BaseException"}
LOG_ATTRS = {"trace", "debug", "info", "warning", "warn", "error",
             "exception", "critical", "fatal", "log", "print_exc"}
METRIC_ATTRS = {"inc", "dec", "mark", "observe"}
HANDLER_NAME_HINTS = ("count", "drop", "error", "metric", "record",
                      "violation", "reject")
CAPTURE_NAME_HINTS = ("error", "err", "failed", "drop", "violation")


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Tuple):
        names = [dotted(e) for e in t.elts]
    else:
        names = [dotted(t)]
    return any(n is not None and n.split(".")[-1] in BROAD_EXC_NAMES
               for n in names)


def _target_name(t: ast.AST) -> str:
    """Dotted name of an assignment target; for subscripts a constant
    string key joins in, so `out["error"] = …` reads as handling."""
    if isinstance(t, ast.Subscript):
        key = t.slice
        key_s = key.value if (isinstance(key, ast.Constant)
                              and isinstance(key.value, str)) else ""
        return f"{_target_name(t.value)}.{key_s}"
    return dotted(t) or ""


def _handler_is_loud(handler: ast.ExceptHandler) -> bool:
    """Does the handler body re-raise, log, count, capture, or answer the
    error in-band (a response carrying an `error` field)?"""
    for node in ast.walk(ast.Module(body=handler.body, type_ignores=[])):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            low = name.lower()
            if isinstance(fn, ast.Attribute) and name in LOG_ATTRS:
                return True
            if isinstance(fn, ast.Attribute) and name in METRIC_ATTRS:
                return True
            if any(h in low for h in HANDLER_NAME_HINTS):
                return True
            # error-collection idiom: errors.append(...) / errs.add(...)
            if isinstance(fn, ast.Attribute) and name in ("append", "add"):
                recv = dotted(fn.value) or ""
                if any(h in recv.lower() for h in CAPTURE_NAME_HINTS):
                    return True
            # in-band error replies: Response(error=...) keywords or a
            # dict-literal payload with an "error" key
            if any(kw.arg and "error" in kw.arg.lower()
                   for kw in node.keywords):
                return True
            for arg in node.args:
                if isinstance(arg, ast.Dict) and any(
                        isinstance(k, ast.Constant)
                        and isinstance(k.value, str)
                        and "error" in k.value.lower()
                        for k in arg.keys):
                    return True
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                tname = _target_name(t)
                if any(h in tname.lower() for h in CAPTURE_NAME_HINTS):
                    return True
    return False


class SilentExceptRule(Rule):
    id = "SA001"
    title = "broad except neither re-raises, logs, nor counts"

    def check(self, src: SourceFile) -> Iterator[Finding]:
        rule = self
        findings: List[Finding] = []

        class V(QualnameVisitor):
            def visit_Try(self, node: ast.Try) -> None:
                for h in node.handlers:
                    if _is_broad_handler(h) and not _handler_is_loud(h):
                        exc = "except" if h.type is None else (
                            f"except {ast.unparse(h.type)}")
                        findings.append(rule.finding(
                            src, h, self.qualname,
                            f"`{exc}` swallows silently: re-raise, log, "
                            f"or bump a metrics counter"))
                self.generic_visit(node)

            visit_TryStar = visit_Try  # 3.11 except* groups

        V().visit(src.tree)
        return iter(findings)


# ------------------------------------------------------------------ SA002

LOCK_ATTR_HINTS = ("lock", "mu", "cond", "_cv")
# methods mutating their receiver in place (queue put/get excluded:
# queues synchronize themselves)
MUTATOR_ATTRS = {"append", "appendleft", "add", "remove", "discard", "pop",
                 "popleft", "popitem", "clear", "extend", "insert",
                 "setdefault", "sort", "reverse"}
ALL_LOCKS = "<all>"


def _is_lock_name(attr: str) -> bool:
    low = attr.lower()
    return any(h in low for h in LOCK_ATTR_HINTS)


class _Write:
    __slots__ = ("qualname", "line", "locks", "in_init")

    def __init__(self, qualname: str, line: int, locks: frozenset, in_init: bool):
        self.qualname = qualname
        self.line = line
        self.locks = locks
        self.in_init = in_init


class _MethodWalker(ast.NodeVisitor):
    """Collect self-attribute writes in one method with the set of
    self-locks held (via `with self.<lock>:`) at each write site."""

    def __init__(self, src: SourceFile, cls: str, method: str,
                 entry_locks: frozenset, writes: Dict[str, List["_Write"]]):
        self.src = src
        self.cls = cls
        self.method = method
        self.locks = set(entry_locks)
        self.writes = writes
        self.in_init = method == "__init__"
        self._annotations: Dict[str, str] = {}

    # -- lock scope ------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        held = []
        for item in node.items:
            ctx = item.context_expr
            base = self_attr_base(ctx)
            if base is not None and _is_lock_name(base):
                held.append(base)
        self.locks.update(held)
        for stmt in node.body:
            self.visit(stmt)
        for h in held:
            self.locks.discard(h)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # a closure runs later, on whatever thread calls it: the lock the
        # enclosing method holds is NOT held there
        lock, _hot = self.src.def_annotation(node)
        entry = frozenset([lock]) if lock else frozenset()
        inner = _MethodWalker(self.src, self.cls,
                              f"{self.method}.{node.name}", entry, self.writes)
        for stmt in node.body:
            inner.visit(stmt)
        self._annotations.update(inner._annotations)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass  # no statements, no writes

    # -- writes ----------------------------------------------------------
    def _record(self, node: ast.AST, attr: str) -> None:
        if _is_lock_name(attr):
            return  # the locks themselves are assigned freely in __init__
        self.writes.setdefault(attr, []).append(_Write(
            f"{self.cls}.{self.method}", getattr(node, "lineno", 0),
            frozenset(self.locks), self.in_init))
        ann = self.src.guarded_by.get(getattr(node, "lineno", -1))
        if ann:
            self._annotations[attr] = ann

    def _record_target(self, node: ast.AST, target: ast.AST) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._record_target(node, e)
            return
        base = self_attr_base(target)
        if base is not None:
            self._record(node, base)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_target(node, t)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_target(node, node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_target(node, node.target)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._record_target(node, t)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in MUTATOR_ATTRS:
            base = self_attr_base(fn.value)
            if base is not None:
                self._record(node, base)
        self.generic_visit(node)


class LockDisciplineRule(Rule):
    id = "SA002"
    title = "guarded attribute mutated outside its lock"

    def check(self, src: SourceFile) -> Iterator[Finding]:
        findings: List[Finding] = []
        for cls in [n for n in ast.walk(src.tree)
                    if isinstance(n, ast.ClassDef)]:
            findings.extend(self._check_class(src, cls))
        return iter(findings)

    def _check_class(self, src: SourceFile, cls: ast.ClassDef) -> List[Finding]:
        writes: Dict[str, List[_Write]] = {}
        annotations: Dict[str, str] = {}
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            lock, _hot = src.def_annotation(item)
            if lock:
                entry = frozenset([lock])
            elif item.name.endswith("_locked"):
                # `_locked` naming convention: caller holds *a* lock; which
                # one is not recoverable statically, so trust the name
                entry = frozenset([ALL_LOCKS])
            else:
                entry = frozenset()
            walker = _MethodWalker(src, cls.name, item.name, entry, writes)
            for stmt in item.body:
                walker.visit(stmt)
            annotations.update(walker._annotations)

        out: List[Finding] = []
        for attr, ws in sorted(writes.items()):
            live = [w for w in ws if not w.in_init]
            if not live:
                continue
            if attr in annotations:
                lock = annotations[attr]
                for w in live:
                    if lock not in w.locks and ALL_LOCKS not in w.locks:
                        out.append(Finding(
                            self.id, src.relpath, w.line, w.qualname,
                            f"`self.{attr}` is `# guarded-by: {lock}` but "
                            f"written without holding it"))
                continue
            inside = [w for w in live if w.locks]
            outside = [w for w in live
                       if not w.locks and ALL_LOCKS not in w.locks]
            if inside and outside:
                lock_names = sorted({l for w in inside for l in w.locks
                                     if l != ALL_LOCKS})
                for w in outside:
                    out.append(Finding(
                        self.id, src.relpath, w.line, w.qualname,
                        f"`self.{attr}` is written under "
                        f"{'/'.join(lock_names) or 'a lock'} elsewhere but "
                        f"mutated here without it"))
        return out


# ------------------------------------------------------------------ SA003

# hard-impurity tables live in callgraph.py (the interprocedural
# extractor shares them); re-exported here so fixtures/tests keep one
# import path
from .callgraph import CTYPES_ALLOC, RANDOM_ROOTS, WALLCLOCK_CALLS  # noqa: E402
# Observability in a hot path must go through the gated helpers (they are
# no-ops when tracing/metrics are off); constructing/looking-up a metric
# or span object per call defeats the gate and allocates in the hot loop.
OBSERVABILITY_ALLOWED = {"phase_timer", "expensive_timer", "span", "mint"}
OBSERVABILITY_FLAGGED = {
    "timer", "histogram", "meter", "get_or_register_timer",
    "get_or_register_meter", "get_or_register_gauge", "Timer", "Histogram",
    "Meter", "Span", "Tracer", "start_span",
}
# Every call that takes a metric/span NAME as an argument: an f-string
# there allocates a fresh string per call AND defeats the registry's
# name-keyed lookup — even through the gated helpers. Trace-id formatting
# belongs in tracectx.mint (gated, %-formatted, off the hot path).
OBSERVABILITY_NAME_CALLS = OBSERVABILITY_ALLOWED | OBSERVABILITY_FLAGGED | {
    "counter", "gauge", "observe_slo", "count_drop",
    "get_or_register_counter",
}


class HotPathPurityRule(Rule):
    id = "SA003"
    title = "hot-path function is impure per call"

    def check(self, src: SourceFile) -> Iterator[Finding]:
        rule = self
        findings: List[Finding] = []

        class V(QualnameVisitor):
            def _visit_func(self, node) -> None:
                _lock, hot = src.def_annotation(node)
                if hot:
                    self._stack.append(node.name)
                    qn = self.qualname
                    for sub in ast.walk(node):
                        msg = rule._impurity(sub)
                        if msg:
                            findings.append(rule.finding(src, sub, qn, msg))
                    self._stack.pop()
                else:
                    QualnameVisitor._visit_func(self, node)

            visit_FunctionDef = _visit_func
            visit_AsyncFunctionDef = _visit_func

        V().visit(src.tree)
        return iter(findings)

    def _impurity(self, node: ast.AST) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        name = dotted(node.func)
        if name is None:
            # `(ctypes.c_uint8 * n)(...)` — array-type instantiation
            if isinstance(node.func, ast.BinOp):
                parts = " ".join(filter(None, (dotted(node.func.left),
                                               dotted(node.func.right))))
                if "ctypes" in parts or ".c_" in parts or parts.startswith("c_"):
                    return ("allocates a ctypes buffer per call — hoist it "
                            "out of the hot loop")
            return None
        if name in WALLCLOCK_CALLS:
            return f"reads wall-clock (`{name}`) inside a hot path"
        if any(name.startswith(r) for r in RANDOM_ROOTS):
            return f"draws randomness (`{name}`) inside a hot path"
        if name in CTYPES_ALLOC:
            return (f"allocates a ctypes buffer per call (`{name}`) — "
                    f"hoist it out of the hot loop")
        last = name.rsplit(".", 1)[-1]
        if last in OBSERVABILITY_NAME_CALLS and any(
                isinstance(a, ast.JoinedStr) for a in node.args):
            return (f"builds a metric/span name with an f-string per call "
                    f"(`{name}`) inside a hot path — hoist the formatted "
                    f"name out of the loop; trace ids come from the gated "
                    f"tracectx.mint helper, not inline formatting")
        if last in OBSERVABILITY_FLAGGED and last not in OBSERVABILITY_ALLOWED:
            return (f"constructs a metric/span per call (`{name}`) inside a "
                    f"hot path — hoist the registry lookup to module scope, "
                    f"or use the gated phase_timer/expensive_timer/span "
                    f"helpers")
        return None

    # -- interprocedural promotion ---------------------------------------
    # A `# hot-path` marker covers the whole call tree, not one frame:
    # a helper that reads the wall clock is just as impure when reached
    # through two calls.  Transitive callees are held to the HARD subset
    # only (wall clock / randomness / ctypes alloc) — the observability
    # style checks stay single-file, where the hot marker is visible.
    # Exempt: the gated observability packages themselves, and the
    # cooperative-deadline checkpoint (its monotonic read at EVM frame
    # entry is the sanctioned design — never in step loops).
    HOT_REACH_EXEMPT = (
        "coreth_tpu_torch/metrics/",
        "coreth_tpu_torch/fault/",
        "coreth_tpu_torch/log.py",
        "coreth_tpu_torch/utils/deadline.py",
    )

    def finalize_program(self, program) -> Iterator[Finding]:
        seeds = sorted(k for k, n in program.funcs.items() if n.rec.hot)
        if not seeds:
            return
        seen = program.reachable(seeds, skip=self.HOT_REACH_EXEMPT)
        for key in sorted(seen):
            parent, _line = seen[key]
            if parent is None:
                continue  # the seed itself — the single-file pass owns it
            node = program.funcs[key]
            if not node.rec.impure:
                continue
            chain = " -> ".join(program.chain_to(seen, key))
            for site in node.rec.impure:
                yield Finding(
                    self.id, node.relpath, site.line, node.rec.qualname,
                    f"{site.kind} (`{site.name}`) reached from a "
                    f"# hot-path function: {chain}")


# ------------------------------------------------------------------ SA004

# Where bit-exactness is the product.  Device-orchestration files under
# trie/ (resident_mirror, planned) keep float *timings*; their roots are
# verified bit-exact against the host path elsewhere, so they are listed
# out of scope rather than baselined line-by-line.
CONSENSUS_FLOAT_PATHS = (
    "coreth_tpu_torch/trie/", "coreth_tpu_torch/rlp.py", "coreth_tpu_torch/evm/gas.py",
    "coreth_tpu_torch/params/", "coreth_tpu_torch/core/types.py",
    "coreth_tpu_torch/bintrie/",
    # the mesh helpers feed the real commit path now (resident-mesh-
    # devices): sharded digests are consensus bytes
    "coreth_tpu_torch/parallel/",
)
CONSENSUS_FLOAT_EXCLUDE = (
    "coreth_tpu_torch/trie/resident_mirror.py", "coreth_tpu_torch/trie/planned.py",
    "coreth_tpu_torch/trie/triedb.py",
)


def _in_scope(relpath: str, paths, exclude=()) -> bool:
    if any(relpath == e or relpath.startswith(e) for e in exclude):
        return False
    return any(relpath == p or relpath.startswith(p) for p in paths)


class ConsensusFloatRule(Rule):
    id = "SA004"
    title = "float arithmetic in a bit-exact module"

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if not _in_scope(src.relpath, CONSENSUS_FLOAT_PATHS,
                         CONSENSUS_FLOAT_EXCLUDE):
            return iter(())
        rule = self
        findings: List[Finding] = []

        class V(QualnameVisitor):
            def visit_Constant(self, node: ast.Constant) -> None:
                if isinstance(node.value, float):
                    findings.append(rule.finding(
                        src, node, self.qualname,
                        f"float literal {node.value!r} in a consensus "
                        f"module (bit-exactness)"))

            def visit_BinOp(self, node: ast.BinOp) -> None:
                if isinstance(node.op, ast.Div):
                    findings.append(rule.finding(
                        src, node, self.qualname,
                        "true division `/` yields float — use `//` in "
                        "consensus arithmetic"))
                self.generic_visit(node)

            def visit_Call(self, node: ast.Call) -> None:
                name = dotted(node.func)
                if name == "float" or (name or "").startswith("math."):
                    findings.append(rule.finding(
                        src, node, self.qualname,
                        f"`{name}` produces floats in a consensus module"))
                self.generic_visit(node)

        V().visit(src.tree)
        return iter(findings)


# ------------------------------------------------------------------ SA005

UNORDERED_ITER_PATHS = CONSENSUS_FLOAT_PATHS + (
    "coreth_tpu_torch/state/statedb.py", "coreth_tpu_torch/state/snapshot.py",
    "coreth_tpu_torch/trie/resident_mirror.py", "coreth_tpu_torch/trie/planned.py",
    "coreth_tpu_torch/trie/triedb.py", "coreth_tpu_torch/core/parallel_exec.py",
)
ITER_UNWRAP = {"list", "tuple", "iter", "enumerate", "reversed"}
SET_BINOPS = (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)


class UnorderedIterationRule(Rule):
    id = "SA005"
    title = "set-order-dependent iteration feeding RLP/hashing"

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if not _in_scope(src.relpath, UNORDERED_ITER_PATHS):
            return iter(())
        rule = self
        findings: List[Finding] = []

        class V(QualnameVisitor):
            def __init__(self):
                super().__init__()
                self._set_locals: List[Set[str]] = [set()]

            def _visit_func(self, node) -> None:
                self._set_locals.append(set())
                QualnameVisitor._visit_func(self, node)
                self._set_locals.pop()

            visit_FunctionDef = _visit_func
            visit_AsyncFunctionDef = _visit_func

            def visit_Assign(self, node: ast.Assign) -> None:
                if rule._is_set_expr(node.value, self._set_locals[-1]):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self._set_locals[-1].add(t.id)
                else:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self._set_locals[-1].discard(t.id)
                self.generic_visit(node)

            def _check_iter(self, it: ast.AST, where: ast.AST) -> None:
                if rule._is_set_expr(it, self._set_locals[-1], unwrap=True):
                    findings.append(rule.finding(
                        src, where, self.qualname,
                        "iterating a set here is not reproducible across "
                        "processes (salted hashes) — wrap in sorted()"))

            def visit_For(self, node: ast.For) -> None:
                self._check_iter(node.iter, node)
                self.generic_visit(node)

            def _visit_comp(self, node) -> None:
                for gen in node.generators:
                    self._check_iter(gen.iter, node)
                self.generic_visit(node)

            visit_ListComp = _visit_comp
            visit_SetComp = _visit_comp
            visit_DictComp = _visit_comp
            visit_GeneratorExp = _visit_comp

        V().visit(src.tree)
        return iter(findings)

    def _is_set_expr(self, node: ast.AST, set_locals: Set[str],
                     unwrap: bool = False) -> bool:
        if unwrap:
            while (isinstance(node, ast.Call)
                   and dotted(node.func) in ITER_UNWRAP and node.args):
                node = node.args[0]
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            if name in ("set", "frozenset"):
                return True
            # dict-view algebra (`a.keys() - b.keys()`) returns a set
            return False
        if isinstance(node, ast.Name):
            return node.id in set_locals
        if isinstance(node, ast.BinOp) and isinstance(node.op, SET_BINOPS):
            return (self._is_set_expr(node.left, set_locals)
                    or self._is_set_expr(node.right, set_locals)
                    or self._is_keys_call(node.left)
                    or self._is_keys_call(node.right))
        return False

    @staticmethod
    def _is_keys_call(node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("keys", "items"))


# ------------------------------------------------------------------ SA006

# The one sanctioned home for a raw sleep: fault.Backoff centralizes
# retry pacing (capped exponential + jitter) so chaos tests can reason
# about every wait in the system.
SLEEP_EXEMPT_PATHS = ("coreth_tpu_torch/fault/",)
FAILPOINT_FUNCS = {"register", "failpoint"}


class FailpointHygieneRule(Rule):
    """Failpoint names are part of the debug/chaos API surface: they must
    be unique string literals registered at import time so
    `debug_listFailpoints` is the complete, greppable catalogue and an
    env spec can never silently name a point that does not exist.  The
    companion check bans naked `time.sleep` outside the fault package —
    ad-hoc sleeps are unbounded, unjittered, and invisible to the
    degradation ladder (use `fault.Backoff`)."""

    id = "SA006"
    title = "failpoint hygiene / naked time.sleep"

    def __init__(self):
        # cross-file state, fed by absorb() (directly or replayed from
        # the cache) and reported in finalize(); check() only stashes
        # the current file's events for summarize() to hand back
        self._pending: List[Tuple] = []
        self._events: List[Tuple[str, Tuple]] = []  # (relpath, event)

    def summarize(self, src: SourceFile):
        events, self._pending = self._pending, []
        return events or None

    def absorb(self, relpath: str, summary) -> None:
        for ev in summary:
            self._events.append((relpath, ev))

    def check(self, src: SourceFile) -> Iterator[Finding]:
        rule = self
        findings: List[Finding] = []
        # alias maps for this file: local-name -> canonical function
        fp_aliases: Dict[str, str] = {}   # e.g. {"register": "register"}
        mod_aliases: Set[str] = set()     # modules exposing .register/.failpoint
        sleep_names: Set[str] = set()     # `from time import sleep [as x]`
        sleep_ok = any(src.relpath == p or src.relpath.startswith(p)
                       for p in SLEEP_EXEMPT_PATHS)

        for node in ast.walk(src.tree):
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod == "fault" or mod.endswith(".fault"):
                    for a in node.names:
                        if a.name in FAILPOINT_FUNCS:
                            fp_aliases[a.asname or a.name] = a.name
                if mod == "time":
                    for a in node.names:
                        if a.name == "sleep":
                            sleep_names.add(a.asname or a.name)
                for a in node.names:  # `from .. import fault [as f]`
                    if a.name == "fault":
                        mod_aliases.add(a.asname or a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "fault" or a.name.endswith(".fault"):
                        mod_aliases.add(a.asname or a.name.split(".")[0])

        def resolve(call: ast.Call) -> Optional[str]:
            """Canonical 'register'/'failpoint' if this call targets the
            fault package through any import shape, else None."""
            fn = call.func
            if isinstance(fn, ast.Name):
                return fp_aliases.get(fn.id)
            if isinstance(fn, ast.Attribute) and fn.attr in FAILPOINT_FUNCS:
                recv = dotted(fn.value)
                if recv is not None and (recv in mod_aliases
                                         or recv.split(".")[-1] == "fault"):
                    return fn.attr
            return None

        class V(QualnameVisitor):
            def visit_Call(self, node: ast.Call) -> None:
                name = dotted(node.func)
                if not sleep_ok and (
                        name == "time.sleep"
                        or (isinstance(node.func, ast.Name)
                            and node.func.id in sleep_names)):
                    findings.append(rule.finding(
                        src, node, self.qualname,
                        "naked time.sleep — retry pacing goes through "
                        "fault.Backoff (capped exponential + jitter), "
                        "visible to chaos tooling"))
                which = resolve(node)
                if which is not None:
                    findings.extend(
                        rule._check_failpoint_call(src, node, self.qualname,
                                                   which))
                self.generic_visit(node)

        V().visit(src.tree)
        return iter(findings)

    def _check_failpoint_call(self, src: SourceFile, node: ast.Call,
                              qualname: str, which: str) -> List[Finding]:
        out: List[Finding] = []
        arg = node.args[0] if node.args else None
        if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
            out.append(self.finding(
                src, node, qualname,
                f"`{which}(...)` needs a literal string name — computed "
                f"names defeat the greppable failpoint catalogue"))
            return out
        name = arg.value
        if which == "register":
            if qualname != "<module>":
                out.append(self.finding(
                    src, node, qualname,
                    f"failpoint {name!r} registered inside {qualname} — "
                    f"registration must run at import (module scope) so "
                    f"debug_listFailpoints is complete at boot"))
            self._pending.append(("reg", name, getattr(node, "lineno", 0),
                                  qualname))
        else:
            self._pending.append(("fire", name, getattr(node, "lineno", 0),
                                  qualname))
        return out

    def finalize(self) -> Iterator[Finding]:
        registered: Dict[str, Tuple[str, str]] = {}
        fired: List[Tuple[str, str, int, str]] = []
        for relpath, (kind, name, line, qualname) in self._events:
            if kind == "reg":
                prior = registered.get(name)
                if prior is not None and prior != (relpath, qualname):
                    yield Finding(
                        self.id, relpath, line, qualname,
                        f"failpoint {name!r} already registered at "
                        f"{prior[0]} [{prior[1]}] — names are global and "
                        f"must be unique")
                else:
                    registered[name] = (relpath, qualname)
            else:
                fired.append((name, relpath, line, qualname))
        for name, path, line, qualname in fired:
            if name not in registered:
                yield Finding(
                    self.id, path, line, qualname,
                    f"failpoint({name!r}) fires a name no module "
                    f"registers — arm via debug_setFailpoint would "
                    f"KeyError; add a module-scope register()")


# ------------------------------------------------------------------ SA007

# The serving tier's overload story *is* its bounded queues
# (ROBUSTNESS.md "Serving under overload"): an unbounded queue or an
# uncapped worker source in a request-serving module quietly
# reintroduces collapse-under-saturation. Only modules that accept or
# fan out remote work are listed: peer/ (gossip + request fan-out pools)
# and sync/ (segment + hedge pools driven by remote responses) — a
# Byzantine peer set must not be able to balloon either.
# core/insert_pipeline.py: its stage queue IS the pipeline depth bound —
# an unbounded queue there would let speculation run arbitrarily far
# ahead of commit.
# ethdb/ (storage fault armor): the degraded read-only rung keeps reads
# serving while writes fail, so the storage boundary is itself a serving
# path — a retry queue or helper pool growing without bound under
# persistent disk failure would turn a survivable fault into a
# memory-pressure collapse.
SERVING_PATHS = (
    "coreth_tpu_torch/rpc/",
    "coreth_tpu_torch/vm/api.py",
    "coreth_tpu_torch/eth/filters.py",
    "coreth_tpu_torch/metrics/http.py",
    "coreth_tpu_torch/peer/",
    "coreth_tpu_torch/sync/",
    "coreth_tpu_torch/core/insert_pipeline.py",
    "coreth_tpu_torch/ethdb/",
)
_QUEUE_CTORS = {"Queue", "LifoQueue", "PriorityQueue"}


class ServingBoundednessRule(Rule):
    """Serving-path modules must construct only *bounded* work buffers:
    `queue.Queue()` with no maxsize (or maxsize=0) is unbounded, as is
    `SimpleQueue()`; a `ThreadPoolExecutor()` without max_workers sizes
    itself from the host, not from an admission budget. Genuinely
    justified cases go in the baseline with a reason."""

    id = "SA007"
    title = "unbounded queue/executor in serving path"

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if not any(src.relpath == p or src.relpath.startswith(p)
                   for p in SERVING_PATHS):
            return iter(())
        rule = self
        findings: List[Finding] = []
        queue_names: Set[str] = set()   # bare names bound to queue ctors
        simple_names: Set[str] = set()  # bare names for SimpleQueue
        exec_names: Set[str] = set()    # bare names for ThreadPoolExecutor
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod == "queue":
                    for a in node.names:
                        if a.name in _QUEUE_CTORS:
                            queue_names.add(a.asname or a.name)
                        elif a.name == "SimpleQueue":
                            simple_names.add(a.asname or a.name)
                elif mod == "concurrent.futures":
                    for a in node.names:
                        if a.name == "ThreadPoolExecutor":
                            exec_names.add(a.asname or a.name)

        def kind_of(call: ast.Call) -> Optional[str]:
            name = dotted(call.func)
            if name is None:
                return None
            head, _, _ = name.partition(".")
            last = name.split(".")[-1]
            if name in queue_names or (head == "queue"
                                       and last in _QUEUE_CTORS):
                return "queue"
            if name in simple_names or (head == "queue"
                                        and last == "SimpleQueue"):
                return "simple"
            if name in exec_names or last == "ThreadPoolExecutor":
                return "executor"
            return None

        def bound_arg(call: ast.Call, kw: str) -> Optional[ast.AST]:
            if call.args:
                return call.args[0]
            for k in call.keywords:
                if k.arg == kw:
                    return k.value
            return None

        class V(QualnameVisitor):
            def visit_Call(self, node: ast.Call) -> None:
                kind = kind_of(node)
                if kind == "simple":
                    findings.append(rule.finding(
                        src, node, self.qualname,
                        "SimpleQueue is always unbounded — serving paths "
                        "use a bounded queue.Queue(maxsize=...) so a full "
                        "buffer sheds instead of growing"))
                elif kind == "queue":
                    arg = bound_arg(node, "maxsize")
                    unbounded = arg is None or (
                        isinstance(arg, ast.Constant) and arg.value == 0)
                    if unbounded:
                        findings.append(rule.finding(
                            src, node, self.qualname,
                            "unbounded queue in a serving module "
                            "(maxsize absent or 0) — bounded admission "
                            "queues are the overload control; pass a "
                            "positive maxsize or baseline with a reason"))
                elif kind == "executor":
                    arg = bound_arg(node, "max_workers")
                    if arg is None or (isinstance(arg, ast.Constant)
                                       and arg.value is None):
                        findings.append(rule.finding(
                            src, node, self.qualname,
                            "ThreadPoolExecutor without max_workers sizes "
                            "itself from the host — serving-path "
                            "concurrency comes from an explicit budget"))
                self.generic_visit(node)

        V().visit(src.tree)
        return iter(findings)


# ------------------------------------------------------------------ SA008

# Commitment-backend isolation (COMMITMENT.md): the MPT and the bintrie
# implementations sit behind the state/commitment.py seam and may not
# import each other — in either direction, by absolute or relative
# import. Shared machinery goes through the interface or scheme-agnostic
# layers (ops/, metrics/, native). The seam module itself is exempt: it
# exists to know both.
BACKEND_ISOLATION = (
    # (package whose files are checked, banned import prefix)
    ("coreth_tpu_torch/bintrie/", "coreth_tpu_torch.trie"),
    ("coreth_tpu_torch/trie/", "coreth_tpu_torch.bintrie"),
)


class BackendIsolationRule(Rule):
    id = "SA008"
    title = "commitment backend reaches around the interface"

    def check(self, src: SourceFile) -> Iterator[Finding]:
        findings: List[Finding] = []
        for pkg, banned in BACKEND_ISOLATION:
            if not _in_scope(src.relpath, (pkg,)):
                continue
            # module path of this file, for resolving relative imports:
            # "coreth_tpu_torch/bintrie/tree.py" -> [coreth_tpu_torch, bintrie, tree]
            parts = src.relpath[:-3].split("/")
            if parts[-1] == "__init__":
                parts = parts[:-1]
            for node in ast.walk(src.tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        self._flag(findings, src, node, alias.name, banned)
                elif isinstance(node, ast.ImportFrom):
                    if node.level == 0:
                        full = node.module or ""
                    else:
                        base = parts[: len(parts) - node.level]
                        full = ".".join(
                            base + ([node.module] if node.module else []))
                    self._flag(findings, src, node, full, banned)
        return iter(findings)

    def _flag(self, findings, src, node, module: str, banned: str) -> None:
        if module == banned or module.startswith(banned + "."):
            findings.append(self.finding(
                src, node, "<module>",
                f"imports {module} across the commitment-backend "
                f"boundary — go through state/commitment.py instead"))


# ------------------------------------------------------------------ SA009

# Deterministic commit (PERF.md r9): the optimistic executor may finish
# transactions in any order, but the fold that applies write-sets to the
# real StateDB is the consensus boundary — it must walk the versioned
# results strictly in tx-index order. A loop over a dict of completion
# events or a worker-local list would be timing-dependent and fork the
# state root. Enforced structurally: inside fold-named functions in the
# executor, every for-loop (and comprehension) iterates an explicitly
# ordered source — range()/sorted(), optionally wrapped in enumerate/
# list/tuple — never a raw container or set.
FOLD_ORDER_PATHS = ("coreth_tpu_torch/core/parallel_exec.py",)
FOLD_ORDER_WRAPPERS = {"enumerate", "list", "tuple", "iter"}
FOLD_ORDER_SOURCES = {"range", "sorted"}


class FoldOrderRule(Rule):
    id = "SA009"
    title = "fold-step iteration must be tx-index ordered"

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if src.relpath not in FOLD_ORDER_PATHS:
            return iter(())
        rule = self
        findings: List[Finding] = []

        class V(QualnameVisitor):
            def __init__(self):
                super().__init__()
                self._fold_depth = 0

            def _visit_func(self, node) -> None:
                folding = "fold" in node.name
                self._fold_depth += folding
                QualnameVisitor._visit_func(self, node)
                self._fold_depth -= folding

            visit_FunctionDef = _visit_func
            visit_AsyncFunctionDef = _visit_func

            def _check_iter(self, it: ast.AST, where: ast.AST) -> None:
                if self._fold_depth and not rule._ordered_iter(it):
                    findings.append(rule.finding(
                        src, where, self.qualname,
                        "fold-step loop must iterate range()/sorted() "
                        "(tx-index order) — container iteration here is "
                        "completion-order and forks the state root"))

            def visit_For(self, node: ast.For) -> None:
                self._check_iter(node.iter, node)
                self.generic_visit(node)

            def _visit_comp(self, node) -> None:
                for gen in node.generators:
                    self._check_iter(gen.iter, node)
                self.generic_visit(node)

            visit_ListComp = _visit_comp
            visit_SetComp = _visit_comp
            visit_DictComp = _visit_comp
            visit_GeneratorExp = _visit_comp

        V().visit(src.tree)
        return iter(findings)

    @staticmethod
    def _ordered_iter(node: ast.AST) -> bool:
        while (isinstance(node, ast.Call)
               and dotted(node.func) in FOLD_ORDER_WRAPPERS and node.args):
            node = node.args[0]
        return (isinstance(node, ast.Call)
                and dotted(node.func) in FOLD_ORDER_SOURCES)


# ------------------------------------------------------------------ SA010

# The lock-free read tier (ROBUSTNESS.md "Read-path lock
# discipline"): read-only RPC handler modules resolve heads and state
# against the chain's atomically published ReadView. Touching `chainmu`
# from any of them — directly or by calling a chain method that takes it
# — re-couples read latency to the write pipeline, which is exactly the
# regression the storm bench measures. The list of chainmu-taking chain
# methods is curated (they are few and stable); receiver matching is
# name-based ("chain" in the dotted receiver) so unrelated objects with
# an `accept` method don't trip it.
READ_TIER_PATHS = (
    "coreth_tpu_torch/eth/api.py",
    "coreth_tpu_torch/eth/filters.py",
    "coreth_tpu_torch/eth/gasprice.py",
    "coreth_tpu_torch/eth/backend.py",
)
CHAINMU_TAKING_METHODS = {
    "insert_block", "insert_block_manual", "accept", "reject",
    "set_preference", "last_consensus_accepted_block",
}


class ReadTierLockRule(Rule):
    """Read-only RPC handlers must be chainmu-free: no `chainmu`
    attribute access (with-statements, acquire/release, passing the lock
    around) and no calls to the curated chainmu-taking chain methods.
    Justified exceptions go in the baseline with a reason."""

    id = "SA010"
    title = "read-tier module touches chainmu"

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if src.relpath not in READ_TIER_PATHS:
            return iter(())
        rule = self
        findings: List[Finding] = []

        class V(QualnameVisitor):
            def visit_Attribute(self, node: ast.Attribute) -> None:
                if node.attr == "chainmu":
                    findings.append(rule.finding(
                        src, node, self.qualname,
                        "read-tier module touches `chainmu` — read-only "
                        "RPC paths resolve against chain.read_view(), "
                        "never the write path's lock"))
                self.generic_visit(node)

            def visit_Call(self, node: ast.Call) -> None:
                fn = node.func
                if (isinstance(fn, ast.Attribute)
                        and fn.attr in CHAINMU_TAKING_METHODS):
                    recv = dotted(fn.value) or ""
                    if "chain" in recv.lower():
                        findings.append(rule.finding(
                            src, node, self.qualname,
                            f"read-tier module calls chainmu-taking "
                            f"`{recv}.{fn.attr}()` — reads must not "
                            f"enter the write path"))
                self.generic_visit(node)

        V().visit(src.tree)
        return iter(findings)

    # -- interprocedural promotion ---------------------------------------
    # The single-file pass only sees `chainmu` named IN the read tier; a
    # read-tier entry that calls a helper in core/ that takes chainmu is
    # the same bug one hop removed.  BFS every read-tier function's
    # transitive callees; flag any reached function that acquires
    # `BlockChain.chainmu` or IS one of the curated chainmu-taking chain
    # methods.  Findings anchor at the read-tier entry (stable baseline
    # key inside eth/), with the full call chain in the message.
    def finalize_program(self, program) -> Iterator[Finding]:
        entries = sorted(k for k, n in program.funcs.items()
                         if n.relpath in READ_TIER_PATHS)
        if not entries:
            return
        seen = program.reachable(entries)
        for key in sorted(seen):
            node = program.funcs[key]
            if node.relpath in READ_TIER_PATHS:
                continue  # direct uses are the single-file rule's job
            if any(lock == "BlockChain.chainmu"
                   for lock, _l, _h, _s in node.acquires):
                culprit = f"`{node.rec.qualname}` acquires `chainmu`"
            elif (node.rec.cls == "BlockChain"
                    and node.rec.name in CHAINMU_TAKING_METHODS):
                culprit = (f"`BlockChain.{node.rec.name}` is a curated "
                           f"chainmu-taking method")
            else:
                continue
            root = key
            while seen[root][0] is not None:
                root = seen[root][0]
            entry_node = program.funcs[root]
            chain = " -> ".join(program.chain_to(seen, key))
            yield Finding(
                self.id, entry_node.relpath, entry_node.rec.line,
                entry_node.rec.qualname,
                f"read-tier entry transitively reaches the write path: "
                f"{chain} — {culprit}; reads resolve against "
                f"chain.read_view(), never chainmu")


# ------------------------------------------------------------------ SA011

# Execution-shard workers (core/exec_shards.py) fork long-lived children
# whose import graph is whatever core/shard_worker.py pulls in at module
# scope. Anything mutable that crosses the fork silently diverges from
# the parent: counters bumped into a registry nobody scrapes, a chainmu
# whose other holders don't exist in the child, dicts that look shared
# but aren't. The contract: worker modules keep module scope down to
# stdlib + coreth_tpu_torch.fault (which re-arms itself via child_after_fork),
# never name the metrics registry or the chain lock, hold no module-level
# mutable state, and import the EVM machinery lazily inside handlers —
# pickle-clean and side-effect-free by construction.
SHARD_WORKER_PATHS = (
    "coreth_tpu_torch/core/shard_worker.py",
)
# internal packages a worker file may not import at ANY level — each one
# drags in a parent-process singleton (metrics registry, chain + chainmu)
SHARD_WORKER_BANNED_MODULES = {"metrics", "blockchain"}
# the ONE sanctioned exception inside a banned package:
# metrics/shardstats.py is fork-clean by construction (pure stdlib, no
# registry, no locks, no threads, no module-level mutable state) and
# exists precisely so workers can accumulate telemetry deltas and ship
# them over the pipe instead of bumping parent singletons
SHARD_WORKER_IMPORT_ALLOWLIST = frozenset({"metrics.shardstats"})
# documented exceptions for module-level mutable bindings (none today;
# additions need a reason next to the name)
SHARD_WORKER_MUTABLE_ALLOWLIST: frozenset = frozenset()
_MUTABLE_CTOR_NAMES = {"dict", "list", "set", "bytearray", "defaultdict",
                       "deque", "Counter", "OrderedDict"}


def _worker_allowlist_tail(mod: str) -> str:
    return mod[len("coreth_tpu_torch."):] if mod.startswith("coreth_tpu_torch.") else mod


def _import_is_allowlisted(node: ast.AST) -> bool:
    """True iff the statement imports ONLY allowlisted modules, under any
    spelling: `from ..metrics.shardstats import ShardStats`,
    `from ..metrics import shardstats`, `import
    coreth_tpu_torch.metrics.shardstats`."""
    mods: List[str] = []
    if isinstance(node, ast.Import):
        mods = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom):
        base = node.module or ""
        if _worker_allowlist_tail(base) == "metrics":
            # `from ..metrics import X, Y` — each alias is a module
            mods = [f"{base}.{a.name}" for a in node.names]
        else:
            mods = [base]
    if not mods:
        return False
    return all(_worker_allowlist_tail(m) in SHARD_WORKER_IMPORT_ALLOWLIST
               for m in mods)


def _import_segments(node: ast.AST) -> List[str]:
    """All dotted segments named by an import statement."""
    segs: List[str] = []
    if isinstance(node, ast.Import):
        for alias in node.names:
            segs.extend(alias.name.split("."))
    elif isinstance(node, ast.ImportFrom):
        if node.module:
            segs.extend(node.module.split("."))
        # `from .. import fault` names the target in the alias list
        if node.level > 0:
            segs.extend(a.name for a in node.names)
    return segs


def _is_mutable_value(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set,
                         ast.DictComp, ast.ListComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = dotted(node.func) or ""
        return name.split(".")[-1] in _MUTABLE_CTOR_NAMES
    return False


class ShardWorkerIsolationRule(Rule):
    """Shard-worker-importable modules must be fork-clean: no imports of
    the metrics or blockchain packages anywhere in the file, no `chainmu`
    attribute access, no `default_registry`, module-level imports limited
    to stdlib + coreth_tpu_torch.fault, and no module-level mutable bindings
    outside the (empty) allowlist."""

    id = "SA011"
    title = "shard-worker module breaks fork isolation"

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if src.relpath not in SHARD_WORKER_PATHS:
            return iter(())
        rule = self
        findings: List[Finding] = []

        def _relative_is_fault_only(node: ast.ImportFrom) -> bool:
            if node.module in (None, ""):
                return all(a.name == "fault" for a in node.names)
            parts = node.module.split(".")
            return parts[0] == "fault"

        # module-scope statements: imports + bindings
        for stmt in src.tree.body:
            if isinstance(stmt, (ast.Import, ast.ImportFrom)):
                relative = (isinstance(stmt, ast.ImportFrom)
                            and stmt.level > 0)
                internal = relative or any(
                    s == "coreth_tpu_torch" for s in _import_segments(stmt))
                ok = (not internal) or (
                    isinstance(stmt, ast.ImportFrom) and relative
                    and _relative_is_fault_only(stmt)) \
                    or _import_is_allowlisted(stmt)
                if not ok:
                    findings.append(rule.finding(
                        src, stmt, "<module>",
                        "shard-worker module imports project code at "
                        "module scope — only stdlib and coreth_tpu_torch.fault "
                        "may load at fork time; import the EVM machinery "
                        "lazily inside the request handler"))
            elif isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                value = stmt.value
                names = [dotted(t) or "" for t in targets]
                if (value is not None and _is_mutable_value(value)
                        and not all(n in SHARD_WORKER_MUTABLE_ALLOWLIST
                                    for n in names)):
                    findings.append(rule.finding(
                        src, stmt, "<module>",
                        f"module-level mutable binding "
                        f"`{', '.join(names)}` in a shard-worker module "
                        f"— state copied through fork diverges silently; "
                        f"keep it per-request or thread it through the "
                        f"pipe protocol"))

        class V(QualnameVisitor):
            def visit_Import(self, node: ast.Import) -> None:
                self._check_import(node)

            def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
                self._check_import(node)

            def _check_import(self, node: ast.AST) -> None:
                banned = SHARD_WORKER_BANNED_MODULES.intersection(
                    _import_segments(node))
                if banned and not _import_is_allowlisted(node):
                    findings.append(rule.finding(
                        src, node, self.qualname,
                        f"shard-worker module imports "
                        f"`{'`, `'.join(sorted(banned))}` — forked "
                        f"workers must never touch the parent's metrics "
                        f"registry or chain singletons, even lazily"))

            def visit_Attribute(self, node: ast.Attribute) -> None:
                if node.attr == "chainmu":
                    findings.append(rule.finding(
                        src, node, self.qualname,
                        "shard-worker module touches `chainmu` — the "
                        "child's copy of the lock has no other holders; "
                        "workers are lock-free by construction"))
                self.generic_visit(node)

            def visit_Name(self, node: ast.Name) -> None:
                if node.id == "default_registry":
                    findings.append(rule.finding(
                        src, node, self.qualname,
                        "shard-worker module names `default_registry` — "
                        "counts bumped in a forked child are invisible "
                        "to the parent's scrapes; ship facts over the "
                        "pipe instead"))
                self.generic_visit(node)

        V().visit(src.tree)
        return iter(findings)

    # -- interprocedural promotion ---------------------------------------
    # The single-file pass pins shard_worker.py's own module scope; the
    # promotion chases what actually executes in the forked child: every
    # function reachable from the worker via the call graph, every lazy
    # import those functions perform, and the transitive MODULE-SCOPE
    # import closure of every module so pulled in (importing a module
    # executes its module scope, which imports more).  A banned package
    # (metrics, blockchain) anywhere in that closure means the child's
    # import image carries a parent-process singleton — the finding
    # anchors at the chain's root (the import that starts the pull) and
    # renders the full module chain.
    def finalize_program(self, program) -> Iterator[Finding]:
        worker_files = [program.files[rel] for rel in sorted(program.files)
                        if rel in SHARD_WORKER_PATHS]
        if not worker_files:
            return
        worker_keys = sorted(k for k, n in program.funcs.items()
                             if n.relpath in SHARD_WORKER_PATHS)
        seen = program.reachable(worker_keys)

        # module -> (why, (relpath, qualname, line), parent_module|None)
        origin: Dict[str, Tuple[str, Tuple[str, str, int], Optional[str]]] = {}
        queue: List[str] = []

        def add(target: str, why: str, anchor: Tuple[str, str, int],
                parent: Optional[str]) -> None:
            mod = program._nearest_module(target)
            rel = program.modules.get(mod)
            if rel in SHARD_WORKER_PATHS or mod in origin:
                return
            head = mod.rsplit(".", 1)[0]
            if ("." in mod and head in origin
                    and origin[head][1] == anchor):
                # `from X import y` records both X and X.y; when X isn't
                # in the analyzed set, X.y can't be trimmed to a known
                # module — one tracked entry per import is enough
                return
            origin[mod] = (why, anchor, parent)
            queue.append(mod)

        for fg in worker_files:
            for target, line in fg.module_imports:
                add(target, "module-scope import",
                    (fg.relpath, "<module>", line), None)
        for key in sorted(seen):
            node = program.funcs[key]
            for li in node.rec.lazy_imports:
                add(li.module,
                    f"lazy import inside `{node.rec.qualname}` "
                    f"(runs in the forked child)",
                    (node.relpath, node.rec.qualname, li.line), None)
            if node.relpath not in SHARD_WORKER_PATHS:
                parent_key, line = seen[key]
                pnode = (program.funcs[parent_key]
                         if parent_key is not None else node)
                add(node.module,
                    f"defines `{node.rec.qualname}`, called from the "
                    f"worker",
                    (pnode.relpath, pnode.rec.qualname, line), None)
        while queue:
            mod = queue.pop(0)
            rel = program.modules.get(mod)
            if rel is None:
                continue
            for target, line in program.files[rel].module_imports:
                add(target, "module-scope import",
                    (rel, "<module>", line), mod)

        for mod in sorted(origin):
            banned = SHARD_WORKER_BANNED_MODULES.intersection(
                mod.split("."))
            if not banned:
                continue
            tail = _worker_allowlist_tail(mod)
            if any(tail == a or tail.startswith(a + ".")
                   for a in SHARD_WORKER_IMPORT_ALLOWLIST):
                continue
            # walk back to the chain's root for the anchor + witness
            chain: List[str] = []
            cur: Optional[str] = mod
            anchor = origin[mod][1]
            while cur is not None:
                why, anc, parent = origin[cur]
                chain.append(f"{cur} ({why} at {anc[0]}:{anc[2]})")
                anchor = anc
                cur = parent
            chain.reverse()
            yield Finding(
                self.id, anchor[0], anchor[2], anchor[1],
                f"shard-worker import/call closure pulls in `{mod}` "
                f"(banned: {', '.join(sorted(banned))}) — the forked "
                f"child's import image carries a parent singleton: "
                f"{' -> '.join(chain)}")


# ------------------------------------------------------------------ SA012

# The torch counterpart of the reference's pjit placement rule. The
# reference pins in_shardings/out_shardings on every jitted commit entry
# and bans single-argument device_put, because an inferred placement
# reshards chained commits. The port has no jit: a mesh is a list of
# torch.devices driven by one process (parallel/__init__.py), and
# placement is decided at each tensor's construction and each copy. The
# inferred placements there are a constructor without `device=` (the
# default device: the host, where the kernel wrappers silently take the
# plain version), a bare `.cuda()`, and a device spelled "cuda" without
# an index (both the CURRENT device, not the shard's). So in the
# mesh-sharded commit modules every torch.empty/zeros/full/arange/
# as_tensor/tensor call passes `device=`, every `.to(...)` that moves a
# tensor names an indexed device (a `.to(<dtype>)` cast places nothing),
# and no bare `.cuda()` appears. A `# sharding:` comment on/above the
# site documents the justified exceptions, as in the reference.
SHARDING_DISCIPLINE_PATHS = (
    "coreth_tpu_torch/ops/keccak_resident.py",
    "coreth_tpu_torch/parallel/__init__.py",
)
_TENSOR_CTORS = {"empty", "zeros", "full", "arange", "as_tensor", "tensor"}


def _is_current_device(node: ast.AST) -> bool:
    """A device spelled without an index: "cuda" or torch.device("cuda")
    (placement on whatever device is current)."""
    if isinstance(node, ast.Constant):
        return node.value == "cuda"
    if (isinstance(node, ast.Call) and (dotted(node.func) or "")
            in ("torch.device", "device") and len(node.args) == 1
            and not node.keywords):
        return _is_current_device(node.args[0])
    return False


class ShardingDisciplineRule(Rule):
    """Mesh commit-path modules must place tensors explicitly: every
    torch.empty/zeros/full/arange/as_tensor/tensor call passes `device=`
    (a `**kwargs` splat is trusted — the options were assembled
    elsewhere), no device is the index-less "cuda", every placing
    `.to(...)` names its device, and no `.cuda()` goes without one — or
    a `# sharding:` comment justifies the site."""

    id = "SA012"
    title = "commit-path tensor placed without an explicit device"

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if src.relpath not in SHARDING_DISCIPLINE_PATHS:
            return iter(())
        rule = self
        findings: List[Finding] = []

        def annotated(lo: int, hi: int) -> bool:
            # `# sharding: ...` on any line in [lo-2, hi] (same line or
            # the two lines above)
            return any("sharding:" in src.comments.get(ln, "")
                       for ln in range(max(1, lo - 2), hi + 1))

        def kw(call: ast.Call, name: str) -> Optional[ast.AST]:
            for k in call.keywords:
                if k.arg == name:
                    return k.value
            return None

        class V(QualnameVisitor):
            def visit_Call(self, node: ast.Call) -> None:
                name = dotted(node.func) or ""
                last = (node.func.attr if isinstance(node.func, ast.Attribute)
                        else name)
                span = (node.lineno, getattr(node, "end_lineno", node.lineno))
                msg = None
                if name.startswith("torch.") and last in _TENSOR_CTORS \
                        and name.count(".") == 1:
                    dev = kw(node, "device")
                    splat = any(k.arg is None for k in node.keywords)
                    if dev is None and not splat:
                        msg = (f"`{name}` without device= lands on the "
                               f"default device (the host) — pass the "
                               f"shard's device explicitly")
                    elif dev is not None and _is_current_device(dev):
                        msg = (f"`{name}` on the index-less \"cuda\" is "
                               f"the current device, not the shard's — "
                               f"pass the shard's torch.device")
                elif isinstance(node.func, ast.Attribute) and last == "to":
                    dev = node.args[0] if node.args else kw(node, "device")
                    if dev is not None and _is_current_device(dev):
                        msg = ("`.to(\"cuda\")` moves to the current "
                               "device, not the shard's — name the "
                               "shard's torch.device")
                elif (isinstance(node.func, ast.Attribute) and last == "cuda"
                        and not node.args and kw(node, "device") is None):
                    msg = ("bare `.cuda()` places on the current device, "
                           "not the shard's — use `.to(<shard device>)`")
                if msg and not annotated(*span):
                    findings.append(rule.finding(src, node, self.qualname,
                                                 msg))
                self.generic_visit(node)

        V().visit(src.tree)
        return iter(findings)


# ------------------------------------------------------------------ SA013

class LockOrderRule(Rule):
    """Global lock-order deadlock lint.  The linker canonicalizes every
    `with <lock>` / `.acquire()` site and every `# guarded-by:` entry
    annotation to an owner-qualified lock identity, propagates
    may-acquire sets through the call graph, and builds the lock-order
    edge set (`held -> acquired-under-it`).  A cycle in that graph is a
    potential AB/BA deadlock: two threads entering the cycle from
    different locks can block each other forever.  The finding carries
    the full witness — the function chain, with files and lines, for
    every edge of the cycle.  Reentrant re-acquisition of a held RLock
    is not an edge (no self-edges), and a lock whose identity cannot be
    resolved (generic attr name through an untyped receiver) is dropped
    from the graph rather than risk a bogus unification cycle.

    The acyclic order this rule certifies is mirrored at runtime by
    `coreth_tpu_torch.utils.racecheck.CANONICAL_LOCK_ORDER` (the lock-order
    witness asserts observed acquisitions against it under the chaos
    conductor); tests/test_torch_analysis.py pins the two against each
    other."""

    id = "SA013"
    title = "lock-order cycle (potential deadlock)"

    def check(self, src: SourceFile) -> Iterator[Finding]:
        return iter(())

    def finalize_program(self, program) -> Iterator[Finding]:
        for cycle in program.lock_cycles():
            key, line, _action = cycle.edges[0].witness[0]
            node = program.funcs[key]
            yield Finding(
                self.id, node.relpath, line, node.rec.qualname,
                "lock-order cycle (potential deadlock):\n  "
                + cycle.render(program.funcs).replace("\n", "\n  "))


# ------------------------------------------------------------------ SA014

# The /metrics exposition sanitizes every registry name down to
# `[a-zA-Z_][a-zA-Z0-9_]*` — two registry names that differ only in
# separator characters silently COLLIDE into one exposition family, and
# a name registered as a counter in one module and a gauge in another
# raises at runtime only when the second call site finally executes.
# The namespace grammar that keeps both failure modes impossible:
# lower-case `[a-z0-9_/]` with `/` as the hierarchy separator (the
# go-metrics convention every existing family follows).  metrics/ itself
# is exempt: the sanitizer tests and the synthetic --check registry
# exercise hostile names on purpose, and racecheck's lock/<canonical>
# families (which legally carry `.`/`:`) are registered through the
# metrics-adjacent telemetry helpers documented in OBSERVABILITY.md.
METRICS_FAMILY_RE_SRC = r"^[a-z0-9_/]+$"
_METRICS_FAMILY_RE = re.compile(METRICS_FAMILY_RE_SRC)
_METRICS_FAMILY_CHARSET = frozenset("abcdefghijklmnopqrstuvwxyz0123456789_/")
_METRICS_CTOR_METHODS = ("counter", "gauge", "meter", "timer", "histogram")
_METRICS_EXEMPT_PREFIXES = ("coreth_tpu_torch/metrics/", "coreth_tpu_torch/utils/racecheck")


def _metric_name_parts(node: ast.AST):
    """(kind, literal_fragments) for a metric name argument: kind is
    'literal' (whole name known), 'fragments' (f-string / concat — only
    the constant pieces are checkable), or None (pure variable)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return "literal", [node.value]
    if isinstance(node, ast.JoinedStr):
        frags = [v.value for v in node.values
                 if isinstance(v, ast.Constant) and isinstance(v.value, str)]
        return "fragments", frags
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        frags: List[str] = []
        for side in (node.left, node.right):
            kind, sub = _metric_name_parts(side)
            if kind == "literal":
                frags.extend(sub)
            elif kind == "fragments":
                frags.extend(sub)
        return "fragments", frags
    return None, []


class MetricsFamilyRule(Rule):
    """Registry names created outside metrics/ must follow the
    `^[a-z0-9_/]+$` namespace grammar, and one family name must never be
    registered under two different metric types anywhere in the repo."""

    id = "SA014"
    title = "metric family name breaks the namespace grammar"

    def __init__(self):
        # name -> {metric type -> (relpath, qualname, line)} across files
        self._families: Dict[str, Dict[str, Tuple[str, str, int]]] = {}

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if src.relpath.startswith(_METRICS_EXEMPT_PREFIXES):
            return iter(())
        rule = self
        findings: List[Finding] = []

        class V(QualnameVisitor):
            def visit_Call(self, node: ast.Call) -> None:
                self.generic_visit(node)
                func = node.func
                if not (isinstance(func, ast.Attribute)
                        and func.attr in _METRICS_CTOR_METHODS
                        and node.args):
                    return
                kind, frags = _metric_name_parts(node.args[0])
                if kind == "literal":
                    name = frags[0]
                    if not _METRICS_FAMILY_RE.match(name):
                        findings.append(rule.finding(
                            src, node, self.qualname,
                            f"metric name {name!r} breaks the "
                            f"`{METRICS_FAMILY_RE_SRC}` family grammar — "
                            f"the exposition sanitizer folds every other "
                            f"character to '_', silently colliding "
                            f"families"))
                elif kind == "fragments":
                    for frag in frags:
                        bad = set(frag) - _METRICS_FAMILY_CHARSET
                        if bad:
                            findings.append(rule.finding(
                                src, node, self.qualname,
                                f"metric name fragment {frag!r} carries "
                                f"characters outside the "
                                f"`{METRICS_FAMILY_RE_SRC}` family "
                                f"grammar: {sorted(bad)}"))
                            break

        V().visit(src.tree)
        return iter(findings)

    def summarize(self, src: SourceFile):
        if src.relpath.startswith(_METRICS_EXEMPT_PREFIXES):
            return []
        rows: List[Tuple[str, str, str, int]] = []

        class V(QualnameVisitor):
            def visit_Call(self, node: ast.Call) -> None:
                self.generic_visit(node)
                func = node.func
                if not (isinstance(func, ast.Attribute)
                        and func.attr in _METRICS_CTOR_METHODS
                        and node.args):
                    return
                kind, frags = _metric_name_parts(node.args[0])
                if kind == "literal":
                    rows.append((frags[0], func.attr, self.qualname,
                                 node.lineno))

        V().visit(src.tree)
        return rows

    def absorb(self, relpath: str, summary) -> None:
        for name, mtype, qualname, line in summary or ():
            self._families.setdefault(name, {}).setdefault(
                mtype, (relpath, qualname, line))

    def finalize(self) -> Iterator[Finding]:
        for name in sorted(self._families):
            by_type = self._families[name]
            if len(by_type) < 2:
                continue
            sites = sorted((mtype, loc) for mtype, loc in by_type.items())
            (first_type, first_loc) = sites[0]
            others = ", ".join(
                f"{mtype} at {loc[0]}:{loc[2]}" for mtype, loc in sites[1:])
            yield Finding(
                self.id, first_loc[0], first_loc[2], first_loc[1],
                f"metric family {name!r} registered as {first_type} here "
                f"but also as {others} — the registry raises on the "
                f"second type at runtime; pick one type per family")
        self._families.clear()


ALL_RULES: Tuple[type, ...] = (
    SilentExceptRule, LockDisciplineRule, HotPathPurityRule,
    ConsensusFloatRule, UnorderedIterationRule, FailpointHygieneRule,
    ServingBoundednessRule, BackendIsolationRule, FoldOrderRule,
    ReadTierLockRule, ShardWorkerIsolationRule, ShardingDisciplineRule,
    LockOrderRule, MetricsFamilyRule,
)


def default_rules() -> List[Rule]:
    return [cls() for cls in ALL_RULES]
