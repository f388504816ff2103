"""AST lint engine — the repo-native analog of `go vet` (SURVEY §5).

The reference coreth keeps its concurrency and error-handling discipline
honest with `go vet` + `go test -race`; this package is the Python port's
equivalent: a small AST walker (`Engine`) over pluggable `Rule` visitors,
each encoding one repo-specific invariant (silent excepts, lock
discipline, hot-path purity, consensus float-freedom, unordered
iteration into hashing).  Findings carry file:line + rule id + the
enclosing qualname, and are keyed `RULE:relpath:qualname` so the
checked-in baseline (`analysis/baseline.txt`) survives line drift.

Source-level annotations the rules understand (scanned from comments):

    # guarded-by: <lockattr>   on an attribute assignment → that
                               attribute must only be mutated with
                               self.<lockattr> held
    # guarded-by: <lockattr>   on a `def` line → the method's CALLER
                               holds the lock (helper-under-lock), so
                               writes inside it count as guarded
    # hot-path                 on a `def` line → SA003 purity rules
                               apply to the function body
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")
HOT_PATH_RE = re.compile(r"#\s*hot-path\b")


@dataclass(frozen=True)
class Finding:
    rule: str            # "SA001"
    path: str            # repo-relative posix path
    line: int
    qualname: str        # enclosing Class.method / function / "<module>"
    message: str

    @property
    def key(self) -> str:
        """Baseline key: stable across line drift within one function."""
        return f"{self.rule}:{self.path}:{self.qualname}"

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} [{self.qualname}] {self.message}"


@dataclass
class SourceFile:
    relpath: str
    text: str
    tree: ast.Module
    # line -> comment text (comments only; from tokenize, so string
    # literals containing '#' can never masquerade as annotations)
    comments: Dict[int, str] = field(default_factory=dict)
    # line -> lock name from a `# guarded-by: <lock>` annotation
    guarded_by: Dict[int, str] = field(default_factory=dict)
    # lines carrying a `# hot-path` marker
    hot_lines: frozenset = frozenset()

    @classmethod
    def from_source(cls, text: str, relpath: str = "<fixture>") -> "SourceFile":
        tree = ast.parse(text)
        comments: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    comments[tok.start[0]] = tok.string
        except tokenize.TokenError:
            pass  # a truncated final line still yields earlier comments
        guarded = {}
        hot = set()
        for line, c in comments.items():
            m = GUARDED_BY_RE.search(c)
            if m:
                guarded[line] = m.group(1)
            if HOT_PATH_RE.search(c):
                hot.add(line)
        return cls(relpath=relpath, text=text, tree=tree,
                   comments=comments, guarded_by=guarded,
                   hot_lines=frozenset(hot))

    def def_annotation(self, node: ast.AST) -> Tuple[Optional[str], bool]:
        """(guarded-by lock, hot?) for a def: the annotation comment may sit
        anywhere on the signature (multi-line defs included), the line above
        the def, or a decorator line."""
        body = getattr(node, "body", None)
        sig_end = body[0].lineno - 1 if body else node.lineno
        lines = list(range(node.lineno, max(node.lineno, sig_end) + 1))
        if getattr(node, "decorator_list", None):
            lines.extend(d.lineno for d in node.decorator_list)
        lines.append(min(lines) - 1)
        lock = None
        hot = False
        for ln in lines:
            if ln in self.guarded_by and lock is None:
                lock = self.guarded_by[ln]
            if ln in self.hot_lines:
                hot = True
        return lock, hot


class Rule:
    """One invariant. Subclasses set `id`/`title` and implement check()."""

    id: str = "SA000"
    title: str = ""

    def check(self, src: SourceFile) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError

    def summarize(self, src: SourceFile):
        """Optional picklable per-file digest for cross-file state.  The
        engine calls this right after check() on a fresh parse, caches
        the result alongside the file's findings, and replays it through
        absorb() on cache hits — so stateful rules stay correct when the
        per-file passes are skipped entirely.  Contract: summarize() runs
        only after check() on the same SourceFile."""
        return None

    def absorb(self, relpath: str, summary) -> None:
        """Feed back a (possibly cached) per-file summary before
        finalize().  Files arrive in sorted-relpath order."""

    def finalize(self) -> Iterator[Finding]:
        """Cross-file pass, called once after every file has been
        check()ed/absorb()ed.  Stateful rules (SA006 failpoint registry)
        report whole-package invariants here; the default has none."""
        return iter(())

    def finalize_program(self, program) -> Iterator[Finding]:
        """Interprocedural pass over the linked whole-repo
        `callgraph.Program` (call edges, lock summaries, import
        closure), called once after finalize().  SA013 and the
        promoted SA003/SA010/SA011 live here; the default has none."""
        return iter(())

    def finding(self, src: SourceFile, node: ast.AST, qualname: str,
                message: str) -> Finding:
        return Finding(self.id, src.relpath, getattr(node, "lineno", 0),
                       qualname, message)


class QualnameVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the enclosing Class.method qualname."""

    def __init__(self):
        self._stack: List[str] = []

    @property
    def qualname(self) -> str:
        return ".".join(self._stack) if self._stack else "<module>"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    def _visit_func(self, node) -> None:
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


# --------------------------------------------------------------- baseline

class BaselineError(ValueError):
    pass


def load_baseline(path: Path) -> Dict[str, str]:
    """Parse the allowlist: one `RULE path:qualname — justification` per
    line; '#' comments and blanks skipped.  A missing justification is an
    error — the allowlist must say WHY each site is exempt."""
    entries: Dict[str, str] = {}
    for n, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^(SA\d{3})\s+(\S+)\s+[—-]+\s*(.+)$", line)
        if not m:
            raise BaselineError(f"{path.name}:{n}: unparseable entry: {raw!r}")
        rule, site, why = m.groups()
        if not why.strip():
            raise BaselineError(f"{path.name}:{n}: missing justification")
        entries[f"{rule}:{site}"] = why.strip()
    return entries


def apply_baseline(findings: List[Finding], baseline: Dict[str, str]):
    """Split into (new, suppressed, unused-baseline-keys)."""
    new: List[Finding] = []
    suppressed: List[Finding] = []
    used = set()
    for f in findings:
        if f.key in baseline:
            suppressed.append(f)
            used.add(f.key)
        else:
            new.append(f)
    unused = sorted(set(baseline) - used)
    return new, suppressed, unused


# ----------------------------------------------------------------- engine

class Engine:
    def __init__(self, rules: Iterable[Rule]):
        self.rules = list(rules)
        # the linked whole-repo Program from the last
        # check_package()/check_program() run (for the --graph CLI)
        self.program = None

    def _check_one(self, src: SourceFile):
        """(findings, {rule_id: summary}) for one parsed file."""
        findings: List[Finding] = []
        summaries: Dict[str, object] = {}
        for rule in self.rules:
            findings.extend(rule.check(src))
            s = rule.summarize(src)
            if s is not None:
                summaries[rule.id] = s
        return findings, summaries

    def check_source(self, text: str, relpath: str = "<fixture>") -> List[Finding]:
        """Single-file pass (per-file rules only; cross-file state is
        absorbed so a later finalize() on this engine sees it)."""
        src = SourceFile.from_source(text, relpath)
        findings, summaries = self._check_one(src)
        for rule in self.rules:
            if rule.id in summaries:
                rule.absorb(relpath, summaries[rule.id])
        return findings

    def check_file(self, path: Path, root: Path) -> List[Finding]:
        rel = path.relative_to(root.parent).as_posix()
        try:
            text = path.read_text()
        except (OSError, UnicodeDecodeError) as exc:
            return [Finding("SA000", rel, 0, "<module>", f"unreadable: {exc}")]
        try:
            return self.check_source(text, rel)
        except SyntaxError as exc:
            return [Finding("SA000", rel, exc.lineno or 0, "<module>",
                            f"syntax error: {exc.msg}")]

    def check_program(self, sources: Iterable[Tuple[str, str]]
                      ) -> List[Finding]:
        """Full pipeline over in-memory (text, relpath) pairs: per-file
        rules, cross-file finalize, and the interprocedural
        finalize_program over the linked call graph.  This is what the
        multi-file fixture tests drive; check_package is the same flow
        plus the on-disk walk and cache."""
        from . import callgraph

        out: List[Finding] = []
        graphs = []
        for text, relpath in sources:
            src = SourceFile.from_source(text, relpath)
            findings, summaries = self._check_one(src)
            out.extend(findings)
            for rule in self.rules:
                if rule.id in summaries:
                    rule.absorb(relpath, summaries[rule.id])
            graphs.append(callgraph.extract_file(src))
        for rule in self.rules:
            out.extend(rule.finalize())
        self.program = callgraph.build_program(graphs)
        for rule in self.rules:
            out.extend(rule.finalize_program(self.program))
        out.sort(key=lambda f: (f.path, f.line, f.rule))
        return out

    def check_package(self, package_root: Path,
                      cache=None) -> List[Finding]:
        """Walk every .py under [package_root] (the coreth_tpu_torch dir).
        With a `cache.FileCache`, unchanged files skip parse + per-file
        rules + graph extraction entirely (findings, summaries, and the
        FileGraph replay from the cache); the cross-file finalize and
        the interprocedural link always run fresh."""
        from . import callgraph

        out: List[Finding] = []
        graphs = []
        for path in sorted(package_root.rglob("*.py")):
            rel = path.relative_to(package_root.parent).as_posix()
            entry = cache.lookup(path, rel) if cache is not None else None
            if entry is None:
                findings: List[Finding]
                summaries: Dict[str, object] = {}
                graph = None
                try:
                    text = path.read_text()
                except (OSError, UnicodeDecodeError) as exc:
                    findings = [Finding("SA000", rel, 0, "<module>",
                                        f"unreadable: {exc}")]
                else:
                    try:
                        src = SourceFile.from_source(text, rel)
                    except SyntaxError as exc:
                        findings = [Finding("SA000", rel, exc.lineno or 0,
                                            "<module>",
                                            f"syntax error: {exc.msg}")]
                    else:
                        findings, summaries = self._check_one(src)
                        graph = callgraph.extract_file(src)
                if cache is not None:
                    cache.store(path, rel, findings, summaries, graph)
            else:
                findings, summaries, graph = entry
            out.extend(findings)
            if graph is not None:
                graphs.append(graph)
            for rule in self.rules:
                if rule.id in summaries:
                    rule.absorb(rel, summaries[rule.id])
        for rule in self.rules:
            out.extend(rule.finalize())
        self.program = callgraph.build_program(graphs)
        for rule in self.rules:
            out.extend(rule.finalize_program(self.program))
        if cache is not None:
            cache.save()
        out.sort(key=lambda f: (f.path, f.line, f.rule))
        return out
