"""CLI: `python -m coreth_tpu_torch.analysis [options]`.

Exit codes: 0 clean (every finding baselined), 1 new findings or stale
baseline entries with --strict-baseline, 2 bad invocation/baseline.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import (BASELINE_PATH, PACKAGE_ROOT, BaselineError, run_repo)
from .rules import ALL_RULES


def _graph_mode(program, fragment: str) -> int:
    """`--graph <qualname>`: triage view of the interprocedural layer —
    callers, callees, direct + transitive lock sets for every function
    matching [fragment]; `--graph locks` prints the global lock-order
    edge set and the derived canonical order."""
    if program is None:
        print("no program built (package walk failed?)", file=sys.stderr)
        return 2
    if fragment == "locks":
        edges = program.lock_edges()
        print(f"lock-order graph: {len(edges)} edge(s)")
        for (a, b), e in sorted(edges.items()):
            key, line, _act = e.witness[0]
            node = program.funcs[key]
            print(f"  {a} -> {b}    [{node.relpath}:{line} "
                  f"{node.qualname}]")
        cycles = program.lock_cycles()
        for c in cycles:
            print("CYCLE:")
            print(c.render(program.funcs))
        print("canonical order:" if not cycles
              else "order (unreliable, cycles present):")
        for name in program.lock_order():
            print(f"  {name}")
        return 0
    nodes = program.find(fragment)
    if not nodes:
        print(f"no function matches {fragment!r}", file=sys.stderr)
        return 1
    summaries = program.lock_summaries()
    for node in nodes[:20]:
        print(f"{node.key}  (line {node.line})")
        if node.entry_locks:
            print(f"  entry locks (guarded-by): "
                  f"{', '.join(sorted(node.entry_locks))}")
        direct = sorted({lock for lock, _l, _h, _s in node.acquires})
        if direct:
            print(f"  acquires: {', '.join(direct)}")
        transitive = sorted(set(summaries.get(node.key, ())) - set(direct))
        if transitive:
            print(f"  may acquire transitively: {', '.join(transitive)}")
        for ck, line, held in sorted(node.callees):
            extra = (f"  [holding {', '.join(sorted(held))}]"
                     if held else "")
            print(f"  -> {ck}  (line {line}){extra}")
        for ck, line in sorted(node.callers):
            print(f"  <- {ck}  (line {line})")
        if node.unresolved:
            shown = ", ".join(t for t, _l in node.unresolved[:8])
            more = len(node.unresolved) - 8
            print(f"  unresolved calls: {shown}"
                  + (f" (+{more} more)" if more > 0 else ""))
    if len(nodes) > 20:
        print(f"... {len(nodes) - 20} more matches")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m coreth_tpu_torch.analysis",
        description="repo-native static analysis of the port (SA001-SA014)")
    ap.add_argument("--package", type=Path, default=PACKAGE_ROOT,
                    help="package dir to walk (default: coreth_tpu_torch)")
    ap.add_argument("--baseline", type=Path, default=BASELINE_PATH,
                    help="allowlist file (default: analysis/baseline.txt)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the allowlist")
    ap.add_argument("--json", action="store_true", help="machine output")
    ap.add_argument("--strict-baseline", action="store_true",
                    help="fail on stale allowlist entries too")
    ap.add_argument("--write-baseline", action="store_true",
                    help="append new findings to the allowlist as TODO "
                         "entries (then edit in real justifications)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore the per-file result cache (cold run)")
    ap.add_argument("--graph", metavar="QUALNAME",
                    help="debug mode: print callers/callees + inferred "
                         "lock set for functions matching QUALNAME "
                         "(substring of 'relpath:Class.method'), plus "
                         "the global lock-order graph for 'locks'")
    args = ap.parse_args(argv)

    if args.list_rules:
        for cls in ALL_RULES:
            print(f"{cls.id}  {cls.title}")
        return 0

    from .engine import Engine
    from .rules import default_rules
    engine = Engine(default_rules())
    try:
        new, suppressed, unused, baseline = run_repo(
            args.package,
            args.baseline if not args.no_baseline else Path("/nonexistent"),
            cache=not args.no_cache, engine=engine)
    except BaselineError as exc:
        print(f"baseline error: {exc}", file=sys.stderr)
        return 2

    if args.graph:
        return _graph_mode(engine.program, args.graph)

    if args.json:
        print(json.dumps({
            "new": [f.__dict__ for f in new],
            "suppressed": len(suppressed),
            "unused_baseline": unused,
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        for key in unused:
            print(f"warning: stale baseline entry (no longer fires): {key}",
                  file=sys.stderr)
        print(f"{len(new)} finding(s), {len(suppressed)} baselined, "
              f"{len(unused)} stale baseline entr{'y' if len(unused)==1 else 'ies'}",
              file=sys.stderr)

    if args.write_baseline and new:
        with args.baseline.open("a") as fh:
            for f in new:
                fh.write(f"{f.rule} {f.path}:{f.qualname} — TODO: justify "
                         f"({f.message})\n")
        print(f"appended {len(new)} entries to {args.baseline}",
              file=sys.stderr)

    if new:
        return 1
    if unused and args.strict_baseline:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
