"""Repo-native static analysis over the port (the `go vet` role, SURVEY
§5): the counterpart of coreth_tpu/analysis/.

`python -m coreth_tpu_torch.analysis` walks coreth_tpu_torch/ with the
SA001–SA014 rule set and exits non-zero on any finding outside the
port's own checked-in allowlist (`coreth_tpu_torch/analysis/
baseline.txt`; never the reference's). Tier-1 gate:
tests/test_torch_analysis.py runs the same entry point.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .engine import (BaselineError, Engine, Finding, SourceFile,
                     apply_baseline, load_baseline)
from .rules import ALL_RULES, default_rules

PACKAGE_ROOT = Path(__file__).resolve().parent.parent
BASELINE_PATH = Path(__file__).resolve().parent / "baseline.txt"

__all__ = [
    "ALL_RULES", "BASELINE_PATH", "BaselineError", "Engine", "Finding",
    "PACKAGE_ROOT", "SourceFile", "apply_baseline", "default_rules",
    "load_baseline", "run_repo",
]


def run_repo(package_root: Optional[Path] = None,
             baseline_path: Optional[Path] = None,
             cache: bool = True,
             engine: Optional[Engine] = None,
             ) -> Tuple[List[Finding], List[Finding], List[str], Dict[str, str]]:
    """Analyze the package. Returns (new, suppressed, unused_baseline_keys,
    baseline) — `new` non-empty means the gate is red.  With cache=True
    (default) unchanged files replay from the per-file result cache (see
    cache.py); pass an Engine to inspect `engine.program` afterwards."""
    engine = engine if engine is not None else Engine(default_rules())
    root = package_root or PACKAGE_ROOT
    fc = None
    if cache:
        from .cache import FileCache, default_cache_path
        fc = FileCache.load(default_cache_path(root))
    findings = engine.check_package(root, cache=fc)
    bp = baseline_path if baseline_path is not None else BASELINE_PATH
    baseline = load_baseline(bp) if bp.exists() else {}
    new, suppressed, unused = apply_baseline(findings, baseline)
    return new, suppressed, unused, baseline
