"""Per-file analysis cache: warm lint runs skip parse + rule passes.

The cold pipeline costs ~3s of parse/tokenize + ~3s of rule visitors on
this repo — too slow for a tier-1 gate that runs on every lint.  The
profile says re-loading pickled ASTs costs nearly as much as re-parsing
them, so the cache deliberately stores *results*, not trees: per file,
the findings list, each stateful rule's picklable summary (replayed via
`Rule.absorb`), and the `callgraph.FileGraph` extraction — everything
downstream of the AST.  A warm run re-does only the cheap whole-repo
work: baseline matching, cross-file finalize, and the call-graph link.

Keying: a file entry is valid iff its (st_mtime_ns, st_size) pair is
unchanged.  The whole cache is additionally fingerprinted by the
analyzer's own sources (every .py in this directory, same mtime/size
pair) and a schema number — editing a rule invalidates everything.

The store is one pickle under the system temp dir, keyed by the package
path and uid so parallel checkouts and users never collide.  Corrupt or
stale caches are ignored, never trusted; writes go through a temp file
+ os.replace so a crashed run can't leave a torn cache.  Set
CORETH_TPU_TORCH_ANALYSIS_CACHE to a path to relocate it, or to "off"/"0"
to disable (the CLI's --no-cache does the same).  The variable and the
file-name stem are the port's own (the reference's are
CORETH_TPU_ANALYSIS_CACHE and coreth-tpu-analysis-*), so the two
packages' caches never mix, even when both gates run at once.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

CACHE_SCHEMA = 1


def analyzer_token() -> Tuple:
    """Fingerprint of the analyzer itself: rule edits invalidate the
    whole cache (cached findings were produced by different code)."""
    here = Path(__file__).resolve().parent
    parts = []
    for p in sorted(here.glob("*.py")):
        try:
            st = p.stat()
        except OSError:
            continue
        parts.append((p.name, st.st_mtime_ns, st.st_size))
    return tuple(parts)


def default_cache_path(package_root: Path) -> Optional[Path]:
    env = os.environ.get("CORETH_TPU_TORCH_ANALYSIS_CACHE")
    if env is not None:
        if env.strip().lower() in ("", "0", "off", "no"):
            return None
        return Path(env)
    digest = hashlib.md5(str(package_root).encode()).hexdigest()[:10]
    uid = getattr(os, "getuid", lambda: 0)()
    return (Path(tempfile.gettempdir())
            / f"coreth-tpu-torch-analysis-{digest}-{uid}.pkl")


class FileCache:
    """mtime/size-keyed store of (findings, summaries, FileGraph)."""

    def __init__(self, path: Path, token: Tuple):
        self.path = path
        self.token = token
        self.files: Dict[str, dict] = {}
        self._touched: set = set()
        self._dirty = False

    @classmethod
    def load(cls, path: Optional[Path]) -> Optional["FileCache"]:
        if path is None:
            return None
        token = analyzer_token()
        cache = cls(path, token)
        try:
            with path.open("rb") as fh:
                blob = pickle.load(fh)
            if (blob.get("schema") == CACHE_SCHEMA
                    and blob.get("token") == token):
                cache.files = blob.get("files", {})
        except (OSError, pickle.UnpicklingError, EOFError, AttributeError,
                ImportError, IndexError, ValueError, KeyError):
            pass  # absent/corrupt/stale caches start empty
        return cache

    def lookup(self, path: Path, rel: str):
        try:
            st = path.stat()
        except OSError:
            return None
        entry = self.files.get(rel)
        if entry is None or entry["meta"] != (st.st_mtime_ns, st.st_size):
            return None
        self._touched.add(rel)
        return entry["findings"], entry["summaries"], entry["graph"]

    def store(self, path: Path, rel: str, findings, summaries, graph) -> None:
        try:
            st = path.stat()
        except OSError:
            return
        self.files[rel] = {"meta": (st.st_mtime_ns, st.st_size),
                           "findings": findings, "summaries": summaries,
                           "graph": graph}
        self._touched.add(rel)
        self._dirty = True

    def save(self) -> None:
        stale = set(self.files) - self._touched
        if stale:
            for rel in stale:  # deleted/renamed files fall out
                del self.files[rel]
            self._dirty = True
        if not self._dirty:
            return
        blob = {"schema": CACHE_SCHEMA, "token": self.token,
                "files": self.files}
        try:
            fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                       prefix=self.path.name + ".")
            try:
                with os.fdopen(fd, "wb") as fh:
                    pickle.dump(blob, fh, protocol=pickle.HIGHEST_PROTOCOL)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            pass  # a read-only temp dir degrades to cold runs, not errors
