"""Compile a C++/CUDA source into a shared library under coreth_tpu_torch/_build/
and dlopen it.

Counterpart of coreth_tpu/native/_build.py with one difference: a failed
build raises (with the compiler's output) instead of returning None, so no
caller can drift to a slower path unnoticed. The stale check and the
compile run under an exclusive fcntl lock on <build dir>/<lib>.lock, so
concurrent processes (pytest-xdist workers) compile each library once and
the others load what it built; the compile still goes to a process-unique
temp file renamed into place, so no process ever sees a half-written
library.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile
from typing import Sequence

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


class BuildError(RuntimeError):
    """A compiler failed, timed out or is missing."""


def _stale(srcs: Sequence[str], lib_path: str) -> bool:
    """True when lib_path is missing or older than a source or any header
    (.h/.cuh) beside one."""
    if not os.path.exists(lib_path):
        return True
    newest = 0.0
    for src in srcs:
        d = os.path.dirname(os.path.abspath(src))
        newest = max(newest, os.path.getmtime(src))
        for f in os.listdir(d):
            if f.endswith((".h", ".cuh")):
                newest = max(newest, os.path.getmtime(os.path.join(d, f)))
    return os.path.getmtime(lib_path) < newest


def build_and_load(compiler: Sequence[str], srcs: Sequence[str], lib_name: str,
                   link: Sequence[str] = (), timeout: int = 600,
                   build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Run `compiler... -o <lib> srcs... link...` if stale, then CDLL it.
    The compiler's output is kept beside the library as <lib>.log.
    Raises BuildError when the compiler fails or is missing."""
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, lib_name)
    with open(lib_path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale(srcs, lib_path):
            _compile(compiler, srcs, lib_name, lib_path, link, timeout)
    return ctypes.CDLL(lib_path)


def _compile(compiler, srcs, lib_name, lib_path, link, timeout) -> None:
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib_path))
    os.close(fd)
    cmd = [*compiler, "-o", tmp, *srcs, *link]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise BuildError(f"build of {lib_name} failed: {e}") from e
    if r.returncode != 0:
        os.unlink(tmp)
        raise BuildError(
            f"build of {lib_name} failed ({' '.join(cmd)}):\n"
            f"{r.stdout}{r.stderr}")
    with open(lib_path + ".log", "w") as f:
        f.write(f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
    os.rename(tmp, lib_path)
