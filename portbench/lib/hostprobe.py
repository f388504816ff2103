"""A fixed piece of host-only work, timed, and what the kernel says of the
process's CPU: printed when set-up starts, when the window opens and when
it closes, so that a run that reads slow can be told apart as a slow host
or a slow program. It touches nothing of the port.

The work is in two parts: pure Python (dict and bytes objects, as the
mirror's bookkeeping is) and a random gather over 128 MiB (memory-bound,
as the native planner's walk of a large trie is). Each part runs REPEAT
times and the fastest is kept.
"""

from __future__ import annotations

import os
import time

import numpy as np

REPEAT = 3
_GATHER: list = []  # [array, indices], made on first use


def _python_ms() -> float:
    t = time.perf_counter()
    d = {}
    for i in range(100_000):
        d[i.to_bytes(4, "little")] = i
    s = 0
    for v in d.values():
        s += v
    return (time.perf_counter() - t) * 1e3


def _memory_ms() -> float:
    if not _GATHER:
        _GATHER.extend((np.arange(1 << 25, dtype=np.int32),  # 128 MiB
                        np.random.default_rng(0).integers(0, 1 << 25,
                                                          1 << 21)))
    a, idx = _GATHER
    t = time.perf_counter()
    a[idx].sum()
    return (time.perf_counter() - t) * 1e3


def _steal_s() -> float:
    """Seconds the hypervisor ran something else on this machine's CPUs
    (all of them, since boot): /proc/stat's steal column."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return float("nan")


def _cpu() -> int:
    """The CPU this thread last ran on (/proc/self/stat, field 39)."""
    try:
        with open("/proc/self/stat") as f:
            return int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, IndexError, ValueError):
        return -1


def probe() -> dict:
    py = min(_python_ms() for _ in range(REPEAT))
    mem = min(_memory_ms() for _ in range(REPEAT))
    try:
        load = os.getloadavg()
    except OSError:
        load = (float("nan"),) * 3
    return {"python_ms": py, "memory_ms": mem, "cpu": _cpu(),
            "steal_s": _steal_s(), "load": load,
            "cpus": len(os.sched_getaffinity(0))}


def line(label: str, p: dict) -> str:
    return (f"host {label}: python {p['python_ms']:.3f} ms, memory "
            f"{p['memory_ms']:.3f} ms, on cpu {p['cpu']} of {p['cpus']}, "
            f"steal {p['steal_s']:.2f} s since boot, load "
            + " ".join(f"{x:.2f}" for x in p["load"]))
