"""Lock telemetry as debug_lockStatus and the sampling profiler read it;
the reading half of coreth_tpu/utils/racecheck.py.

In the reference these tables are filled by the lock proxies of
LockOrderWitness and RaceDetector.require_lock, which only fault/chaos.py
and the race-discipline tests install, and the slow-hold budget those
proxies check comes from lock-slow-hold-budget. The proxies come with
chaos.py (ROADMAP "Still to port", item 8b), and vm/config.py refuses the
knob until then. So no lock of the port is instrumented: the tables are
empty and the budget is 0, as the reference answers on a node that
installs no witness.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def slow_hold_budget() -> float:
    """Seconds a canonical-lock hold may last before it is captured; 0
    (off) until the lock witness is ported."""
    return 0.0


def contention_table() -> List[Dict[str, object]]:
    """The debug_lockStatus rows, one per instrumented lock ranked by
    total acquire-wait: none, since no lock is instrumented."""
    return []


def recent_slow_holds() -> List[Dict[str, object]]:
    """The recent slow-hold captures: none, with the budget off."""
    return []


def held_locks_snapshot() -> Dict[int, Tuple[str, ...]]:
    """Thread ident -> names of the witnessed locks it holds, which the
    profiler tags its samples with: empty, with no witness installed."""
    return {}
