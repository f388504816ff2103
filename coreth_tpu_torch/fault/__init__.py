"""Deterministic failpoints + the shared backoff helper; counterpart of
coreth_tpu/fault/__init__.py (the chaos conductor that arms them across
subsystems is fault/chaos.py).

Named fault-injection sites compiled into production code paths. The
contract mirrors metrics.spans: when nothing is armed the whole package
is a single module-bool check per site (`if not enabled: return`), so
hot paths pay one dict-free branch. Arming any failpoint (env, RPC, or
tests) flips the bool and routes the named site through its action.

Site names are registered at import time of the module that contains
them (`register("chain/tail/before_head")`); arming an unregistered
name raises, so a typo'd chaos script fails loudly instead of silently
never firing.

Action spec grammar (env `CORETH_TPU_FAILPOINTS="name=spec;name2=spec2"`
or `set_failpoint`):

    spec   := verb [":" arg] ["%" prob] ["*" count]
    verb   := "raise" | "hang"
    arg    := message (raise) | milliseconds (hang)
    prob   := fire probability in (0, 1]   (default 1 = always)
    count  := max number of fires          (default unlimited)

`hang` with no argument parks the caller on an event that `clear()` /
`clear_all()` releases — kill-injection tests SIGKILL the process while
parked, in-process tests un-hang by disarming. Probabilistic fires draw
from a per-failpoint `random.Random` seeded from
`CORETH_TPU_FAILPOINT_SEED` xor a stable crc32 of the name, so chaos
runs replay exactly.

This module is also the one home of `time.sleep` outside tests:
`Backoff` below is the capped-exponential-plus-jitter
helper every retry loop in the tree must go through.
"""

from __future__ import annotations

import copy
import os
import random
import threading
import time
import zlib
from typing import Dict, List, Optional

# Fast-path gate: True iff at least one failpoint is currently armed.
# Sites check this bare module bool before touching any dict or lock.
enabled = False

_lock = threading.Lock()
_registry: Dict[str, str] = {}  # name -> site description
_armed: Dict[str, "_Armed"] = {}
_unhang = threading.Event()  # released when the armed config changes


def _env_seed() -> int:
    try:
        return int(os.environ.get("CORETH_TPU_FAILPOINT_SEED", "") or "0")
    except ValueError:
        return 0


_seed = _env_seed()


class FailpointError(RuntimeError):
    """Raised by an armed `raise` failpoint at its site."""

    def __init__(self, name: str, message: str = ""):
        super().__init__(message or f"failpoint {name} fired")
        self.failpoint = name


class _Armed:
    """One armed failpoint: parsed spec + deterministic RNG + fire budget."""

    __slots__ = ("name", "spec", "verb", "arg", "prob", "remaining", "rng",
                 "fired")

    def __init__(self, name: str, spec: str):
        self.name = name
        self.spec = spec
        body = spec
        self.remaining: Optional[int] = None
        if "*" in body:
            body, _, count = body.rpartition("*")
            self.remaining = int(count)
            if self.remaining <= 0:
                raise ValueError(f"failpoint {name}: count must be > 0")
        self.prob = 1.0
        if "%" in body:
            body, _, prob = body.rpartition("%")
            self.prob = float(prob)
            if not 0.0 < self.prob <= 1.0:
                raise ValueError(f"failpoint {name}: prob must be in (0, 1]")
        verb, _, arg = body.partition(":")
        if verb not in ("raise", "hang"):
            raise ValueError(f"failpoint {name}: unknown verb {verb!r}")
        self.verb = verb
        self.arg = arg
        if verb == "hang" and arg:
            float(arg)  # validate at arm time, not fire time
        # Stable per-(seed, name) stream so probabilistic chaos replays.
        self.rng = random.Random(_seed ^ zlib.crc32(name.encode()))
        self.fired = 0

    def should_fire(self) -> bool:
        if self.remaining is not None and self.remaining <= 0:
            return False
        if self.prob < 1.0 and self.rng.random() >= self.prob:
            return False
        if self.remaining is not None:
            self.remaining -= 1
        self.fired += 1
        return True


def register(name: str, doc: str = "") -> str:
    """Declare a failpoint site at module import. Duplicate names raise:
    every site string must be unique so arming is unambiguous."""
    with _lock:
        if name in _registry:
            raise ValueError(f"failpoint {name!r} registered twice")
        _registry[name] = doc
    return name


def registered() -> Dict[str, str]:
    with _lock:
        return dict(_registry)


def list_armed() -> List[Dict[str, object]]:
    with _lock:
        return [
            {"name": a.name, "spec": a.spec, "fired": a.fired,
             "remaining": a.remaining}
            for a in _armed.values()
        ]


def set_failpoint(name: str, spec: Optional[str]) -> None:
    """Arm [name] with [spec], or disarm it when spec is None/''.
    Unknown names raise KeyError."""
    global enabled, _unhang
    with _lock:
        if name not in _registry:
            raise KeyError(f"unknown failpoint {name!r}; "
                           f"registered: {sorted(_registry)}")
        if spec:
            _armed[name] = _Armed(name, spec)
        else:
            _armed.pop(name, None)
        enabled = bool(_armed)
        # Wake anything parked on a `hang` under the previous config.
        _unhang.set()
        _unhang = threading.Event()


def clear_all() -> None:
    global enabled, _unhang
    with _lock:
        _armed.clear()
        enabled = False
        _unhang.set()
        _unhang = threading.Event()


def set_seed(seed: int) -> None:
    """Reseed the deterministic fire streams (tests); takes effect for
    failpoints armed after the call."""
    global _seed
    _seed = seed


def seed() -> int:
    """The active deterministic seed (env or set_seed). Sites that need
    their own seeded randomness (ethdb/corrupt_read's bit pick) derive
    from this so chaos runs replay bit-exactly."""
    return _seed


def is_armed(name: str) -> bool:
    """True iff [name] is currently armed. For sites whose *shape*
    changes when armed (FaultInjectingDB splits a batch in two only
    while ethdb/torn_batch is armed) — never needed on the fast path,
    which stays on the bare `enabled` bool."""
    if not enabled:
        return False
    with _lock:
        return name in _armed


def armed_spec(name: str) -> Optional[str]:
    """The spec string [name] is currently armed with, or None. Lets a
    site branch on the armed *verb* (exec_shards must not park its own
    dispatch thread on a `hang` meant for a forked child)."""
    if not enabled:
        return None
    with _lock:
        a = _armed.get(name)
        return a.spec if a is not None else None


def _fire_counter(name: str) -> None:
    # imported lazily: `fault` sits in a forked worker's import closure,
    # and a module-scope metrics import would copy the parent's registry
    # singleton into every child image. Only the parent ever reaches this
    # hook — child_after_fork() swaps in a no-op.
    from ..metrics import default_registry
    default_registry.counter(f"fault/fired/{name}").inc()


_fired_hook = _fire_counter


def child_after_fork() -> None:
    """Re-arm this module inside a forked worker process:
    fresh lock/event objects — the parent's copies may have been held/set
    by a thread that does not exist after fork — and a no-op fired-counter
    sink, so an env-inherited failpoint firing in the child never touches
    the (invisible, copy-on-write) metrics registry. Env/fork-inherited
    arming itself is preserved: `_armed` carries over, which is what makes
    CORETH_TPU_FAILPOINTS drills replayable inside forked children."""
    global _lock, _unhang, _fired_hook
    _lock = threading.Lock()
    _unhang = threading.Event()
    _fired_hook = lambda name: None


def armed_state() -> Dict[str, "_Armed"]:
    """Copies of every armed failpoint, with its fire budget and random
    stream as they stand now: what a worker process started from a
    forkserver (core/exec_shards.py) adopts with adopt_armed(), so it
    sees the parent's arming exactly as a forked child would."""
    with _lock:
        return copy.deepcopy(_armed)


def adopt_armed(state: Dict[str, "_Armed"]) -> None:
    """Replace this process's armed set with a parent's armed_state()."""
    global enabled
    with _lock:
        _armed.clear()
        _armed.update(state)
        enabled = bool(_armed)


def failpoint(name: str) -> None:
    """The injection site. A single module-bool check when nothing is
    armed; otherwise fires the configured action for [name]."""
    if not enabled:
        return
    with _lock:
        armed = _armed.get(name)
        if armed is None or not armed.should_fire():
            return
        verb, arg = armed.verb, armed.arg
        unhang = _unhang
    _fired_hook(name)
    if verb == "raise":
        raise FailpointError(name, arg)
    if arg:  # hang:<ms>
        time.sleep(float(arg) / 1000.0)
    else:  # hang until disarmed (or the process is killed)
        unhang.wait()


def _parse_env() -> None:
    spec = os.environ.get("CORETH_TPU_FAILPOINTS", "")
    if not spec:
        return
    global enabled
    for item in spec.split(";"):
        item = item.strip()
        if not item:
            continue
        name, _, action = item.partition("=")
        name, action = name.strip(), action.strip()
        if not name or not action:
            raise ValueError(f"CORETH_TPU_FAILPOINTS: bad entry {item!r}")
        with _lock:
            # Env arming happens before site modules import and register,
            # so env names bypass the registry check; a bad name simply
            # never fires and never shows up in registered().
            _armed[name] = _Armed(name, action)
            enabled = True


_parse_env()


class Backoff:
    """Capped exponential backoff with jitter — the one sanctioned
    retry-delay primitive .

    delay_n = min(cap, base * factor**n) * (1 + jitter * U[-1, 1))
    """

    def __init__(self, base: float = 0.05, factor: float = 2.0,
                 cap: float = 5.0, jitter: float = 0.25,
                 rng: Optional[random.Random] = None):
        self.base = base
        self.factor = factor
        self.cap = cap
        self.jitter = jitter
        self.attempt = 0
        self._rng = rng if rng is not None else random.Random(_seed or None)

    def reset(self) -> None:
        self.attempt = 0

    def next_delay(self) -> float:
        delay = min(self.cap, self.base * (self.factor ** self.attempt))
        self.attempt += 1
        if self.jitter:
            delay *= 1.0 + self.jitter * (self._rng.random() * 2.0 - 1.0)
        return max(0.0, delay)

    def sleep(self) -> float:
        delay = self.next_delay()
        if delay > 0:
            time.sleep(delay)
        return delay
