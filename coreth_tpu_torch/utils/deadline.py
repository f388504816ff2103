"""Cooperative per-request deadlines (role of Go's context.Context
deadline threading through the reference's rpc handlers).

Threads cannot be cancelled; a request that must not outlive its budget
has to *check* — so the primitive here is a monotonic-clock `Deadline`
token installed in a thread-local by the RPC dispatch layer
(`rpc/admission.py`) and polled at loop boundaries: the `eth_getLogs`
block scan, the tracers' per-tx replay loop, and EVM frame entry. The
hot EVM step loop is deliberately *not* instrumented (SA003: `# hot-path`
functions read no wall clock); gas bounds a single frame, the frame
boundary bounds a call tree.

`check()` is the universal checkpoint: one thread-local read when no
deadline is armed (the consensus path never arms one), a monotonic
compare when one is. Expiry raises `DeadlineExceeded`, which the
dispatch layer maps to a JSON-RPC timeout error and a freed worker.

Counterpart of coreth_tpu/utils/deadline.py.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

__all__ = ["Deadline", "DeadlineExceeded", "check", "current", "remaining",
           "scope"]


class DeadlineExceeded(Exception):
    """A cooperative checkpoint found the request past its budget.  When
    the expiring thread carries a trace context the trace id is stamped
    on (`trace_id`), so the dispatch layer can attribute the expiry
    end-to-end without re-deriving ambient state."""

    def __init__(self, budget: float, trace_id: Optional[str] = None):
        msg = f"request exceeded its {budget:g}s budget"
        if trace_id:
            msg += f" [trace {trace_id}]"
        super().__init__(msg)
        self.budget = budget
        self.trace_id = trace_id


class Deadline:
    """Monotonic-clock budget token for one request."""

    __slots__ = ("budget", "_expires")

    def __init__(self, budget: float):
        self.budget = budget
        self._expires = time.monotonic() + budget

    def remaining(self) -> float:
        return self._expires - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self._expires

    def check(self) -> None:
        if time.monotonic() >= self._expires:
            # the import and ambient lookup only run on the expiry path,
            # never on the no-op checkpoint fast path
            from ..metrics import tracectx

            raise DeadlineExceeded(self.budget, tracectx.current_id())


_tls = threading.local()


def current() -> Optional[Deadline]:
    """The calling thread's armed deadline, or None."""
    return getattr(_tls, "deadline", None)


def check() -> None:
    """The cooperative checkpoint: free when nothing is armed."""
    d = getattr(_tls, "deadline", None)
    if d is not None:
        d.check()


def remaining(default: float) -> float:
    """Budget left for one sub-operation: [default] when no deadline is
    armed on this thread, otherwise the armed deadline's remaining time
    clamped to [0, default] — so a per-request-class timeout never
    outlives the caller's overall budget."""
    d = getattr(_tls, "deadline", None)
    if d is None:
        return default
    return max(0.0, min(default, d.remaining()))


class scope:
    """Install [deadline] on this thread for the `with` body (nestable;
    the previous deadline is restored on exit). Pass None for a no-op
    scope so call sites stay unconditional."""

    __slots__ = ("deadline", "_prev")

    def __init__(self, deadline: Optional[Deadline]):
        self.deadline = deadline

    def __enter__(self) -> Optional[Deadline]:
        self._prev = getattr(_tls, "deadline", None)
        if self.deadline is not None:
            _tls.deadline = self.deadline
        return self.deadline

    def __exit__(self, *exc) -> None:
        _tls.deadline = self._prev
