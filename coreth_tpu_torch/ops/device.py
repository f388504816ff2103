"""Device-hasher resolution and the device degradation ladder; counterpart
of coreth_tpu/ops/device.py.

`get_batch_keccak(mode, device)` hands the tries their batch keccak: the
planned marker (ops/keccak_planned.PlannedMode: one K1 program a commit),
the fused marker (FusedModeKeccak: one fused commit a trie, K2 per
segment) or the level-batched seam (LadderedKeccak over BatchedKeccak:
K2). "off" keeps everything on the CPU hasher.

The degradation ladder (`DeviceLadder`, one per process as in the
reference) wraps every laddered device dispatch, with a watchdog when
`call_timeout` is set, and tracks whether the device seam runs on the
device or on the host:

    healthy --(a caller's demote(): BlockChain.take_over_host)--> demoted
    demoted --(1 healthy background probe)--> probation
    probation --(promote_after consecutive healthy probes)--> healthy
    probation --(any failed probe)--> demoted

While demoted, `PlannedMode.planned` (a dynamic property) reads False,
which reroutes Trie.hash and StateDB.intermediate_root to their
host-routed paths, a dispatch is refused with DeviceDegradedError, and
the plain-callable seam hashes on the threaded native C++ batch keccak
(native.keccak256_batch, never the plain torch version): roots stay
bit-exact on either rung. Events fan out to listeners (core/blockchain
pipes them into the flight recorder) and the `ops/device/demotions` /
`ops/device/promotions` counters; a demotion is logged at error level.

Where the port differs from the reference, by its device rules (ROADMAP
Queue 3):

- Only a caller demotes. An error of a dispatched call (a device fault of
  device.DEVICE_FAULTS, a BuildError, a bug, an armed failpoint) reaches
  the caller as it is, with no retry and no demotion, and is counted in
  `ops/device/dispatch_errors` (a BuildError is not); a call past the
  watchdog's deadline raises DeviceWedgedError the same way. The
  reference retries, demotes and finishes the work on the host; the port
  never turns a kernel's failure into a root computed on the host.
  `device-max-retries` is therefore refused but at 0.
- Resolution never degrades quietly: without a Hopper CUDA device every
  mode but "off" raises ("auto" too, where the reference runs CPU-only),
  after counting `ops/device/resolve_fail` and keeping the cause for
  `resolution_error()`.
- The background probe hashes through the K2 seam (BatchedKeccak.digests)
  of the device last resolved by get_batch_keccak: the reference caches
  one process-wide function, the port one per device, and a process's
  chain runs on one device. On a CPU tensor that seam is K2's plain
  version.
- A watchdogged dispatch runs on a worker thread with the caller's CUDA
  stream made current there (torch's current stream is per thread). A
  call the watchdog abandoned may still run: the next dispatch waits for
  its worker to end (up to call_timeout) before it starts, and raises
  DeviceWedgedError without starting while it has not, so no two calls
  share the caller's stream or the executor's buffers. One abandoned
  while parked on the dispatch failpoint never starts once released.
- The fused mode is on the ladder like every other mode: its commit is a
  DeviceLadder.dispatch, so its errors and the watchdog reach the caller,
  and while demoted Trie.hash takes the level hasher on the host batch
  keccak. The reference keeps it off the ladder for A/B comparison, a
  reason that does not hold where the ladder neither retries nor falls
  back.
- Dispatches serialise on one lock of the ladder: Block-STM's threads and
  the insert pipeline's stages reach the same seams (a BatchedKeccak's
  totals, a PlannedCommit's timing fields) from several threads.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

import torch

from ..device import DeviceLike, DeviceWedgedError, resolve
from ..fault import FailpointError, failpoint
from ..fault import register as _register_failpoint
from ..native._build import BuildError
from ..trie.hasher import count_keccak_batch
from .keccak_torch import BatchedKeccak, default_batched_keccak

# the K2 seam of the device resolved last ("fn", the probe's function)
# and the last resolution failure ("error")
_cached: dict = {}

# failpoint sites (fault/__init__.py registry; armed via
# CORETH_TPU_FAILPOINTS or fault.set_failpoint)
FP_RESOLVE = _register_failpoint(
    "ops/device/resolve", "during device-keccak resolution")
FP_DISPATCH = _register_failpoint(
    "ops/device/dispatch",
    "inside every laddered device dispatch (runs on the watchdog worker "
    "thread, so `hang` exercises the deadline)")
FP_PROBE = _register_failpoint(
    "ops/device/probe", "inside the ladder's background health probe")


class DeviceDegradedError(RuntimeError):
    """A laddered dispatch was refused: a caller demoted the ladder
    (DeviceLadder.demote, BlockChain.take_over_host), so the device seam
    runs on the host until the probes re-promote. Callers take their host
    path."""


class DeviceLadder:
    """Process-wide device health state machine. Chains configure it from
    CacheConfig at construction and subscribe for flight-recorder events;
    tests drive it directly."""

    HEALTHY = "healthy"
    DEMOTED = "demoted"
    PROBATION = "probation"

    PROBE_MSG = b"coreth-tpu device health probe"
    DEFAULT_PROBE_TIMEOUT = 5.0
    # the knobs at construction and after reset(); call_timeout None is
    # the watchdog off: dispatch runs inline with zero extra threads
    DEFAULTS = {"call_timeout": None, "probe_interval": 5.0,
                "promote_after": 3}

    def __init__(self):
        self._lock = threading.Lock()
        self.state = self.HEALTHY  # guarded-by: _lock
        self.last_error: Optional[str] = None  # guarded-by: _lock
        self.call_timeout: Optional[float] = self.DEFAULTS["call_timeout"]
        self.probe_interval: float = self.DEFAULTS["probe_interval"]
        self.promote_after: int = self.DEFAULTS["promote_after"]
        self._healthy_probes = 0  # guarded-by: _lock
        self._listeners: List[Callable] = []  # guarded-by: _lock
        self._probe_gen = 0  # guarded-by: _lock; invalidates stale probes
        self._probe_wake = threading.Event()
        # the done event of the last call the watchdog abandoned, until a
        # dispatch sees it set
        self._abandoned: Optional[threading.Event] = None  # guarded-by: _lock
        # held by a dispatch from its start to its end (module docstring)
        self._dispatch_mu = threading.RLock()

    # ---- configuration / wiring -----------------------------------------

    def configure(self, call_timeout: Optional[float] = None,
                  probe_interval: Optional[float] = None,
                  promote_after: Optional[int] = None) -> None:
        """Apply chain knobs (CacheConfig.device_*). 0 timeouts mean
        'off', matching the resident watchdog's convention."""
        with self._lock:
            if call_timeout is not None:
                self.call_timeout = call_timeout if call_timeout > 0 else None
            if probe_interval is not None:
                self.probe_interval = float(probe_interval)
            if promote_after is not None:
                self.promote_after = max(1, int(promote_after))

    def add_listener(self, fn: Callable) -> None:
        """fn(kind, fields) on every ladder event: demote/probation/
        promote. Exceptions are counted, never propagated."""
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable) -> None:
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def _notify(self, kind: str, **fields) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(kind, dict(fields))
            except Exception:
                from ..metrics import count_drop

                count_drop("ops/device/listener_error")

    # ---- state -----------------------------------------------------------

    @property
    def healthy(self) -> bool:
        return self.state == self.HEALTHY

    def status(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "last_error": self.last_error,
                "healthy_probes": self._healthy_probes,
                "call_timeout": self.call_timeout,
                "probe_interval": self.probe_interval,
                "promote_after": self.promote_after,
            }

    def reset(self) -> None:
        """Back to healthy with no listeners and the knobs' DEFAULTS;
        retires any probe thread. Test isolation and the end of a drill:
        the ladder is process-global. A call the watchdog abandoned is
        still waited for."""
        with self._lock:
            self.state = self.HEALTHY
            self.last_error = None
            self._healthy_probes = 0
            self._listeners.clear()
            self._probe_gen += 1
            self._probe_wake.set()
            self._probe_wake = threading.Event()
            self.call_timeout = self.DEFAULTS["call_timeout"]
            self.probe_interval = self.DEFAULTS["probe_interval"]
            self.promote_after = self.DEFAULTS["promote_after"]

    # ---- dispatch (the watchdogged device call) --------------------------

    def dispatch(self, fn: Callable, what: str, *args):
        """Run one device call under the ladder. While the ladder is
        demoted the call is refused with DeviceDegradedError and the
        caller takes its host path. Otherwise fn(*args) runs, one dispatch
        at a time, under the watchdog when call_timeout is set (a call
        past its deadline raises DeviceWedgedError). Every error of the
        call reaches the caller as it is: no retry, no demotion (module
        docstring); all but a BuildError count ops/device/dispatch_errors."""
        from ..metrics import default_registry

        with self._lock:
            if self.state != self.HEALTHY:
                raise DeviceDegradedError(
                    f"{what}: the device seam is demoted to the host "
                    f"({self.last_error})")
            timeout = self.call_timeout
        try:
            with self._dispatch_mu:
                self._join_abandoned(what, timeout)
                if timeout is None:
                    failpoint(FP_DISPATCH)
                    return fn(*args)
                return self._watchdogged(fn, args, timeout, what)
        except BuildError:
            raise
        except Exception:
            default_registry.counter("ops/device/dispatch_errors").inc()
            raise

    def _join_abandoned(self, what: str, timeout: Optional[float]) -> None:
        """Wait up to `timeout` for the worker of a call the watchdog
        abandoned; DeviceWedgedError while it still runs."""
        with self._lock:
            done = self._abandoned
        if done is None:
            return
        if not done.wait(timeout or 0):
            raise DeviceWedgedError(
                f"{what}: a call the watchdog abandoned is still running")
        with self._lock:
            if self._abandoned is done:
                self._abandoned = None

    def _watchdogged(self, fn: Callable, args, timeout: float, what: str):
        """fn(*args) on a watchdog worker on the caller's CUDA stream;
        DeviceWedgedError at the deadline, the worker then abandoned
        (dispatch waits for it before the next call). A call abandoned
        while parked on the dispatch failpoint never starts."""
        stream = (torch.cuda.current_stream() if torch.cuda.is_initialized()
                  else None)
        box: dict = {}
        done = threading.Event()
        abandoned = threading.Event()

        def work():
            try:
                failpoint(FP_DISPATCH)
                if abandoned.is_set():
                    raise DeviceWedgedError(f"{what} abandoned by the watchdog")
                if stream is None:
                    box["val"] = fn(*args)
                else:
                    with torch.cuda.stream(stream):
                        box["val"] = fn(*args)
            except BaseException as e:  # noqa: BLE001 — crosses threads
                box["err"] = e
            finally:
                done.set()

        threading.Thread(target=work, daemon=True, name=f"wd-{what}").start()
        if not done.wait(timeout):
            abandoned.set()
            with self._lock:
                self._abandoned = done
            raise DeviceWedgedError(
                f"{what}: no answer within the {timeout:g} s watchdog "
                "deadline")
        if "err" in box:
            raise box["err"]
        return box["val"]

    # ---- demotion / probation / re-promotion -----------------------------

    def demote(self, why: str) -> None:
        """Device -> host, idempotent; a caller's decision, never the
        dispatch's. Starts the background probe loop that earns the way
        back (probation -> re-promotion)."""
        from ..log import error, get_logger
        from ..metrics import default_registry

        with self._lock:
            if self.state != self.HEALTHY:
                self.last_error = why
                return
            self.state = self.DEMOTED
            self._healthy_probes = 0
            self.last_error = why
        default_registry.counter("ops/device/demotions").inc()
        error(get_logger("ops"),
              "device demoted to host: laddered dispatches run on the "
              "host's native C++ batch keccak until background probes "
              "re-promote", why=why)
        self._notify("demote", why=why)
        self._start_probe_thread()

    def promote(self) -> None:
        from ..log import get_logger, info
        from ..metrics import default_registry

        with self._lock:
            if self.state == self.HEALTHY:
                return
            self.state = self.HEALTHY
            self._healthy_probes = 0
        default_registry.counter("ops/device/promotions").inc()
        info(get_logger("ops"), "device re-promoted after healthy probes")
        self._notify("promote")

    def _start_probe_thread(self) -> None:
        with self._lock:
            if (self.probe_interval <= 0 or self.promote_after <= 0
                    or _cached.get("fn") is None):
                return  # no road back: stay demoted (or no device at all)
            self._probe_gen += 1
            gen = self._probe_gen
        threading.Thread(target=self._probe_loop, args=(gen,),
                         name="device-probe", daemon=True).start()

    def _probe_loop(self, gen: int) -> None:
        while True:
            with self._lock:
                if gen != self._probe_gen or self.state == self.HEALTHY:
                    return
                wake = self._probe_wake
                interval = self.probe_interval
            wake.wait(interval)
            with self._lock:
                if gen != self._probe_gen or self.state == self.HEALTHY:
                    return
            if _cached.get("fn") is None:
                return
            self.probe_once()

    def probe_once(self) -> bool:
        """One health probe now, on the caller's thread: hash PROBE_MSG
        through the K2 seam of the device last resolved, under the probe
        watchdog, and feed the verdict to the ladder as one tick of the
        background loop does (promote_after healthy probes in a row
        re-promote). A caller whose probe loop is off (probe_interval 0:
        the chaos conductor) earns the way back through these. Returns
        whether the probe was healthy; with no seam resolved it is not."""
        from ..metrics import default_registry
        from ..native import keccak256 as _host_keccak
        from ..native.mpt import _run_with_watchdog

        with self._lock:
            timeout = self.call_timeout or self.DEFAULT_PROBE_TIMEOUT
        fn = _cached.get("fn")

        def probe():
            failpoint(FP_PROBE)
            return fn([self.PROBE_MSG])

        try:
            if fn is None:
                raise RuntimeError("no device seam resolved to probe")
            out = _run_with_watchdog(probe, timeout, "device health probe")
            ok = bool(out) and bytes(out[0]) == _host_keccak(self.PROBE_MSG)
        except Exception:
            default_registry.counter("ops/device/probe_errors").inc()
            ok = False
        self._on_probe(ok)
        return ok

    def _on_probe(self, ok: bool) -> None:
        with self._lock:
            if ok:
                self._healthy_probes += 1
                entered_probation = self.state == self.DEMOTED
                if entered_probation:
                    self.state = self.PROBATION
                promote = self._healthy_probes >= self.promote_after
                probes = self._healthy_probes
            else:
                self._healthy_probes = 0
                relapsed = self.state == self.PROBATION
                if relapsed:
                    self.state = self.DEMOTED
                entered_probation = promote = False
        if ok and entered_probation:
            self._notify("probation", healthy_probes=probes)
        if ok and promote:
            self.promote()


_ladder = DeviceLadder()


def default_ladder() -> DeviceLadder:
    """The process-wide ladder every laddered seam shares."""
    return _ladder


def resolution_error() -> Optional[str]:
    """The cached device-resolution failure, if any."""
    e = _cached.get("error")
    return repr(e) if e is not None else None


def _host_batch_keccak(msgs) -> List[bytes]:
    """Bit-exact host rung of a demoted seam: the threaded native C++
    batch keccak (the marker wrappers already counted the batch)."""
    from ..native import default_cpu_threads, keccak256_batch

    return keccak256_batch([bytes(m) for m in msgs],
                           threads=default_cpu_threads())


class LadderedKeccak:
    """The "batched" mode's seam, msgs -> digests, behind the degradation
    ladder: counts each batch in trie.hasher.count_keccak_batch, then
    hashes it with BatchedKeccak (kernel K2 on CUDA) under dispatch while
    the ladder is healthy, and on the native host batch keccak while a
    caller has it demoted. An error of K2 reaches the caller. Trie.hash hands it to BatchedHasher,
    which hashes each trie level in one call. The planned marker
    (ops/keccak_planned.PlannedMode) is one too."""

    def __init__(self, batched: BatchedKeccak,
                 ladder: Optional[DeviceLadder] = None):
        self.batched = batched
        self._ladder = ladder if ladder is not None else _ladder

    def __call__(self, msgs: Sequence[bytes]) -> list:
        count_keccak_batch(len(msgs))
        lad = self._ladder
        if not lad.healthy:
            return _host_batch_keccak(msgs)
        try:
            return lad.dispatch(self.batched.digests, "device batch keccak",
                                msgs)
        except DeviceDegradedError:
            return _host_batch_keccak(msgs)


class FusedModeKeccak(LadderedKeccak):
    """Marker handed to Trie / StateTrie as `batch_keccak`: Trie.hash
    takes the one-dispatch FusedHasher when `fused` and the dirty set is
    at least BATCH_THRESHOLD nodes, with fused_commit as its fused impl.
    Counterpart of coreth_tpu/ops/device.py:FusedModeKeccak. Still
    callable as the plain batch keccak (K2 under the ladder), so every
    other consumer of the seam works unchanged.

    `fused` reads False while the ladder is demoted, which sends
    Trie.hash to the BatchedHasher on the host batch keccak; the fused
    commit itself is a ladder dispatch (module docstring)."""

    @property
    def fused(self) -> bool:
        return self._ladder.healthy

    def fused_commit(self, specs, flat, nblocks, patch_lane, patch_off,
                     patch_child):
        """ops/keccak_fused.fused_commit on the seam's device, under the
        ladder (DeviceDegradedError while demoted)."""
        from .keccak_fused import fused_commit

        return self._ladder.dispatch(
            fused_commit, "device fused commit", specs, flat, nblocks,
            patch_lane, patch_off, patch_child, self.batched.device)


def _resolve_seam(device: DeviceLike) -> BatchedKeccak:
    """The device's K2 seam, cached as the ladder's probe function. A
    failure counts ops/device/resolve_fail, keeps its cause for
    resolution_error() and raises."""
    try:
        failpoint(FP_RESOLVE)
        bk = default_batched_keccak(resolve(device))
    except Exception as e:
        from ..log import error, get_logger
        from ..metrics import default_registry

        default_registry.counter("ops/device/resolve_fail").inc()
        error(get_logger("ops"), "device keccak did not resolve",
              error=repr(e), failpoint=isinstance(e, FailpointError))
        _cached["error"] = e
        raise
    _cached["fn"] = bk.digests
    return bk


def get_batch_keccak(mode: str = "auto", device: DeviceLike = None
                     ) -> Optional[LadderedKeccak]:
    """Resolve a device-hasher mode to a batch keccak, or None.

    mode: "off"      None: the recursive CPU Hasher everywhere
          "batched"  level-batched hashing (trie/hasher.BatchedHasher),
                     one K2 batch per trie level and block-count bucket
          "planned"  the planned executor: a state commit's storage tries
                     and account trie in one device program (kernel K1);
                     the marker is still callable as a plain batch keccak
          "auto"     the same as "planned"
          "fused"    the fused marker: each large trie commit in one fused
                     commit (FusedHasher), K2 per segment

    `device` follows device.resolve: None is CUDA. Unlike the reference,
    "auto" does not fall back to CPU-only hashing when the device is
    missing: without a Hopper CUDA device every mode but "off" raises, as
    every entry point of the port does. Every returned seam routes
    through the process DeviceLadder."""
    if mode == "off":
        return None
    if mode not in ("batched", "planned", "auto", "fused"):
        raise ValueError(f"unknown device-hasher mode {mode!r}")
    bk = _resolve_seam(device)
    if mode == "batched":
        return LadderedKeccak(bk)
    if mode == "fused":
        return FusedModeKeccak(bk)
    from .keccak_planned import PlannedMode

    return PlannedMode(device=bk.device)
