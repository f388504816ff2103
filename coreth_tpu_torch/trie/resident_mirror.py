"""Branch-aware resident account mirror: drives one device-resident
IncrementalTrie through a chain's verify/accept/reject lifecycle,
including sibling competition and reorgs.

The resident executor (ops/keccak_resident.py) holds a single linear
trie history, but consensus verifies SIBLING blocks against different
parents (core/blockchain.go:1424 reorg; plugin/evm/block.go Verify/
Accept/Reject). This adapter reconciles the two:

  - the mirror keeps a LINEAR applied stack (one undo scope per applied
    block, native/mpt_inc.cpp checkpoint/rollback);
  - verifying a block whose parent is not the current head REWINDS
    (rollback scopes) to the nearest applied ancestor of the parent and
    REPLAYS the saved per-block update batches down the target branch;
  - accept finalizes: scopes (and records) of accepted blocks deeper
    than the TIP_BUFFER flush (journal memory reclaimed); the retained
    window keeps recent accepted states rewindable for reads — the
    reference's 32-root tip buffer (core/state_manager.go:189+);
  - reject drops a block (and any applied descendants, which consensus
    rejects with it) by rewinding through it.

Each verify returns the block's state root from the device (lazy handle
resolved to bytes), so the chain adapter can compare it against the
header exactly where statedb.IntermediateRoot's result is used today
(core/blockchain.go:1331 ValidateState).

A commit's host time is split into the registry's resident/phase/*
timers where each piece of work runs (metrics.phase_timer): `update`
(the block's leaves into the native trie) and `record` (the mirror's
bookkeeping after the root) here, around `commit`, the parent of the
native planner's `plan` and `export`, the watchdog's `handoff`
(native/mpt.py) and the executor's `stage`, `scatter`, `patch`, `hash`,
`store` and `readback` (ops/keccak_resident.py); host commits add
`host_hash`, store readbacks for an export or a spot-check `absorb`.
With spans on each phase is a span under resident/commit (a pipelined
dispatch opens one too); while a torch profiler session runs, a
profiler range on the verifying thread, the watchdog worker's included.

Upstream integration: state/resident_trie.py (the StateDB facade that
feeds per-block account batches and reads through here),
core/state_manager.py ResidentTrieWriter (consensus lifecycle + the
interval disk export). Counterpart of coreth_tpu/trie/resident_mirror.py.

Device rules of the port: the mirror runs on the device its executor
resolves (`device`: None is CUDA and raises without it; "cpu" only when
asked, where the executor runs kernel K1's plain version). Host mode, the
native threaded hasher for every commit, happens only when the caller
passes prefer_host=True or sets CORETH_TPU_RESIDENT_HOST=1; the reference
also starts there when no TPU resolves, the port never. A device that
stops answering inside `device_timeout` raises DeviceWedgedError to the
caller, and a device fault of a commit (device.DEVICE_FAULTS: a K1 launch
error, a build error) raises as it is; either is counted in
state/resident/device_wedges, with an error log, and leaves the applied
stack as it was. The device's resident state is not trusted after it:
every later device operation raises DeviceWedgedError, until the caller
moves the mirror down a rung with take_over_host()
(counted in state/resident/device_takeovers) or rebuilds it. Where the
reference takes over on the host by itself, the port never moves work
off the card unasked. The chain boots it (core/blockchain.py _boot_mirror,
after the "auto" probe) and takes it over through
BlockChain.take_over_host(), which notes the takeover in its flight
recorder.

The mesh rung: with mesh_devices = n > 0 the executor's store and arenas
are split by rows over make_mesh(n, device=device)
(parallel.resident_executor_over_mesh: the first n CUDA devices when
`device` is None, n positions on the one device named otherwise). The
ladder is mesh -> single device -> host, one rung a take_over_host()
call: from the mesh, the host oracle rehashes the trie, a fresh
single-device executor recommits it, and the root must equal the
oracle's (state/resident/mesh_demotions; a rebuild that fails or
diverges counts state/resident/mesh_demotion_failures and lands on the
host instead; a mesh spanning processes skips to the host,
state/resident/mesh_demotion_cross_process_skips). The reference walks
that ladder by itself when a commit wedges; the port raises the wedge
and walks it only when asked (ROADMAP Queue 3).
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..device import DEVICE_FAULTS, DeviceLike, DeviceWedgedError
from ..fault import FailpointError, failpoint
from ..fault import register as _register_failpoint
from ..metrics import phase_timer
from ..metrics.spans import span
from ..native.mpt import IncrementalTrie

FP_SPOT_CHECK = _register_failpoint(
    "state/resident/spot_check",
    "`raise` forces the periodic mirror spot-check to report divergence "
    "(exercises the quarantine/reboot path without corrupting a trie)")


class MirrorError(Exception):
    pass


def _locked(fn):
    """Serialize public mirror ops: the chain calls verify/preview from
    the insert path (under chainmu) but accept/export ride the async
    acceptor thread (core/blockchain.py _accept_post_process)."""

    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        with self._lock:
            return fn(self, *a, **kw)

    return wrapper


class ResidentAccountMirror:
    GENESIS = b"\x00" * 32  # sentinel parent of the initial state
    # single in-flight anonymous state (a miner's block-under-construction:
    # root computed before the block hash exists; the next verify with the
    # same parent+batch adopts it, anything else rewinds it)
    ANON = b"\x01" + b"anon" * 7 + b"\x01\x01\x01"

    def __init__(self, items: Sequence[Tuple[bytes, bytes]] = (),
                 executor=None, base_key: Optional[bytes] = None,
                 device_timeout: Optional[float] = None,
                 cpu_threads: Optional[int] = None,
                 prefer_host: Optional[bool] = None,
                 pipeline_depth: int = 0,
                 template_residency: bool = False,
                 mesh_devices: int = 0,
                 lean_rows: bool = False,
                 device: DeviceLike = None):
        import os

        if cpu_threads is None or int(cpu_threads) <= 0:
            from ..native import default_cpu_threads

            cpu_threads = default_cpu_threads()
        self._cpu_threads = int(cpu_threads)
        # host mode only when asked: the argument, or the reference's own
        # environment override (which wins, as there). No device probe:
        # without CUDA the executor below raises, as every entry point does
        env = os.environ.get("CORETH_TPU_RESIDENT_HOST", "").lower()
        if env in ("1", "true", "yes"):
            prefer_host = True
        elif env in ("0", "false", "no"):
            prefer_host = False
        self.host_mode = bool(prefer_host)
        if self.host_mode:
            from ..metrics import default_registry

            default_registry.counter("state/resident/cpu_fastpath").inc(1)
        elif executor is None:
            if mesh_devices and int(mesh_devices) > 0:
                # MeshConfigError propagates: an impossible width is a
                # configuration error, not a reason to run unsharded
                from ..parallel import make_mesh, resident_executor_over_mesh

                executor = resident_executor_over_mesh(
                    make_mesh(int(mesh_devices), device=device))
            else:
                from ..ops.keccak_resident import ResidentExecutor

                executor = ResidentExecutor(device=device)
        self.mesh_devices = int(mesh_devices or 0)
        self.ex = executor  # None in host mode unless the caller passed one
        # cross-commit device pipelining: up to [pipeline_depth] verified
        # commits may stay IN FLIGHT on the device, each optimistically
        # recorded under the header root it was dispatched against (the
        # chain threads it through verify/preview) and settled — device
        # root compared against that header root — at the next drain
        # point: accept, reject, reorg/branch switch, spot-check, export,
        # window refill, or take_over_host. 0 = every commit synchronizes
        # before verify returns (the pre-pipelining behavior).
        self.pipeline_depth = max(0, int(pipeline_depth or 0))
        # template residency: planned-path semantics (the host digest
        # cache re-absorbs every commit's digests, so root()/export work
        # per commit) at resident-path
        # transfer cost (device keeps arenas/store; uploads carry only
        # fresh leaf content). The per-commit absorb IS a device sync,
        # so it excludes pipelining.
        self.template = bool(template_residency) and not self.host_mode
        if self.template:
            self.pipeline_depth = 0
        if self.ex is not None:
            self.ex.pipeline_depth = self.pipeline_depth
        # in-flight pipelined commits, DISPATCH order — always a
        # contiguous suffix of _applied (dispatch happens only at the
        # head; every branch switch drains first).
        # guarded-by: _lock
        self._inflight: List[dict] = []
        # 1 - (time blocked at drain / wall since dispatch) of the most
        # recently drained commit — the overlap the pipeline actually
        # bought (0.0 when serial or never pipelined)
        self.last_overlap_fraction = 0.0
        # why the device stopped answering, once it has: every later
        # device operation raises until take_over_host()
        self._wedged: Optional[str] = None
        self._lock = threading.RLock()
        self.trie = IncrementalTrie(items)
        # device watchdog: a device operation that does not answer within
        # [device_timeout] seconds raises DeviceWedgedError to the caller
        # (see _wedge). None = watchdog off; env override for operators.
        if device_timeout is None:
            raw = os.environ.get("CORETH_TPU_RESIDENT_TIMEOUT", "")
            try:
                device_timeout = float(raw) if raw else None
            except ValueError:
                from ..log import get_logger

                get_logger("state").warning(
                    "ignoring malformed CORETH_TPU_RESIDENT_TIMEOUT=%r",
                    raw)
                device_timeout = None
        if device_timeout is not None and device_timeout <= 0:
            device_timeout = None  # 0 disables the watchdog (config doc)
        self.device_timeout = device_timeout
        # storage-lean node rows (the resident_lean_rows knob): the
        # native planner ships fresh single-block rows as 80-byte wire
        # records instead of 136-byte padded rows. A no-op for host
        # commits, so it stays pinned across take_over_host().
        self.lean_rows = bool(lean_rows)
        if self.lean_rows:
            self.trie.set_lean(True)
        base = base_key if base_key is not None else self.GENESIS
        self._dirty_since_export = True  # genesis image not yet on disk
        self._export_degraded = False    # failed write -> next export full
        # the genesis commit (everything is dirty after construction)
        self._roots: Dict[bytes, bytes] = {base: self._commit_root()}
        self._by_root: Dict[bytes, List[bytes]] = {
            self._roots[base]: [base]
        }
        self._parent: Dict[bytes, bytes] = {}
        self._batch: Dict[bytes, List[Tuple[bytes, bytes]]] = {}
        self._batch_keys: Dict[bytes, frozenset] = {}  # lazy overlay index
        self._applied: List[bytes] = [base]
        self._accepted: set = {base}

    # ---- device failure -------------------------------------------------

    def _commit_root(self) -> bytes:  # guarded-by: _lock
        """Settle the trie's current state and return the 32-byte root:
        on the device, under the watchdog, or on the host in host mode.
        A device that does not answer raises DeviceWedgedError (_wedge)."""
        with span("resident/commit", host_mode=self.host_mode):
            with phase_timer("resident/phase/commit"):
                if self.host_mode:
                    if self.ex is not None:
                        # host commits move no bytes; a stale device-era
                        # value here would be re-counted per commit by
                        # anything summing ex.h2d_bytes across commits
                        self.ex.h2d_bytes = 0
                    return self.trie.commit_cpu(threads=self._cpu_threads)
                try:
                    self._check_device()
                    if self.template:
                        return self.trie.commit_template(
                            self.ex, self.device_timeout)
                    return self.trie.commit_resident_timed(
                        self.ex, self.device_timeout)
                except DEVICE_FAULTS as e:
                    raise self._wedge(e)

    def _commit_scope(self) -> bytes:  # guarded-by: _lock
        """_commit_root for a block whose scope the caller has just opened
        and filled: a wedge closes the scope again before it raises, so
        the trie stays at the applied stack's head."""
        try:
            return self._commit_root()
        except DEVICE_FAULTS:
            self.trie.rollback()
            raise

    def _check_device(self) -> None:  # guarded-by: _lock
        if self._wedged is not None:
            raise DeviceWedgedError(
                f"the device stopped answering earlier ({self._wedged}); "
                "call take_over_host() or rebuild the mirror")

    def _wedge(self, e: Exception) -> Exception:  # guarded-by: _lock
        """Mark the device as gone (a wedge, or a device fault that may
        have left the executor's state half written), the first time
        loudly (the state/resident/device_wedges counter, an error log),
        and return `e` for the caller to raise. The watchdog's abandoned
        worker may still run on the executor, so nothing touches the
        device again:
        the mirror keeps its records and the host trie its values, and
        every later device operation raises until take_over_host()."""
        if self._wedged is None:
            from ..log import get_logger
            from ..metrics import default_registry

            self._wedged = str(e)
            default_registry.counter("state/resident/device_wedges").inc(1)
            get_logger("state").error(
                "resident device backend wedged or failed (%r): the mirror "
                "raises until take_over_host() or a rebuild", e)
        return e

    @property
    def shards(self) -> int:
        """Shards behind the current rung (1 on the host, on a single
        device, or after a mesh demotion): the flight record's un-ragged
        `resident.shards`."""
        if self.host_mode or self.ex is None:
            return 1
        return int(getattr(self.ex, "shards", 1))

    @_locked  # guarded-by: _lock
    def take_over_host(self, why: str = "asked by the caller") -> str:
        """Move this mirror one rung down, on the caller's request (the
        way on after a DeviceWedgedError, short of a rebuild), and return
        the rung it landed on: "device" after a mesh demotion
        (_demote_mesh), else "host". On the host for good: rebuild the
        full host digest cache (the device store is unreachable) and
        degrade the next export to a full image (counted in
        state/resident/device_takeovers, with an error log). Either way
        any in-flight pipelined window settles on the landing rung. The
        mirror keeps ALL state — records, journal, branch logic — so
        verify/accept/reject/reorg continue with identical roots. In host
        mode already, a no-op."""
        if self.host_mode:
            return "host"
        window, self._inflight = list(self._inflight), []
        self._pipeline_gauge()
        if self._demote_mesh(why):
            landed = "device"
        else:
            self._take_over_host(why)
            landed = "host"
        self._replay_window(window)
        return landed

    def _demote_mesh(self, why: str) -> bool:  # guarded-by: _lock
        """The mesh rung: from a sharded executor, rebuild residency on a
        single device (the mesh's first) before giving up the device.
        Host-oracle rehash (also the digest cache later exports read),
        then abandon every device row and slot (rebase_residency), then a
        full recommit on a fresh unsharded executor, which must equal the
        oracle root. False (the caller lands on the host) at the bottom
        device rung, on a mesh spanning processes, or when the rebuild
        fails or diverges."""
        if self.ex is None or int(getattr(self.ex, "shards", 1)) <= 1:
            return False
        from ..log import get_logger
        from ..metrics import default_registry

        if bool(getattr(self.ex, "spans_processes", False)):
            # the single-device rung is a unilateral local rebuild: on a
            # mesh spanning processes it would desync the others
            default_registry.counter(
                "state/resident/mesh_demotion_cross_process_skips").inc(1)
            get_logger("state").error(
                "mesh resident backend demoted (%s) on a mesh spanning "
                "processes: the single-device rung is unavailable, "
                "going to the host", why)
            return False
        get_logger("state").error(
            "mesh resident backend demoted (%s): %d-shard mesh to a single "
            "device: host oracle rehash, fresh residency, recommit of %d "
            "nodes", why, int(self.ex.shards), self.trie.num_nodes)
        try:
            from ..ops.keccak_resident import ResidentExecutor

            host_root = self.trie.rehash_host(threads=self._cpu_threads)
            ex = ResidentExecutor(seg_impl=self.ex.seg_impl,
                                  device=self.ex.device,
                                  pipeline_depth=self.pipeline_depth)
            self.trie.rebase_residency()
            self.ex = ex
            self._wedged = None  # the wedged executor is left behind
            if self.template:
                root = self.trie.commit_template(ex, self.device_timeout)
            else:
                root = self.trie.commit_resident_timed(
                    ex, self.device_timeout)
            if root != host_root:
                raise MirrorError(
                    "single-device recommit root does not match the host "
                    "oracle")
        except BaseException as rebuild_err:
            default_registry.counter(
                "state/resident/mesh_demotion_failures").inc(1)
            get_logger("state").error(
                "single-device rebuild failed (%s): going to the host",
                rebuild_err)
            return False
        default_registry.counter("state/resident/mesh_demotions").inc(1)
        # the device-era delta marks predate the demotion
        self._export_degraded = True
        self._dirty_since_export = True
        return True

    def _take_over_host(self, why: str) -> None:  # guarded-by: _lock
        from ..log import get_logger
        from ..metrics import default_registry

        default_registry.counter("state/resident/device_takeovers").inc(1)
        get_logger("state").error(
            "resident mirror moving to the host (%s): full rehash of %d "
            "nodes, then CPU-resident commits", why, self.trie.num_nodes)
        self.host_mode = True
        self.template = False  # host commits absorb by construction
        if self.ex is not None:
            self.ex.h2d_bytes = 0  # no further uploads after takeover
        self.trie.rehash_host(threads=self._cpu_threads)
        # the export delta marks predate the takeover; write a full
        # image at the next interval so disk supersedes any device-era
        # uncertainty
        self._export_degraded = True
        self._dirty_since_export = True

    def _replay_window(self, window) -> None:  # guarded-by: _lock
        """Recompute every in-flight commit's root serially on the rung
        just landed on: rewind through the window's scopes and replay
        each batch, comparing against the header root it was recorded
        under. Bit-exact: the host hasher is the oracle the device was
        checked against all along, and a mesh demotion re-proved its
        image against it."""
        from ..metrics import default_registry

        for _ in window:
            self._applied.pop()
            self.trie.rollback()
        for i, ent in enumerate(window):
            self.trie.checkpoint()
            self.trie.update(self._batch[ent["key"]])
            root = self._commit_root()
            if root != ent["expected"]:
                # the host oracle disagrees with the recorded header
                # root: the BLOCK was wrong, not the device — drop it
                # and everything stacked on it
                self.trie.rollback()
                for e in window[i:]:
                    self._forget(e["key"])
                self._prune_orphans()
                default_registry.counter(
                    "state/resident/pipeline_divergences").inc(1)
                raise MirrorError(
                    "host recompute of in-flight block "
                    f"{ent['key'].hex()[:8]} does not match its header "
                    "root")
            self._applied.append(ent["key"])

    # ---- cross-commit device pipelining ----------------------------------

    def _pipelining(self) -> bool:
        return (self.pipeline_depth > 0 and not self.host_mode
                and not self.template and self.ex is not None)

    def _pipeline_gauge(self) -> None:  # guarded-by: _lock
        # current window occupancy, exported so an operator can tell a
        # saturated pipeline (depth pinned at max) from an idle one
        from ..metrics import default_registry

        default_registry.gauge("resident/pipeline/depth").update(
            len(self._inflight))

    def _commit_dispatch(self, key: bytes,  # guarded-by: _lock
                         expected: bytes) -> bytes:
        """Dispatch this commit's device program WITHOUT waiting for its
        root; the entry settles at the next drain point. The caller has
        already opened the scope and applied [updates]; [expected] is
        the header root this commit is optimistically recorded under."""
        try:
            with span("resident/commit", host_mode=False, pipelined=True), \
                    phase_timer("resident/phase/commit"):
                self._check_device()
                resolve = self.trie.commit_resident_dispatch(
                    self.ex, self.device_timeout)
        except DEVICE_FAULTS as e:
            # wedge at dispatch: close the current block's open scope, so
            # the window below it stays as it was
            self.trie.rollback()
            raise self._wedge(e)
        self._inflight.append({
            "key": key, "expected": expected, "resolve": resolve,
            "t_dispatch": time.monotonic()})
        self._pipeline_gauge()
        return expected

    def _drain_pipeline(self, leave: int = 0,  # guarded-by: _lock
                        upto: Optional[bytes] = None) -> None:
        """Resolve in-flight pipelined commits in dispatch order,
        comparing each device root against the header root it was
        recorded under. leave: stop once at most this many entries
        remain (window refill before the next dispatch); upto: stop
        once this block's entry has settled (accept only needs its own
        prefix). A device wedge mid-drain raises DeviceWedgedError with
        the window left in flight (take_over_host settles it on the
        host); a root mismatch rewinds the offending commit and raises
        MirrorError."""
        if upto is not None and not any(
                e["key"] == upto for e in self._inflight):
            return
        try:
            while len(self._inflight) > max(0, leave):
                self._check_device()
                ent = self._inflight[0]
                t0 = time.monotonic()
                try:
                    root = ent["resolve"]()
                except DEVICE_FAULTS as e:
                    raise self._wedge(e)
                self._inflight.pop(0)
                self._note_overlap(ent, t0)
                if root != ent["expected"]:
                    self._pipeline_diverged(ent, root)
                if upto is not None and ent["key"] == upto:
                    return
        finally:
            self._pipeline_gauge()

    def _note_overlap(self, ent: dict, t0: float) -> None:  # guarded-by: _lock
        """Record how much of this commit's device time the pipeline hid
        (1 = the drain found it already finished; 0 = fully serial)."""
        from ..metrics import default_registry

        now = time.monotonic()
        wall = now - ent["t_dispatch"]
        blocked = now - t0
        frac = 0.0 if wall <= 0 else max(0.0, 1.0 - blocked / wall)
        self.last_overlap_fraction = frac
        default_registry.gauge("resident/overlap_fraction").update(frac)

    def _pipeline_diverged(self, ent: dict, got: bytes) -> None:  # guarded-by: _lock
        """A drained pipelined commit's device root differs from the
        header root it was optimistically recorded under. Rewind the
        offending commit and every applied descendant (they built on a
        wrong state), forget the rest of the window, and raise: the
        MirrorError reaches the chain (MirrorStateTrie falls back to the
        disk path only in host mode), so a bad block fails consensus and
        the periodic spot-check quarantines a genuinely corrupt device."""
        from ..log import get_logger
        from ..metrics import default_registry

        default_registry.counter(
            "state/resident/pipeline_divergences").inc(1)
        stale, self._inflight = list(self._inflight), []
        self._pipeline_gauge()
        key = ent["key"]
        if key in self._applied:
            idx = self._applied.index(key)
            while len(self._applied) > idx:
                dropped = self._applied.pop()
                self.trie.rollback()
                self._dirty_since_export = True
                self._forget(dropped)
        else:
            self._forget(key)
        for e in stale:
            self._forget(e["key"])
        self._prune_orphans()
        get_logger("state").error(
            "pipelined resident commit diverged at %s: device %s != "
            "header %s — rewound %d in-flight block(s)",
            key.hex()[:8], got.hex()[:16], ent["expected"].hex()[:16],
            1 + len(stale))
        raise MirrorError(
            f"pipelined commit root mismatch at {key.hex()[:8]}")

    @_locked  # guarded-by: _lock
    def spot_check(self) -> bool:
        """Periodic device-vs-host cross-check (chain knob
        resident_spot_check_interval): verify the device-resident image
        against the host keccak oracle WITHOUT ending residency. Returns
        False on divergence — the chain quarantines via reboot_mirror()
        instead of letting a silently-corrupt mirror feed consensus.

        rehash_host would be the obvious oracle but it one-way pins the
        trie to host mode, so a PASSING check would still end residency.
        Instead: settle + read back the device store (watchdogged, like
        export_to), then export the full node image and check
        keccak256(node_rlp) == claimed digest for every node on the host,
        plus the cached applied root appearing in the digest set. Node
        RLP embeds children digests from the same store, so this
        transitively verifies the whole device digest chain down from
        the root. The full export consumes the delta marks, so the next
        interval flush is degraded to a full image."""
        from ..metrics import default_registry
        from ..native import keccak256_batch

        default_registry.counter("state/resident/spot_checks").inc(1)
        try:
            failpoint("state/resident/spot_check")
        except FailpointError:
            return False  # chaos-forced divergence
        if self.host_mode or self.trie.num_nodes == 0:
            return True  # the host oracle already computed these roots
        # the check must not race an in-flight pipelined window: its
        # store readback would observe commits whose roots were never
        # compared, mis-attributing a divergence to "the device" when a
        # specific block was wrong. Settle the window first (per-block
        # attribution), then cross-check the settled image.
        # guarded-by: _lock (the decorator serializes against dispatch)
        try:
            self._drain_pipeline()
        except MirrorError:
            default_registry.counter(
                "state/resident/spot_check_failures").inc(1)
            return False
        try:
            self._check_device()
            if self.template:
                # template commits absorb every digest as they go — the
                # host cache is already the device image; just settle
                dev_root = self.trie.commit_template(
                    self.ex, self.device_timeout)
            else:
                dev_root = self.trie.commit_resident_timed(
                    self.ex, self.device_timeout)
                self._absorb_device_store("spot-check store readback")
        except DEVICE_FAULTS as e:
            # not a divergence: the device stopped answering
            raise self._wedge(e)
        digs, blob, off = self.trie.export_nodes(delta=False)
        self._export_degraded = True
        self._dirty_since_export = True
        n = int(digs.shape[0])
        msgs = [bytes(blob[int(off[i]):int(off[i + 1])]) for i in range(n)]
        host = keccak256_batch(msgs, threads=self._cpu_threads)
        claimed = {digs[i].tobytes() for i in range(n)}
        ok = all(digs[i].tobytes() == host[i] for i in range(n))
        cached = self._roots.get(self._applied[-1])
        ok = ok and dev_root in claimed and (
            cached is None or cached == dev_root)
        if not ok:
            default_registry.counter(
                "state/resident/spot_check_failures").inc(1)
        return ok

    def _absorb_device_store(self, what: str) -> None:
        """Sync the device store into the host digest cache before an
        export/spot-check read: the executor's store_parts() when it has
        them, else its `.store` (wrappers, stubs). The watchdog wraps only
        the readback; absorb mutates the trie on THIS thread, so an
        abandoned worker can't race it. Both are the
        resident/phase/absorb timer."""
        import numpy as np

        from ..native.mpt import _run_with_watchdog

        reader = getattr(self.ex, "store_parts", None)
        if reader is not None:
            work, absorb = (lambda: list(reader())), \
                self.trie.absorb_store_parts
        else:
            work, absorb = (lambda: np.asarray(self.ex.store)), \
                self.trie.absorb_store
        with phase_timer("resident/phase/absorb"):
            if self.device_timeout is None:
                absorb(work())
            else:
                absorb(_run_with_watchdog(work, self.device_timeout, what))

    # ---- lifecycle -------------------------------------------------------

    @_locked  # guarded-by: _lock
    def verify(self, parent_hash: bytes, block_hash: bytes,
               updates: Sequence[Tuple[bytes, bytes]],
               expected_root: Optional[bytes] = None) -> bytes:
        """Apply [updates] on top of [parent_hash]'s state and return the
        resulting state root. Saves the batch so later branch switches
        can replay it.

        When [expected_root] (the header root) is given and pipelining
        is on, the commit is DISPATCHED but not synchronized: the
        expected root is recorded and returned optimistically, and the
        device root is compared against it at the next drain point —
        host planning of the next block overlaps this block's device
        execution."""
        if parent_hash == self.ANON:
            parent_hash = self._promote_anon()
        if parent_hash not in self._roots:
            raise MirrorError(f"unknown parent {parent_hash.hex()[:8]}")
        if block_hash in self._roots:
            # re-verify of a known block: the root is cached, but the
            # mirror must still LAND on that block's state (callers read
            # intermediate state through the head)
            if self._applied[-1] != block_hash:
                self._switch_to(block_hash)
            return self._roots[block_hash]
        updates = list(updates)
        # a matching anonymous preview (the miner's block-under-
        # construction) is this block's state already applied: adopt it
        # (an in-flight ANON dispatch is adopted with it — the entry is
        # renamed and settles under the block's name)
        if (self.ANON in self._roots
                and self._parent.get(self.ANON) == parent_hash
                and self._batch.get(self.ANON) == updates
                and self._applied and self._applied[-1] == self.ANON):
            root = self._roots[self.ANON]
            self._rename_anon(block_hash)
            return root
        self._drop_anon()
        if self._applied[-1] != parent_hash:
            self._switch_to(parent_hash)
        if expected_root is not None and self._pipelining():
            # refill the bounded window, then dispatch without waiting
            self._drain_pipeline(leave=self.pipeline_depth - 1)
            self._apply(updates)
            root = self._commit_dispatch(block_hash, expected_root)
        else:
            self._drain_pipeline()
            self._apply(updates)
            root = self._commit_scope()
        with phase_timer("resident/phase/record"):
            self._dirty_since_export = True
            self._record(block_hash, parent_hash, updates, root)
        return root

    @_locked  # guarded-by: _lock
    def preview(self, parent_hash: bytes,
                updates: Sequence[Tuple[bytes, bytes]],
                expected_root: Optional[bytes] = None) -> bytes:
        """Compute the root [updates] would produce on top of
        [parent_hash] WITHOUT naming a block — the miner's path, where
        the block hash depends on this root. The state stays applied as
        the single anonymous head; the next verify with the same
        parent+batch adopts it for free, anything else rewinds it.

        [expected_root] pipelines exactly like verify(): the chain's
        validate phase previews with the header root in hand, the later
        verify adopts the in-flight dispatch — one device program per
        block, settled at the next drain point."""
        if parent_hash == self.ANON:
            parent_hash = self._promote_anon()
        if parent_hash not in self._roots:
            raise MirrorError(f"unknown parent {parent_hash.hex()[:8]}")
        updates = list(updates)
        if (self.ANON in self._roots
                and self._parent.get(self.ANON) == parent_hash
                and self._batch.get(self.ANON) == updates):
            if self._applied and self._applied[-1] != self.ANON:
                self._switch_to(self.ANON)
            return self._roots[self.ANON]
        self._drop_anon()
        if self._applied[-1] != parent_hash:
            self._switch_to(parent_hash)
        if expected_root is not None and self._pipelining():
            self._drain_pipeline(leave=self.pipeline_depth - 1)
            self._apply(updates)
            root = self._commit_dispatch(self.ANON, expected_root)
        else:
            self._drain_pipeline()
            self._apply(updates)
            root = self._commit_scope()
        with phase_timer("resident/phase/record"):
            self._dirty_since_export = True
            self._record(self.ANON, parent_hash, updates, root)
        return root

    def _apply(self, updates) -> None:  # guarded-by: _lock
        """Open the block's undo scope and apply its leaves to the native
        trie: the resident/phase/update timer."""
        with phase_timer("resident/phase/update"):
            self.trie.checkpoint()
            self.trie.update(updates)

    # side-branch records (phantom previews, losing forks) kept replayable
    # before GC reclaims the oldest — generous: consensus only builds on
    # recent blocks (the reference's dirty forest is similarly bounded)
    MAX_SIDE_RECORDS = 512

    def _record(self, key: bytes, parent: bytes,  # guarded-by: _lock
                batch: List[Tuple[bytes, bytes]], root: bytes) -> None:
        self._parent[key] = parent
        self._batch[key] = batch
        self._roots[key] = root
        self._by_root.setdefault(root, []).append(key)
        self._applied.append(key)
        extra = len(self._roots) - len(self._applied)
        if extra > self.MAX_SIDE_RECORDS:
            applied = set(self._applied)
            for k in list(self._roots):
                if extra <= self.MAX_SIDE_RECORDS:
                    break
                if k in applied or k in self._accepted:
                    continue
                self._forget(k)
                extra -= 1
            # descendants of a collected record have dangling parents and
            # can never replay — collect them now (matching reject()'s
            # cleanup) instead of surfacing later as a "no path" error in
            # _switch_to
            self._prune_orphans()

    def _promote_anon(self) -> bytes:
        """Name the anonymous head by its ROOT so new work can build on
        top of it — chain generation commits block k+1's state before
        block k has a hash. When the real block arrives, verify() records
        it under its hash; the promoted record ages out via the
        side-record GC."""
        if self.ANON not in self._roots:
            raise MirrorError("no anonymous state to build on")
        root = self._roots[self.ANON]
        if root in self._roots:
            # an identically-rooted record already exists (e.g. an empty
            # batch on a promoted parent): collapse onto it
            self._drop_anon()
            return root
        self._rename_anon(root)
        return root

    def _rename_anon(self, block_hash: bytes) -> None:  # guarded-by: _lock
        # an in-flight ANON dispatch is adopted with the record: rename
        # its entry BEFORE _forget (which drops entries by key) so it
        # settles under the block's name at the next drain
        for e in self._inflight:
            if e["key"] == self.ANON:
                e["key"] = block_hash
        root = self._roots[self.ANON]
        parent = self._parent[self.ANON]
        batch = self._batch[self.ANON]
        # the anon may have been rewound off the stack by an intervening
        # read/switch — its record is still renameable
        idx = (self._applied.index(self.ANON)
               if self.ANON in self._applied else None)
        self._forget(self.ANON)
        if idx is not None:
            self._applied[idx] = block_hash
        self._parent[block_hash] = parent
        self._batch[block_hash] = batch
        self._roots[block_hash] = root
        self._by_root.setdefault(root, []).append(block_hash)

    def _drop_anon(self) -> None:  # guarded-by: _lock
        if self.ANON not in self._roots:
            return
        if self.ANON in self._applied:
            idx = self._applied.index(self.ANON)
            while len(self._applied) > idx:
                dropped = self._applied.pop()
                self.trie.rollback()
                self._dirty_since_export = True
                if dropped != self.ANON:
                    self._forget(dropped)
        self._forget(self.ANON)

    @_locked  # guarded-by: _lock
    def accept(self, block_hash: bytes) -> None:
        """Finalize a block. Scopes of finalized history deeper than the
        tip buffer flush (the common linear-chain steady state keeps a
        rolling TIP_BUFFER-deep readable window)."""
        if block_hash not in self._roots:
            raise MirrorError("accepting a block the mirror never saw")
        # settle the accepted block's dispatch (and everything before
        # it) BEFORE finality marks it: a root that never matched its
        # header must not finalize. Later in-flight siblings keep
        # overlapping.
        self._drain_pipeline(upto=block_hash)
        self._accepted.add(block_hash)
        self._maybe_flush()

    # finalized blocks whose undo scopes (and records) stay retained so
    # recent-state reads keep working — the reference's 32-root tip
    # buffer (core/state_manager.go:189+ / TIP_BUFFER_SIZE)
    TIP_BUFFER = 32

    def _maybe_flush(self) -> None:  # guarded-by: _lock
        # the finalized PREFIX of the stack (base + contiguous accepted
        # blocks; anything above can still be rejected and must stay
        # rewindable). Scopes deeper than the tip buffer flush; history
        # below the new base stops being rewindable, so a sibling
        # branching there can never apply again and its parent lookup
        # failing is the correct refusal
        m = 0
        while (m + 1 < len(self._applied)
               and self._applied[m + 1] in self._accepted):
            m += 1
        n_flush = m - self.TIP_BUFFER
        if n_flush <= 0:
            return
        self.trie.flush_oldest_checkpoints(n_flush)
        evicted, self._applied = (
            self._applied[:n_flush], self._applied[n_flush:])
        for h in evicted:
            self._forget(h)
            self._accepted.discard(h)
        # the new base is the tree's floor: drop its parent link so
        # orphan pruning never mistakes it for unreachable
        self._parent.pop(self._applied[0], None)
        # side records that branched below the new base (stale promoted
        # previews, losing siblings) lost their replay path
        self._prune_orphans()

    def _prune_orphans(self) -> None:
        """Forget every record whose parent record is gone (no replay
        path can reach it anymore), to a fixpoint."""
        changed = True
        while changed:
            changed = False
            for h, p in list(self._parent.items()):
                if p not in self._roots:
                    self._forget(h)
                    changed = True

    @_locked  # guarded-by: _lock
    def reject(self, block_hash: bytes) -> None:
        """Drop a block. If it is applied, rewind through it (consensus
        rejects its applied descendants with it)."""
        if block_hash in self._accepted:
            # with the tip buffer, accepted blocks stay on the stack for
            # TIP_BUFFER blocks — a duplicate/out-of-order Reject must
            # not rewind finalized state through them
            raise MirrorError(
                f"rejecting an ACCEPTED block ({block_hash.hex()[:8]})")
        # settle any in-flight window before rewinding through it (a
        # reject mid-pipeline is a reorg: the drain keeps divergence
        # attribution per-block before scopes are torn down)
        self._drain_pipeline()
        if block_hash in self._applied:
            idx = self._applied.index(block_hash)
            while len(self._applied) > idx:
                dropped = self._applied.pop()
                self.trie.rollback()
                self._dirty_since_export = True
                if dropped != block_hash:
                    # descendant of the rejected block: gone with it
                    self._forget(dropped)
        self._forget(block_hash)
        # unapplied descendants lost their replay path with the rejected
        # block (consensus rejects them too, but their Reject may never
        # reach us once the parent is gone)
        self._prune_orphans()
        # dropping the last unaccepted block can make the stack final
        self._maybe_flush()

    @property
    def head(self) -> bytes:
        with self._lock:
            return self._applied[-1]

    @_locked
    def root_of(self, block_hash: bytes) -> Optional[bytes]:
        return self._roots.get(block_hash)

    @_locked
    def has_root(self, root: bytes) -> bool:
        return root in self._by_root

    @_locked
    def key_for_root(self, root: bytes) -> Optional[bytes]:
        """A block key whose state has [root]. Prefers a key on the
        applied stack (always reachable); identical-root records off the
        stack (stale promoted previews) may sit beyond the rewind
        horizon."""
        keys = self._by_root.get(root)
        if not keys:
            return None
        applied = set(self._applied)
        for k in reversed(keys):
            if k in applied:
                return k
        return keys[-1]

    # ---- reads (chain adapter state reads at a resident root) ------------

    @_locked
    def read(self, root: bytes, key32: bytes) -> Optional[bytes]:
        """Value of [key32] in the state identified by [root]. Positions
        the trie at a block with that root (identical-root blocks have
        identical state, so any is correct). Raises MirrorError when the
        root is not resident or no longer reachable (accepted history —
        serve those from the exported disk image instead)."""
        keys = self._by_root.get(root)
        if not keys:
            raise MirrorError("root not resident")
        if self._roots.get(self._applied[-1]) == root:
            return self.trie.get(key32)
        # overlay shortcut: if [key32] is untouched by every batch on
        # both legs of the path between a target block and the head, the
        # head's value IS the target's value — serve it without
        # repositioning (an RPC StateDB at block N-1 interleaved with
        # processing at N would otherwise pay two branch switches, each
        # a device commit, per account read)
        for k in keys:
            if self._untouched_between(k, key32):
                return self.trie.get(key32)
        last_err: Optional[MirrorError] = None
        for k in list(keys):
            try:
                self._switch_to(k)
                return self.trie.get(key32)
            except MirrorError as e:
                last_err = e
        raise last_err if last_err is not None else MirrorError(
            "root unreachable")

    def _batch_keys_of(self, k: bytes):  # guarded-by: _lock
        s = self._batch_keys.get(k)
        if s is None:
            b = self._batch.get(k)
            if b is None:
                return None
            s = self._batch_keys[k] = frozenset(kk for kk, _ in b)
        return s

    def _untouched_between(self, target: bytes, key32: bytes) -> bool:
        """True iff no batch on target->ancestor or ancestor->head
        touches [key32], where ancestor is target's nearest applied
        ancestor — then the value at the head equals the value at
        target's state."""
        applied_idx = {k: i for i, k in enumerate(self._applied)}
        chain: List[bytes] = []
        cur = target
        while cur not in applied_idx:
            p = self._parent.get(cur)
            if p is None:
                return False
            chain.append(cur)
            cur = p
        for k in chain:
            s = self._batch_keys_of(k)
            if s is None or key32 in s:
                return False
        for k in self._applied[applied_idx[cur] + 1:]:
            s = self._batch_keys_of(k)
            if s is None or key32 in s:
                return False
        return True

    # ---- interval persistence (disk flush of changed nodes) --------------

    @_locked  # guarded-by: _lock
    def export_to(self, diskdb, at_block: Optional[bytes] = None,
                  pre_write=None) -> int:
        """Durably write every account-trie node changed since the
        previous export into [diskdb] — the commit-interval disk flush
        (reference trie/triedb/hashdb Commit via
        core/state_manager.go:153). Positions the trie at [at_block]
        (typically the just-accepted block) first so the on-disk image is
        complete for that block's root; [pre_write] (e.g. the storage-
        forest cap) runs after the batch is staged but before it commits,
        preserving children-first crash ordering. Returns nodes written.

        Durability: the native export clears its changed-node marks as it
        walks, so a FAILED disk write would silently drop those nodes
        from every later delta. On any write failure the next export
        degrades to a FULL image (which supersedes all lost deltas)
        before the marks are trusted again.

        Content-addressed writes make sibling/abandoned-branch nodes
        harmless on disk: they are unreachable garbage the offline
        pruner sweeps, exactly like the reference's stale hashdb nodes."""
        if not self._dirty_since_export and not self._export_degraded and (
            at_block is None or self._applied[-1] == at_block
        ):
            # nothing re-hashed since the last export at this position:
            # skip the store readback + full-trie walk (an RPC client
            # polling eth_getProof per block would otherwise make every
            # call O(total nodes))
            return 0
        # the on-disk image must only ever contain SETTLED state: drain
        # the pipeline window before reading the store back
        self._drain_pipeline()
        if at_block is not None and self._applied[-1] != at_block:
            self._switch_to(at_block)
        if self.trie.num_nodes == 0:
            return 0
        # a rewind-only switch leaves the reverted paths dirty (rollback
        # replays through the updater, native/mpt.py rollback): re-commit
        # so digests are settled before the export reads them. A clean
        # trie plans nothing, so this is free in the common case. On the
        # device path the store readback runs under the watchdog too — a
        # wedge MID-EXPORT raises like a wedge mid-commit, with the delta
        # marks untouched (the worker only syncs device state; absorb
        # mutates the trie on THIS thread, so an abandoned worker can't
        # race it).
        if self.host_mode:
            self.trie.commit_cpu(threads=self._cpu_threads)
        else:
            try:
                self._check_device()
                if self.template:
                    # template commits absorb as they go — no store
                    # readback, the host cache is already current
                    self.trie.commit_template(self.ex,
                                              self.device_timeout)
                else:
                    self.trie.commit_resident_timed(
                        self.ex, self.device_timeout)
                    self._absorb_device_store("store readback")
            except DEVICE_FAULTS as e:
                raise self._wedge(e)
        try:
            digs, blob, off = self.trie.export_nodes(
                delta=not self._export_degraded)
        except RuntimeError as e:  # dirty-trie guard: surface as ours
            raise MirrorError(f"export on unsettled trie: {e}")
        try:
            batch = diskdb.new_batch()
            for i in range(digs.shape[0]):
                batch.put(digs[i].tobytes(), blob[int(off[i]):int(off[i + 1])])
            if pre_write is not None:
                pre_write()
            batch.write()
        except BaseException:
            self._export_degraded = True
            self._dirty_since_export = True
            raise
        self._export_degraded = False
        self._dirty_since_export = False
        return int(digs.shape[0])

    # ---- branch switching ------------------------------------------------

    def _forget(self, block_hash: bytes) -> None:
        # a forgotten block's in-flight dispatch has nothing left to
        # settle against (rollback already re-dirtied its paths; the
        # device program is harmless — the delta-patch scheme tolerates
        # rolled-back dispatched commits)   # guarded-by: _lock
        if self._inflight:
            self._inflight = [e for e in self._inflight
                              if e["key"] != block_hash]
            self._pipeline_gauge()
        root = self._roots.pop(block_hash, None)
        if root is not None:
            keys = self._by_root.get(root)
            if keys is not None:
                try:
                    keys.remove(block_hash)
                except ValueError:
                    pass
                if not keys:
                    del self._by_root[root]
        self._parent.pop(block_hash, None)
        self._batch.pop(block_hash, None)
        self._batch_keys.pop(block_hash, None)
        self._accepted.discard(block_hash)

    def _switch_to(self, target: bytes) -> None:  # guarded-by: _lock
        """Rewind to the nearest applied ancestor of [target], then
        replay the saved batches down to it."""
        # a branch switch is the pipeline's hard barrier: settle every
        # in-flight commit before tearing scopes down (the replay-root
        # compare below would otherwise race unverified dispatches)
        # guarded-by: _lock (every caller holds it)
        self._drain_pipeline()
        # ancestry chain of target up to something applied
        chain: List[bytes] = []
        cur = target
        applied_set = set(self._applied)
        while cur not in applied_set:
            chain.append(cur)
            nxt = self._parent.get(cur)
            if nxt is None:
                raise MirrorError(
                    f"no path from {target.hex()[:8]} to the mirror")
            cur = nxt
        # rewind to the common ancestor `cur`. Accepted blocks within the
        # tip buffer rewind like any other (recent-state reads position
        # here); their records are retained, so the canonical path
        # replays back on the next forward switch. True finality is the
        # flushed base: anything below it has no record and the ancestry
        # walk above already refused it.
        while self._applied[-1] != cur:
            self._applied.pop()
            self.trie.rollback()
            self._dirty_since_export = True
        # replay down the target branch (deepest ancestor first)
        for h in reversed(chain):
            self.trie.checkpoint()
            self.trie.update(self._batch[h])
            self._dirty_since_export = True
            root = self._commit_scope()
            if root != self._roots[h]:
                self.trie.rollback()  # close the scope we just opened
                raise MirrorError(
                    f"replay of {h.hex()[:8]} produced a different root")
            self._applied.append(h)
