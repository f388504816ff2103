"""Canonical chain management under Snowman consensus (semantics of coreth
core/blockchain.go); counterpart of coreth_tpu/core/blockchain.py.

The chain has no forks-choice rule of its own: consensus drives it through
insertBlock (verify+process, core/blockchain.go:1245), Accept
(core/blockchain.go:1034 → async acceptor queue :563-611), Reject (:1067),
and SetPreference (:973 → reorg :1424). A block goes insert_block →
sender recovery → StateProcessor.process → validate_state →
StateDB.commit → the trie writer → accept. State commitment flows through
the TrieWriter policy (state_manager) into the TrieDatabase, whose batch
keccak is the device seam (ops/device.get_batch_keccak on the chain's
`device`: planned K1 by default).

The resident chain: with resident_account_trie "auto" (the default) the
chain resolves its device under a 10 s watchdog and, when that is CUDA,
boots a ResidentAccountMirror over the last-accepted state, so every
block's account trie commits on the device (ResidentExecutor on K1) and
its storage tries in one planned program (PlannedCommit on K1). With
device="cpu" "auto" is off, as the reference's is without a TPU; a probe
that fails or times out raises ChainError. A DeviceWedgedError or a
device MirrorError leaves insert_block as an exception with the head
where it was; the mirror moves to the host only when the caller calls
chain.take_over_host() (noted in the flight recorder), never by itself.

Device rules of the port: `device` None is CUDA, and without it the
device seam and the "auto" probe raise; "cpu" only when asked. A device
fault (device.DEVICE_FAULTS) is never a bad block.

The execution options: evm_exec_shards and evm_parallel_workers (and
their env overrides, read per block) pick the processor's speculative
mode (state_processor.py); insert_pipeline_depth > 0 hands insert_block
to the staged pipeline (insert_pipeline.py), drained at accept, reject,
set_preference and insert_block_manual and stopped at stop().

The degradation ladder (ops/device.DeviceLadder, process-wide): the chain
configures it from its device_* knobs and listens to it
(_on_device_event: every device/* event goes into the flight recorder,
and a promotion after a takeover reboots the mirror on the device).
take_over_host() also demotes the ladder, whose probes then decide when
the device earned its way back; nothing else demotes it, and a device
fault of a laddered dispatch reaches insert_block like any other
(device_max_retries is refused but at 0). The listener leaves at stop().

Event feeds, each fn(block, logs): subscribe_chain_event (canonical head
changes: an insert that extends the preference, a reorg), on which the
VM's tx pool re-anchors; subscribe_chain_accepted_event (each accepted
block once, on the acceptor thread after its post-processing), which the
RPC filters (eth/filters.py) read.

The dual-root shadow (state_backend="bintrie-shadow"): the chain mounts a
bintrie/shadow.ShadowCommitment on its Database before the genesis
commit, on the chain's device, with _note_shadow_event as its quarantine
hook; StateDB.commit feeds it. An error of its planned commit (kernel K1)
reaches insert_block / build_block like any other device error.

The mesh-sharded mirror (resident_mesh_devices = n > 0): the mirror's
store and arenas split by rows over n mesh positions on the chain's
device argument (parallel.make_mesh: the first n CUDA devices for None,
n positions on the one device named). take_over_host() walks it down one
rung a call: mesh -> single device (the ladder stays healthy), then
single device -> host.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .. import rlp
from ..device import DEVICE_FAULTS, DeviceLike, DeviceWedgedError, resolve
from ..fault import failpoint
from ..fault import register as _register_failpoint
from ..metrics.flight import FlightRecorder
from ..metrics.spans import span as _span
from ..state.database import Database
from ..state.statedb import StateDB
from . import rawdb
from .state_manager import (
    CappedMemoryTrieWriter,
    NoPruningTrieWriter,
    ResidentTrieWriter,
)
from .state_processor import StateProcessor
from .types import Block, Body, Header, Receipt, create_bloom, derive_sha


class ChainError(Exception):
    pass


class ChainDegradedError(ChainError):
    """Inserts refused: the chain demoted itself to the degraded
    read-only rung after a persistent storage write failure (the
    bottom of the same ladder the device/mirror path rides —
    ROBUSTNESS.md "Storage faults & degraded mode"). Reads, RPC, and
    metrics keep serving; every insert attempt re-probes the disk and
    the chain re-promotes itself once a probe write lands."""


class TailStalled(ChainError):
    """A bounded join on the insert tail / acceptor queue expired: the
    async worker is wedged (or its current item is), and the caller
    refuses to block forever. Carries enough context to diagnose WHERE
    the pipeline stopped without attaching a debugger."""

    def __init__(self, what: str, timeout: float, depth: int,
                 last_record: Optional[dict] = None,
                 worker_error: Optional[str] = None):
        self.what = what
        self.timeout = timeout
        self.depth = depth
        self.last_record = last_record
        self.worker_error = worker_error
        at = ""
        if last_record:
            at = (f"; last flight record: block {last_record.get('number')}"
                  f" phases={sorted(last_record.get('phases', {}))}")
        err = f"; worker error:\n{worker_error}" if worker_error else ""
        super().__init__(
            f"{what} still has {depth} unfinished item(s) after "
            f"{timeout:.1f}s{at}{err}")


# insert-tail failpoint sites (fault/): `raise`/`hang` here
# simulate a crash between the tail's ordered disk writes — the torn
# states the boot-time repair scan must handle.
FP_TAIL_BEFORE_BODY = _register_failpoint(
    "chain/tail/before_body", "before any rawdb write for a block")
FP_TAIL_PARTIAL_BODY = _register_failpoint(
    "chain/tail/partial_body",
    "after the header writes, before body/receipts — a torn body")
FP_TAIL_BEFORE_HEAD = _register_failpoint(
    "chain/tail/before_head",
    "after a block's body is durable, before the canonical-hash/"
    "head-pointer writes")

# insert-stage failpoint sites: one per stage of the insert path (the
# reference's pipeline fires the same names).
FP_INSERT_BEFORE_RECOVER = _register_failpoint(
    "insert/before_recover", "before sender-recovery dispatch")
FP_INSERT_BEFORE_EXECUTE = _register_failpoint(
    "insert/before_execute",
    "after verify/recovery, before (speculative) execution")
FP_INSERT_BEFORE_COMMIT = _register_failpoint(
    "insert/before_commit",
    "under chainmu, before the state commit of a validated block")
FP_INSERT_BEFORE_WRITE = _register_failpoint(
    "insert/before_write",
    "after the state commit, before the block enters the insert tail")


@dataclass
class CacheConfig:
    """core.CacheConfig (blockchain.go:150-180) — the knobs that matter."""

    pruning: bool = True
    commit_interval: int = 4096
    trie_dirty_limit: int = 256 * 1024 * 1024
    # flat-snapshot diff-layer budget; 0 disables the snapshot tree and
    # every state read walks the trie. On by default: the flat layers
    # turn per-account trie walks into O(1) dict gets.
    snapshot_limit: int = 256
    # the device seam of the chain's own TrieDatabase (when the caller
    # gives no state_database): "auto"/"planned" one device program per
    # commit (K1), "batched" level by level (K2), "fused" one fused commit
    # per large trie (K2 per segment), "off" the recursive CPU hasher
    # everywhere (ops/device.get_batch_keccak)
    device_hasher: str = "auto"
    # device-resident account trie: per-block account hashing runs as one
    # resident commit on the mirror (ops/keccak_resident.py) instead of
    # the Python trie walk; changed nodes flush to disk at
    # commit_interval. A pruning policy: off under pruning=False.
    # "auto" (the default): ON exactly when the chain's device resolves to
    # CUDA (checked under a 10 s watchdog; a failed probe raises
    # ChainError); device="cpu" keeps the default trie path.
    resident_account_trie: "bool | str" = "auto"
    # watchdog budget (seconds) for one resident device commit/readback;
    # on expiry the commit raises DeviceWedgedError to the caller
    # (trie/resident_mirror.py) and the head stays. None disables the
    # watchdog (the CORETH_TPU_RESIDENT_TIMEOUT env override still
    # applies).
    resident_commit_timeout: "float | None" = None
    # resident mirror host preference: True commits on the threaded
    # native CPU hasher (the mirror's host mode); "auto" and False keep
    # the device path (the port never picks the host by itself)
    resident_prefer_host: "bool | str" = "auto"
    # native CPU hasher worker threads; 0 = auto
    # (env CORETH_TPU_CPU_THREADS, else min(16, cores))
    cpu_threads: int = 0
    # bloom-bit index section (bloom_indexer.go BloomBitsBlocks)
    bloom_section_size: int = 4096
    # Block-STM optimistic parallel execution workers (core/parallel_exec);
    # 0 = the serial loop. CORETH_TPU_EVM_PARALLEL overrides per block.
    evm_parallel_workers: int = 0
    # process-level execution shards (core/exec_shards): worker processes
    # execute speculative txs and ship write-sets back; 0 = in-process
    # paths only. Checked before evm_parallel_workers;
    # CORETH_TPU_EVM_EXEC_SHARDS overrides per block.
    evm_exec_shards: int = 0
    # per-chain flight recorder: ring size of retained per-block phase
    # records (metrics/flight.py; served by debug_blockFlightRecord)
    flight_recorder_size: int = 64
    # --- the degradation ladder's knobs (ops/device.DeviceLadder) ---
    # per-call watchdog deadline (seconds) for laddered device dispatches;
    # 0 disables the watchdog: dispatches run inline with no extra thread
    device_call_timeout: float = 0.0
    # retries of a failed laddered dispatch: the port retries none (a
    # device fault reaches the caller; ROADMAP Queue 3), so anything but
    # 0 raises
    device_max_retries: int = 0
    # seconds between background health probes while demoted; <= 0 means
    # a demoted device is never re-promoted
    device_probe_interval: float = 5.0
    # consecutive healthy probes required for re-promotion
    device_promote_after: int = 3
    # resident-mirror spot check (device root vs host keccak oracle)
    # every K committed inserts; 0 disables
    resident_spot_check_interval: int = 0
    # cross-commit device pipelining: up to this many resident commits
    # stay in flight on the device, verified against their header roots
    # at the next drain point (accept/reject/reorg/spot-check/export) —
    # host planning of block k+1 overlaps device execution of block k.
    # 0 = every commit synchronizes before verify returns
    resident_pipeline_depth: int = 0
    # template residency: keep the planned path's host digest cache warm
    # (per-commit device->host digest absorb) while the device keeps row
    # arenas + store resident, so uploads carry only fresh leaf content.
    # Excludes pipelining (the per-commit absorb IS a sync)
    resident_template_residency: bool = False
    # mesh-sharded resident commits: shard the mirror's digest store +
    # row arenas over this many mesh positions (0 = unsharded). The
    # caller's take_over_host() demotes mesh -> single-device resident ->
    # host, each rung bit-exact against the host oracle
    resident_mesh_devices: int = 0
    # storage-lean node rows (SonicDB-style fixed-width records): fresh
    # single-block nodes upload as 72-byte content-only records (+ 4 B
    # arena index + 4 B length = 80 B/leaf on the wire vs the 136-byte
    # padded row); the device re-derives the keccak padding. Root-exact
    # on every path; OFF by default until config-20 A/B data accumulates
    resident_lean_rows: bool = False
    # deadline (seconds) for join_tail / acceptor-queue joins; on expiry
    # they raise TailStalled instead of blocking forever. 0 = unbounded
    tail_join_timeout: float = 0.0
    # --- commitment backend ---
    # "mpt": consensus Merkle-Patricia trie only (default).
    # "bintrie-shadow": also mount the binary-Merkle shadow beside it
    # (bintrie/shadow.py), never consensus; its canonical-rebuild check
    # runs every shadow_check_interval commits (0 disables)
    state_backend: str = "mpt"
    shadow_check_interval: int = 16
    # block-insert SLO budget (seconds): inserts slower than this are
    # auto-captured into the trace ring (debug_traceRequest); 0 disables
    insert_slo_budget: float = 0.0
    # staged insert pipeline depth (core/insert_pipeline.py): up to this
    # many blocks stay in flight — block k+1's sender recovery and
    # speculative execution overlap block k's commit/device-hash/tail
    # write, with only the commit/write/canonical stage under chainmu.
    # 0 = the serial insert path (every stage under chainmu); validated
    # range 0-3. Read at construction only
    insert_pipeline_depth: int = 0
    # --- storage fault armor (ROBUSTNESS.md "Storage faults") ---
    # re-hash hash-addressed payloads as they leave disk: header RLP and
    # contract code against their hash keys (rawdb), body/receipt
    # content against the header's tx/receipt roots (chain layer). A
    # mismatch counts db/verify_failures and raises typed
    # CorruptDataError instead of feeding bad bytes into consensus
    db_verify_on_read: bool = False
    # transient storage-error (ethdb.DBError) retries for the insert
    # tail's rawdb writes, paced by fault.Backoff, before the chain
    # demotes itself to the degraded read-only rung; 0 = the first
    # failure degrades. CorruptDataError is never retried
    db_retry_budget: int = 2


def _check_cache_config(cfg: CacheConfig) -> None:
    """Refuse the knob values the port does not run: an unknown state
    backend, and device retries (ROADMAP Queue 3)."""
    if cfg.state_backend not in ("mpt", "bintrie-shadow"):
        raise ValueError(
            f"unknown state-backend {cfg.state_backend!r} "
            "(expected 'mpt' or 'bintrie-shadow')")
    if cfg.device_max_retries != 0:
        raise ValueError(
            f"CacheConfig.device_max_retries={cfg.device_max_retries!r}: "
            "the port retries no device dispatch; a device fault reaches "
            "the caller (ROADMAP Queue 3)")


# counter/timer families snapshotted around each insert so the flight
# record carries per-block deltas (snapshot + plan-cache hits, keccak
# batching) rather than process-cumulative values
_FLIGHT_COUNTERS = (
    "state/snap/hits", "state/snap/misses", "state/snap/generating",
    "resident/plan_cache/hits", "resident/plan_cache/misses",
    "resident/h2d_bytes", "resident/gather_bytes",
    "resident/gather_bytes_modeled", "resident/absorb_d2h_bytes",
    "resident/lean_wire_bytes",
    "trie/keccak/batches", "trie/keccak/batch_msgs",
)
# the resident commit's phases, each updated where its work runs
# (trie/resident_mirror.py, native/mpt.py, ops/keccak_resident.py)
_FLIGHT_TIMERS = (
    "resident/phase/commit", "resident/phase/update", "resident/phase/plan",
    "resident/phase/export", "resident/phase/handoff",
    "resident/phase/stage", "resident/phase/scatter", "resident/phase/patch",
    "resident/phase/hash", "resident/phase/store", "resident/phase/readback",
    "resident/phase/record", "resident/phase/host_hash",
)


class _PhaseClock:
    """Times one insert phase into three sinks at once: the cumulative
    `<prefix><name>` registry timer (default `chain/phase/`), the
    in-flight block's flight record, and — when tracing is on — a
    `<span_prefix><name>` span. One extra dict store and two monotonic
    reads per phase over a bare registry timer. The insert pipeline uses
    a `chain/pipeline/` prefix so its stage timers are a parallel family,
    not an overwrite of the serial attribution."""

    __slots__ = ("_timer", "_phases", "_name", "_span_name", "_span", "_t0")

    def __init__(self, name: str, phases: Dict[str, float], registry,
                 prefix: str = "chain/phase/", span_prefix: str = "chain/"):
        self._timer = registry.timer(prefix + name)
        self._phases = phases
        self._name = name
        self._span_name = span_prefix + name

    def __enter__(self):
        self._span = _span(self._span_name)
        self._span.__enter__()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.monotonic() - self._t0
        self._timer.update(dt)
        self._phases[self._name] = self._phases.get(self._name, 0.0) + dt
        self._span.__exit__(exc_type, exc, tb)
        return False


class BlockValidator:
    """core/block_validator.go: body + post-state checks."""

    def __init__(self, config, chain, engine):
        self.config = config
        self.chain = chain
        self.engine = engine

    def validate_body(self, block: Block) -> None:
        header = block.header
        if self.chain.has_block_and_state(block.hash(), header.number):
            raise ChainError("known block")
        if derive_sha(block.transactions) != header.tx_hash:
            raise ChainError("transaction root hash mismatch")
        if block.uncles:
            raise ChainError("uncles not allowed")
        if not self.chain.has_block_and_state(header.parent_hash, header.number - 1):
            raise ChainError("unknown ancestor / pruned ancestor")

    def validate_state(self, block: Block, statedb: StateDB, receipts: List[Receipt],
                       used_gas: int) -> None:
        header = block.header
        if header.gas_used != used_gas:
            raise ChainError(f"invalid gas used (remote {header.gas_used} local {used_gas})")
        rbloom = create_bloom(receipts)
        if rbloom != header.bloom:
            raise ChainError("invalid bloom")
        receipt_sha = derive_sha(receipts)
        if receipt_sha != header.receipt_hash:
            raise ChainError(
                f"invalid receipt root (remote {header.receipt_hash.hex()} local {receipt_sha.hex()})"
            )
        root = statedb.intermediate_root(self.config.is_eip158(header.number))
        if root != header.root:
            raise ChainError(
                f"invalid merkle root (remote {header.root.hex()} local {root.hex()})"
            )


class ReadView:
    """Immutable snapshot of the chain's serving surface, published by a
    single reference swap so readers never take chainmu (ROADMAP 1: the
    read tier must not contend with the AlDBaran-style write pipeline).

    `accepted` is the coreth "latest" head, `preferred` the "pending"
    tip, `degraded` the storage-fault rung at publish time. `snap_ready`
    is the snapshot-attach event captured WITH the heads: a reader waits
    only for its own view's diff layer, never a later in-flight
    insert's. `seq` increases with every publication — a reader holding
    two views can order them without touching the chain."""

    __slots__ = ("accepted", "preferred", "degraded", "seq", "snap_ready")

    def __init__(self, accepted: Block, preferred: Block, degraded: bool,
                 seq: int, snap_ready: threading.Event):
        self.accepted = accepted
        self.preferred = preferred
        self.degraded = degraded
        self.seq = seq
        self.snap_ready = snap_ready


class BlockChain:
    def __init__(
        self,
        diskdb,
        cache_config: CacheConfig,
        config,
        genesis,
        engine,
        state_database: Optional[Database] = None,
        last_accepted_hash: bytes = b"\x00" * 32,
        device: DeviceLike = None,
    ):
        """`device` is the chain's device: None is CUDA, "cpu" only when
        asked. It resolves the device seam of the chain's own
        TrieDatabase (when no `state_database` is given), the "auto"
        probe and the mirror."""
        from ..trie.triedb import TrieDatabase

        _check_cache_config(cache_config)
        self.device = device
        self.diskdb = diskdb
        self.cache_config = cache_config
        # resident mode is a PRUNING policy (interval persistence): under
        # pruning=False the archive guarantee — every block's state on
        # disk — requires the default per-block commit path. "auto" is
        # probed here, before any worker starts or the genesis commits,
        # so a device that does not resolve refuses the chain at once
        resident = (cache_config.resident_account_trie
                    if cache_config.pruning else False)
        if resident == "auto":
            resident = self._probe_device()
        self.config = config
        self.engine = engine
        # storage fault armor: mount the process-wide rawdb verify mode
        # from this chain's knob, and start healthy on the degraded
        # ladder (persistent tail write failure demotes; a probe write
        # on a later insert attempt re-promotes)
        rawdb.set_verify_on_read(cache_config.db_verify_on_read)
        self.degraded = False
        self._degraded_mu = threading.Lock()
        # tail items whose rawdb writes failed persistently: replayed
        # in order when the chain re-promotes, so recovery loses nothing
        self._degraded_pending: List[tuple] = []
        if state_database is None:
            from ..ops.device import get_batch_keccak

            state_database = Database(TrieDatabase(
                diskdb,
                batch_keccak=get_batch_keccak(cache_config.device_hasher,
                                              device),
            ))
        self.state_database = state_database

        # dual-root shadow mount, before genesis setup, so the genesis
        # commit anchors the shadow at the empty tree. The event hook
        # finds the flight recorder at call time: it is constructed
        # further down, and quarantines only come from later commits.
        if cache_config.state_backend == "bintrie-shadow":
            from ..bintrie.shadow import ShadowCommitment

            state_database.shadow = ShadowCommitment(
                check_interval=cache_config.shadow_check_interval,
                note_event=self._note_shadow_event, device=device)

        self.chainmu = threading.RLock()

        # lock-free read tier: `_read_view` is replaced wholesale (one
        # reference swap) and never mutated in place; readers grab it
        # without any lock. Publication serializes on `_view_mu` — NOT
        # chainmu, because degraded flips publish from the tail worker —
        # and re-reads the head pointers inside the mutex, so the last
        # published view always reflects the newest heads (no regression
        # even with racing publishers).
        self._view_mu = threading.Lock()
        self._view_seq = 0
        self._read_view: Optional[ReadView] = None

        self._blocks: Dict[bytes, Block] = {}  # block cache by hash
        self._receipts: Dict[bytes, List[Receipt]] = {}
        self._canonical: Dict[int, bytes] = {}

        # overlapped insert tail: once validate_state has proven a block's
        # root, its rawdb body/receipt writes and snapshot diff-layer
        # update run on this bounded single-worker queue — block k's disk
        # tail overlaps block k+1's sender recovery and verification.
        # Disk readers join the whole queue before touching rawdb;
        # state_at waits only for the (cheap) snapshot update, so the
        # expensive RLP encodes never serialize the next execution.
        # (Created before genesis setup: boot-time reads already join.)
        self.tail_error: Optional[str] = None
        self._tail_queue: "queue.Queue[Optional[tuple]]" = queue.Queue(2)
        # the Event OBJECT is swapped per enqueued block; the swap races
        # readers unless serialized with the insert path
        self._tail_snap_applied = threading.Event()  # guarded-by: chainmu
        self._tail_snap_applied.set()
        self._tail_closed = False
        self._tail_thread = threading.Thread(
            target=self._tail_worker, name="insert-tail", daemon=True
        )
        self._tail_thread.start()

        self.processor = StateProcessor(
            config, self, engine,
            parallel_workers=cache_config.evm_parallel_workers,
            exec_shards_n=cache_config.evm_exec_shards)
        self.validator = BlockValidator(config, self, engine)
        if cache_config.pruning:
            self.trie_writer = CappedMemoryTrieWriter(
                state_database.triedb,
                commit_interval=cache_config.commit_interval,
                memory_cap=cache_config.trie_dirty_limit,
            )
        else:
            self.trie_writer = NoPruningTrieWriter(state_database.triedb)

        # subscription feeds
        self._chain_feed: List[Callable] = []
        self._chain_accepted_feed: List[Callable] = []

        # genesis
        self.genesis_block = self._setup_genesis(genesis)

        self.current_block: Block = self.genesis_block
        self.last_accepted: Block = self.genesis_block

        # recent insertion failures for debug_getBadBlocks (core
        # reportBlock keeps a similar bounded set)
        from collections import deque

        # bad_blocks holds (block, reason, flight_record) — the record is
        # the in-flight phase breakdown captured up to the failure point
        # (None when the failure precedes any instrumented phase)
        self.bad_blocks = deque(maxlen=10)
        # per-chain flight recorder (metrics/flight.py): last-N per-block
        # phase/counter records
        self.flight_recorder = FlightRecorder(cache_config.flight_recorder_size)
        # records of inserts currently in flight, keyed by block hash.
        # Read by _note_bad_block to attach phase context to bad-block
        # entries.
        self._insert_recs: Dict[bytes, dict] = {}  # guarded-by: _insert_recs_mu
        self._insert_recs_mu = threading.Lock()

        # device degradation ladder (ops/device.py): configure the
        # process-wide ladder from this chain's knobs and pipe its
        # demote/probation/promote events into the flight recorder
        from ..ops.device import default_ladder

        self._ladder = default_ladder()
        self._ladder.configure(
            call_timeout=cache_config.device_call_timeout,
            probe_interval=cache_config.device_probe_interval,
            promote_after=cache_config.device_promote_after,
        )
        self._ladder.add_listener(self._on_device_event)
        # set by take_over_host; a later ladder re-promotion reboots the
        # (then host-mode) mirror back onto the device
        self._mirror_degraded = False
        self._spot_check_countdown = cache_config.resident_spot_check_interval

        # crash consistency: the insert tail orders body-before-head, so
        # a kill can only lose whole tails — but a database written by a
        # pre-ordering version (or torn some other way) can have its head
        # pointer ahead of fully-persisted block data. Repair BEFORE the
        # head restore below trusts the pointer.
        self._repair_torn_tail()

        # restore pointers if the db has a head
        head = rawdb.read_head_block_hash(diskdb)
        if head is not None and head != self.genesis_block.hash():
            blk = self.get_block(head)
            if blk is not None:
                self.current_block = blk
                self.last_accepted = blk

        if last_accepted_hash != b"\x00" * 32:
            blk = self.get_block(last_accepted_hash)
            if blk is None:
                raise ChainError("last accepted block not found")
            self.current_block = blk
            self.last_accepted = blk

        # crash recovery: pruning mode persists roots only at commit
        # intervals, so an unclean shutdown can leave the tip state missing —
        # re-execute forward from the last committed root
        # (loadLastState → reprocessState, blockchain.go:679,1745)
        if not self.has_state(self.last_accepted.root):
            self.reprocess_state(self.last_accepted, cache_config.commit_interval)

        # resident account trie: boot the mirror from the last-accepted
        # state (one ordered leaf scan of the disk image — recovery above
        # guarantees it exists), then route account-trie lifecycle through
        # it. Genesis/recovery writes above intentionally used the default
        # writer; history before this point lives on disk.
        self.mirror = None
        if resident:
            self._boot_mirror()

        # flat snapshot tree over the last-accepted state (snapshot_limit
        # gates it, like CacheConfig.SnapshotLimit in the reference)
        self.snaps = None
        if cache_config.snapshot_limit > 0:
            from ..state.snapshot import Tree as SnapshotTree

            self.snaps = SnapshotTree(
                diskdb,
                state_database.triedb,
                self.last_accepted.root,
                block_hash=self.last_accepted.hash(),
            )

        # sectioned bloom-bit index for historical log search
        # (core/bloom_indexer.go; section commits ride the acceptor queue)
        from .bloom_index import BloomIndexer

        self.bloom_indexer = BloomIndexer(
            diskdb, section_size=cache_config.bloom_section_size
        )
        # backfill the in-flight section (genesis + anything accepted
        # before this boot never rode the acceptor queue)
        tip_n = self.last_accepted.number
        sec_start = tip_n - tip_n % cache_config.bloom_section_size
        for n in range(sec_start, tip_n + 1):
            # headers only: the backfill needs nothing but the 256-byte
            # bloom, not whole decoded blocks
            h = rawdb.read_canonical_hash(diskdb, n)
            blob = rawdb.read_header_rlp(diskdb, n, h) if h else None
            if blob is None:
                break
            self.bloom_indexer.add_block(n, Header.decode(blob).bloom)

        # async acceptor queue (blockchain.go:563-611): decouples consensus
        # Accept from expensive post-accept work, with backpressure
        self.acceptor_queue_limit = 64
        self.acceptor_error: Optional[str] = None
        self._acceptor_queue: "queue.Queue[Optional[Block]]" = queue.Queue(
            self.acceptor_queue_limit
        )
        self._acceptor_closed = False
        self._acceptor_wg = threading.Event()
        self._acceptor_wg.set()  # empty == set
        self._acceptor_tip_lock = threading.Lock()
        self._acceptor_tip: Optional[Block] = None
        self._acceptor_thread = threading.Thread(
            target=self._start_acceptor, name="acceptor", daemon=True
        )
        self._acceptor_thread.start()

        # staged insert pipeline (core/insert_pipeline.py): recover/verify/
        # speculate on the caller thread, commit under chainmu on a single
        # worker. Built last — it captures a fully constructed chain.
        self.pipeline = None
        if cache_config.insert_pipeline_depth > 0:
            from .insert_pipeline import InsertPipeline

            self.pipeline = InsertPipeline(
                self, depth=cache_config.insert_pipeline_depth)

        # first view: the fully restored boot heads
        self._publish_read_view()

    # ----------------------------------------------------------- read view

    def _publish_read_view(self) -> None:
        """Publish a fresh ReadView from the current head pointers.
        Callers: every head/degraded transition (_write_canonical,
        accept, _reorg, degraded enter/recover, state-sync reset). The
        pointer reads happen INSIDE _view_mu so two racing publishers
        cannot leave a stale head as the last-published view."""
        with self._view_mu:
            self._view_seq += 1
            view = ReadView(
                accepted=self.last_accepted,
                preferred=self.current_block,
                degraded=self.degraded,
                seq=self._view_seq,
                snap_ready=self._tail_snap_applied,
            )
            self._read_view = view

    def read_view(self) -> ReadView:
        """The current ReadView — a single attribute load, no lock."""
        return self._read_view

    def state_at_view(self, view: ReadView, root: bytes) -> StateDB:
        """StateDB resolution pinned to [view]: waits only the view's
        own snapshot-attach event (captured at publish time), so a read
        never blocks behind a LATER in-flight insert the way the
        chain-global state_at() join does. Deliberately does NOT consume
        tail_error — reads keep serving through a sick tail (the
        degraded-rung contract); write paths surface the error."""
        timeout = self.cache_config.tail_join_timeout
        if not view.snap_ready.wait(timeout if timeout > 0 else None):
            raise TailStalled(
                "read-view snapshot attach", timeout,
                self._tail_queue.unfinished_tasks,
                worker_error=self.tail_error)
        return StateDB(root, self.state_database, self.snaps)

    # ------------------------------------------------------------- genesis

    def _setup_genesis(self, genesis) -> Block:
        stored = rawdb.read_canonical_hash(self.diskdb, 0)
        if stored is None:
            block = genesis.commit(self.diskdb, self.state_database)
        else:
            # fail fast on config/database mismatch rather than silently
            # re-initializing over existing chain data (genesis.go
            # SetupGenesisBlock mismatch error)
            expected = genesis.to_block(self.state_database)
            if expected.hash() != stored:
                raise ChainError(
                    f"genesis mismatch: database has {stored.hex()}, "
                    f"config produces {expected.hash().hex()}"
                )
            block = self.get_block(stored)
            if block is None:
                raise ChainError("genesis block data missing from database")
        self._canonical[0] = block.hash()
        self._blocks[block.hash()] = block
        return block

    # --------------------------------------------------------------- reads

    def get_block(self, block_hash: bytes) -> Optional[Block]:
        blk = self._blocks.get(block_hash)
        if blk is not None:
            return blk
        self.join_tail()  # the block may still be in the insert tail
        number = rawdb.read_header_number(self.diskdb, block_hash)
        if number is None:
            return None
        return self.get_block_by_number_and_hash(number, block_hash)

    def get_block_by_number_and_hash(self, number: int, block_hash: bytes) -> Optional[Block]:
        hdr_rlp = rawdb.read_header_rlp(self.diskdb, number, block_hash)
        body_rlp = rawdb.read_body_rlp(self.diskdb, number, block_hash)
        if hdr_rlp is None or body_rlp is None:
            return None
        header = Header.decode(hdr_rlp)
        items = rlp.decode(body_rlp)
        from .types import Transaction

        txs = []
        for ti in items[0]:
            txs.append(
                Transaction.decode(rlp.encode(ti) if isinstance(ti, list) else ti)
            )
        uncles = [Header.from_items(u) for u in items[1]]
        version = int.from_bytes(items[2], "big") if isinstance(items[2], bytes) else items[2]
        ext = items[3] if len(items) > 3 and items[3] != b"" else None
        blk = Block(header, txs, uncles, version, ext)
        if self.cache_config.db_verify_on_read:
            # the body keys on the BLOCK hash, so its content check is
            # against the header's tx root (rawdb already re-hashed the
            # header RLP against the block hash on the way out)
            if derive_sha(txs) != header.tx_hash:
                from ..ethdb import CorruptDataError
                from ..metrics import default_registry as _metrics

                _metrics.counter("db/verify_failures").inc()
                raise CorruptDataError(
                    f"body payload failed verify-on-read: tx root "
                    f"mismatch for block {block_hash.hex()}")
        self._blocks[block_hash] = blk
        return blk

    def get_block_by_number(self, number: int) -> Optional[Block]:
        h = self.get_canonical_hash(number)
        if h is None:
            return None
        return self.get_block(h)

    def get_canonical_hash(self, number: int) -> Optional[bytes]:
        h = self._canonical.get(number)
        if h is not None:
            return h
        return rawdb.read_canonical_hash(self.diskdb, number)

    def get_header(self, block_hash: bytes) -> Optional[Header]:
        blk = self.get_block(block_hash)
        return blk.header if blk is not None else None

    def get_header_by_number(self, number: int) -> Optional[Header]:
        """Header-only canonical lookup: decodes just the header RLP, no
        body/transactions (GetHeaderByNumber, eth/api.go:469 use) —
        range scans like debug_getAccessibleState must not pay a full
        block decode per candidate."""
        h = self.get_canonical_hash(number)
        if h is None:
            return None
        blk = self._blocks.get(h)
        if blk is not None:
            return blk.header
        self.join_tail()  # the header may still be in the insert tail
        blob = rawdb.read_header_rlp(self.diskdb, number, h)
        return Header.decode(blob) if blob is not None else None

    def get_receipts(self, block_hash: bytes) -> Optional[List[Receipt]]:
        cached = self._receipts.get(block_hash)
        if cached is not None:
            return cached
        self.join_tail()  # receipts may still be in the insert tail
        number = rawdb.read_header_number(self.diskdb, block_hash)
        if number is None:
            return None
        blob = rawdb.read_receipts_rlp(self.diskdb, number, block_hash)
        if blob is None:
            return None
        items = rlp.decode(blob)
        receipts = [Receipt.decode(r) for r in items]
        if self.cache_config.db_verify_on_read:
            cached = self._blocks.get(block_hash)
            if cached is not None:
                hdr = cached.header
            else:  # by hash, not number: the block may be non-canonical
                hdr_blob = rawdb.read_header_rlp(
                    self.diskdb, number, block_hash)
                hdr = Header.decode(hdr_blob) if hdr_blob else None
            if hdr is not None and derive_sha(receipts) != hdr.receipt_hash:
                from ..ethdb import CorruptDataError
                from ..metrics import default_registry as _metrics

                _metrics.counter("db/verify_failures").inc()
                raise CorruptDataError(
                    f"receipts payload failed verify-on-read: receipt "
                    f"root mismatch for block {block_hash.hex()}")
        # stored receipts hold only consensus fields; rederive the rest
        # (types.deriveReceiptFields — tx hash, gas used, contract addr…)
        block = self.get_block(block_hash)
        if block is not None:
            from .types import Signer, derive_receipt_fields

            derive_receipt_fields(
                receipts, block.transactions, block_hash, number,
                block.base_fee, Signer(self.config.chain_id),
            )
        # lock-free cache fill: a single-key store of an immutable list
        # is atomic under the GIL, and the read tier must not contend on
        # chainmu for a cache insert. Structural writers (_write_block,
        # reject) still serialize on chainmu; the worst race here is two
        # readers deriving the same receipts and one store winning.
        self._receipts[block_hash] = receipts
        return receipts

    def has_block(self, block_hash: bytes) -> bool:
        return self.get_block(block_hash) is not None

    def _probe_device(self) -> bool:
        """The "auto" probe (the reference's _tpu_backend probe, on CUDA):
        resolve the chain's device under a 10 s watchdog — discovery
        through a wedged device can hang, and a hung boot is worse than a
        refusal. True when it is CUDA; a probe that fails or times out
        raises ChainError (there is no drop to the disk path)."""
        from ..native.mpt import _run_with_watchdog

        try:
            dev = _run_with_watchdog(lambda: resolve(self.device), 10.0,
                                     "resident auto probe")
        except (RuntimeError, ValueError) as e:
            raise ChainError(
                f"resident-account-trie 'auto': the device probe failed "
                f"({e}); pass device='cpu' or resident_account_trie=False "
                "to run without the device") from e
        return dev.type == "cuda"

    def _boot_mirror(self) -> None:
        """(Re)build the resident account mirror over the last-accepted
        state on the chain's device: one ordered leaf scan of its
        (on-disk) account trie, then route the trie lifecycle through
        it."""
        from ..trie.iterator import iterate_leaves
        from ..trie.resident_mirror import ResidentAccountMirror

        tr = self.state_database.triedb.open_state_trie(
            self.last_accepted.root).trie
        prefer = self.cache_config.resident_prefer_host
        self.mirror = ResidentAccountMirror(
            list(iterate_leaves(tr)),
            base_key=self.last_accepted.hash(),
            device_timeout=self.cache_config.resident_commit_timeout,
            cpu_threads=self.cache_config.cpu_threads,
            prefer_host=None if prefer == "auto" else bool(prefer),
            pipeline_depth=self.cache_config.resident_pipeline_depth,
            template_residency=(
                self.cache_config.resident_template_residency),
            mesh_devices=self.cache_config.resident_mesh_devices,
            lean_rows=self.cache_config.resident_lean_rows,
            device=self.device,
        )
        self.state_database.mirror = self.mirror
        self.trie_writer = ResidentTrieWriter(
            self.state_database.triedb,
            self.mirror,
            commit_interval=self.cache_config.commit_interval,
            memory_cap=self.cache_config.trie_dirty_limit,
        )

    def reboot_mirror(self) -> None:
        """Rebuild the mirror after the chain's state was replaced out of
        band (state sync landing on a far-future root — the analog of
        blockchain.go:2051 ResetToStateSyncedBlock re-opening state): the
        old mirror's base is the pre-sync state and can never reach the
        synced root by replay. No-op when resident mode is off."""
        if self.mirror is None:
            return
        self._boot_mirror()

    def take_over_host(self, why: str = "asked by the caller") -> str:
        """Move the resident mirror one rung down after its device stopped
        answering (ResidentAccountMirror.take_over_host, under chainmu so
        no insert runs beside it) and return the rung it landed on. A
        mesh-sharded mirror lands on a single device (flight event
        mirror/mesh_demotion; the ladder stays as it is). Otherwise it
        lands on the host: note the takeover in the flight recorder and
        demote the degradation ladder, whose probes decide when the
        device earned its way back (then _on_device_event reboots the
        mirror on it; coreth_tpu/core/blockchain.py:888-896). The port's
        only way off the device: nothing calls it by itself."""
        with self.chainmu:
            if self.mirror is None:
                raise ChainError("no resident mirror to take over")
            landed = self.mirror.take_over_host(why)
            if landed == "device":
                self.flight_recorder.note_event("mirror/mesh_demotion",
                                                why=why)
                return landed
            self._mirror_degraded = True
            self.flight_recorder.note_event("mirror/takeover", why=why)
        self._ladder.demote(f"resident mirror takeover: {why}")
        return landed

    def _note_shadow_event(self, kind: str, **fields) -> None:
        """ShadowCommitment event hook (coreth_tpu/core/blockchain.py:856):
        installed before the flight recorder exists, so it resolves the
        recorder at call time."""
        rec = getattr(self, "flight_recorder", None)
        if rec is not None:
            rec.note_event(kind, **fields)

    def _on_device_event(self, kind: str, fields: dict) -> None:
        """DeviceLadder listener: every ladder transition lands in the
        flight recorder's event ring, and a re-promotion after a mirror
        takeover reboots the mirror onto the device. Runs on whichever
        thread tripped the ladder, never under the ladder's own lock
        (ops/device._notify), so taking chainmu here cannot invert against
        a dispatch under it. A reboot that fails is counted
        (chain/mirror/reboot_error), logged at error level and noted in
        the flight recorder; the mirror then stays on the host. The flag
        is tested and cleared under chainmu, where take_over_host sets
        it, so two promote events reboot the mirror once."""
        self.flight_recorder.note_event("device/" + kind, **fields)
        if kind == "promote" and self._mirror_degraded:
            # the takeover pinned the mirror's trie to host mode one-way;
            # residency only returns through a rebuild
            with self.chainmu:
                if not self._mirror_degraded:
                    return  # another promote event rebooted it
                self._mirror_degraded = False
                try:
                    self.reboot_mirror()
                    self.flight_recorder.note_event("mirror/reboot")
                except Exception as e:
                    from ..log import error, get_logger
                    from ..metrics import count_drop

                    count_drop("chain/mirror/reboot_error")
                    self.flight_recorder.note_event(
                        "mirror/reboot_error", error=repr(e))
                    error(get_logger("chain"), "resident mirror reboot "
                          "after re-promotion failed; it stays on the host",
                          error=repr(e))

    def _spot_check_mirror(self) -> None:
        """Periodic device-vs-host cross-check of the resident mirror
        (every resident_spot_check_interval committed inserts): a
        diverged mirror is QUARANTINED — rebuilt from the last-accepted
        disk state — instead of feeding consensus wrong roots. Caller
        holds chainmu."""
        from ..log import error, get_logger
        from ..metrics import default_registry as _metrics

        mirror = self.mirror
        if mirror is None:
            return
        if mirror.spot_check():
            return
        _metrics.counter("chain/mirror/quarantines").inc()
        self.flight_recorder.note_event(
            "mirror/quarantine", at=self.last_accepted.number)
        error(get_logger("chain"),
              "resident mirror diverged from the host keccak oracle — "
              "quarantining: mirror rebuilt from last-accepted state",
              last_accepted=self.last_accepted.number)
        # the accepted disk image is the trust anchor; anything the
        # diverged mirror held above it is re-verified on insert
        self.join_tail()
        self.reboot_mirror()

    # ---------------------------------------------- crash-consistent tail

    def _block_data_complete(self, number: int, block_hash: bytes) -> bool:
        """True iff every row the insert tail writes for a block is
        present (header number mapping, header, body, receipts)."""
        return (
            rawdb.read_header_number(self.diskdb, block_hash) is not None
            and rawdb.read_header_rlp(
                self.diskdb, number, block_hash) is not None
            and rawdb.read_body_rlp(
                self.diskdb, number, block_hash) is not None
            and rawdb.read_receipts_rlp(
                self.diskdb, number, block_hash) is not None
        )

    def _repair_torn_tail(self) -> None:
        """Boot-time torn-tail scan: if the head pointer references a
        block whose data never fully persisted (a crash between the
        tail's writes, or a database from before the body-before-head
        ordering), rewind the head to the last canonical block whose
        data is complete and drop the canonical rows above it. The
        blocks lost were never fully durable; consensus re-delivers
        them."""
        from ..log import get_logger, warn
        from ..metrics import default_registry as _metrics

        gen_h = self.genesis_block.hash()
        head = rawdb.read_head_block_hash(self.diskdb)
        if head is None or head == gen_h:
            return
        head_n = rawdb.read_header_number(self.diskdb, head)
        if head_n is not None and self._block_data_complete(head_n, head):
            return
        # torn: find the canonical tip number (the header-number row for
        # the head hash may itself be missing), then walk down to the
        # last complete block
        if head_n is None:
            head_n = 0
            while rawdb.read_canonical_hash(
                    self.diskdb, head_n + 1) is not None:
                head_n += 1
        new_n, new_h = 0, gen_h
        k = head_n
        while k > 0:
            h = rawdb.read_canonical_hash(self.diskdb, k)
            if h is not None and self._block_data_complete(k, h):
                new_n, new_h = k, h
                break
            k -= 1
        for num in range(new_n + 1, head_n + 1):
            rawdb.delete_canonical_hash(self.diskdb, num)
        rawdb.write_head_block_hash(self.diskdb, new_h)
        _metrics.counter("chain/tail/torn_repairs").inc()
        self.flight_recorder.note_event(
            "tail/torn_repair", torn_head=head.hex(), torn_number=head_n,
            repaired_number=new_n)
        warn(get_logger("chain"),
             "torn insert tail repaired at boot: head pointer was ahead "
             "of persisted block data; rewound to last consistent block",
             torn_head=head.hex(), torn_number=head_n, repaired_number=new_n)

    def has_state(self, root: bytes) -> bool:
        from ..trie.node import EMPTY_ROOT

        if root == EMPTY_ROOT:
            return True
        mirror = getattr(self.state_database, "mirror", None)
        if mirror is not None and mirror.has_root(root):
            return True
        return root in self.state_database.triedb or (
            self.diskdb.get(root) is not None
        )

    def has_block_and_state(self, block_hash: bytes, number: int) -> bool:
        blk = self.get_block(block_hash)
        if blk is None:
            return False
        return self.has_state(blk.root)

    def state_at(self, root: bytes) -> StateDB:
        # pending diff-layer attaches must land first, or the lookup for
        # [root] misses and every read in this StateDB walks the trie
        self._wait_tail_snap()
        return StateDB(root, self.state_database, self.snaps)

    def state(self) -> StateDB:
        return self.state_at(self.current_block.root)

    # -------------------------------------------------------------- insert

    def insert_block(self, block: Block) -> None:
        """InsertBlockManual(writes=True) (blockchain.go:1234-1389): the
        serial insert, every stage under chainmu.

        With insert_pipeline_depth > 0 the block is handed to the staged
        pipeline instead: this call runs recovery/verification/
        speculative execution (no chainmu) and returns once the block is
        queued for its commit stage. A commit failure surfaces at the
        next submit or drain point (accept/reject/set_preference/
        insert_block_manual/stop) — same deferred-error contract as the
        async insert tail."""
        if self.degraded:
            self._probe_degraded()  # raises ChainDegradedError while sick
        if self.pipeline is not None:
            self.pipeline.submit(block)
            return
        with self.chainmu:
            self._insert_checked(block, writes=True)

    def insert_block_manual(self, block: Block, writes: bool) -> None:
        if self.degraded:
            self._probe_degraded()  # raises ChainDegradedError while sick
        # a writes=False semantic check runs against the latest committed
        # state; in-flight pipelined successors would race it — land them
        # (and surface any deferred commit error) first
        if self.pipeline is not None:
            self.pipeline.drain()
        with self.chainmu:
            self._insert_checked(block, writes)

    def _insert_checked(self, block: Block, writes: bool) -> None:
        """Serial insert with bad-block bookkeeping: failures land in the
        bad-block ring (eth/api.go GetBadBlocks / core reportBlock) so
        operators can debug bad-root/gas-mismatch blocks from
        debug_getBadBlocks. A device fault (DEVICE_FAULTS: a device that
        stopped answering, a CUDA error, a kernel that did not build) is
        not the block's fault: it leaves with the head where it was and no
        bad-block entry."""
        if self.get_header(block.header.parent_hash) is None:
            # unknown ancestor is an ORDERING condition, not a bad block
            # (geth's reportBlock is only reached by validation errors;
            # ErrUnknownAncestor takes the unknown-block path)
            raise ChainError("unknown ancestor")
        try:
            self._insert_block(block, writes)
        except DEVICE_FAULTS:
            raise
        except Exception as e:
            self._note_bad_block(block, e)
            raise
        finally:
            with self._insert_recs_mu:
                self._insert_recs.pop(block.hash(), None)

    def _note_bad_block(self, block: Block, e: BaseException) -> None:
        """Append a failed insert to the bounded bad-block ring with its
        in-flight flight record attached — phase timings up to the point
        of failure are exactly what an operator debugging a bad-root/
        gas-mismatch block needs. Shared by the serial path and the
        pipeline's submit and commit stages."""
        # dedup by hash: consensus retries re-submit the same bad
        # block, and each retry would otherwise evict a DISTINCT
        # earlier failure from the bounded ring (the newest reason
        # wins — it reflects the current chain state)
        h = block.hash()
        for i, (b, _, _) in enumerate(self.bad_blocks):
            if b.hash() == h:
                del self.bad_blocks[i]
                break
        with self._insert_recs_mu:
            rec = self._insert_recs.get(h)
        self.bad_blocks.append((block, f"{type(e).__name__}: {e}", rec))

    def _insert_block(self, block: Block, writes: bool) -> None:
        from ..metrics import default_registry as _metrics
        from ..metrics import observe_slo as _observe_slo
        from ..metrics import tracectx as _tracectx

        insert_timer = _metrics.timer("chain/block/inserts")
        header = block.header
        parent = self.get_header(header.parent_hash)
        if parent is None:
            raise ChainError("unknown ancestor")

        # one trace per insert, minted at entry like the RPC admission
        # point: phase spans collect under it and the flight record keys
        # back to it, so a slow block is attributable end-to-end
        ctx = _tracectx.begin("insert")

        # flight record for this insert: phases fill as the block moves
        # through the pipeline; counter deltas are computed at the end.
        # `parallel` starts present (empty) so host-fallback and
        # failed-before-execute records are never ragged
        rec: dict = {
            "number": block.number,
            "hash": block.hash(),
            "txs": len(block.transactions),
            "gas_used": 0,
            "phases": {},
            "parallel": {},
            "writes": writes,
            "trace_id": ctx.trace_id if ctx is not None else None,
        }
        with self._insert_recs_mu:
            self._insert_recs[block.hash()] = rec
        counters0 = {n: _metrics.counter(n).count() for n in _FLIGHT_COUNTERS}
        timers0 = {n: _metrics.timer(n).total() for n in _FLIGHT_TIMERS}
        phases = rec["phases"]

        t0 = time.monotonic()
        tscope = _tracectx.scope(ctx)
        tscope.__enter__()
        insert_span = _span("chain/insert", number=block.number,
                            txs=len(block.transactions))
        insert_span.__enter__()
        try:
            self._insert_phases(block, header, parent, writes, rec, phases,
                                insert_timer, _metrics)
        except BaseException as e:
            insert_span.__exit__(type(e), e, e.__traceback__)
            if ctx is not None:
                ctx.meta["error"] = type(e).__name__
            raise
        else:
            insert_span.__exit__(None, None, None)
        finally:
            mirror = self.mirror
            rec["host_mode"] = (bool(mirror.host_mode)
                                if mirror is not None else None)
            rec["counters"] = {
                n: _metrics.counter(n).count() - counters0[n]
                for n in _FLIGHT_COUNTERS
            }
            rec["resident"] = {
                n.rsplit("/", 1)[1]: d
                for n in _FLIGHT_TIMERS
                if (d := _metrics.timer(n).total() - timers0[n]) > 0.0
            }
            if mirror is not None:
                # un-ragged across configs: unsharded commits emit an
                # explicit shards=1, and gather_bytes=0 rides the
                # counters dict
                rec["resident"]["shards"] = mirror.shards
                _metrics.gauge("resident/shards").update(mirror.shards)
            if mirror is not None and mirror.last_overlap_fraction > 0.0:
                # overlap of the most recently DRAINED pipelined commit
                # (drains lag dispatch by up to the window depth, so
                # this reads one-to-two blocks behind the record it
                # lands in — good enough for the A/B artifact)
                rec["resident"]["overlap_fraction"] = round(
                    mirror.last_overlap_fraction, 4)
            elapsed = time.monotonic() - t0
            _observe_slo("slo/chain/insert", elapsed,
                         ctx.trace_id if ctx is not None else None)
            if ctx is not None:
                ctx.meta["number"] = block.number
                ctx.meta["txs"] = len(block.transactions)
                budget = self.cache_config.insert_slo_budget
                if "error" in ctx.meta:
                    ctx.meta["outcome"] = "insert_failed"
                    _tracectx.capture(ctx, "insert_failed")
                elif 0 < budget < elapsed:
                    ctx.meta["outcome"] = "slow"
                    ctx.meta["over_slo_budget_s"] = budget
                    _tracectx.capture(ctx, "slow")
            tscope.__exit__(None, None, None)

    def _insert_phases(self, block: Block, header: Header, parent: Header,
                       writes: bool, rec: dict, phases: Dict[str, float],
                       insert_timer, _metrics) -> None:
        """Phase body of _insert_block (split so the flight-record
        bookkeeping wraps it exactly once). This is the SERIAL path:
        every stage runs here, under chainmu. The pipeline runs the
        recover/verify/execute half on the submitting thread and shares
        only _commit_validated — the one stage that needs the lock."""
        # overlap sender ecrecover with verification (blockchain.go:1247)
        from .sender_cacher import sender_cacher
        from .types import Signer

        failpoint("insert/before_recover")
        with _PhaseClock("recover", phases, _metrics):
            token = sender_cacher.recover(
                Signer(self.config.chain_id), block.transactions)

        with _PhaseClock("verify", phases, _metrics):
            self.engine.verify_header(self.config, header, parent)
            self.validator.validate_body(block)

        # join THIS block's recovery batch before execution: losing the
        # race means re-deriving senders one-by-one mid-execute, which
        # duplicates the whole batch's work on small machines
        with _PhaseClock("recover", phases, _metrics):
            sender_cacher.wait(token)

        failpoint("insert/before_execute")
        statedb, receipts, used_gas = self._execute_and_validate(
            block, header, parent, rec, phases, _metrics, insert_timer)

        if not writes:
            return
        self._commit_validated(block, statedb, receipts, used_gas,
                               rec, phases, _metrics)

    def _execute_and_validate(self, block: Block, header: Header,
                              parent: Header, rec: dict,
                              phases: Dict[str, float], _metrics,
                              insert_timer):
        """Open the parent state, execute the block, and validate the
        post-state against the header. No chain mutation — safe to run
        outside chainmu as long as the parent's state stays reachable
        (the serial path holds chainmu anyway; the pipeline's commit
        worker calls this as the serial fallback, ordered after the
        parent's commit)."""
        statedb = self.state_at(parent.root)
        if getattr(statedb.trie, "resident", False):
            # hand the header root to the mirror: with pipelining on,
            # validate/commit dispatch against it and the device-root
            # compare defers to the mirror's next drain point (a
            # divergence there rewinds and raises MirrorError to this
            # insert)
            statedb.trie.expected_root = header.root
        # warm touched trie paths while txs execute (blockchain.go:1312)
        statedb.start_prefetcher("chain")

        try:
            with insert_timer.time():
                with _PhaseClock("execute", phases, _metrics):
                    receipts, _, used_gas = self.processor.process(
                        block, parent, statedb)
                rec["parallel"] = dict(self.processor.last_parallel)
                with _PhaseClock("validate", phases, _metrics):
                    self.validator.validate_state(
                        block, statedb, receipts, used_gas)
        finally:
            statedb.stop_prefetcher()

        rec["gas_used"] = used_gas
        return statedb, receipts, used_gas

    def _commit_validated(self, block: Block, statedb: StateDB,
                          receipts: List[Receipt],
                          used_gas: int, rec: dict,
                          phases: Dict[str, float],
                          _metrics) -> None:  # guarded-by: chainmu
        """Commit/device-hash/write/canonical stage for a block whose
        post-state already validated. With pipelining on this is the
        ONLY insert stage that holds chainmu — everything above it runs
        on the submitting thread."""
        header = block.header
        failpoint("insert/before_commit")

        # count only committed inserts: locally built blocks run a
        # writes=False pre-verification first and must not double-count
        _metrics.meter("chain/txs/processed").mark(len(block.transactions))
        _metrics.meter("chain/gas/used").mark(used_gas)

        # commit state: trie refs live until Accept/Reject balance them;
        # block hashes key the snapshot diff layer (coreth CommitWithSnap).
        # The diff-layer attach itself is deferred to the insert-tail
        # worker along with the rawdb writes (see _tail_worker)
        with _PhaseClock("commit", phases, _metrics):
            root = statedb.commit(
                self.config.is_eip158(header.number),
                block_hash=block.hash(),
                parent_block_hash=header.parent_hash,
                defer_snap=True,
            )
            if root != header.root:
                raise ChainError("commit root mismatch")
            self.trie_writer.insert_trie(block)

        # periodic resident-mirror spot check (device root vs host
        # keccak oracle, ROBUSTNESS.md): a diverged mirror quarantines —
        # rebuilt from last-accepted state; the unaccepted suffix gets
        # re-verified by consensus re-inserts
        if (self.mirror is not None
                and self.cache_config.resident_spot_check_interval > 0):
            self._spot_check_countdown -= 1
            if self._spot_check_countdown <= 0:
                self._spot_check_countdown = (
                    self.cache_config.resident_spot_check_interval)
                self._spot_check_mirror()

        # committed inserts enter the ring; the async tail stamps `write`
        self.flight_recorder.record(rec)
        failpoint("insert/before_write")
        self._write_block(block, receipts, statedb._deferred_snap_update,
                          rec=rec)

        # new tip if it extends the current preference; the chain feed only
        # fires for head changes — non-canonical siblings must not reset
        # the tx pool onto a losing fork
        if block.parent_hash == self.current_block.hash():
            self._write_canonical(block)
            if self._chain_feed:
                logs = [lg for r in receipts for lg in r.logs]
                for fn in self._chain_feed:
                    fn(block, logs)

    def _write_block(self, block: Block, receipts: List[Receipt],
                     snap_update: Optional[tuple] = None,
                     rec: Optional[dict] = None) -> None:  # guarded-by: chainmu
        """Register the block in memory, then hand the disk tail (rawdb
        writes + snapshot diff-layer attach) to the insert-tail worker.
        Caller holds chainmu (insert_block / reprocess paths). [rec] is
        the block's flight record; the worker stamps its `write` phase."""
        h = block.hash()
        self._blocks[h] = block
        self._receipts[h] = receipts
        # replace the join target BEFORE enqueueing: a reader racing the
        # swap at worst waits on the already-set previous event and takes
        # the trie fallback for one read
        ev = threading.Event()
        self._tail_snap_applied = ev
        self._tail_queue.put(("block", block, receipts, snap_update, ev, rec))

    def _write_block_data(self, block: Block, receipts: List[Receipt]) -> None:
        """rawdb persistence for one inserted block (tail-worker body)."""
        h = block.hash()
        n = block.number
        failpoint("chain/tail/before_body")
        rawdb.write_header_number(self.diskdb, h, n)
        rawdb.write_header_rlp(self.diskdb, n, h, block.header.encode())
        failpoint("chain/tail/partial_body")
        body_items = [
            [rlp.decode(t.encode()) if t.type == 0 else t.encode() for t in block.transactions],
            [u.rlp_items() for u in block.uncles],
            block.version,
            block.ext_data if block.ext_data is not None else b"",
        ]
        rawdb.write_body_rlp(self.diskdb, n, h, rlp.encode(body_items))
        rawdb.write_receipts_rlp(
            self.diskdb, n, h, rlp.encode([r.encode() for r in receipts])
        )

    def _tail_write_retry(self, write_fn) -> None:
        """Run one tail write with up to db_retry_budget Backoff-paced
        retries for transient storage errors (typed ethdb.DBError from
        any backend). CorruptDataError and non-storage exceptions
        (failpoint-simulated crashes, bugs) propagate on first throw —
        only I/O flakes are transient. Writes are idempotent puts, so a
        replay from the top is safe."""
        from ..ethdb import CorruptDataError, DBError
        from ..fault import Backoff
        from ..metrics import default_registry as _metrics

        budget = max(0, self.cache_config.db_retry_budget)
        backoff = Backoff(base=0.01, cap=0.5)
        attempt = 0
        while True:
            try:
                write_fn()
                if attempt:
                    _metrics.counter("db/retry_successes").inc()
                return
            except CorruptDataError:
                raise
            except DBError:
                if attempt >= budget:
                    raise
                attempt += 1
                _metrics.counter("db/retries").inc()
                backoff.sleep()

    def _enter_degraded(self, why: str, pending_item: tuple) -> None:
        """Demote the chain to the degraded read-only rung: persistent
        storage write failure stops inserts (typed ChainDegradedError at
        the front door) instead of crashing the node, while reads, RPC,
        and metrics keep serving. The failed tail item is stashed for
        an in-order replay at re-promotion, so recovery loses nothing.
        Same ladder shape as the device demote/probe/promote cycle."""
        from ..log import get_logger, warn
        from ..metrics import default_registry as _metrics

        with self._degraded_mu:
            self._degraded_pending.append(pending_item)
            first = not self.degraded
            self.degraded = True
        if not first:
            return
        self._publish_read_view()  # readers see the rung without chainmu
        _metrics.gauge("chain/degraded").update(1)
        _metrics.counter("chain/degraded_entries").inc()
        self.flight_recorder.note_event("chain/degraded", why=why)
        warn(get_logger("chain"),
             "persistent storage write failure — chain demoted to "
             "degraded read-only mode: inserts refused with "
             "ChainDegradedError, reads/RPC keep serving; the next "
             "insert attempt probes the disk for re-promotion",
             why=why)

    def _probe_degraded(self) -> None:
        """One probe write against the disk from an insert attempt while
        degraded. Failure keeps the rung (typed refusal); success
        re-promotes: pending tail items replay in order, then inserts
        flow again."""
        from ..ethdb import DBError
        from ..metrics import default_registry as _metrics

        try:
            self.diskdb.put(b"DegradedProbe", self.current_block.hash())
        except DBError as e:
            _metrics.counter("chain/degraded_probe_failures").inc()
            raise ChainDegradedError(
                f"chain is degraded read-only (storage writes failing); "
                f"probe write failed: {e}") from e
        # the disk accepts writes again: settle the tail, replay what
        # the degraded window stashed, and re-promote
        self._join_queue(self._tail_queue, "insert tail",
                         self.cache_config.tail_join_timeout)
        with self._degraded_mu:
            pending, self._degraded_pending = self._degraded_pending, []
        try:
            for item in pending:
                if item[0] == "head":
                    rawdb.write_canonical_hash(
                        self.diskdb, item[1].hash(), item[1].number)
                    rawdb.write_head_block_hash(self.diskdb, item[1].hash())
                else:
                    self._write_block_data(item[1], item[2])
        except DBError as e:
            # the disk flaked again mid-replay: stay degraded with the
            # unreplayed suffix intact
            idx = pending.index(item)
            with self._degraded_mu:
                self._degraded_pending = (pending[idx:]
                                          + self._degraded_pending)
            _metrics.counter("chain/degraded_probe_failures").inc()
            raise ChainDegradedError(
                f"chain is degraded read-only; replay failed: {e}") from e
        with self._degraded_mu:
            self.degraded = False
        self._publish_read_view()
        self.tail_error = None  # surfaced through the rung, not join_tail
        _metrics.gauge("chain/degraded").update(0)
        _metrics.counter("chain/degraded_recoveries").inc()
        self.flight_recorder.note_event(
            "chain/degraded_recovered", replayed=len(pending))

    def _tail_worker(self) -> None:
        from ..ethdb import DBError
        from ..metrics import default_registry as _metrics

        write_timer = _metrics.timer("chain/phase/write")
        while True:
            item = self._tail_queue.get()
            if item is None:
                self._tail_queue.task_done()
                return
            if item[0] == "head":
                # canonical-hash + head-pointer writes ride the same FIFO
                # BEHIND the block's body item (_write_canonical enqueues
                # after _write_block), so the pointer can never reach disk
                # before the data it points at — crash consistency by
                # ordering, not fsync
                _, block = item

                def _write_head(block=block):
                    failpoint("chain/tail/before_head")
                    rawdb.write_canonical_hash(
                        self.diskdb, block.hash(), block.number)
                    rawdb.write_head_block_hash(self.diskdb, block.hash())

                try:
                    self._tail_write_retry(_write_head)
                except DBError as e:
                    self._enter_degraded(
                        f"head write failed after retries: {e}", item)
                except Exception:
                    import traceback

                    self.tail_error = traceback.format_exc()
                finally:
                    self._tail_queue.task_done()
                continue
            _, block, receipts, snap_update, snap_applied, rec = item
            try:
                t0 = time.monotonic()
                with _span("chain/write", number=block.number):
                    with write_timer.time():
                        if snap_update is not None:
                            self.snaps.update(*snap_update)
                        # layer attached: the next block's state_at can open
                        # against it while we grind through the RLP encodes
                        snap_applied.set()
                        self._tail_write_retry(
                            lambda: self._write_block_data(block, receipts))
                if rec is not None:
                    # late stamp into the shared record dict: readers of
                    # the flight ring see `write` once the tail lands
                    rec["phases"]["write"] = time.monotonic() - t0
            except DBError as e:
                self._enter_degraded(
                    f"block data write failed after retries: {e}", item)
            except Exception:
                import traceback

                self.tail_error = traceback.format_exc()
            finally:
                snap_applied.set()  # never leave a joiner hanging
                self._tail_queue.task_done()

    def _join_queue(self, q: "queue.Queue", what: str,
                    timeout: Optional[float]) -> None:
        """Queue.join with a deadline: raises TailStalled (with queue
        depth + last flight record + any worker error) instead of
        blocking forever on a wedged worker. timeout None/<=0 keeps the
        unbounded join."""
        if not timeout or timeout <= 0:
            q.join()
            return
        deadline = time.monotonic() + timeout
        with q.all_tasks_done:
            while q.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    last = self.flight_recorder.last(1)
                    raise TailStalled(
                        what, timeout, q.unfinished_tasks,
                        last_record=last[-1] if last else None,
                        worker_error=self.tail_error or self.acceptor_error)
                q.all_tasks_done.wait(remaining)

    def join_tail(self, timeout: Optional[float] = None) -> None:
        """Wait until every queued insert tail has reached disk; raises
        (once) if the tail worker failed. [timeout] (default: the
        tail_join_timeout knob; 0 = unbounded) bounds the wait — on
        expiry TailStalled carries the diagnosis instead of a hang."""
        if timeout is None:
            timeout = self.cache_config.tail_join_timeout
        self._join_queue(self._tail_queue, "insert tail", timeout)
        if self.tail_error is not None:
            err, self.tail_error = self.tail_error, None
            raise ChainError(f"insert tail failed:\n{err}")

    def _wait_tail_snap(self) -> None:
        """Wait only for pending snapshot diff-layer attaches (the cheap
        head of the tail) — what state reads need for layer lookup."""
        timeout = self.cache_config.tail_join_timeout
        if not self._tail_snap_applied.wait(timeout if timeout > 0 else None):
            raise TailStalled(
                "insert-tail snapshot attach", timeout,
                self._tail_queue.unfinished_tasks,
                worker_error=self.tail_error)
        if self.tail_error is not None:
            err, self.tail_error = self.tail_error, None
            raise ChainError(f"insert tail failed:\n{err}")

    def _write_canonical(self, block: Block) -> None:  # guarded-by: chainmu
        """Extend the canonical chain: in-memory mappings flip
        synchronously (readers under chainmu see the new head at once),
        but the DISK canonical-hash/head-pointer writes are enqueued
        behind the block's body on the insert tail, enforcing
        body-before-head durability ordering."""
        self._canonical[block.number] = block.hash()
        self.current_block = block
        self._publish_read_view()
        self._tail_queue.put(("head", block))

    def reprocess_state(self, target: Block, reexec_limit: int) -> None:
        """reprocessState (blockchain.go:1745): walk back to the nearest
        block whose root is available, then re-execute forward to [target],
        committing each root into the trie forest."""
        missing: List[Block] = []
        cur = target
        while not self.has_state(cur.root):
            missing.append(cur)
            if len(missing) > reexec_limit:
                raise ChainError(
                    f"required historical state unavailable (>{reexec_limit} blocks back)"
                )
            parent = self.get_block(cur.parent_hash)
            if parent is None:
                raise ChainError("missing ancestor during state reprocess")
            cur = parent
        for blk in reversed(missing):
            self._reexecute_and_commit(blk)
            self.trie_writer.insert_trie(blk)
            self.trie_writer.accept_trie(blk)

    def _reexecute_and_commit(self, blk: Block) -> bytes:
        """Re-run [blk] from its parent's state, validate, and commit the
        regenerated root into the forest (shared by reprocess_state and
        populate_missing_tries — one re-execution path to maintain)."""
        parent = self.get_header(blk.parent_hash)
        if parent is None or not self.has_state(parent.root):
            raise ChainError(
                f"cannot re-execute block {blk.number}: parent state unavailable"
            )
        statedb = StateDB(parent.root, self.state_database)
        receipts, _, used_gas = self.processor.process(blk, parent, statedb)
        self.validator.validate_state(blk, statedb, receipts, used_gas)
        root = statedb.commit(self.config.is_eip158(blk.number))
        if root != blk.root:
            raise ChainError(f"re-executed root mismatch at {blk.number}")
        return root

    def populate_missing_tries(self, from_height: int,
                               parallelism: int = 1024) -> int:
        """Heal trie gaps in an archival chain (blockchain.go:1899
        populateMissingTries): scan canonical blocks from [from_height] to
        the current tip; any block whose state root is missing is
        re-executed from its parent's state and committed to disk.

        Execution is inherently sequential (block k needs block k-1's
        state), so — like the reference, whose parallelism knob feeds the
        trie-read prefetcher — [parallelism] drives a read-ahead pool that
        concurrently loads upcoming blocks and warms their sender
        recoveries (the batched-ecrecover cost) while the current block
        executes. Returns the number of healed blocks.
        """
        import concurrent.futures as _fut

        tip = self.last_accepted.number
        if from_height > tip:
            return 0
        pool = _fut.ThreadPoolExecutor(
            max_workers=max(1, min(parallelism, 16)))
        window = max(1, min(parallelism, 64))

        from .types import Signer

        signer = Signer(self.config.chain_id)

        def load_and_warm(num: int):
            blk = self.get_block_by_number(num)
            if blk is not None:
                # caches the recovered senders; an invalid signature stays
                # uncached and the block's own execution raises on it
                signer.sender_batch(blk.transactions)
            return blk

        healed = 0
        try:
            pending = {
                n: pool.submit(load_and_warm, n)
                for n in range(from_height, min(from_height + window, tip + 1))
            }
            for num in range(from_height, tip + 1):
                fut = pending.pop(num, None)
                blk = fut.result() if fut else self.get_block_by_number(num)
                # keep the read-ahead window full
                head = max(pending) + 1 if pending else num + 1
                while head <= tip and len(pending) < window:
                    pending[head] = pool.submit(load_and_warm, head)
                    head += 1
                if blk is None:
                    raise ChainError(f"canonical block {num} missing")
                if self.has_state(blk.root):
                    continue
                root = self._reexecute_and_commit(blk)
                # archival heal: persist the regenerated trie immediately
                self.state_database.triedb.commit(root)
                healed += 1
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
        return healed

    # ------------------------------------------------------ accept / reject

    def accept(self, block: Block) -> None:
        """Accept (blockchain.go:1034-1065): reorg to the accepted block if
        it is not canonical, then enqueue async post-processing."""
        # land in-flight pipelined inserts BEFORE taking chainmu (the
        # commit worker needs the lock to make progress — draining under
        # it would deadlock). An accept of an in-flight block thereby
        # waits for its commit; a deferred commit failure surfaces here,
        # and the pipeline has already rewound the speculated successors.
        if self.pipeline is not None:
            self.pipeline.drain()
        with self.chainmu:
            canonical = self.get_canonical_hash(block.number)
            if canonical != block.hash():
                self._set_preference_locked(block)
            self.last_accepted = block
            self._publish_read_view()
            with self._acceptor_tip_lock:
                self._acceptor_tip = block
            self._acceptor_wg.clear()
            # enqueue under chainmu so concurrent accepts cannot reorder the
            # queue relative to the pointer updates (blockchain.go:1061)
            self._acceptor_queue.put(block)

    def reject(self, block: Block) -> None:
        """Reject (blockchain.go:1067-1094): drop refs for the losing block."""
        # same ordering as accept: drain the pipeline outside chainmu so
        # a reject of (or racing) an in-flight block sees it committed —
        # or its speculation rewound — before refs are dropped
        if self.pipeline is not None:
            self.pipeline.drain()
        with self.chainmu:
            # the losing block's tail may still be queued; land it before
            # dropping the in-memory refs so disk state stays coherent
            self.join_tail()
            self.trie_writer.reject_trie(block)
            self._blocks.pop(block.hash(), None)
            self._receipts.pop(block.hash(), None)

    def _start_acceptor(self) -> None:
        while True:
            block = self._acceptor_queue.get()
            if block is None:
                return
            try:
                self._accept_post_process(block)
            except Exception:
                # the acceptor thread must survive post-processing faults:
                # a dead consumer deadlocks accept()/drain on the bounded
                # queue; record and continue (the reference logs+continues)
                import traceback

                self.acceptor_error = traceback.format_exc()
            finally:
                self._acceptor_queue.task_done()
                if self._acceptor_queue.empty():
                    self._acceptor_wg.set()

    def _accept_post_process(self, block: Block) -> None:
        """startAcceptor body (blockchain.go:563-611), on the acceptor
        thread. Its device work (the mirror's drain and interval export
        through trie_writer.accept_trie) runs on the executor's own
        stream, which ResidentExecutor makes current on whichever thread
        enqueues or reads back. A device that stops answering there (a
        DeviceWedgedError from the interval export) is recorded in
        acceptor_error and the host-side work below still runs: the
        mirror stays wedged, so the next insert raises, and once the
        caller moves it with take_over_host() the next export writes the
        full image."""
        from ..metrics import default_registry as _metrics

        with _span("chain/accept", number=block.number):
            with _metrics.timer("chain/block/accepts").time():
                # the accepted block's diff layer and rawdb rows must be
                # down before flatten folds layers / tx lookups are written
                self.join_tail()
                if self.snaps is not None:
                    self.snaps.flatten(block.hash())
                try:
                    self.trie_writer.accept_trie(block)
                except DeviceWedgedError as e:
                    self.acceptor_error = (
                        f"accept of block {block.number}: the trie "
                        f"writer's device wedged: {e}")
        _metrics.gauge("chain/head/accepted").update(block.number)
        self.flight_recorder.mark_accepted(block.hash())
        self.bloom_indexer.add_block(block.number, block.header.bloom)
        for tx in block.transactions:
            rawdb.write_tx_lookup(self.diskdb, tx.hash(), block.number)
        if self._chain_accepted_feed:
            receipts = self.get_receipts(block.hash()) or []
            logs = [lg for r in receipts for lg in r.logs]
            for fn in self._chain_accepted_feed:
                fn(block, logs)
        with self._acceptor_tip_lock:
            if self._acceptor_tip is block:
                self._acceptor_tip = None

    def drain_acceptor_queue(self, timeout: Optional[float] = None) -> None:
        """Block until all queued Accepts have been post-processed.
        [timeout] (default: the tail_join_timeout knob; 0 = unbounded)
        bounds the wait with a TailStalled instead of an indefinite
        hang on a wedged acceptor."""
        if timeout is None:
            timeout = self.cache_config.tail_join_timeout
        self._join_queue(self._acceptor_queue, "acceptor queue", timeout)
        self._acceptor_wg.set()

    # ----------------------------------------------------- preference/reorg

    def set_preference(self, block: Block) -> None:
        """SetPreference (blockchain.go:973-1012)."""
        # a preference switch can reorg: rewind in-flight speculation
        # first (outside chainmu — see accept) so the reorg never races
        # a pipelined commit that extends the losing fork
        if self.pipeline is not None:
            self.pipeline.drain()
        with self.chainmu:
            self._set_preference_locked(block)

    def _set_preference_locked(self, block: Block) -> None:
        if block.hash() == self.current_block.hash():
            return
        self._reorg(self.current_block, block)

    def _reorg(self, old_head: Block, new_head: Block) -> None:  # guarded-by: chainmu
        """reorg (blockchain.go:1424+): rewind canonical mappings to the
        common ancestor, then write the new chain's canonical pointers."""
        # land queued tails first: the direct canonical/head writes below
        # must not overtake body (or head) items still in the tail queue,
        # or the body-before-head ordering breaks exactly when it matters
        self.join_tail()
        new_chain = []
        old, new = old_head, new_head
        while new.number > old.number:
            new_chain.append(new)
            parent = self.get_block(new.parent_hash)
            if parent is None:
                raise ChainError("reorg: missing new-chain parent")
            new = parent
        while old.number > new.number:
            parent = self.get_block(old.parent_hash)
            if parent is None:
                raise ChainError("reorg: missing old-chain parent")
            old = parent
        while old.hash() != new.hash():
            new_chain.append(new)
            old_p = self.get_block(old.parent_hash)
            new_p = self.get_block(new.parent_hash)
            if old_p is None or new_p is None:
                raise ChainError("reorg: missing common ancestor")
            old, new = old_p, new_p
        # delete canonical entries above the fork point on the old chain
        for num in range(new.number + 1, old_head.number + 1):
            self._canonical.pop(num, None)
            rawdb.delete_canonical_hash(self.diskdb, num)
        for blk in reversed(new_chain):
            self._canonical[blk.number] = blk.hash()
            rawdb.write_canonical_hash(self.diskdb, blk.hash(), blk.number)
        self.current_block = new_head
        self._publish_read_view()
        rawdb.write_head_block_hash(self.diskdb, new_head.hash())
        # a reorg is a head change: downstream (the tx pool) re-anchors on
        # the new fork, as for an insert that extends the preference
        if self._chain_feed:
            receipts = self.get_receipts(new_head.hash()) or []
            logs = [lg for r in receipts for lg in r.logs]
            for fn in self._chain_feed:
                fn(new_head, logs)

    # -------------------------------------------------------------- events

    def subscribe_chain_event(self, fn: Callable) -> None:
        self._chain_feed.append(fn)

    def subscribe_chain_accepted_event(self, fn: Callable) -> None:
        self._chain_accepted_feed.append(fn)

    # ------------------------------------------------------------ lifecycle

    def stop(self) -> None:
        """Retire the insert pipeline and the shard pool, drain the
        acceptor queue and the insert tail, retire both workers, leave the
        degradation ladder's listeners, then the trie writer's shutdown
        (the resident writer's final export of the last accepted
        block)."""
        # the pipeline first: its commit worker feeds the acceptor/tail
        # queues being drained below
        if self.pipeline is not None:
            self.pipeline.stop()
        # then the execution shard pool (the pipeline's submit stage was
        # its last possible dispatcher)
        self.processor.close()
        self.drain_acceptor_queue()
        self._acceptor_queue.put(None)
        self._acceptor_thread.join(timeout=5)
        # land every queued insert tail, then retire the worker
        if not self._tail_closed:
            self._tail_closed = True
            try:
                self.join_tail()
            finally:
                self._tail_queue.put(None)
                self._tail_thread.join(timeout=5)
        self._ladder.remove_listener(self._on_device_event)
        self.trie_writer.shutdown()

    def last_accepted_block(self) -> Block:
        return self.last_accepted

    def last_consensus_accepted_block(self) -> Block:
        with self.chainmu:
            return self.last_accepted
