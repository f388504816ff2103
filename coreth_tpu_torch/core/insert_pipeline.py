"""Staged block-insert pipeline: overlap block k+1's sender recovery and
speculative execution with block k's state commit, device-hash dispatch
and async tail write; counterpart of coreth_tpu/core/insert_pipeline.py.

The AlDBaran shape (PAPERS.md): recover ∥ execute ∥ commit ∥ device-hash,
so steady-state insert rate approaches the MAX of the stage costs instead
of their sum. The journal-free substrate (`VersionedStateView` +
`StateDB.fold_tx_writes`, core/parallel_exec.py) separates "execute a
block" from "mutate the StateDB": execution produces immutable per-tx
write-sets, and the fold applies them deterministically in tx order. This
module reuses exactly that seam across BLOCKS:

- **submit (caller thread, no chainmu)**: recover senders (tagged batch),
  verify the header/body against the in-flight window, then execute the
  block's txs in order through `VersionedStateView` against an *overlay
  base* — the flattened write-sets of the in-flight ancestors stacked on
  a `_BaseReader` over the oldest in-flight parent's committed state.
  In-order execution means every read is final: no validation waves, no
  re-executions — the Block-STM machinery degenerates to "execute once,
  keep the write-sets". With execution shards on, the same execution is
  dispatched through the processor's shard pool.
- **commit (single worker thread, chainmu)**: replay the recorded
  gas-pool ops, fold the write-sets into a fresh StateDB at the parent
  root, run the engine finalize + full `validate_state` (gas/bloom/
  receipt root, state root vs header), then reuse the serial path's
  `_commit_validated` tail (commit → trie writer/resident dispatch →
  flight record → tail write → canonical head). The storage programs
  (PlannedCommit) and the mirror's account trie (ResidentExecutor) launch
  K1 from this thread; it makes the chain's CUDA device current before
  its first commit, and the executor enqueues on its own recorded stream,
  so the acceptor's drain and export still order after these dispatches.

Speculation is a PERF HINT, never a correctness input: any speculative
failure (overlay miss, coinbase read, gas-pool hit, validate mismatch,
any exception at all) discards the speculated statedb and re-executes the
block serially at the commit stage — the exact serial loop, against the
exact committed parent state. Receipts, roots, and head are therefore
bit-exact vs depth 0 by construction. A device fault
(device.DEVICE_FAULTS: a wedged device, a CUDA error, a kernel that did
not build) is not a failed speculation: it passes through, is never
re-run serially and never counted as a fallback, and poisons the
pipeline like any commit-stage failure, with no bad-block entry (the
block is not at fault).

Failure/rewind contract: a commit-stage failure poisons the pipeline —
every queued successor is discarded (their speculation depended on the
failed block's post-state), the failed block lands in the chain's
bad-block ring, and the stored error re-raises at the next submit or
drain point. Drain points are `accept`, `reject`, `set_preference`,
`insert_block_manual`, and `stop` — all of which drain BEFORE taking
chainmu, because the commit worker needs chainmu to make progress.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

import torch

from ..device import DEVICE_FAULTS, resolve
from ..fault import failpoint
from ..metrics import default_registry as _metrics
from ..metrics import tracectx as _tracectx
from ..metrics.spans import span as _span
from ..state.state_object import ZERO32
from .blockchain import ChainError, _PhaseClock
from .parallel_exec import (
    _BaseReader,
    _ExecEnv,
    _run_incarnation,
    _VersionedTable,
    fold_results,
    tx_as_message,
)
from .state_processor import new_block_context
from .state_transition import GasPool
from .types import Block, Header, Signer

_PIPE_PREFIX = "chain/pipeline/"

_c_spec_ok = _metrics.counter("chain/pipeline/spec_commits")
_c_spec_fallback = _metrics.counter("chain/pipeline/serial_fallbacks")
_c_spec_aborts = _metrics.counter("chain/pipeline/spec_aborts")
_c_discards = _metrics.counter("chain/pipeline/discards")
_c_stop_errors = _metrics.counter("chain/pipeline/stop_errors")
_g_depth = _metrics.gauge("chain/pipeline/depth")


class _SpecAbort(Exception):
    """Speculative execution could not complete (stale overlay, coinbase
    read, per-tx error) — the block falls back to the serial loop at its
    commit stage. Never escapes this module."""


class _OverlayBase:
    """A `_BaseReader`-shaped read source layering one in-flight block's
    flattened write-sets over a deeper base (another overlay, or the
    committed-state `_BaseReader` at the bottom of the window).

    Frozen after construction — reads need no lock; the bottom
    `_BaseReader` carries its own. Account values convert the table's
    7-tuples to the reader's 4-tuple shape; a barrier (account reset /
    deletion) pins absent slots to zero instead of falling through.

    Deliberately NOT represented: per-tx coinbase fee deltas and engine
    finalize writes of the in-flight ancestor. A read that depends on
    them yields a stale value, the speculated root misses the header,
    and the commit stage falls back to serial — correctness comes from
    the validate gate, not from overlay completeness (on Avalanche the
    coinbase is the constant blackhole address, so in practice this
    never fires for the fee case).
    """

    __slots__ = ("accounts", "storage", "barriers", "deeper")

    def __init__(self, accounts: Dict[bytes, Optional[tuple]],
                 storage: Dict[Tuple[bytes, bytes], bytes],
                 barriers: Set[bytes], deeper):
        self.accounts = accounts
        self.storage = storage
        self.barriers = barriers
        self.deeper = deeper

    def account(self, addr: bytes) -> Optional[tuple]:
        """(nonce, balance, code_hash, is_multi_coin) or None (absent)."""
        if addr in self.accounts:
            val = self.accounts[addr]
            if val is None:
                return None  # deleted by the in-flight ancestor
            nonce, balance, code_hash, _code, _dirty, multi, _fresh = val
            return (nonce, balance, code_hash, multi)
        return self.deeper.account(addr)

    def slot(self, addr: bytes, key: bytes) -> bytes:
        v = self.storage.get((addr, key))
        if v is not None:
            return v
        if addr in self.barriers:
            # reset/recreated account: unwritten slots are zero as of the
            # barrier, whatever the deeper layers say
            return ZERO32
        return self.deeper.slot(addr, key)

    def code(self, addr: bytes) -> bytes:
        if addr in self.accounts:
            val = self.accounts[addr]
            if val is None:
                return b""
            code = val[3]
            if code is not None:
                return code
            # code=None in a write-set means "unchanged" — fall through
        return self.deeper.code(addr)


def _flatten_write_sets(results) -> Tuple[dict, dict, set]:
    """Collapse a block's per-tx write-sets into one overlay, applying
    them in tx-index order (last write wins; a barrier at tx i drops the
    slots written by txs < i, exactly like `_VersionedTable.read_slot`'s
    jb > jw rule)."""
    accounts: Dict[bytes, Optional[tuple]] = {}
    storage: Dict[Tuple[bytes, bytes], bytes] = {}
    barriers: Set[bytes] = set()
    for i in range(len(results)):  # ascending tx index — consensus order
        ws = results[i].ws
        for addr in ws.barriers:
            barriers.add(addr)
            for sk in [sk for sk in storage if sk[0] == addr]:
                del storage[sk]
        accounts.update(ws.accounts)
        storage.update(ws.storage)
    return accounts, storage, barriers


class _Entry:
    """One in-flight block: its speculation products plus the overlay its
    successors read through. All fields are written once on the
    submitting thread before the entry is published to the window/queue;
    the commit worker only reads them (plus rec/ctx, which are
    stage-sequential for a given block)."""

    __slots__ = ("block", "hash", "header", "parent_header", "rec", "ctx",
                 "phases", "results", "coinbase", "base", "overlay",
                 "spec_iv", "spec_shards", "spec_worker_stats")

    def __init__(self, block: Block, parent_header: Header, rec: dict,
                 ctx) -> None:
        self.block = block
        self.hash = block.hash()
        self.header = block.header
        self.parent_header = parent_header
        self.rec = rec
        self.ctx = ctx
        self.phases = rec["phases"]
        # speculation products: None results => serial fallback at commit
        self.results: Optional[list] = None
        self.coinbase: Optional[bytes] = None
        # read source for THIS block's speculation (overlay chain or
        # committed-state reader); successors stack their overlay on it
        self.base = None
        # flattened write-sets for successors; None when speculation
        # failed (successors then cannot speculate either — the cascade
        # re-arms once the window drains back to committed state)
        self.overlay: Optional[_OverlayBase] = None
        # wall-clock interval of the speculative execute stage, for the
        # chain-level overlap fraction in the flight record
        self.spec_iv: Optional[Tuple[float, float]] = None
        # worker count when the exec shards ran this block's
        # speculation; 0 = in-process serial speculation
        self.spec_shards: int = 0
        # per-worker ShardStats view for the flight record (exec_shards
        # per_worker_view shape); {} when shards didn't run
        self.spec_worker_stats: dict = {}


def _commit_device(chain) -> Optional[torch.device]:
    """The chain's CUDA device, which the commit thread makes current;
    None when the chain runs on the CPU or CUDA is absent."""
    d = torch.device("cuda" if chain.device is None else chain.device)
    if d.type != "cuda" or not torch.cuda.is_available():
        return None
    return resolve(d)


class InsertPipeline:
    """Bounded-depth staged insert pipeline over a BlockChain.

    `submit()` runs the recover/verify/speculate stages on the calling
    thread and enqueues the block for its commit stage; the bounded
    queue (maxsize = depth) is the backpressure — a caller more than
    `depth` blocks ahead of the commit worker blocks in put().
    """

    def __init__(self, chain, depth: int):
        if not (1 <= int(depth) <= 3):
            raise ValueError(
                f"insert-pipeline-depth must be in [1, 3], got {depth}")
        self.chain = chain
        self.depth = int(depth)
        self._mu = threading.Lock()
        # in-flight window, insertion-ordered by submit: hash -> _Entry.
        # Linear by construction — submit drains unless the new block
        # extends the newest entry.
        self._window: Dict[bytes, _Entry] = {}  # guarded-by: _mu
        self._error: Optional[BaseException] = None  # guarded-by: _mu
        self._queue: "queue.Queue[Optional[_Entry]]" = queue.Queue(depth)
        self._closed = False
        # commit-interval bookkeeping for the overlap fraction; the
        # single commit worker is the only writer after __init__
        self._last_commit_iv: Optional[Tuple[float, float]] = None
        self._device = _commit_device(chain)
        self._worker = threading.Thread(
            target=self._commit_worker, name="insert-pipeline", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- submit

    def submit(self, block: Block) -> None:
        """Stage 1-3 (caller thread): recover + verify + speculate, then
        hand the block to the commit worker. Raises here for ordering/
        verification problems (same errors as the serial path) and for a
        DEFERRED commit failure of an earlier block."""
        self._raise_pending()
        chain = self.chain

        parent_entry, parent_header = self._resolve_parent(block)

        ctx = _tracectx.begin("insert")
        rec: dict = {
            "number": block.number,
            "hash": block.hash(),
            "txs": len(block.transactions),
            "gas_used": 0,
            "phases": {},
            "parallel": {},
            "writes": True,
            "trace_id": ctx.trace_id if ctx is not None else None,
        }
        entry = _Entry(block, parent_header, rec, ctx)
        with chain._insert_recs_mu:
            chain._insert_recs[entry.hash] = rec

        try:
            with _tracectx.scope(ctx):
                self._prepare(entry, parent_entry)
        except Exception as e:
            if not isinstance(e, DEVICE_FAULTS):
                chain._note_bad_block(block, e)
            with chain._insert_recs_mu:
                chain._insert_recs.pop(entry.hash, None)
            if ctx is not None:
                ctx.meta["error"] = type(e).__name__
                _tracectx.capture(ctx, "insert_failed")
            raise

        with self._mu:
            self._window[entry.hash] = entry
            _g_depth.update(len(self._window))
        # bounded handoff: blocks when the worker is `depth` commits
        # behind — that backpressure IS the pipeline depth knob
        self._queue.put(entry)

    def _resolve_parent(self, block: Block):
        """Find the parent among the in-flight window (extend the tail)
        or the committed chain. A block that extends neither the tail
        nor committed state drains the window first — out-of-order and
        fork submissions restart the window from committed state, which
        deterministically rewinds any speculation they would invalidate."""
        chain = self.chain
        with self._mu:
            tail = next(reversed(self._window.values()), None)
        if tail is not None and block.header.parent_hash == tail.hash:
            return tail, tail.header
        if tail is not None:
            self.drain()
        parent = self._get_block_no_join(block.header.parent_hash)
        if parent is None:
            # ordering condition, not a bad block (see _insert_checked)
            raise ChainError("unknown ancestor")
        return None, parent.header

    def _get_block_no_join(self, block_hash: bytes) -> Optional[Block]:
        """`get_block` without its tail join: the submit stage runs
        concurrently with the tail worker and must neither block on its
        queue (a parked/slow tail would stall EVERY submit) nor surface
        its deferred errors here — those belong to the commit stage and
        the drain points. `_blocks` is stamped synchronously at commit,
        before the tail items land, so it covers every in-tail block;
        the rawdb fallback covers reopened databases."""
        from . import rawdb

        chain = self.chain
        blk = chain._blocks.get(block_hash)
        if blk is not None:
            return blk
        number = rawdb.read_header_number(chain.diskdb, block_hash)
        if number is None:
            return None
        return chain.get_block_by_number_and_hash(number, block_hash)

    def _known_with_state(self, block_hash: bytes) -> bool:
        """`has_block_and_state` minus the tail join (see above)."""
        blk = self._get_block_no_join(block_hash)
        return blk is not None and self.chain.has_state(blk.root)

    def _prepare(self, entry: _Entry, parent_entry: Optional[_Entry]) -> None:
        from .sender_cacher import sender_cacher

        chain = self.chain
        block, header = entry.block, entry.header
        phases = entry.phases

        failpoint("insert/before_recover")
        with _PhaseClock("recover", phases, _metrics,
                         prefix=_PIPE_PREFIX, span_prefix="pipeline/"):
            token = sender_cacher.recover(
                Signer(chain.config.chain_id), block.transactions)

        with _PhaseClock("verify", phases, _metrics,
                         prefix=_PIPE_PREFIX, span_prefix="pipeline/"):
            self._verify_windowed(entry, parent_entry)

        with _PhaseClock("recover", phases, _metrics,
                         prefix=_PIPE_PREFIX, span_prefix="pipeline/"):
            sender_cacher.wait(token)

        failpoint("insert/before_execute")
        t0 = time.monotonic()
        with _PhaseClock("execute", phases, _metrics,
                         prefix=_PIPE_PREFIX, span_prefix="pipeline/"):
            try:
                self._speculate(entry, parent_entry)
            except DEVICE_FAULTS:
                raise
            except Exception:
                # ANY speculative failure means "commit serially", never
                # "fail the insert": the serial fallback reproduces real
                # errors with the serial path's exact wrapping
                _c_spec_aborts.inc()
                entry.results = None
                entry.overlay = None
        entry.spec_iv = (t0, time.monotonic())

    def _verify_windowed(self, entry: _Entry,
                         parent_entry: Optional[_Entry]) -> None:
        """The serial path's verify stage (engine.verify_header +
        validate_body), consulting the in-flight window where the serial
        checks would consult committed state."""
        from .types import derive_sha

        chain = self.chain
        block, header = entry.block, entry.header
        chain.engine.verify_header(chain.config, header, entry.parent_header)
        with self._mu:
            in_window = entry.hash in self._window
        if in_window or self._known_with_state(entry.hash):
            raise ChainError("known block")
        if derive_sha(block.transactions) != header.tx_hash:
            raise ChainError("transaction root hash mismatch")
        if block.uncles:
            raise ChainError("uncles not allowed")
        if parent_entry is None and not self._known_with_state(
                header.parent_hash):
            raise ChainError("unknown ancestor / pruned ancestor")

    # -------------------------------------------------------- speculation

    def _speculate(self, entry: _Entry,
                   parent_entry: Optional[_Entry]) -> None:
        """Execute the block's txs in order through VersionedStateView
        against the window's overlay base, keeping the write-sets for the
        commit-stage fold. In-order, single-incarnation: reads are final
        by construction, so there is nothing to validate here — the
        commit stage's validate_state is the gate."""
        from ..evm.evm import Config as EvmConfig

        chain = self.chain
        block, header = entry.block, entry.header
        txs = block.transactions
        if not chain.config.is_byzantium(header.number):
            # pre-Byzantium per-tx intermediate roots need the real
            # StateDB journal; never the case on Avalanche
            raise _SpecAbort("pre-byzantium block")
        if parent_entry is not None and parent_entry.overlay is None:
            # the ancestor's speculation failed — its post-state exists
            # nowhere until its serial commit lands, so this block (and
            # the rest of the window) serializes too
            raise _SpecAbort("ancestor speculation unavailable")

        if parent_entry is None:
            # bottom of the window: a committed parent root. Mirror
            # execute_block's base construction — configure-precompiles
            # transition writes fold into the base via finalise(True).
            base_sdb = chain.state_at(entry.parent_header.root)
            chain.config.check_configure_precompiles(
                entry.parent_header.time, header, base_sdb)
            base_sdb.finalise(True)
            entry.base = _BaseReader(base_sdb)
        else:
            entry.base = parent_entry.overlay

        signer = Signer(chain.config.chain_id)
        msgs = [tx_as_message(tx, signer, header.base_fee) for tx in txs]
        block_ctx = self._window_block_ctx(entry)
        env = _ExecEnv(chain.config, EvmConfig(), block_ctx, txs, msgs,
                       _VersionedTable(), entry.base,
                       budget=max(4, len(txs)))
        results = self._execute_speculative(entry, env, txs)
        entry.results = results
        entry.coinbase = block_ctx.coinbase
        accounts, storage, barriers = _flatten_write_sets(results)
        entry.overlay = _OverlayBase(accounts, storage, barriers, entry.base)

    def _execute_speculative(self, entry: _Entry, env: _ExecEnv,
                             txs) -> List:
        """The submit stage's execution engine: the in-order in-process
        loop, or — when the chain runs execution shards — a GIL-free
        dispatch through the processor's shard pool. Either way the
        product is the same dense per-tx `_TxResult` list; shard-path
        failures abort speculation (serial fallback at commit), never
        the insert."""
        from .exec_shards import (
            MIN_SHARD_TXS,
            per_worker_view,
            run_shard_incarnations,
        )

        pool = self.chain.processor.shard_pool()
        if pool is not None and len(txs) >= MIN_SHARD_TXS:
            # the sweep inside run_shard_incarnations re-executes (in
            # this thread, against the overlay base) every tx whose
            # shipped reads turned stale — restoring exactly the
            # in-order loop's "reads are final" guarantee
            if not run_shard_incarnations(pool, env):
                raise _SpecAbort("shard sweep failed")
            entry.spec_shards = len(pool.workers)
            entry.spec_worker_stats = per_worker_view(pool.last_worker_stats)
            return [env.results[i] for i in range(len(txs))]
        results: List = []
        for i in range(len(txs)):
            r = _run_incarnation(env, i, 0)
            if r.err is not None:
                # could be a genuine bad tx or an overlay blind spot —
                # either way the serial commit path decides
                raise _SpecAbort(f"tx {i}: {type(r.err).__name__}")
            env.table.publish(i, 0, r.ws)
            results.append(r)
        return results

    def _window_block_ctx(self, entry: _Entry):
        """new_block_context with BLOCKHASH resolving in-flight ancestors
        from the window before falling back to the canonical chain."""
        chain = self.chain
        with self._mu:
            window_hashes = {e.header.number: e.hash
                             for e in self._window.values()}
        # the submitting thread is the only speculator, but BLOCKHASH
        # falls through to chain caches shared with the commit worker —
        # get_canonical_hash is GIL-atomic dict reads, safe unlocked
        ctx = new_block_context(entry.header, chain)
        inner = ctx.get_hash

        def get_hash(n: int) -> Optional[bytes]:
            h = window_hashes.get(n)
            if h is not None:
                return h
            return inner(n)

        from dataclasses import replace as _dc_replace

        return _dc_replace(ctx, get_hash=get_hash)

    # ------------------------------------------------------ commit worker

    def _commit_worker(self) -> None:
        if self._device is not None:
            # a new thread: make the chain's device current, so the
            # planned programs launch there on its default stream
            torch.cuda.set_device(self._device)
        while True:
            entry = self._queue.get()
            if entry is None:
                self._queue.task_done()
                return
            try:
                with self._mu:
                    poisoned = self._error is not None
                if poisoned:
                    self._discard(entry)
                else:
                    with _tracectx.scope(entry.ctx):
                        self._commit_entry(entry)
            except Exception as e:
                # poison: queued successors speculated against this
                # block's post-state — discard them all (the worker loop
                # drains them via the poisoned branch above) and deliver
                # the error at the next submit/drain
                with self._mu:
                    self._error = e
                if not isinstance(e, DEVICE_FAULTS):
                    self.chain._note_bad_block(entry.block, e)
                if entry.ctx is not None:
                    entry.ctx.meta["error"] = type(e).__name__
                    _tracectx.capture(entry.ctx, "insert_failed")
            finally:
                with self.chain._insert_recs_mu:
                    self.chain._insert_recs.pop(entry.hash, None)
                with self._mu:
                    self._window.pop(entry.hash, None)
                    _g_depth.update(len(self._window))
                self._queue.task_done()

    def _discard(self, entry: _Entry) -> None:
        """Rewind one speculated successor of a failed commit: count it,
        stamp its trace, and drop it without touching chain state."""
        _c_discards.inc()
        if entry.ctx is not None:
            entry.ctx.meta["outcome"] = "speculation_discarded"
            _tracectx.capture(entry.ctx, "speculation_discarded")

    def _commit_entry(self, entry: _Entry) -> None:
        from ..metrics import observe_slo as _observe_slo

        chain = self.chain
        block, header = entry.block, entry.header
        rec, phases = entry.rec, entry.phases
        insert_timer = _metrics.timer("chain/block/inserts")
        t_c0 = time.monotonic()
        mode = "serial-fallback"
        with _span("pipeline/commit_stage", number=block.number):
            with chain.chainmu:
                if chain.get_header(header.parent_hash) is None:
                    raise ChainError("unknown ancestor")
                statedb = None
                if entry.results is not None:
                    try:
                        with _PhaseClock("fold", phases, _metrics,
                                         prefix=_PIPE_PREFIX,
                                         span_prefix="pipeline/"):
                            (statedb, receipts,
                             used_gas) = self._fold_speculation(entry)
                        mode = "spec"
                        _c_spec_ok.inc()
                    except DEVICE_FAULTS:
                        raise
                    except Exception:
                        # stale overlay / gas-pool hit / validate miss:
                        # drop the speculated statedb wholesale and run
                        # the true serial loop below
                        _c_spec_fallback.inc()
                        statedb = None
                if statedb is None:
                    statedb, receipts, used_gas = (
                        chain._execute_and_validate(
                            block, header, entry.parent_header, rec,
                            phases, _metrics, insert_timer))
                rec["gas_used"] = used_gas
                mirror = chain.mirror
                rec["host_mode"] = (bool(mirror.host_mode)
                                    if mirror is not None else None)
                # no per-block counter deltas here: with two blocks in
                # flight the process-wide counters smear across them —
                # the pipeline record carries stage truth instead
                rec["pipeline"] = {
                    "depth": self.depth,
                    "mode": mode,
                    "overlap_fraction": self._overlap_fraction(entry),
                }
                chain._commit_validated(block, statedb, receipts,
                                        used_gas, rec, phases, _metrics)
        t_c1 = time.monotonic()
        self._last_commit_iv = (t_c0, t_c1)
        _metrics.timer("chain/pipeline/commit").update(t_c1 - t_c0)
        _observe_slo("slo/chain/insert", t_c1 - t_c0,
                     rec.get("trace_id"))
        if entry.ctx is not None:
            entry.ctx.meta["number"] = block.number
            entry.ctx.meta["txs"] = len(block.transactions)
            entry.ctx.meta["pipeline_mode"] = mode
            budget = chain.cache_config.insert_slo_budget
            if 0 < budget < entry.ctx.elapsed():
                entry.ctx.meta["outcome"] = "slow"
                entry.ctx.meta["over_slo_budget_s"] = budget
                _tracectx.capture(entry.ctx, "slow")

    def _overlap_fraction(self, entry: _Entry) -> float:
        """Fraction of this block's speculative-execute interval that
        overlapped the PREVIOUS block's commit stage — the chain-level
        pipelining actually achieved, stamped per block into the flight
        record."""
        prev = self._last_commit_iv
        iv = entry.spec_iv
        if prev is None or iv is None:
            return 0.0
        s0, s1 = iv
        dur = s1 - s0
        if dur <= 0.0:
            return 0.0
        lo = max(s0, prev[0])
        hi = min(s1, prev[1])
        return round(max(0.0, hi - lo) / dur, 4)

    def _fold_speculation(self, entry: _Entry):
        """Commit-stage half of the speculative path: replay the recorded
        gas-pool ops, fold the write-sets into a fresh StateDB at the
        committed parent root, engine-finalize, and run the FULL
        validate_state gate. Raises on any mismatch — the caller falls
        back to serial re-execution."""
        chain = self.chain
        block, header = entry.block, entry.header
        results = entry.results

        # gas accounting is block-serial state: replay in tx order
        # against the real pool so ErrGasLimitReached surfaces exactly
        # as the serial loop would raise it (here: as a fallback)
        gp = GasPool(header.gas_limit)
        for i in range(len(results)):
            for kind, amount in results[i].gas_ops:
                if kind == "sub":
                    gp.sub_gas(amount)
                else:
                    gp.add_gas(amount)

        statedb = chain.state_at(entry.parent_header.root)
        if getattr(statedb.trie, "resident", False):
            # resident device-hash dispatch: same contract as the serial
            # path — the mirror validates/commits against the header
            # root, deferring the device compare to its own drain point
            statedb.trie.expected_root = header.root
        chain.config.check_configure_precompiles(
            entry.parent_header.time, header, statedb)
        # the fold assumes an empty journal (see execute_block)
        statedb.finalise(True)
        statedb.start_prefetcher("chain")
        try:
            receipts, _, used_gas = fold_results(
                block.transactions, results, entry.coinbase, statedb, block)
            with _span("chain/execute/finalize"):
                chain.engine.finalize(chain.config, block,
                                      entry.parent_header, statedb, receipts)
            rec = entry.rec
            rec["parallel"] = {"mode": "pipeline-spec",
                               "shards": entry.spec_shards,
                               "per_worker": entry.spec_worker_stats}
            with _PhaseClock("validate", entry.phases, _metrics):
                chain.validator.validate_state(block, statedb, receipts,
                                               used_gas)
        finally:
            statedb.stop_prefetcher()
        return statedb, receipts, used_gas

    # ------------------------------------------------------ drain / stop

    def _raise_pending(self) -> None:
        """Raise the deferred commit error, if any, once the successors
        queued behind the failed block have been discarded: clearing the
        poison while one is still queued would commit it over a parent
        that never landed (ROADMAP Queue 3)."""
        with self._mu:
            pending = self._error is not None
        if pending:
            self._join()
        with self._mu:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _join(self) -> None:
        self.chain._join_queue(
            self._queue, "insert pipeline",
            self.chain.cache_config.tail_join_timeout)

    def drain(self) -> None:
        """Wait until every submitted block has committed (or been
        discarded), then surface any deferred commit error. NEVER call
        while holding chainmu — the commit worker needs it."""
        self._join()
        self._raise_pending()

    def stop(self) -> None:
        """Land in-flight work and retire the worker. A deferred error
        at stop time is counted (not raised): stop() runs on shutdown
        paths that must complete — the error already sits in the
        bad-block ring from the commit worker."""
        try:
            self.drain()
        except Exception:
            _c_stop_errors.inc()
        with self._mu:
            if self._closed:
                return
            self._closed = True
        self._queue.put(None)
        self._worker.join(timeout=5)
