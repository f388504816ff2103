"""Block-STM-style optimistic parallel transaction execution; counterpart
of coreth_tpu/core/parallel_exec.py.

Role of the Block-STM scheduler (Fantom/Aptos lineage; PAPERS.md) adapted
to this codebase's geth-shaped StateDB: a block's transactions execute
concurrently against `VersionedStateView`s that resolve every read to the
highest lower-indexed published write (the multi-version table) or to the
block-parent snapshot, recording per-tx read/write sets. Completed
incarnations publish their write-sets and trigger a validation wave over
higher-indexed transactions; a failed validation aborts the incarnation
and re-executes at the next one.

Determinism is anchored in two places, not in the scheduler:

  * a final ascending validate-or-re-execute sweep on the calling thread
    — by the time tx i is visited every lower tx is final, so one pass
    converges and any scheduler race is corrected deterministically;
  * the fold: per-tx write-sets apply to the real StateDB in tx-index
    order (`StateDB.fold_tx_writes`), regardless of completion order, so
    receipts, logs, gas refunds and the post-state root are bit-exact vs
    the serial loop.

Blocks that are pathological for optimism (conflict-rate threshold,
re-execution budget, a worker error that survives the sweep, or any read
of the fee recipient) return None and the caller runs the untouched
serial path — the fold is the only StateDB mutation, and it only happens
once the whole block has validated.

Fee handling: the coinbase balance is the one location nearly every tx
writes. Fees are therefore carried as commutative per-tx deltas folded in
tx order; any transaction that *reads* the fee recipient (balance opcode,
zero-amount touch, sender == coinbase) trips `_CoinbaseRead` and the
block falls back to serial. On Avalanche the coinbase is the blackhole
address, so real workloads never read it.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import replace as _dc_replace
from typing import List, Optional

from ..device import DEVICE_FAULTS
from ..metrics import default_registry as _metrics
from ..metrics.spans import span
from .mvcc import (
    BASE,
    VersionedStateView,
    _BaseReader,
    _RecordingGasPool,
    _VersionedTable,
)
from .state_transition import GasPool, TxValidationError, apply_message, tx_as_message
from .types import Receipt, Signer, create_address, logs_bloom

# 0 disables parallel execution (the serial loop). The env var wins
# over the evm_parallel_workers knob so A/B runs don't need a chain restart.
PARALLEL_ENV = "CORETH_TPU_EVM_PARALLEL"
MAX_WORKERS = 64
MIN_PARALLEL_TXS = 2
# fraction of txs allowed to depend on an in-block write before the block
# is declared serial-shaped and handed back to the serial loop
CONFLICT_RATE_FALLBACK = 0.75
REEXEC_BUDGET_FACTOR = 2

_c_conflicts = _metrics.counter("exec/parallel/conflicts")
_c_reexecs = _metrics.counter("exec/parallel/reexecs")
_c_fallbacks = _metrics.counter("exec/parallel/fallbacks")
_c_softfail = _metrics.counter("exec/parallel/speculative_errors")
_g_workers = _metrics.gauge("exec/parallel/workers")
_t_schedule = _metrics.timer("chain/execute/schedule")
_t_execute = _metrics.timer("chain/execute/execute")
_t_validate = _metrics.timer("chain/execute/validate")
_t_fold = _metrics.timer("chain/execute/fold")


def effective_workers(cfg_val: Optional[int] = None) -> int:
    """CORETH_TPU_EVM_PARALLEL > evm_parallel_workers knob > 0 (serial)."""
    env = os.environ.get(PARALLEL_ENV)
    if env is not None:
        try:
            return max(0, min(int(env), MAX_WORKERS))
        except ValueError:
            pass
    if cfg_val:
        return max(0, min(int(cfg_val), MAX_WORKERS))
    return 0


# --------------------------------------------------------------------------
# per-incarnation execution


class _TxResult:
    __slots__ = ("inc", "result", "err", "ws", "reads", "gas_ops", "msg")

    def __init__(self, inc, result, err, ws, reads, gas_ops, msg):
        self.inc = inc
        self.result = result
        self.err = err
        self.ws = ws
        self.reads = reads
        self.gas_ops = gas_ops
        self.msg = msg


class _ExecEnv:
    """Everything a worker needs, plus the shared result/incarnation
    arrays. Mutable scheduling state (results, incarn, conflicts, reexecs,
    fallback) is guarded by the scheduler's cond; the table and base
    reader carry their own locks."""

    def __init__(self, chain_config, vm_config, block_ctx, txs, msgs,
                 table, base, budget):
        self.chain_config = chain_config
        self.vm_config = vm_config
        self.block_ctx = block_ctx
        self.coinbase = block_ctx.coinbase
        self.txs = txs
        self.msgs = msgs
        self.table = table
        self.base = base
        self.budget = budget
        self.results: List[Optional[_TxResult]] = [None] * len(txs)
        self.incarn: List[int] = [0] * len(txs)
        self.conflicts = 0
        self.reexecs = 0
        self.fallback = False
        # the first exception a worker thread raised (a device fault):
        # the scheduler stops and run() raises it on the calling thread
        self.error: Optional[BaseException] = None
        self._tls = threading.local()

    def local_evm(self):
        """One EVM per worker thread (jump tables are stateless; depth/
        statedb are per-reset)."""
        from ..evm.evm import EVM, TxContext

        evm = getattr(self._tls, "evm", None)
        if evm is None:
            evm = EVM(self.block_ctx, TxContext(), None, self.chain_config,
                      self.vm_config)
            self._tls.evm = evm
        return evm


def _run_incarnation(env: _ExecEnv, i: int, inc: int) -> _TxResult:
    from ..evm.evm import TxContext

    msg = env.msgs[i]
    view = VersionedStateView(env.table, env.base, i, env.coinbase)
    gp = _RecordingGasPool()
    evm = env.local_evm()
    evm.reset(TxContext(origin=msg.from_, gas_price=msg.gas_price), view)
    try:
        result = apply_message(evm, msg, gp)
        return _TxResult(inc, result, None, view.build_write_set(),
                         view.reads, gp.ops, msg)
    except DEVICE_FAULTS:
        # a base read reached the device and it failed: not a speculative
        # failure, so it reaches the caller (device.DEVICE_FAULTS)
        raise
    except Exception as err:
        # speculative failure: reads may be stale, so the error is not yet
        # meaningful. The final sweep re-executes against final state; an
        # error that reproduces there forces the serial fallback, which
        # raises it with the serial loop's exact wrapping.
        _c_softfail.inc()
        return _TxResult(inc, None, err, None, view.reads, gp.ops, msg)


# --------------------------------------------------------------------------
# scheduler


class _Scheduler:
    """Collaborative scheduler in the Block-STM shape: a shared execution
    queue plus a validation wave per completed incarnation. Under
    CPython's GIL a work-stealing deque per worker degrades to this shared
    queue anyway, so the shared structure is the honest implementation;
    the scheduling state lives behind one condition variable with short
    critical sections. Execution and validation happen OUTSIDE the lock.
    """

    def __init__(self, env: _ExecEnv, workers: int):
        self.env = env
        self.workers = workers
        self.cond = threading.Condition()
        n = len(env.txs)
        self.exec_q: List[int] = list(range(n - 1, -1, -1))  # pop() ascends
        self.val_q: List[int] = []
        self.active = 0
        self.done = False

    def run(self) -> None:
        threads = [
            threading.Thread(target=self._worker, args=(w,), daemon=True,
                             name=f"parallel-exec-{w}")
            for w in range(self.workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.env.error is not None:
            raise self.env.error

    def _worker(self, widx: int) -> None:
        env = self.env
        lo = hi = -1
        executed = 0
        with span("exec/parallel/worker", worker=widx) as sp:
            while True:
                task = self._next_task()
                if task is None:
                    break
                kind, i, inc, reads = task
                try:
                    if kind == "exec":
                        r = _run_incarnation(env, i, inc)
                        executed += 1
                        lo = i if lo < 0 else min(lo, i)
                        hi = max(hi, i)
                        self._finish_exec(i, inc, r)
                    else:
                        ok = env.table.validate(i, reads)
                        self._finish_val(i, inc, ok)
                except BaseException as err:  # noqa: BLE001 — run() raises it
                    with self.cond:
                        if env.error is None:
                            env.error = err
                        self.active -= 1
                        self.done = True
                        self.cond.notify_all()
                    break
            sp.set_attr("executed", executed)
            sp.set_attr("tx_lo", lo)
            sp.set_attr("tx_hi", hi)

    def _next_task(self):
        with self.cond:
            while True:
                if self.done:
                    return None
                if self.val_q:
                    # lowest index first: the wave front settles bottom-up
                    self.val_q.sort()
                    i = self.val_q.pop(0)
                    r = self.env.results[i]
                    if r is None:
                        continue  # aborted while queued
                    self.active += 1
                    return ("val", i, r.inc, r.reads)
                if self.exec_q:
                    i = self.exec_q.pop()
                    self.active += 1
                    return ("exec", i, self.env.incarn[i], None)
                if self.active == 0:
                    self.done = True
                    self.cond.notify_all()
                    return None
                self.cond.wait(0.05)

    def _finish_exec(self, i: int, inc: int, r: _TxResult) -> None:
        env = self.env
        env.table.publish(i, inc, r.ws)
        with self.cond:
            if env.incarn[i] == inc:
                env.results[i] = r
                if i not in self.val_q:
                    self.val_q.append(i)
                # validation wave: higher txs that already executed may
                # have read locations this incarnation just (re)wrote
                for j in range(i + 1, len(env.txs)):
                    if env.results[j] is not None and j not in self.val_q:
                        self.val_q.append(j)
            self.active -= 1
            self.cond.notify_all()

    def _finish_val(self, i: int, inc: int, ok: bool) -> None:
        env = self.env
        with self.cond:
            r = env.results[i]
            if (not ok) and env.incarn[i] == inc and r is not None and r.inc == inc:
                env.conflicts += 1
                env.reexecs += 1
                if env.reexecs > env.budget:
                    env.fallback = True
                    self.done = True
                else:
                    env.incarn[i] = inc + 1
                    env.results[i] = None
                    self.exec_q.append(i)  # re-run next (freshest deps)
            self.active -= 1
            self.cond.notify_all()


# --------------------------------------------------------------------------
# deterministic tail: sweep, gas precheck, fold


def _final_sweep(env: _ExecEnv) -> bool:
    """Authoritative ascending validate-or-re-execute pass on the calling
    thread. When tx i is visited every j < i is final, so a single pass
    converges; this is what makes the concurrent phase a pure warm-up and
    the commit deterministic. Returns False → serial fallback."""
    n = len(env.txs)
    for i in range(n):
        r = env.results[i]
        if r is not None and r.err is None and env.table.validate(i, r.reads):
            continue
        if r is not None and r.err is None:
            env.conflicts += 1
        env.reexecs += 1
        if env.reexecs > env.budget:
            return False
        inc = env.incarn[i] = env.incarn[i] + 1
        r = _run_incarnation(env, i, inc)
        env.results[i] = r
        env.table.publish(i, inc, r.ws)
        if r.err is not None:
            # reads were final, so the error is genuine (e.g. a
            # TxValidationError): fall back so the serial loop raises it
            # with its exact ProcessorError wrapping
            return False
    return True


def _replay_gas_pool(env: _ExecEnv, gas_limit: int) -> bool:
    """Validate block gas accounting in tx-index order against a scratch
    pool — ErrGasLimitReached must surface exactly as the serial loop
    would raise it, so any hit falls back."""
    gp = GasPool(gas_limit)
    try:
        for i in range(len(env.results)):
            for kind, amount in env.results[i].gas_ops:
                if kind == "sub":
                    gp.sub_gas(amount)
                else:
                    gp.add_gas(amount)
    except TxValidationError:
        return False
    return True


def fold_results(txs, results, coinbase: bytes, statedb, block):
    """Apply per-tx write-sets to the StateDB and build receipts in
    tx-index order (the deterministic-commit half of Block-STM). Shared
    by execute_block and the insert pipeline's speculative commit —
    [results] is a dense list of completed _TxResult, one per tx."""
    header = block.header
    block_hash = block.hash()
    used = 0
    receipts: List[Receipt] = []
    all_logs: List = []
    for i in range(len(txs)):  # ascending tx index — consensus order
        tx = txs[i]
        r = results[i]
        ws = r.ws
        tx_hash = tx.hash()
        statedb.fold_tx_writes(tx_hash, i, ws.accounts, ws.storage, ws.logs,
                               ws.preimages, coinbase, ws.fee)
        used += r.result.used_gas
        receipt = Receipt(
            type=tx.type,
            status=0 if r.result.failed else 1,
            cumulative_gas_used=used,
            tx_hash=tx_hash,
            gas_used=r.result.used_gas,
        )
        if r.msg.to is None:
            receipt.contract_address = create_address(r.msg.from_, r.msg.nonce)
        receipt.logs = statedb.get_logs(tx_hash, header.number, block_hash)
        receipt.bloom = logs_bloom(receipt.logs)
        receipt.block_number = header.number
        receipts.append(receipt)
        all_logs.extend(receipt.logs)
    return receipts, all_logs, used


def _locked_block_ctx(block_ctx):
    """chain.get_canonical_hash (BLOCKHASH) touches chain caches that are
    not thread-safe; serialise it for the concurrent phase."""
    lock = threading.Lock()
    inner = block_ctx.get_hash

    def get_hash(n: int):
        with lock:
            return inner(n)

    return _dc_replace(block_ctx, get_hash=get_hash)


# --------------------------------------------------------------------------
# entry point


def execute_block(chain_config, block, parent, statedb, block_ctx,
                  vm_config, workers: int):
    """Optimistically execute a block in parallel.

    Returns ((receipts, all_logs, used_gas), stats) on success, or
    (None, stats) — statedb untouched — when the block must run serially.
    """
    txs = block.transactions
    n = len(txs)
    header = block.header
    stats = {"mode": "serial", "workers": workers, "conflicts": 0,
             "reexecs": 0, "deps": 0, "fallback": True}

    t0 = time.monotonic()
    signer = Signer(chain_config.chain_id)
    try:
        msgs = [tx_as_message(tx, signer, header.base_fee) for tx in txs]
    except DEVICE_FAULTS:
        raise
    except Exception:
        # e.g. unrecoverable sender — the serial loop raises the exact
        # ProcessorError for it
        _c_fallbacks.inc()
        return None, stats

    # the serial loop folds the configure-precompiles journal at tx 0's
    # finalise; the parallel base must present those writes to every
    # worker, and the fold assumes an empty journal
    statedb.finalise(True)

    table = _VersionedTable()
    base = _BaseReader(statedb)
    budget = max(4, REEXEC_BUDGET_FACTOR * n)
    workers_n = max(1, min(workers, n, MAX_WORKERS))
    env = _ExecEnv(chain_config, vm_config, _locked_block_ctx(block_ctx),
                   txs, msgs, table, base, budget)
    _g_workers.update(workers_n)
    stats["workers"] = workers_n
    _t_schedule.update(time.monotonic() - t0)

    t1 = time.monotonic()
    _Scheduler(env, workers_n).run()
    _t_execute.update(time.monotonic() - t1)

    t2 = time.monotonic()
    ok = (not env.fallback) and _final_sweep(env)
    if ok:
        deps = 0
        for i in range(n):
            for ver in env.results[i].reads.values():
                if ver != BASE:
                    deps += 1
                    break
        stats["deps"] = deps
        if n >= 4 and deps > CONFLICT_RATE_FALLBACK * n:
            # serial-shaped block: optimism would re-execute most of it
            # anyway, and the deterministic trigger keeps tests stable
            ok = False
    if ok:
        ok = _replay_gas_pool(env, header.gas_limit)
    _t_validate.update(time.monotonic() - t2)

    stats["conflicts"] = env.conflicts
    stats["reexecs"] = env.reexecs
    _c_conflicts.inc(env.conflicts)
    _c_reexecs.inc(env.reexecs)
    if not ok:
        _c_fallbacks.inc()
        return None, stats

    t3 = time.monotonic()
    receipts, all_logs, used = fold_results(
        env.txs, env.results, env.coinbase, statedb, block)
    _t_fold.update(time.monotonic() - t3)
    stats["mode"] = "parallel"
    stats["fallback"] = False
    return (receipts, all_logs, used), stats
