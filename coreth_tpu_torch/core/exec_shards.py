"""Process-level execution shards: GIL-free speculative tx execution;
counterpart of coreth_tpu/core/exec_shards.py.

Every in-process speculative worker shares one GIL-bound interpreter.
This module escapes it with a pool of long-lived worker processes
(core/shard_worker.py) that execute incarnation 0 of a block's txs
against a read-only view of base state and ship back compact write-sets
— the exact `_WriteSet` shape `fold_tx_writes` and the insert pipeline's
`_OverlayBase` already speak. The parent then runs the UNCHANGED
deterministic tail: publish, `_final_sweep` (validate-or-re-execute in
the parent), gas-pool replay, `fold_results`, full `validate_state`.
The shard boundary adds no new trust: workers are advisory, and any
shard failure — crash, timeout, pickle error, stale snapshot — falls
back to the untouched serial loop bit-exact.

How the workers start (the reference forks them from the chain's own
process). Here the parent holds a CUDA context and runs threads of its
own (the acceptor, the insert tail, the sender cacher's pool, the
mirror's watchdog, torch's): a child forked from it could use none of
them, and a fork of a threaded process can deadlock the child. So the
pool starts its workers from a forkserver
(`multiprocessing.get_context("forkserver")`): the server is a fresh
single-threaded interpreter with no CUDA context, and each worker is
forked from it. The server preloads (PRELOAD) the worker loop, the EVM
modules its exec handler imports (none of them imports torch) and the
parent's main module (shard_worker's docstring says how), so a worker
starts, and a respawn restarts, with all of them copy-on-write and
imports none itself. What the reference's fork carried in memory
crosses pickled in the start arguments: the chain config, and the
parent's armed failpoints as they stand at the start
(fault.armed_state), so a failpoint armed in the parent before a worker
starts reaches the worker as it would through a fork; a `raise` armed
later still fires in the parent and kills a worker for real
(run_shard_incarnations). A worker never touches the device: its pong
reports torch.cuda.is_initialized() and any refused module (jax, jaxlib,
coreth_tpu) it has loaded.

A device fault (device.DEVICE_FAULTS) raised by a base read the parent
serves for a worker is not a shard failure: the dispatch respawns the
worker left waiting for the answer and raises the fault to the caller,
without a fallback or a step towards demotion.

Lifecycle ladder:

    healthy ──crash/timeout──▶ respawn-on-crash (serial for THIS block)
        ╰── DEMOTE_AFTER consecutive dispatch failures ──▶ demoted:
            pool closed, chain serves serial until restart

Wire-up: the `evm_exec_shards` knob (0 = the in-process paths; env
CORETH_TPU_EVM_EXEC_SHARDS overrides, read per block) —
`StateProcessor.process` checks shards before the thread-parallel mode,
and `insert_pipeline._speculate` dispatches its submit-stage execution
through the same pool. One dispatch at a time per pool: the processor's
serial-fallback path and the pipeline's submit stage may ask at once.

The forkserver and multiprocessing's resource tracker would outlive
the last pool and the parent itself by a moment (each exits when it
reads the parent's end of its pipe closed), so stop_servers closes every
open pool and stops both, waiting for each to exit; it runs at exit once
a pool was made, and a program that must leave no process behind calls
it itself before it looks.

`python -m coreth_tpu_torch.core.exec_shards --smoke` starts a 2-worker
pool, SIGKILLs one worker and checks the respawn.
"""

from __future__ import annotations

import atexit
import multiprocessing
import os
import signal
import sys
import threading
import weakref
from multiprocessing import forkserver, resource_tracker
from typing import Dict, List, Optional

from .. import fault
from ..fault import FailpointError, failpoint
from ..metrics import default_registry as _metrics
from ..metrics.spans import span
from . import shard_worker

# 0 disables the sharded path. The env var wins over the knob so A/B runs
# don't need a chain restart (same policy as the thread-parallel mode).
SHARDS_ENV = "CORETH_TPU_EVM_EXEC_SHARDS"
MAX_SHARDS = 16
# seconds a dispatch waits for a worker message before declaring the
# shard hung (hung shards are SIGKILLed and respawned)
TIMEOUT_ENV = "CORETH_TPU_SHARD_TIMEOUT_S"
DEFAULT_TIMEOUT_S = 30.0
# consecutive dispatch failures before the pool demotes to serial
DEMOTE_AFTER = 3
# blocks below this many txs aren't worth the pipe round-trips (mirrors
# parallel_exec.MIN_PARALLEL_TXS; kept local so this module imports
# without the EVM machinery)
MIN_SHARD_TXS = 2
# modules the forkserver imports before it forks any worker: the worker
# loop (first: importing it in the server also imports the parent's main
# module) and what its exec handler imports (none of them imports torch)
PRELOAD = ["coreth_tpu_torch.core.shard_worker",
           "coreth_tpu_torch.core.mvcc",
           "coreth_tpu_torch.core.state_transition",
           "coreth_tpu_torch.evm.evm"]

fault.register("exec/before_dispatch",
               "before shipping a block's txs to the shard pool")
fault.register("exec/shard_crash",
               "per exec request in the shard worker: raise = hard exit "
               "(crash), hang = parked for SIGKILL drills; a raise spec "
               "armed in the parent after the workers started translates "
               "to a real worker kill at dispatch")

_c_dispatches = _metrics.counter("exec/shard/dispatches")
_c_fallbacks = _metrics.counter("exec/shard/fallbacks")
_c_crashes = _metrics.counter("exec/shard/crashes")
_c_respawns = _metrics.counter("exec/shard/respawns")
_c_demotions = _metrics.counter("exec/shard/demotions")
_c_fork_guard = _metrics.counter("exec/shard/fork_guard_trips")
_g_workers = _metrics.gauge("exec/shard/workers")

# the pools not yet closed, for stop_servers
_open_pools: "weakref.WeakSet[ShardPool]" = weakref.WeakSet()
_stop_registered = False


def stop_servers() -> None:
    """Close every open ShardPool, then stop the forkserver its workers
    came from and multiprocessing's resource tracker, and wait for both
    to exit (module docstring). A pool made later starts them again."""
    for pool in list(_open_pools):
        pool.close()
    # the workers hold the tracker's pipe too: the server goes first
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _register_stop() -> None:
    # registered twice by a race, it stops twice: a no-op the second time
    global _stop_registered
    if not _stop_registered:
        _stop_registered = True
        atexit.register(stop_servers)


# `shard-telemetry-enabled` knob (the VM sets it from its config): gates
# the registry-merge of the worker-shipped ShardStats deltas (the
# piggyback itself always rides the reply, one small dict per dispatch,
# and the flight-record per-worker stamp stays on)
_telemetry_enabled = True


def set_telemetry_enabled(on: bool) -> None:
    global _telemetry_enabled
    _telemetry_enabled = bool(on)


def _merge_worker_stats(raw: Dict[int, dict]) -> None:
    """Fold one dispatch's worker ShardStats snapshots into the parent
    registry under exec/shard/worker/<i>/*. Called exactly once per
    fully-successful dispatch (a failed dispatch merges nothing, so a
    crash/respawn can never double-count); nothing while the telemetry
    switch is off."""
    if not _telemetry_enabled:
        return
    for i, snap in raw.items():
        prefix = f"exec/shard/worker/{i}/"
        for k, n in snap.get("counts", {}).items():
            _metrics.counter(prefix + k).inc(n)
        for k, s in snap.get("seconds", {}).items():
            _metrics.timer(prefix + k + "_seconds").update(s)


def per_worker_view(raw: Dict[int, dict]) -> Dict[str, dict]:
    """Compact flight-record stamp: each shard's dispatch decomposed into
    worker CPU (execute - pipe_wait) and pipe round-trip time."""
    view: Dict[str, dict] = {}
    for i in sorted(raw):
        snap = raw[i]
        counts = snap.get("counts", {})
        secs = snap.get("seconds", {})
        view[str(i)] = {
            "txs": counts.get("txs", 0),
            "spec_failures": counts.get("spec_failures", 0),
            "pipe_reads": counts.get("pipe_reads", 0),
            "execute_seconds": round(secs.get("execute", 0.0), 6),
            "pipe_wait_seconds": round(secs.get("pipe_wait", 0.0), 6),
        }
    return view


def effective_shards(cfg_val: Optional[int] = None) -> int:
    """CORETH_TPU_EVM_EXEC_SHARDS > evm_exec_shards knob > 0 (off)."""
    env = os.environ.get(SHARDS_ENV)
    if env is not None:
        try:
            return max(0, min(int(env), MAX_SHARDS))
        except ValueError:
            pass
    if cfg_val:
        return max(0, min(int(cfg_val), MAX_SHARDS))
    return 0


def dispatch_timeout() -> float:
    raw = os.environ.get(TIMEOUT_ENV, "")
    if raw:
        try:
            v = float(raw)
            if v > 0:
                return v
        except ValueError:
            pass
    return DEFAULT_TIMEOUT_S


class ShardFailure(Exception):
    """A shard crashed, hung, or shipped garbage — the caller must fall
    back to the serial loop (statedb untouched by construction)."""


class ShardVMError(Exception):
    """Parent-side stand-in for a VM error (revert, OOG, …) raised inside
    a shard worker: preserves `ExecutionResult.failed` (status-0
    receipts) and the repr; the original exception object stays in the
    child — only its consensus-relevant effect crosses the pipe."""


class _Worker:
    __slots__ = ("proc", "conn", "index", "failed")

    def __init__(self, proc, conn, index: int):
        self.proc = proc
        self.conn = conn
        self.index = index
        self.failed = False


class ShardPool:
    """A fixed-width pool of long-lived, crash-replaceable execution
    shard processes, each forked from the forkserver (module docstring).
    The chain config and the armed failpoints cross pickled at the start;
    per-block state crosses the per-worker duplex pipe."""

    def __init__(self, workers: int, chain_config):
        self.chain_config = chain_config
        self._ctx = multiprocessing.get_context("forkserver")
        self._ctx.set_forkserver_preload(PRELOAD)
        self._lock = threading.Lock()
        # one dispatch at a time: the workers' pipes are request/response
        self.dispatch_mu = threading.Lock()
        self.workers: List[_Worker] = []
        self.healthy = True
        self.consecutive_failures = 0
        self._closed = False
        # raw ShardStats snapshots from the last fully-successful
        # dispatch, {worker index: {"counts": ..., "seconds": ...}}
        self.last_worker_stats: Dict[int, dict] = {}
        shard_worker.export_main()
        _register_stop()
        _open_pools.add(self)
        for i in range(workers):
            self.workers.append(self._spawn(i))
        self.ping()
        _g_workers.update(workers)

    def _spawn(self, index: int) -> _Worker:
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=shard_worker.worker_main,
            args=(child_conn, index, self.chain_config,
                  fault.armed_state()),
            daemon=True, name=f"exec-shard-{index}",
        )
        proc.start()
        child_conn.close()
        return _Worker(proc, parent_conn, index)

    def ping(self, timeout: float = 10.0) -> List[tuple]:
        """Round-trip every worker, returning their pongs (shard_worker's
        protocol); raises ShardFailure on a dead or unresponsive one.
        Also the fork-guard checkpoint: a worker that reports inherited
        threads counts a fork_guard trip."""
        pongs: List[tuple] = []
        for w in self.workers:
            try:
                w.conn.send(("ping",))
                if not w.conn.poll(timeout):
                    raise ShardFailure(f"shard {w.index}: ping timeout")
                pong = w.conn.recv()
            except (EOFError, OSError) as exc:
                w.failed = True
                raise ShardFailure(f"shard {w.index}: {exc!r}") from exc
            if pong[0] != "pong":
                w.failed = True
                raise ShardFailure(f"shard {w.index}: bad pong {pong!r}")
            if pong[3] > 0:
                _c_fork_guard.inc(pong[3])
            pongs.append(pong)
        return pongs

    def pids(self) -> List[int]:
        return [w.proc.pid for w in self.workers]

    def kill_one(self) -> None:
        """Hard-exit one worker (chaos drills): best effort — the
        subsequent dispatch to it surfaces the death as a pipe EOF."""
        for w in self.workers:
            try:
                w.conn.send(("crash",))
            except OSError:
                w.failed = True
            return

    def respawn_failed(self) -> int:
        """Replace every dead/failed/hung worker with a fresh one."""
        respawned = 0
        with self._lock:
            if self._closed:
                return 0
            for i, w in enumerate(self.workers):
                if not w.failed and w.proc.is_alive():
                    continue
                if w.proc.is_alive():
                    w.proc.kill()  # hung: SIGKILL, never wait on it
                w.proc.join(timeout=2)
                w.conn.close()
                self.workers[i] = self._spawn(w.index)
                respawned += 1
                _c_respawns.inc()
        return respawned

    def note_dispatch(self, ok: bool) -> None:
        """Lifecycle ladder bookkeeping: DEMOTE_AFTER consecutive
        dispatch failures demote the pool to serial for good."""
        with self._lock:
            if ok:
                self.consecutive_failures = 0
                return
            self.consecutive_failures += 1
            if self.consecutive_failures >= DEMOTE_AFTER and self.healthy:
                self.healthy = False
                _c_demotions.inc()
        if not self.healthy:
            self.close()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            workers, self.workers = self.workers, []
        _open_pools.discard(self)
        for w in workers:
            try:
                w.conn.send(("exit",))
            except OSError:
                w.failed = True
            w.proc.join(timeout=2)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=2)
            w.conn.close()
        _g_workers.update(0)


# --------------------------------------------------------------------------
# dispatch


def _serve_read(env, msg):
    kind = msg[1]
    if kind == "account":
        return env.base.account(msg[2])
    if kind == "slot":
        return env.base.slot(msg[2], msg[3])
    if kind == "code":
        return env.base.code(msg[2])
    if kind == "blockhash":
        return env.block_ctx.get_hash(msg[2])
    raise ShardFailure(f"unknown read kind {kind!r}")


def _drive(worker: _Worker, req: dict, env, timeout: float,
           out: dict, errs: list, stats_out: dict) -> None:
    """One parent thread per busy worker: ship the exec request, serve
    base-state reads, collect the results. Anything that breaks the
    exchange (a protocol break, or a base read that raised, such as a
    device fault from a read that reached the device) marks the worker
    failed and lands in [errs] — the dispatch then fails whole."""
    conn = worker.conn
    try:
        conn.send(("exec", req))
        while True:
            if not conn.poll(timeout):
                raise ShardFailure(
                    f"shard {worker.index}: no response in {timeout:g}s")
            msg = conn.recv()
            kind = msg[0]
            if kind == "read":
                conn.send(("val", _serve_read(env, msg)))
            elif kind == "done":
                out[worker.index] = msg[1]
                stats_out[worker.index] = msg[2]
                return
            elif kind == "done_error":
                raise ShardFailure(
                    f"shard {worker.index}: result shipping failed: "
                    f"{msg[1]}")
            else:
                raise ShardFailure(
                    f"shard {worker.index}: unexpected {kind!r}")
    except BaseException as exc:  # noqa: BLE001 — _dispatch raises it
        # the worker may be waiting for a read's answer: it is out of
        # step with its pipe, so it is respawned before the next dispatch
        worker.failed = True
        errs.append(exc)


def run_shard_incarnations(pool: ShardPool, env) -> bool:
    """Distribute incarnation 0 of env's txs across the pool, install the
    shipped write-sets into the multi-version table, then run the
    existing `_final_sweep` on the calling thread. Returns the sweep's
    verdict (False → caller falls back serial); raises ShardFailure when
    the dispatch itself failed (crash/timeout/pickle), after respawning
    the dead workers and advancing the demotion ladder."""
    from .parallel_exec import _final_sweep

    failpoint("exec/before_dispatch")
    with pool.dispatch_mu:
        ok = _dispatch(pool, env)
    # the unchanged deterministic tail: ascending validate-or-re-execute
    # on this thread — exactly what anchors Block-STM's determinism
    return ok and _final_sweep(env)


def _dispatch(pool: ShardPool, env) -> bool:
    """run_shard_incarnations' exchange with the workers, under the pool's
    dispatch_mu. True once every tx's shipped result is published."""
    from .mvcc import _WriteSet
    from .parallel_exec import _TxResult
    from .state_transition import ExecutionResult

    spec = fault.armed_spec("exec/shard_crash")
    if spec is not None and not spec.startswith("hang"):
        # arming after the workers started is invisible to them; fire the
        # site here (deterministic, seeded, parent-side counters) and
        # translate a hit into a REAL worker death so the drill walks
        # the same pipe-EOF path as a genuine crash. `hang` specs are
        # child-side only — parking the dispatch thread would be a
        # different failure than the drill means to inject.
        try:
            failpoint("exec/shard_crash")
        except FailpointError:
            pool.kill_one()

    n = len(env.txs)
    workers = [w for w in pool.workers]
    nw = min(len(workers), n)
    if nw <= 0:
        raise ShardFailure("no live shard workers")
    _c_dispatches.inc()
    timeout = dispatch_timeout()

    # parent-side prefetch of the obviously-hot accounts (senders and
    # direct recipients) — cuts per-tx read round-trips without touching
    # the coinbase (a coinbase read must keep tripping _CoinbaseRead in
    # the child)
    prefetch_accounts: Dict[bytes, Optional[tuple]] = {}
    for msg in env.msgs:
        for addr in (msg.from_, msg.to):
            if addr is not None and addr != env.coinbase \
                    and addr not in prefetch_accounts:
                prefetch_accounts[addr] = env.base.account(addr)

    bc = env.block_ctx
    out: Dict[int, list] = {}
    stats_out: Dict[int, dict] = {}
    errs: List[BaseException] = []
    threads = []
    with span("exec/shard/dispatch", txs=n, workers=nw):
        for w in range(nw):
            indices = tuple(range(w, n, nw))
            req = {
                "indices": indices,
                "msgs": {i: env.msgs[i] for i in indices},
                "coinbase": bc.coinbase,
                "number": bc.block_number,
                "time": bc.time,
                "difficulty": bc.difficulty,
                "gas_limit": bc.gas_limit,
                "base_fee": bc.base_fee,
                "vm_config": env.vm_config,
                "prefetch": {"accounts": prefetch_accounts},
            }
            t = threading.Thread(
                target=_drive, args=(workers[w], req, env, timeout, out,
                                     errs, stats_out),
                name=f"shard-drive-{w}", daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()

    if errs:
        from ..device import DEVICE_FAULTS

        pool.respawn_failed()
        device_fault = next(
            (e for e in errs if isinstance(e, DEVICE_FAULTS)), None)
        if device_fault is not None:
            # the device failed, not a shard: no crash, no step towards
            # demotion, and no serial fallback — the caller gets the fault
            raise device_fault
        _c_crashes.inc(len(errs))
        pool.note_dispatch(False)
        raise ShardFailure(
            f"{len(errs)} shard(s) failed ({errs[0]}); serial fallback")
    pool.note_dispatch(True)
    # exactly-once merge point: only a dispatch where every drive thread
    # returned clean reaches here, and each reply's stats dict is that
    # dispatch's drained deltas (snapshot_and_reset on the child)
    pool.last_worker_stats = stats_out
    _merge_worker_stats(stats_out)

    results = sorted(r for rs in out.values() for r in rs)
    for i, err_repr, ws_parts, reads, gas_ops, res_parts in results:
        if err_repr is not None:
            # speculative child-side failure: leave the slot empty — the
            # sweep below re-executes tx i in the parent against final
            # state, where a genuine error forces the serial fallback
            continue
        ws = _WriteSet(*ws_parts)
        used_gas, vm_err_repr, return_data = res_parts
        vm_err = ShardVMError(vm_err_repr) if vm_err_repr is not None else None
        result = ExecutionResult(used_gas=used_gas, err=vm_err,
                                 return_data=return_data)
        env.table.publish(i, 0, ws)
        env.results[i] = _TxResult(0, result, None, ws, reads, gas_ops,
                                   env.msgs[i])
    return True


# --------------------------------------------------------------------------
# block entry point (third execution mode behind StateProcessor)


def execute_block_sharded(chain_config, block, parent, statedb, block_ctx,
                          vm_config, shards_n: int, pool: ShardPool):
    """execute_block's contract, on processes: returns ((receipts, logs,
    used_gas), stats) on success or (None, stats) — statedb untouched —
    when the block must run serially. Raises ShardFailure upward for
    dispatch-level failures (the caller's except-branch is the fallback,
    same as the thread-parallel mode)."""
    from ..device import DEVICE_FAULTS
    from .parallel_exec import (
        _BaseReader,
        _ExecEnv,
        _locked_block_ctx,
        _replay_gas_pool,
        _VersionedTable,
        BASE,
        CONFLICT_RATE_FALLBACK,
        fold_results,
        REEXEC_BUDGET_FACTOR,
        tx_as_message,
    )
    from .types import Signer

    txs = block.transactions
    n = len(txs)
    header = block.header
    stats = {"mode": "serial", "workers": shards_n, "conflicts": 0,
             "reexecs": 0, "deps": 0, "fallback": True}

    signer = Signer(chain_config.chain_id)
    try:
        msgs = [tx_as_message(tx, signer, header.base_fee) for tx in txs]
    except DEVICE_FAULTS:
        raise
    except Exception:
        # unrecoverable sender etc. — the serial loop raises the exact
        # ProcessorError for it
        _c_fallbacks.inc()
        return None, stats

    # same base contract as execute_block: fold the configure-precompiles
    # journal into the base before any worker reads through it
    statedb.finalise(True)

    env = _ExecEnv(chain_config, vm_config, _locked_block_ctx(block_ctx),
                   txs, msgs, _VersionedTable(), _BaseReader(statedb),
                   max(4, REEXEC_BUDGET_FACTOR * n))
    stats["workers"] = len(pool.workers)

    ok = run_shard_incarnations(pool, env)
    if ok:
        deps = 0
        for i in range(n):
            for ver in env.results[i].reads.values():
                if ver != BASE:
                    deps += 1
                    break
        stats["deps"] = deps
        if n >= 4 and deps > CONFLICT_RATE_FALLBACK * n:
            # serial-shaped block: same honesty rule as the in-process
            # mode — don't pretend the shards won it
            ok = False
    if ok:
        ok = _replay_gas_pool(env, header.gas_limit)

    stats["conflicts"] = env.conflicts
    stats["reexecs"] = env.reexecs
    if not ok:
        # fallback dispatches merge nothing: no per_worker stamp either,
        # so a failed block's flight record can't wear another dispatch's
        # worker stats
        _c_fallbacks.inc()
        return None, stats

    stats["per_worker"] = per_worker_view(pool.last_worker_stats)
    receipts, all_logs, used = fold_results(
        env.txs, env.results, env.coinbase, statedb, block)
    stats["mode"] = "shards"
    stats["fallback"] = False
    return (receipts, all_logs, used), stats


# --------------------------------------------------------------------------
# smoke: start, ping, SIGKILL, respawn, re-ping


def _smoke() -> int:
    pool = ShardPool(2, None)
    try:
        pids_before = pool.pids()
        os.kill(pids_before[0], signal.SIGKILL)
        pool.workers[0].proc.join(timeout=10)
        if pool.workers[0].proc.is_alive():
            print("shard smoke: FAIL (worker survived SIGKILL)")
            return 1
        respawned = pool.respawn_failed()
        if respawned != 1:
            print(f"shard smoke: FAIL (respawned {respawned}, want 1)")
            return 1
        pool.ping()
        pids_after = pool.pids()
        if pids_after[0] == pids_before[0]:
            print("shard smoke: FAIL (respawn reused the dead pid)")
            return 1
        print(f"shard smoke: OK (started {pids_before}, killed "
              f"{pids_before[0]}, respawned -> {pids_after[0]}, "
              f"{int(_c_respawns.count())} respawn(s))")
        return 0
    finally:
        pool.close()


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m coreth_tpu_torch.core.exec_shards",
        description="execution shard-pool utilities")
    p.add_argument("--smoke", action="store_true",
                   help="start a 2-worker pool, SIGKILL one, verify "
                        "the respawn")
    args = p.parse_args(argv)
    if args.smoke:
        return _smoke()
    p.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
