"""Child side of the process-level execution shards (core/exec_shards);
counterpart of coreth_tpu/core/shard_worker.py.

This module is the ONLY code that runs at a shard worker's top level.
Its module-level imports are the stdlib, `coreth_tpu_torch.fault` and
`coreth_tpu_torch.metrics.shardstats` (stdlib-only telemetry), with no
module-level mutable state and no touch of the parent's concurrency
surface: chainmu, the metrics registry, thread pools, the device
(tests/test_torch_isolation.py holds the imports to that). The EVM
machinery (`mvcc`, `evm.evm`, `state_transition`) is imported inside the
exec handler; none of it imports torch, and a worker never touches the
device.

The workers are started from a forkserver (core/exec_shards.py): each is
forked from a fresh single-threaded interpreter, never from the parent,
so it inherits no CUDA context and no parent thread. The chain config
arrives pickled in the start arguments, with the parent's armed
failpoints (fault.armed_state) at the moment of the start.

The parent's main module is imported once, in the server, and each
worker inherits it. A process that multiprocessing does not fork from
the parent imports the parent's main module before it runs (so that what
was pickled from it unpickles), unless it finds it imported already. The
forkserver means to import it once when '__main__' is among its preloads,
but Python 3.12 never hands the server the main module's path
(ForkServer.ensure_running keeps the preparation keys 'main_path' and
'sys_path'; the path is under 'init_main_from_path'), so every worker
would import it anew: for a script that imports torch, seconds at each
start and respawn. So the parent puts its pid and its main module's
preparation in MAIN_ENV (export_main) before it starts a worker, and
this module, the server's first preload, runs that preparation once
when it is imported in that parent's forkserver (_adopt_parent_main).

Protocol (one duplex Pipe per worker, strict request/response, child is
single-threaded):

    parent -> child   ("ping",)            liveness + isolation probe
                      ("exit",)            clean retirement
                      ("crash",)           hard os._exit (chaos drills)
                      ("exec", req)        execute assigned tx indices
    child  -> parent  ("pong", index, pid, stale_threads,
                       cuda_initialized, refused_modules)
                      ("read", kind, ...)  base-state miss, served by the
                                           parent from its _BaseReader /
                                           overlay / BLOCKHASH resolver
                      ("done", results, stats)
                                           per-tx result tuples + this
                                           dispatch's ShardStats deltas
                                           (two flat str->number dicts)
                      ("done_error", r)    results failed to pickle

`cuda_initialized` is torch.cuda.is_initialized() when torch is loaded
(False otherwise) and `refused_modules` lists any jax, jaxlib or
coreth_tpu module in the worker's sys.modules: both must stay empty.

Each assigned tx executes incarnation 0 against an EMPTY multi-version
table: every read resolves to BASE and is recorded as such, so the
parent's `_final_sweep` validates the recorded versions against the real
table (which holds every tx's published write-set) and re-executes, in
the parent, exactly the txs that read something a lower-indexed tx
wrote. Distributed incarnation-0 + the existing deterministic serial
validation sweep — no new trust, bit-exact by the same argument as
Block-STM's.

Fault contract: the worker fires `exec/shard_crash` once per exec
request. A `raise` spec hard-exits the process (indistinguishable from a
crash to the parent); a `hang` spec parks the child so SIGKILL drills can
take it down mid-block. Arming is inherited from the parent at the
worker's start, whether it came from `CORETH_TPU_FAILPOINTS` or from
set_failpoint, which is what makes the drills env-replayable.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from multiprocessing import process, spawn

from .. import fault
from ..metrics.shardstats import ShardStats

# exit code for a failpoint-induced hard death; distinct from a SIGKILL's
# negative exitcode but equally "no cleanup ran"
CRASH_EXIT = 13
# packages a worker must never load (the port stands alone)
REFUSED = ("jax", "jaxlib", "coreth_tpu")
# "<parent pid>:<JSON of the parent's main-module preparation>"
MAIN_ENV = "CORETH_TPU_SHARD_MAIN"
# how the forkserver's interpreter is started (multiprocessing.forkserver)
_FORKSERVER_CMD = "from multiprocessing.forkserver import main"


def export_main() -> None:
    """Parent side, before a worker starts: publish the main module's
    preparation (spawn.get_preparation_data's init_main_from_path or
    init_main_from_name) for the forkserver this process starts."""
    prep = {k: v for k, v in spawn.get_preparation_data("exec-shard").items()
            if k.startswith("init_main_from_")}
    value = f"{os.getpid()}:{json.dumps(prep)}"
    if os.environ.get(MAIN_ENV) != value:
        os.environ[MAIN_ENV] = value


def _adopt_parent_main() -> None:
    """Server side: import the parent's main module as a worker would
    (spawn.prepare, under the same bootstrapping guard the forkserver
    uses), so that every worker forked from here finds it imported. Runs
    only in a forkserver started by the process that exported MAIN_ENV.
    If the import fails, each worker imports the module itself, as it
    would without this."""
    pid, _, prep = os.environ.get(MAIN_ENV, "").partition(":")
    if (not pid.isdigit() or int(pid) != os.getppid()
            or not sys.orig_argv[-1].startswith(_FORKSERVER_CMD)):
        return
    current = process.current_process()
    current._inheriting = True
    try:
        spawn.prepare(json.loads(prep))
    except Exception:  # noqa: BLE001 — each worker then imports it itself
        pass
    finally:
        del current._inheriting


class _PipeBase:
    """`_BaseReader`-shaped read source that answers from the prefetch
    cache and serves misses over the pipe. Memoised: each (kind, key) is
    one round-trip for the life of the exec request."""

    __slots__ = ("conn", "accounts", "slots", "codes", "stats")

    def __init__(self, conn, prefetch, stats=None):
        self.conn = conn
        self.accounts = dict(prefetch.get("accounts", {}))
        self.slots = dict(prefetch.get("slots", {}))
        self.codes = dict(prefetch.get("codes", {}))
        self.stats = stats

    def _rpc(self, kind, *args):
        if self.stats is not None:
            self.stats.inc("pipe_reads")
            with self.stats.timed("pipe_wait"):
                self.conn.send(("read", kind) + args)
                _tag, val = self.conn.recv()
            return val
        self.conn.send(("read", kind) + args)
        _tag, val = self.conn.recv()
        return val

    def account(self, addr):
        """(nonce, balance, code_hash, is_multi_coin) or None (absent)."""
        if addr in self.accounts:
            return self.accounts[addr]
        v = self._rpc("account", addr)
        self.accounts[addr] = v
        return v

    def slot(self, addr, key):
        sk = (addr, key)
        v = self.slots.get(sk)
        if v is None:
            v = self._rpc("slot", addr, key)
            self.slots[sk] = v
        return v

    def code(self, addr):
        c = self.codes.get(addr)
        if c is None:
            c = self._rpc("code", addr)
            self.codes[addr] = c
        return c


def _handle_exec(conn, chain_config, req, stats: ShardStats) -> None:
    # the per-request crash site: raise -> hard exit (the parent sees a
    # dead pipe, exactly like a real crash); hang -> parked, SIGKILL-able
    try:
        fault.failpoint("exec/shard_crash")
    except fault.FailpointError:
        os._exit(CRASH_EXIT)

    from ..evm.evm import EVM, BlockContext, TxContext
    from .mvcc import (
        _RecordingGasPool,
        _VersionedTable,
        VersionedStateView,
    )
    from .state_transition import apply_message

    def get_hash(n, conn=conn):
        conn.send(("read", "blockhash", n))
        _tag, val = conn.recv()
        return val

    block_ctx = BlockContext(
        coinbase=req["coinbase"],
        block_number=req["number"],
        time=req["time"],
        difficulty=req["difficulty"],
        gas_limit=req["gas_limit"],
        base_fee=req["base_fee"],
        get_hash=get_hash,
    )
    base = _PipeBase(conn, req["prefetch"], stats)
    # deliberately EMPTY and never published to: every read resolves to
    # BASE, and the parent's sweep validates those versions for real
    table = _VersionedTable()
    evm = EVM(block_ctx, TxContext(), None, chain_config, req["vm_config"])
    coinbase = req["coinbase"]
    msgs = req["msgs"]

    out = []
    with stats.timed("execute"):
        for i in req["indices"]:
            msg = msgs[i]
            view = VersionedStateView(table, base, i, coinbase)
            gp = _RecordingGasPool()
            evm.reset(
                TxContext(origin=msg.from_, gas_price=msg.gas_price), view)
            try:
                result = apply_message(evm, msg, gp)
                ws = view.build_write_set()
                out.append((
                    i, None,
                    (ws.accounts, ws.storage, ws.barriers, ws.logs,
                     ws.preimages, ws.fee),
                    view.reads, gp.ops,
                    (result.used_gas,
                     repr(result.err) if result.err is not None else None,
                     result.return_data),
                ))
                stats.inc("txs")
            except Exception as exc:
                # speculative failure (coinbase read, validation error, …):
                # ship the marker; the parent leaves the slot empty and its
                # sweep re-executes tx i against final state
                err_repr = repr(exc)
                out.append((i, err_repr, None, None, None, None))
                stats.inc("spec_failures")
    try:
        # "execute" above includes time parked in _PipeBase pipe waits;
        # the parent derives worker-CPU as execute - pipe_wait
        conn.send(("done", out, stats.snapshot_and_reset()))
    except Exception as exc:
        # unpicklable write-set member — reduce to an error the parent
        # turns into a serial fallback
        err_repr = repr(exc)
        conn.send(("done_error", err_repr))


def _cuda_initialized() -> bool:
    """torch.cuda.is_initialized() without importing torch: a worker that
    never loaded torch cannot have touched the device."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def _refused_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)


def worker_main(conn, index: int, chain_config, armed) -> None:
    """Long-lived worker loop. `chain_config` and `armed` (the parent's
    fault.armed_state()) arrive pickled in the start arguments;
    everything per-block crosses the pipe."""
    fault.child_after_fork()
    fault.adopt_armed(armed)
    # a worker forked from the forkserver starts single-threaded; anything
    # visible here is a thread the server carried (the parent counts
    # these as exec/shard/fork_guard_trips)
    stale_threads = threading.active_count() - 1
    # function-local (no module-level mutable state); deltas drain into
    # each ("done", out, stats) reply
    stats = ShardStats()
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        kind = msg[0]
        if kind == "ping":
            conn.send(("pong", index, os.getpid(), stale_threads,
                       _cuda_initialized(), _refused_modules()))
        elif kind == "exit":
            return
        elif kind == "crash":
            os._exit(CRASH_EXIT)
        elif kind == "exec":
            _handle_exec(conn, chain_config, msg[1], stats)
        else:
            conn.send(("error", f"unknown message kind {kind!r}"))


_adopt_parent_main()
