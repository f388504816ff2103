"""VM-level RPC APIs: avax namespace, admin, health (semantics of coreth
plugin/evm/{service,admin,health}.go); counterpart of coreth_tpu/vm/api.py.

create_handlers() assembles the full RPC surface the reference exposes at
/ext/bc/C/{rpc,avax,admin} (vm.go:1138-1186 CreateHandlers).
"""

from __future__ import annotations

from typing import Optional

from ..eth.api import EthAPI, PersonalAPI, hb, hx, parse_addr, parse_bytes
from ..eth.backend import EthBackend
from ..eth.tracers import DebugAPI
from ..rpc.admission import ServingPolicy
from ..rpc.server import RPCError, RPCServer
from .atomic_backend import TX_INDEX_PREFIX
from .atomic_tx import decode_tx
from .config import DEFAULT_ETH_APIS, Config


class AvaxAPI:
    """avax.* handlers (service.go:89-460): issueTx/getAtomicTx/getUTXOs."""

    def __init__(self, vm):
        self.vm = vm

    def issueTx(self, tx_bytes: str) -> dict:
        tx = decode_tx(parse_bytes(tx_bytes))
        self.vm.issue_atomic_tx(tx)
        return {"txID": hb(tx.id())}

    def getAtomicTxStatus(self, tx_id: str) -> dict:
        tid = parse_bytes(tx_id)
        if self.vm.mempool.has(tid):
            return {"status": "Processing"}
        blob = self.vm.blockchain.diskdb.get(TX_INDEX_PREFIX + tid)
        if blob is not None:
            height = int.from_bytes(blob[:8], "big")
            return {"status": "Accepted", "blockHeight": hx(height)}
        return {"status": "Unknown"}

    def getAtomicTx(self, tx_id: str) -> dict:
        tid = parse_bytes(tx_id)
        tx = self.vm.mempool.get(tid)
        if tx is not None:
            return {"tx": hb(tx.encode()), "blockHeight": None}
        blob = self.vm.blockchain.diskdb.get(TX_INDEX_PREFIX + tid)
        if blob is not None:
            return {
                "tx": hb(blob[8:]),
                "blockHeight": hx(int.from_bytes(blob[:8], "big")),
            }
        raise RPCError(-32000, "transaction not found")

    def getUTXOs(self, addresses, source_chain: str = "", limit: int = 100) -> dict:
        """UTXOs owned by [addresses] in this chain's inbound namespace."""
        if isinstance(addresses, str):
            addresses = [addresses]
        addrs = [parse_bytes(a) for a in addresses]
        source = parse_bytes(source_chain) if source_chain else self.vm.ctx.x_chain_id
        utxos, _, last = self.vm.shared_memory.indexed(
            source, addrs, limit=limit
        )
        return {
            "numFetched": hx(len(utxos)),
            "utxos": [hb(u) for u in utxos],
            "endIndex": hb(last) if last else None,
        }

    def version(self) -> dict:
        return {"version": "coreth-tpu/0.1.0"}

    # --- key management + wallet-side atomic txs (service.go:108-460) ----
    # The reference scopes keys to an avalanchego per-user keystore
    # (username+password); this framework's analog is the node's
    # directory keystore (accounts/keystore.py) with per-key passwords —
    # the password plays both roles, so the RPC shapes keep the
    # reference's field names minus `username`.

    def _keystore(self):
        from ..eth.backend import require_keystore

        return require_keystore(getattr(self.vm, "keystore", None))

    def importKey(self, password: str, privateKey: str) -> dict:
        """service.go:141 ImportKey: store a private key, return its
        EVM address."""
        priv = parse_bytes(privateKey)
        if len(priv) != 32:
            raise RPCError(-32602, "private key must be 32 bytes")
        acct = self._keystore().import_key(priv, password)
        return {"address": hb(acct.address)}

    def exportKey(self, password: str, address: str) -> dict:
        """service.go:108 ExportKey: reveal the private key for an owned
        address (password-checked)."""
        from ..accounts.keystore import KeyStoreError

        try:
            priv = self._keystore().export_key(parse_addr(address), password)
        except KeyStoreError as e:
            raise RPCError(-32000, str(e))
        return {"privateKey": hb(priv)}

    def _unlocked_keys(self, password: str):
        """Decrypt every keystore key the password opens (the analog of
        the reference's per-user key list)."""
        from ..accounts.keystore import KeyStoreError

        ks = self._keystore()
        keys = []
        for acct in ks.accounts():
            try:
                keys.append(ks.export_key(acct.address, password))
            except KeyStoreError:
                continue
        if not keys:
            raise RPCError(-32000, "password unlocks no keystore keys")
        return keys

    def _import_impl(self, password: str, to: str,
                     sourceChain: str = "") -> dict:
        """service.go Import: build+sign+issue an ImportTx consuming the
        keystore's UTXOs from [sourceChain] to EVM address [to].
        Registered EXPLICITLY as wire method "avax_import" ("import" is a
        python keyword; the leading underscore keeps register_api from
        exposing a stray avax_import_ alias)."""
        from .atomic_tx import AtomicTxError
        from .tx_builder import new_import_tx

        source = (parse_bytes(sourceChain) if sourceChain
                  else self.vm.ctx.x_chain_id)
        try:
            tx = new_import_tx(
                self.vm, parse_addr(to), source,
                self._unlocked_keys(password))
            self.vm.issue_atomic_tx(tx)
        except AtomicTxError as e:
            raise RPCError(-32000, str(e))
        return {"txID": hb(tx.id())}

    def export(self, password: str, amount, to: str,
               destinationChain: str = "", assetID: str = "") -> dict:
        """service.go Export/ExportAVAX: build+sign+issue an ExportTx of
        [amount] nAVAX (or [assetID] units) to [to] on the destination
        chain."""
        from .atomic_tx import AtomicTxError
        from .tx_builder import new_export_tx

        dest = (parse_bytes(destinationChain) if destinationChain
                else self.vm.ctx.x_chain_id)
        asset = parse_bytes(assetID) if assetID else self.vm.avax_asset_id
        amt = amount if isinstance(amount, int) else int(amount, 0)
        try:
            tx = new_export_tx(
                self.vm, amt, asset, dest, parse_addr(to),
                self._unlocked_keys(password))
            self.vm.issue_atomic_tx(tx)
        except AtomicTxError as e:
            raise RPCError(-32000, str(e))
        return {"txID": hb(tx.id())}


class _StackSampler:
    """All-thread statistical CPU profiler: a daemon thread samples
    sys._current_frames() on an interval and aggregates hit counts per
    (file, line, function). Covers work on every thread — the property a
    deterministic per-thread profiler can't give an RPC-driven node."""

    def __init__(self, interval: float = 0.005):
        import threading

        self.interval = interval
        self.samples = 0
        self.counts: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()

    def _run(self):
        import sys
        import time

        me = self._thread.ident
        while not self._stop.is_set():
            for tid, frame in list(sys._current_frames().items()):
                if tid == me:
                    continue
                self.samples += 1
                while frame is not None:
                    code = frame.f_code
                    key = (code.co_filename, frame.f_lineno, code.co_name)
                    self.counts[key] = self.counts.get(key, 0) + 1
                    frame = frame.f_back
            time.sleep(self.interval)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)

    def dump(self, path: str):
        rows = sorted(self.counts.items(), key=lambda kv: -kv[1])
        with open(path, "w") as f:
            f.write(f"# stack samples: {self.samples}\n")
            for (fn, line, name), n in rows[:500]:
                f.write(f"{n}\t{fn}:{line}\t{name}\n")


class ContinuousProfiler:
    """startContinuousProfiler (vm.go:1642 + config.go:89-91): rolls a
    CPU stack-sample profile to disk every [freq] seconds, keeping
    [max_files] generations (cpu.profile.1 newest)."""

    def __init__(self, profile_dir: str, freq: float = 900.0,
                 max_files: int = 5):
        import threading

        self.dir = profile_dir
        self.freq = freq
        self.max_files = max_files
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._sampler = None

    def start(self):
        self._thread.start()
        return self

    def _roll(self):
        import os

        os.makedirs(self.dir, exist_ok=True)
        for i in range(self.max_files - 1, 0, -1):
            src = os.path.join(self.dir, f"cpu.profile.{i}")
            if os.path.exists(src):
                os.replace(src, os.path.join(self.dir, f"cpu.profile.{i + 1}"))
        if self._sampler is not None:
            self._sampler.stop()
            self._sampler.dump(os.path.join(self.dir, "cpu.profile.1"))
        self._sampler = _StackSampler(interval=0.01)
        self._sampler.start()

    def _run(self):
        self._roll()
        while not self._stop.wait(self.freq):
            self._roll()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
        if self._sampler is not None:
            self._sampler.stop()


class AdminAPI:
    """coreth-admin (admin.go:29-62). Profiles are real artifacts written
    to [profile_dir] (admin.go performanceProfile dir): CPU via an
    all-thread stack sampler, memory via tracemalloc/gc snapshot,
    lock/stack via a faulthandler-style all-thread dump."""

    def __init__(self, vm, profile_dir: str = None):
        import tempfile

        self.vm = vm
        self.log_level = "info"
        self.profile_dir = profile_dir or tempfile.mkdtemp(prefix="coreth_tpu_prof_")
        self._cpu_profiler = None

    def _path(self, name: str) -> str:
        import os

        os.makedirs(self.profile_dir, exist_ok=True)
        return os.path.join(self.profile_dir, name)

    def setLogLevel(self, level: str) -> bool:
        from .. import log

        log.set_level(level)  # raises on unknown levels
        self.log_level = level
        return True

    # --- chain export/import (eth/api.go Admin ExportChain/ImportChain) --

    def exportChain(self, path: str, first: int = None,
                    last: int = None) -> bool:
        """admin_exportChain: write blocks [first..last] (accepted chain,
        defaults: genesis..head) as length-prefixed RLP to [path]."""
        import struct

        chain = self.vm.blockchain
        lo = int(first) if first is not None else 0
        hi = int(last) if last is not None else chain.last_accepted.number
        if lo > hi:
            raise RPCError(-32602, "first must be <= last")
        with open(path, "wb") as f:
            for n in range(lo, hi + 1):
                blk = chain.get_block_by_number(n)
                if blk is None:
                    raise RPCError(-32000, f"block {n} not found")
                raw = blk.encode()
                f.write(struct.pack(">I", len(raw)) + raw)
        return True

    def importChain(self, path: str) -> bool:
        """admin_importChain: insert + accept each block from an
        exportChain file (blocks already known are skipped, like the
        reference's hasAllBlocks fast path)."""
        import struct

        from ..core.types import Block

        chain = self.vm.blockchain
        with open(path, "rb") as f:
            while True:
                hdr = f.read(4)
                if not hdr:
                    break
                (n,) = struct.unpack(">I", hdr)
                blk = Block.decode(f.read(n))
                if chain.get_block(blk.hash()) is not None:
                    continue  # already have it
                chain.insert_block(blk)
                chain.accept(blk)
        chain.drain_acceptor_queue()
        return True

    def startCPUProfiler(self) -> bool:
        """Statistical profiler sampling ALL thread stacks (RPC handlers
        run on per-request threads, so a deterministic per-thread profiler
        would only ever see its own handler thread)."""
        if self._cpu_profiler is not None:
            raise RuntimeError("CPU profiler already running")
        self._cpu_profiler = _StackSampler(interval=0.005)
        self._cpu_profiler.start()
        return True

    def stopCPUProfiler(self) -> bool:
        if self._cpu_profiler is None:
            raise RuntimeError("CPU profiler not running")
        p, self._cpu_profiler = self._cpu_profiler, None
        p.stop()
        p.dump(self._path("cpu.profile"))
        return True

    def memoryProfile(self) -> bool:
        """Heap snapshot. Uses a tracemalloc snapshot when tracing was
        enabled externally (full alloc-site detail); otherwise a gc-walk
        summary by type — zero standing overhead either way."""
        import tracemalloc

        with open(self._path("mem.profile"), "w") as f:
            if tracemalloc.is_tracing():
                for stat in tracemalloc.take_snapshot().statistics("lineno")[:200]:
                    f.write(f"{stat}\n")
            else:
                import gc
                import sys as _sys
                from collections import Counter

                by_type: Counter = Counter()
                bytes_by_type: Counter = Counter()
                for o in gc.get_objects():
                    t = type(o).__name__
                    by_type[t] += 1
                    try:
                        bytes_by_type[t] += _sys.getsizeof(o)
                    except Exception:
                        pass
                for t, n in by_type.most_common(200):
                    f.write(f"{t}: count={n} bytes={bytes_by_type[t]}\n")
        return True

    def lockProfile(self) -> bool:
        """Per-thread stack dump (closest host analog of the mutex
        profile): which threads are parked where."""
        import sys
        import traceback

        with open(self._path("lock.profile"), "w") as f:
            for tid, frame in sys._current_frames().items():
                f.write(f"--- thread {tid}\n")
                f.write("".join(traceback.format_stack(frame)))
        return True


class TxPoolAPI:
    """txpool namespace (internal/ethapi TxPoolAPI)."""

    def __init__(self, backend):
        self.b = backend

    def status(self) -> dict:
        pending, queued = self.b.txpool.stats()
        return {"pending": hx(pending), "queued": hx(queued)}

    def content(self) -> dict:
        out = {"pending": {}, "queued": {}}
        for addr, txs in self.b.txpool.pending_txs().items():
            out["pending"][hb(addr)] = {
                str(t.nonce): hb(t.hash()) for t in txs
            }
        return out

    def contentFrom(self, address: str) -> dict:
        """txpool_contentFrom (api.go ContentFrom): one account's slice
        of content."""
        addr = parse_addr(address)
        txs = self.b.txpool.pending_txs().get(addr, [])
        return {"pending": {str(t.nonce): hb(t.hash()) for t in txs},
                "queued": {}}

    def inspect(self) -> dict:
        """txpool_inspect (api.go Inspect): human-oriented one-line tx
        summaries, geth's '<to>: <value> wei + <gas> gas x <price> wei'
        format."""
        out = {"pending": {}, "queued": {}}
        for addr, txs in self.b.txpool.pending_txs().items():
            out["pending"][hb(addr)] = {
                str(t.nonce): (
                    f"{hb(t.to) if t.to else 'contract creation'}: "
                    f"{t.value} wei + {t.gas} gas x "
                    f"{t.gas_fee_cap} wei")
                for t in txs
            }
        return out


class NetAPI:
    def __init__(self, network_id: int):
        self._id = network_id

    def version(self) -> str:
        return str(self._id)

    def listening(self) -> bool:
        return True

    def peerCount(self) -> str:
        return hx(0)


class Web3API:
    def clientVersion(self) -> str:
        return "coreth-tpu/0.1.0"

    def sha3(self, data: str) -> str:
        from ..native import keccak256

        return hb(keccak256(parse_bytes(data)))


class FiltersAPI:
    """eth_newFilter family bridged onto the FilterSystem."""

    def __init__(self, backend):
        self.b = backend

    def newFilter(self, crit: dict) -> str:
        return self.b.filters.new_log_filter(crit)

    def newBlockFilter(self) -> str:
        return self.b.filters.new_block_filter()

    def newPendingTransactionFilter(self) -> str:
        return self.b.filters.new_pending_tx_filter()

    def uninstallFilter(self, fid: str) -> bool:
        return self.b.filters.uninstall(fid)

    def getFilterChanges(self, fid: str) -> list:
        items = self.b.filters.get_changes(fid)
        out = []
        api = EthAPI(self.b)
        for item in items:
            if isinstance(item, bytes):
                out.append(hb(item))
            else:
                out.append(api._marshal_log(item, 0))
        return out


def health_check(vm) -> dict:
    """health.go: the VM is healthy when the acceptor is alive AND the
    RPC front door is not mid-drain — a draining node must drop out of
    its load balancer (503) before the lanes start shedding, not
    after."""
    out = {
        "healthy": vm.blockchain.acceptor_error is None,
        "lastAcceptedHeight": vm.blockchain.last_accepted.number,
        "error": vm.blockchain.acceptor_error,
    }
    if getattr(vm.blockchain, "degraded", False):
        # degraded read-only rung (storage write failure): the node
        # still serves reads so it stays in the LB pool, but operators
        # see the rung on every health poll
        out["degraded"] = True
    server = getattr(vm, "rpc_server", None)
    if server is not None and getattr(server, "draining", False):
        out["healthy"] = False
        out["draining"] = True
    return out


class DebugMetricsAPI:
    """Observability half of the debug namespace (go-ethereum's
    debug/metrics.go Metrics + the flight-recorder/span surface this repo
    adds). Registered alongside the tracing DebugAPI under the same
    eth-apis gate."""

    def __init__(self, vm):
        self.vm = vm

    def metrics(self) -> dict:
        """debug_metrics: JSON dump of every registered metric, plus the
        device ladder's status (state, last error, knobs) and any cached
        device-resolution failure under ops/device/status."""
        from ..metrics import default_registry
        from ..ops import device

        out = default_registry.marshal()
        status = device.default_ladder().status()
        status["resolve_error"] = device.resolution_error()
        out["ops/device/status"] = status
        return out

    def blockFlightRecord(self, n: Optional[int] = None,
                          accepted_only: bool = True) -> list:
        """debug_blockFlightRecord: per-phase timings + counter deltas
        for the last N accepted blocks (accepted_only=False includes
        inserted-but-not-yet-accepted blocks)."""
        from ..metrics.flight import marshal_record

        recs = self.vm.blockchain.flight_recorder.last(
            n=n, accepted_only=accepted_only)
        return [marshal_record(r) for r in recs]

    def spanDump(self, clear: bool = False) -> dict:
        """debug_spanDump: finished spans as Chrome trace-event JSON
        (load the result straight into Perfetto)."""
        from ..metrics.spans import tracer

        return tracer.chrome_trace(clear=bool(clear))

    def profileDump(self, fmt: str = "json") -> object:
        """debug_profileDump: the sampling profiler's bounded
        collapsed-stack table. fmt="collapsed" returns flamegraph-ready
        text (`role;frame;...;frame count` lines, pipe straight into
        flamegraph.pl); anything else returns the full JSON dump
        (per-role sample counts, lock-tagged stacks, overflow count).
        Empty/running=False when profiler-hz is 0."""
        from ..metrics.profiler import profile_dump

        dump = profile_dump()
        if fmt == "collapsed":
            return dump.get("collapsed", "")
        return dump

    def lockStatus(self) -> dict:
        """debug_lockStatus: per-canonical-lock contention table (wait/
        hold counts, totals, p99s) ranked by total measured acquire-wait,
        plus the slow-hold budget and the recent budget-breach captures
        (traceback + trace id). Rows appear once a LockOrderWitness (the
        chaos conductor's, fault/chaos.py) or RaceDetector.require_lock
        instruments the lock; a node with none answers empty tables. The
        budget is the lock-slow-hold-budget knob."""
        from ..utils import racecheck

        return {
            "slow_hold_budget_seconds": racecheck.slow_hold_budget(),
            "contention": racecheck.contention_table(),
            "recent_slow_holds": racecheck.recent_slow_holds(),
        }

    def setSpans(self, enabled: bool) -> bool:
        """debug_setSpans: toggle span collection process-wide at
        runtime; returns the new state."""
        from ..metrics import spans

        spans.set_enabled(bool(enabled))
        return spans.enabled

    def setExpensiveMetrics(self, enabled: bool) -> bool:
        """debug_setExpensiveMetrics: flip the EnabledExpensive gate
        process-wide at runtime; returns the new state."""
        from .. import metrics as _metrics

        _metrics.enabled_expensive = bool(enabled)
        return _metrics.enabled_expensive

    def setFailpoint(self, name: str, spec: Optional[str] = None) -> list:
        """debug_setFailpoint: arm failpoint [name] with [spec]
        ("raise[:msg]" / "hang[:ms]" with optional "%prob" / "*count" —
        coreth_tpu/fault), or disarm it when spec is empty. Returns the
        currently-armed list. Unknown names error (the registry is the
        source of truth; see debug_listFailpoints)."""
        from .. import fault

        fault.set_failpoint(name, spec or None)
        return fault.list_armed()

    def listFailpoints(self) -> dict:
        """debug_listFailpoints: every registered failpoint site with its
        description, plus the currently-armed specs and fire counts."""
        from .. import fault

        return {"registered": fault.registered(),
                "armed": fault.list_armed()}

    def deviceStatus(self) -> dict:
        """debug_deviceStatus: the degradation ladder's current state
        (healthy/demoted/probation), last error, and knobs."""
        from ..ops import device

        status = device.default_ladder().status()
        status["resolve_error"] = device.resolution_error()
        return status

    def flightEvents(self, n: Optional[int] = None,
                     kind: Optional[str] = None) -> list:
        """debug_flightEvents: out-of-band lifecycle events from the
        flight recorder (device demotions/re-promotions, mirror
        takeovers/quarantines, torn-tail repairs), newest last."""
        return self.vm.blockchain.flight_recorder.events(n=n, kind=kind)

    def rpcStatus(self) -> dict:
        """debug_rpcStatus: live serving-overload state — lane queue
        depths/inflight, breaker state, drain status (ROBUSTNESS.md
        "Serving under overload")."""
        server = getattr(self.vm, "rpc_server", None)
        if server is None:
            return {"pooled": False}
        return server.serving_status()

    def traceRequest(self, trace_id: Optional[str] = None,
                     n: Optional[int] = None) -> object:
        """debug_traceRequest: span tree + admission/deadline/lane
        metadata for one captured trace id — or, with no id, the last N
        captured traces (newest last). The capture ring holds only
        interesting traces: sheds, deadline expiries, abandoned handlers,
        failed inserts, and completions slower than the SLO budget."""
        from ..metrics import tracectx

        if trace_id is None:
            return tracectx.ring.last(16 if n is None else int(n))
        rec = tracectx.ring.get(str(trace_id))
        if rec is None:
            raise RPCError(
                -32000,
                f"trace {trace_id} not captured (completed under budget, "
                "tracing disabled, or evicted from the ring)")
        return rec

    def sloStatus(self) -> dict:
        """debug_sloStatus: per-method latency percentiles from the
        slo/* histograms vs the configured budgets — the live view of
        the exposition's SLO families."""
        from ..metrics import default_registry

        server = getattr(self.vm, "rpc_server", None)
        policy = getattr(server, "policy", None)
        chain = getattr(self.vm, "blockchain", None)
        cache_cfg = getattr(chain, "cache_config", None)
        series = {}
        for name, m in default_registry.each():
            if not name.startswith("slo/") or not hasattr(m, "percentile"):
                continue
            p50, p90, p99 = m.percentiles((0.50, 0.90, 0.99))
            series[name] = {
                "count": m.count(), "p50": p50, "p90": p90, "p99": p99,
            }
        return {
            "rpcSloBudget": getattr(policy, "slo_budget", None),
            "chainInsertSloBudget": getattr(
                cache_cfg, "insert_slo_budget", None),
            "series": series,
        }

    def syncStatus(self) -> dict:
        """debug_syncStatus: bootstrap progress — peers by ladder state
        (healthy/suspect/quarantined with scores and failure kinds),
        per-segment trie progress, and the pivot history (ROBUSTNESS.md
        "Bootstrap under Byzantine peers")."""
        sync_client = getattr(self.vm, "state_sync_client", None)
        if sync_client is None:
            return {"syncing": False}
        out = sync_client.status()
        out["syncing"] = True
        return out


class DebugCommitmentAPI:
    """Commitment-backend surface of the debug namespace (COMMITMENT.md):
    both backends answer proofs through this one API — MPT node-list
    proofs via debug_getProof, binary-Merkle compact witnesses via
    debug_stateWitness — plus the dual-root shadow's live status."""

    def __init__(self, vm, eth_api):
        self.vm = vm
        self._eth = eth_api

    def _shadow(self):
        shadow = getattr(self.vm.blockchain.state_database, "shadow", None)
        if shadow is None:
            raise RPCError(
                -32000,
                "no commitment shadow mounted (state-backend is not "
                "bintrie-shadow)")
        return shadow

    def getProof(self, address: str, storage_keys: list,
                 block: str = "latest") -> dict:
        """debug_getProof: eth_getProof-shaped MPT account/storage proof
        (same marshalling, served under the debug gate so proof triage
        works even on nodes that trim the eth namespace)."""
        return self._eth.getProof(address, storage_keys, block)

    def stateWitness(self, address: str, block: str = "latest") -> dict:
        """debug_stateWitness: compact binary-Merkle witness for
        [address]'s account leaf against the shadow bintrie root of
        [block]'s state. The blob is self-contained: verify_witness
        (bintrie/witness.py) checks it against `bintrieRoot` with no
        store access, and absorbing the witnesses a block touches
        rebuilds enough tree to re-execute it statelessly."""
        from ..bintrie.witness import prove as bintrie_prove
        from ..native import keccak256

        shadow = self._shadow()
        blk = self.vm.eth_backend.block_by_tag(block)
        if blk is None:
            raise RPCError(-32000, "block not found")
        broot = shadow.root_for(blk.root)
        if broot is None:
            raise RPCError(
                -32000,
                f"shadow has no bintrie root for state {blk.root.hex()} "
                "(commit predates the shadow, or it is quarantined)")
        addr = parse_addr(address)
        witness = bintrie_prove(shadow.store, broot, keccak256(addr))
        return {
            "address": hb(addr),
            "stateRoot": hb(blk.root),
            "bintrieRoot": hb(broot),
            "witness": hb(witness),
        }

    def commitmentStatus(self) -> dict:
        """debug_commitmentStatus: which backend is mounted and, in
        shadow mode, the shadow's commit/quarantine state and per-backend
        commit-timer totals (the dual-commit overhead, live)."""
        from ..metrics import default_registry

        shadow = getattr(self.vm.blockchain.state_database, "shadow", None)
        out = {
            "backend": self.vm.blockchain.cache_config.state_backend,
            "shadow": shadow.status() if shadow is not None else None,
        }
        timers = {}
        for name in ("chain/commit/mpt", "chain/commit/bintrie"):
            t = default_registry.timer(name)
            timers[name] = {"count": t.count(), "total": t.total()}
        out["commitTimers"] = timers
        return out


def create_handlers(vm, allow_unfinalized_queries: bool = False) -> RPCServer:
    """CreateHandlers (vm.go:1138): the full RPC surface on one server,
    namespace-gated by the eth-apis config list (config.go eth-apis,
    vm.go:1140) plus the admin/health enable flags."""
    cfg = getattr(vm, "full_config", None)
    apis = set(cfg.eth_apis) if cfg is not None else set(DEFAULT_ETH_APIS)
    allow_unfinalized = allow_unfinalized_queries or (
        cfg.allow_unfinalized_queries if cfg is not None else False)

    backend = EthBackend(vm.blockchain, vm.txpool, allow_unfinalized,
                         keystore=getattr(vm, "keystore", None),
                         external_signer=getattr(vm, "external_signer",
                                                 None),
                         api_max_blocks=(cfg.api_max_blocks_per_request
                                         if cfg is not None else 0),
                         gasprice_cache_size=(cfg.gasprice_cache_size
                                              if cfg is not None else 8),
                         logs_cache_size=(cfg.logs_cache_size
                                          if cfg is not None else 64))
    vm.eth_backend = backend
    server = RPCServer(
        policy=ServingPolicy.from_config(cfg if cfg is not None
                                         else Config()))
    vm.rpc_server = server
    eth = EthAPI(backend)
    if apis & {"eth", "internal-eth", "internal-blockchain",
               "internal-transaction"}:
        server.register_api("eth", eth)
        if not apis & {"personal", "internal-account"}:
            # account-signing methods ride the internal-account gate in
            # the reference (off by default); plain eth-apis keep the
            # read/submit surface only
            for m in ("accounts", "sign", "signTransaction",
                      "sendTransaction"):
                server.unregister("eth", m)
    if "eth-filter" in apis:
        filters_api = FiltersAPI(backend)
        server.register("eth", "newFilter", filters_api.newFilter)
        server.register("eth", "newBlockFilter", filters_api.newBlockFilter)
        server.register("eth", "newPendingTransactionFilter",
                        filters_api.newPendingTransactionFilter)
        server.register("eth", "uninstallFilter", filters_api.uninstallFilter)
        server.register("eth", "getFilterChanges",
                        filters_api.getFilterChanges)
    if apis & {"personal", "internal-account", "internal-personal"}:
        server.register_api("personal", PersonalAPI(backend))
    if apis & {"debug", "internal-debug", "debug-tracer"}:
        server.register_api("debug", DebugAPI(backend))
        server.register_api("debug", DebugMetricsAPI(vm))
        server.register_api("debug", DebugCommitmentAPI(vm, eth))
    if apis & {"txpool", "internal-tx-pool"}:
        server.register_api("txpool", TxPoolAPI(backend))
    if "net" in apis:
        server.register_api("net", NetAPI(vm.network_id))
    if "web3" in apis:
        server.register_api("web3", Web3API())
    # the avax handler is its own endpoint in the reference (vm.go:1160),
    # not gated by eth-apis
    avax_api = AvaxAPI(vm)
    server.register_api("avax", avax_api)
    # "import" is a python keyword; the wire name must match
    # service.go's avax.import
    server.register("avax", "import", avax_api._import_impl)
    if cfg is None or cfg.admin_api_enabled or cfg.coreth_admin_api_enabled:
        server.register_api("admin", AdminAPI(vm))
    if cfg is None or cfg.health_api_enabled:
        server.register("health", "check", lambda: health_check(vm))

    # eth_subscribe kinds (WS push; filter_system.go subscription feeds +
    # vm.go:1178-1186 WS handler registration)
    def new_heads_factory(notify):
        return backend.filters.subscribe_push(
            "newHeads", None, lambda blk: notify(eth._marshal_block(blk, False))
        )

    def logs_factory(notify, crit=None):
        return backend.filters.subscribe_push(
            "logs", crit or {}, lambda l: notify(eth._marshal_log(l, 0))
        )

    def pending_factory(notify):
        return backend.filters.subscribe_push(
            "newPendingTransactions", None, lambda h: notify(hb(h))
        )

    server.register_subscription("eth", "newHeads", new_heads_factory)
    server.register_subscription("eth", "logs", logs_factory)
    server.register_subscription("eth", "newPendingTransactions",
                                 pending_factory)
    return server


def serve_ws(vm, host: str = "127.0.0.1", port: int = 0,
             rpc_server: Optional[RPCServer] = None):
    """WS endpoint over the VM's RPC surface (vm.go:1178-1186: the /ws
    handler with per-connection CPU limits from config). Returns
    (WSServer, bound_port).

    Pass the node's existing RPCServer (from create_handlers) to share
    ONE backend/filter system between HTTP and WS — building a second
    stack would double per-block filter work and split filter state.
    Stop the WSServer before vm.shutdown(); its stop() joins every thread
    it started."""
    from ..rpc.websocket import WSServer

    server = rpc_server if rpc_server is not None else create_handlers(vm)
    cfg = vm.full_config
    body_limit = server.policy.body_limit if server.policy is not None else 0
    ws = WSServer(server, refill_rate=cfg.ws_cpu_refill_rate,
                  max_stored=cfg.ws_cpu_max_stored,
                  notify_queue_size=cfg.ws_notify_queue_size,
                  max_payload=body_limit)
    return ws, ws.serve(host, port)
