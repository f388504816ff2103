"""Deterministic cross-subsystem chaos conductor; counterpart of
coreth_tpu/fault/chaos.py.

One seeded scheduler arms and disarms random bounded failpoint specs
from the full failpoint catalogue while driving a randomized workload over
a real in-process node — block inserts through the staged pipeline
with the resident mirror on, mixed RPC traffic, accepts/rejects/
reorgs, a degraded-rung storage drill, and one mid-run SIGKILL-and-
reboot drill — and checks invariants after every step:

  * state-root parity: the accepted root re-derived by a pure-python
    trie walk (iterate_leaves -> fresh CPU Trie) must equal the header
    root, whatever path (device, host fallback, quarantined mirror,
    degraded replay) produced it;
  * un-ragged flight records: every record in the ring carries the
    identical top-level key set — fault paths must not drop fields;
  * no wedged thread: a watchdog bounds each step and disarms
    everything if the budget is blown (a trip IS a violation);
  * bit-exact recovery after the kill: the reopened database repairs
    to exactly the head the child reported before dying.

Everything is derived from one seed — the scheduler RNG, the per-
failpoint fire streams (fault.set_seed), the corrupt-read bit pick —
so two runs with the same seed and steps produce byte-identical JSON
(`json.dumps(..., sort_keys=True)`, no timestamps). The per-run
metric deltas come from counter baselines snapshotted at entry, so
back-to-back runs in one process stay comparable.

CLI:  python -m coreth_tpu_torch.fault.chaos --seed 7 --steps 500 --json
      [--device cpu]

The device: the node runs on the device the caller names (`device=`,
`--device`; None is CUDA, and without CUDA the boot raises): its
resident mirror and its storage programs commit on K1, and the
degradation ladder's probes hash on K2 of that device. The kill drill's
child names the same device and runs its chain there; the parent
reboots the child's store on it too. Build the kernels before a run on
CUDA: a first-use build inside a step counts against STEP_BUDGET.

Where the port departs from the reference, by the port's device rule
(ROADMAP Queue 3: only a caller demotes, and a failed dispatch reaches
it), a run of the same seed differs from the reference's in these
fields only, and tests/test_torch_chaos.py pins each:

  * act_device: an armed `ops/device/dispatch` fires once per drill (the
    reference's ladder retries once, so its site fires twice) and its
    error reaches the conductor, which is the caller: it demotes the
    ladder, and the refused re-dispatch raises DeviceDegradedError, the
    drill's one fault. So `fired["ops/device/dispatch"]` counts one per
    raising drill where the reference counts two.
  * _recover: the conductor re-promotes the ladder through
    `DeviceLadder.probe_once()` (promote_after healthy K2 probes) where
    the reference calls promote() directly; the outcome, a healthy
    ladder before the next step, is the same.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

from . import clear_all, list_armed, set_failpoint, set_seed

# ---------------------------------------------------------------- catalogue

# (failpoint, subsystem, action, bounded specs to draw from). Every
# entry names an action that is GUARANTEED to reach the site while the
# spec is armed, so coverage pressure converges instead of spinning.
# Specs are bounded on purpose (`*count`, `hang:<ms>`): the conductor
# must never park a worker past the step watchdog.
CATALOGUE = (
    ("ethdb/before_get", "ethdb", "readfault", ("raise*1", "raise*2")),
    ("ethdb/before_put", "ethdb", "degraded", ("raise*24",)),
    ("ethdb/before_batch_write", "ethdb", "batchfault", ("raise*1",)),
    ("ethdb/torn_batch", "ethdb", "tornbatch", ("raise*1",)),
    ("ethdb/corrupt_read", "ethdb", "corrupt", ("raise*1",)),
    ("insert/before_recover", "insert", "insert",
     ("raise*1", "raise%0.5*2", "hang:5*2")),
    ("insert/before_execute", "insert", "insert",
     ("raise*1", "raise%0.5*2", "hang:5*2")),
    ("insert/before_commit", "insert", "insert", ("raise*1", "hang:5*2")),
    ("insert/before_write", "insert", "insert", ("raise*1", "hang:5*2")),
    ("chain/tail/before_body", "insert", "insert", ("raise*1", "hang:5*2")),
    ("chain/tail/partial_body", "insert", "insert", ("raise*1",)),
    ("chain/tail/before_head", "insert", "insert", ("raise*1", "hang:5*2")),
    ("rpc/before_dispatch", "rpc", "rpc",
     ("raise*1", "raise%0.5*4", "hang:5*4")),
    ("rpc/before_dispatch_expensive", "rpc", "rpc", ("raise*1", "hang:5*2")),
    ("ops/device/dispatch", "device", "device", ("raise*4", "hang:5*4")),
    ("resident/before_absorb", "device", "insert", ("hang:5*2",)),
    ("state/resident/spot_check", "device", "spotcheck", ("raise*1",)),
    # exec shards: before_dispatch fires in the parent (raise -> fallback
    # before any worker traffic; hang -> bounded stall under the dispatch
    # span). shard_crash is raise-only HERE because hang specs park the
    # worker, not the parent — the parent-side translation kills a real
    # worker process, so coverage counts in the parent registry and the
    # serial fallback must still commit the same root (invariant #1).
    ("exec/before_dispatch", "shard", "shard",
     ("raise*1", "raise%0.5*2", "hang:5*2")),
    ("exec/shard_crash", "shard", "shard", ("raise*1", "raise*2")),
)

# exceptions the conductor treats as the *point* of the exercise: every
# armor layer converts an injected fault into exactly one of these (or
# answers in-band, like RPC error objects)
def _expected_types():
    from ..core.blockchain import ChainError, TailStalled
    from ..ethdb import DBError
    from ..ops.device import DeviceDegradedError
    from . import FailpointError

    return (FailpointError, DBError, ChainError, TailStalled,
            DeviceDegradedError)


STEP_BUDGET = 60.0  # watchdog: seconds one step may take before it trips

KEY1 = b"\x11" * 32
KEY2 = b"\x22" * 32
DEST = b"\xbb" * 20
FUND = 10 ** 22


class _Watchdog:
    """Per-step deadline monitor: if a step blows its budget the
    watchdog records the trip (a violation) and disarms every failpoint
    so parked workers release and the run can finish with evidence
    instead of hanging CI."""

    def __init__(self, budget: float):
        self.budget = budget
        self.tripped: List[str] = []
        self._mu = threading.Lock()
        self._label: Optional[str] = None
        self._deadline: Optional[float] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="chaos-watchdog", daemon=True)
        self._thread.start()

    def begin(self, label: str) -> None:
        with self._mu:
            self._label = label
            self._deadline = time.monotonic() + self.budget

    def end(self) -> None:
        with self._mu:
            self._label = None
            self._deadline = None

    def _loop(self) -> None:
        while not self._stop.wait(0.25):
            with self._mu:
                expired = (self._deadline is not None
                           and time.monotonic() > self._deadline)
                label = self._label
                if expired:
                    self._deadline = None  # one trip per step
            if expired:
                self.tripped.append(label or "?")
                clear_all()  # release anything parked on a hang

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)


# ------------------------------------------------------- kill-reboot drill

# Child for the mid-run SIGKILL drill: builds a real chain on SQLite on
# the device named by argv[3] (on CUDA its resident mirror commits on
# K1), tears block 3's insert tail with an armed failpoint (head pointer
# lands, body never does), reports its hashes, then parks until the
# parent SIGKILLs it. It is started with subprocess, never forked from a
# parent whose CUDA is initialised, and imports only this package.
_KILL_CHILD = r"""
import sys, threading
sys.path.insert(0, sys.argv[2])
from coreth_tpu_torch import fault, params
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig, ChainError
from coreth_tpu_torch.core.chain_makers import generate_chain
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Signer, Transaction
from coreth_tpu_torch.crypto.secp256k1 import priv_to_address
from coreth_tpu_torch.ethdb.faultdb import FaultInjectingDB
from coreth_tpu_torch.ethdb.sqlitedb import SQLiteDB
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.trie.triedb import TrieDatabase

KEY = b"\x11" * 32
ADDR = priv_to_address(KEY)
DEST = b"\xbb" * 20
DEVICE = sys.argv[3]

def tx(nonce):
    t = Transaction(type=2, chain_id=43112, nonce=nonce, max_fee=10**12,
                    max_priority_fee=10**9, gas=21000, to=DEST, value=1000)
    return Signer(43112).sign(t, KEY)

diskdb = FaultInjectingDB(SQLiteDB(sys.argv[1]))
genesis = Genesis(config=params.TEST_CHAIN_CONFIG,
                  gas_limit=params.CORTINA_GAS_LIMIT,
                  alloc={ADDR: GenesisAccount(balance=10**22)})
chain = BlockChain(diskdb, CacheConfig(commit_interval=4096),
                   params.TEST_CHAIN_CONFIG, genesis, new_dummy_engine(),
                   state_database=Database(TrieDatabase(diskdb)),
                   device=DEVICE)
print("DEVICE", DEVICE, "mirror", chain.mirror is not None, flush=True)

def build(n):
    blocks, _ = generate_chain(
        chain.config, chain.current_block, chain.engine,
        chain.state_database, n,
        gen=lambda i, bg: bg.add_tx(tx(chain.current_block.number + i)))
    for b in blocks:
        chain.insert_block(b)
    return blocks

blocks = build(2)
chain.join_tail()
fault.set_failpoint("chain/tail/partial_body", "raise*1")
extra = build(1)
try:
    chain.join_tail()
except ChainError:
    pass
from coreth_tpu_torch.ops import keccak_cuda
print("B2", blocks[1].hash().hex(), flush=True)
print("B3", extra[0].hash().hex(), flush=True)
print("K1", keccak_cuda.launches, flush=True)
print("READY", flush=True)
threading.Event().wait(120)  # parked until SIGKILL
"""


# ------------------------------------------------------------ the conductor

class Conductor:
    """One chaos run: owns the chain + RPC surface, the seeded
    scheduler, and the invariant checks. `run()` returns the
    deterministic result dict."""

    def __init__(self, seed: int, steps: int, kill_drill: bool = True,
                 step_budget: float = STEP_BUDGET, device=None):
        from ..device import resolve

        self.device = resolve(device)
        self.seed = int(seed)
        self.steps = int(steps)
        self.kill_drill = bool(kill_drill)
        self.step_budget = float(step_budget)
        self.violations: List[Dict[str, object]] = []
        self.step_log: List[Dict[str, object]] = []
        self.kill_result: Optional[Dict[str, object]] = None
        # the kill child's stdout lines (DEVICE, B2, B3, K1, READY)
        self.kill_child_lines: List[str] = []
        self._watchdog_seen = 0
        self._pick_attempts: Dict[str, int] = {}

    # ---- lifecycle -------------------------------------------------------

    def _boot(self) -> None:
        import random

        from .. import params
        from ..consensus.dummy import new_dummy_engine
        from ..core.blockchain import BlockChain, CacheConfig
        from ..core.genesis import Genesis, GenesisAccount
        from ..core.txpool import TxPool, TxPoolConfig
        from ..crypto.secp256k1 import priv_to_address
        from ..eth.api import EthAPI
        from ..eth.backend import EthBackend
        from ..ethdb import MemoryDB
        from ..ethdb.faultdb import FaultInjectingDB
        from ..metrics import default_registry
        from ..rpc.server import RPCServer
        from ..state.database import Database
        from ..trie.triedb import TrieDatabase

        from ..ops.device import default_ladder, get_batch_keccak

        clear_all()
        set_seed(self.seed)
        # the ladder is process-global: start from HEALTHY so a prior
        # run (or test) that left it demoted cannot leak into this one
        default_ladder().reset()
        self.rng = random.Random(self.seed)
        self.addr1 = priv_to_address(KEY1)
        self.addr2 = priv_to_address(KEY2)

        self.baseline = {
            name: m.count() for name, m in default_registry.each()
            if hasattr(m, "count") and not hasattr(m, "update")
        }

        cfg = params.TEST_CHAIN_CONFIG
        self.diskdb = FaultInjectingDB(MemoryDB())
        # the chain's own default seam ("auto": the planned marker) on the
        # run's device: storage commits on K1, and the ladder's probe on
        # that device's K2 seam
        state_db = Database(TrieDatabase(
            self.diskdb, batch_keccak=get_batch_keccak("auto", self.device)))
        genesis = Genesis(
            config=cfg, gas_limit=params.CORTINA_GAS_LIMIT,
            alloc={self.addr1: GenesisAccount(balance=FUND),
                   self.addr2: GenesisAccount(balance=FUND)},
        )
        # commit_interval=1: accepted tries land on disk every block, so
        # the pure-trie oracle can walk any accepted root; verify-on-read
        # + bounded retries + the degraded rung all armed; probe loop off
        # (device re-promotion is driven deterministically by the
        # conductor, not a timer); no resident watchdog — the only
        # timing authority in the run is the conductor's own watchdog.
        self.chain = BlockChain(
            self.diskdb,
            CacheConfig(pruning=True, commit_interval=1,
                        resident_account_trie=True,
                        resident_prefer_host=False,
                        resident_pipeline_depth=2,
                        resident_spot_check_interval=1,
                        insert_pipeline_depth=2,
                        evm_exec_shards=2,
                        db_verify_on_read=True, db_retry_budget=2,
                        tail_join_timeout=self.step_budget / 2,
                        device_probe_interval=0.0),
            cfg, genesis, new_dummy_engine(), state_database=state_db,
            device=self.device,
        )
        self.txpool = TxPool(TxPoolConfig(), cfg, self.chain)
        self.server = RPCServer()
        self.server.register_api("eth", EthAPI(EthBackend(
            self.chain, self.txpool)))
        self.genesis_hash = self.chain.get_canonical_hash(0)

        # lock-order witness (invariant #6): every chain-path lock from
        # racecheck.CANONICAL_LOCK_ORDER that exists in this topology is
        # swapped for an order-tracking proxy, immediately after
        # construction so no Condition can capture a raw inner lock.
        from ..utils.racecheck import LockOrderWitness
        self.witness = LockOrderWitness()
        self.witness.wrap(self.chain, "chainmu", "BlockChain.chainmu")
        self.witness.wrap(self.chain, "_acceptor_tip_lock",
                          "BlockChain._acceptor_tip_lock")
        self.witness.wrap(self.chain, "_insert_recs_mu",
                          "BlockChain._insert_recs_mu")
        self.witness.wrap(self.chain, "_view_mu", "BlockChain._view_mu")
        self.witness.wrap(self.chain, "_degraded_mu",
                          "BlockChain._degraded_mu")
        if getattr(self.chain, "pipeline", None) is not None:
            self.witness.wrap(self.chain.pipeline, "_mu",
                              "InsertPipeline._mu")
        if self.chain.snaps is not None:
            self.witness.wrap(self.chain.snaps, "lock", "Tree.lock")
        self.witness.wrap(self.txpool, "mu", "TxPool.mu")
        self.witness.wrap(default_registry, "_lock", "Registry._lock")

        # sampling profiler armed hot for the whole run (invariant #7):
        # 50 Hz against every witnessed lock above — the sampler must
        # never throw into the workload, and its lock-tag reads of the
        # witness mirror must not perturb the lock-order record
        from ..metrics.profiler import start_profiler
        self.profiler = start_profiler(50.0, ring_size=4096)

        self.watchdog = _Watchdog(self.step_budget)
        self.expected = _expected_types()

    def _shutdown(self) -> None:
        clear_all()
        try:
            self.chain.stop()
        except Exception as e:  # noqa: BLE001 - teardown is best-effort
            self._record_violation("shutdown", f"chain.stop failed: {e!r}")
        if getattr(self, "profiler", None) is not None:
            # stop sampling BEFORE the witness unwraps: the sampler's
            # lock-tag reads reference the witness held-stack mirror
            from ..metrics.profiler import stop_profiler
            stop_profiler()
            self.profiler = None
        if getattr(self, "witness", None) is not None:
            # the metrics registry is process-global; it must not keep a
            # witness proxy once this conductor is gone
            self.witness.unwrap_all()
        self.watchdog.close()

    def _record_violation(self, what: str, detail: str, step: int = -1) -> None:
        self.violations.append(
            {"step": step, "what": what, "detail": detail})

    # ---- deterministic helpers ------------------------------------------

    def _tx(self, nonce: int, value: int = 1000):
        from ..core.types import Signer, Transaction

        t = Transaction(type=2, chain_id=43112, nonce=nonce,
                        max_fee=10 ** 12, max_priority_fee=10 ** 9,
                        gas=21000, to=DEST, value=value)
        return Signer(43112).sign(t, KEY1)

    def _make_blocks(self, n: int, gap: int = 10):
        from ..core.chain_makers import generate_chain

        chain = self.chain
        nonce = chain.state().get_nonce(self.addr1)
        blocks, _ = generate_chain(
            chain.config, chain.current_block, chain.engine,
            chain.state_database, n, gap=gap,
            gen=lambda i, bg: bg.add_tx(self._tx(nonce + i)))
        return blocks

    def _quiesce(self) -> int:
        """Land every async worker so step accounting is deterministic.
        Returns how many expected (injected) failures surfaced here."""
        faults = 0
        chain = self.chain
        for closer in (
                (chain.pipeline.drain if chain.pipeline is not None
                 else lambda: None),
                chain.join_tail,
                chain.drain_acceptor_queue):
            try:
                closer()
            except self.expected:
                faults += 1
        return faults

    def _accept_pending(self) -> int:
        """Accept every canonical block above last-accepted, in order.

        Accepts are deliberately deferred to here, AFTER clear_all: the
        acceptor's post-process join_tail would otherwise consume an
        injected tail tear mid-accept, skip the flatten/export for that
        block, and poison every later flatten with an accept-order
        violation. Consensus delivers accepts in order on a healthy
        node; the conductor plays consensus."""
        faults = 0
        chain = self.chain
        try:
            while (chain.last_accepted.number
                   < chain.current_block.number):
                n = chain.last_accepted.number + 1
                h = chain.get_canonical_hash(n)
                b = chain.get_block(h) if h else None
                if b is None:
                    self._record_violation("accept-backlog",
                                  f"canonical block {n} unresolvable")
                    break
                chain.accept(b)
            faults += self._quiesce()
        except self.expected:
            faults += 1
        return faults

    def _recover(self) -> int:
        """Undo every armed consequence: disarm, re-promote the device
        ladder, walk the chain out of the degraded rung (checking that
        reads kept serving while it was degraded), and play consensus —
        accept the canonical backlog in order."""
        from ..ops.device import default_ladder

        faults = 0
        clear_all()
        ladder = default_ladder()
        if not ladder.healthy:
            self._repromote(ladder)
        if self.chain.degraded:
            faults += self._check_degraded_serving()
            faults += self._heal_degraded()
        faults += self._quiesce()
        faults += self._accept_pending()
        return faults

    def _repromote(self, ladder) -> None:
        """Earn the ladder's way back as its probe loop would: healthy K2
        probes on the run's device, promote_after in a row (the loop
        itself is off, probe interval 0, so the schedule stays the
        conductor's). A probe that fails is a violation: nothing is
        armed by now."""
        for _ in range(max(1, ladder.promote_after)):
            if not ladder.probe_once():
                self._record_violation(
                    "device-probe", f"re-promotion probe failed: "
                    f"{ladder.status()['last_error']}")
                ladder.promote()
                return
        if not ladder.healthy:
            self._record_violation("device-probe",
                                   "healthy probes left the ladder demoted")
            ladder.promote()

    def _check_degraded_serving(self) -> int:
        """The degraded acceptance surface: a chain that cannot write
        must still answer reads."""
        ok, errs = self._rpc_batch()
        if errs:
            self._record_violation("degraded-serving",
                          f"{errs} RPC read(s) failed while degraded")
        return 0

    def _heal_degraded(self) -> int:
        """With failpoints disarmed, the next insert probes the store,
        replays the stashed tail writes, and clears the rung."""
        faults = 0
        try:
            blocks = self._make_blocks(1)
            self.chain.insert_block(blocks[0])
            faults += self._quiesce()
        except self.expected:
            faults += 1
        if self.chain.degraded:
            self._record_violation("degraded-recovery",
                          "chain still degraded after disarm + insert")
        return faults

    # ---- workload actions ------------------------------------------------

    def act_insert(self) -> int:
        """The bread-and-butter action: a 1-2 block burst through the
        pipelined insert path, driving the tail, the resident mirror,
        the spot check, and the interval flush. Accepts are NOT issued
        here — _recover plays them in order once faults are disarmed,
        like consensus would on a healthy node."""
        faults = 0
        chain = self.chain
        try:
            blocks = self._make_blocks(self.rng.randint(1, 2))
            for b in blocks:
                chain.insert_block(b)
        except self.expected:
            faults += 1
        faults += self._quiesce()
        return faults

    def act_reorg(self) -> int:
        """Two competing children of the same parent (same txs, gap-
        skewed timestamps, so the nonce model is fork-independent);
        prefer and accept one, reject the other."""
        faults = 0
        chain = self.chain
        try:
            fork_a = self._make_blocks(1, gap=10)
            fork_b = self._make_blocks(1, gap=11)
            chain.insert_block(fork_a[0])
            chain.insert_block(fork_b[0])
            winner, loser = ((fork_a[0], fork_b[0])
                            if self.rng.random() < 0.5
                            else (fork_b[0], fork_a[0]))
            chain.set_preference(winner)
            chain.accept(winner)
            chain.reject(loser)
            faults += self._quiesce()
        except self.expected:
            faults += 1
        return faults

    def act_spotcheck(self) -> int:
        """Forced mirror divergence: the armed spot check quarantines
        the mirror (rebuilt from last-accepted state), which drops the
        unaccepted block it was mid-insert on. The consensus contract
        (test_resident_chain) is that the suffix gets RE-DELIVERED, so
        the conductor re-inserts it through the rebuilt mirror before
        accepting."""
        faults = 0
        chain = self.chain
        try:
            blocks = self._make_blocks(1)
            chain.insert_block(blocks[0])
            faults += self._quiesce()  # lands commit + any quarantine
            clear_all()
            chain.insert_block(blocks[0])  # consensus re-delivery
            faults += self._quiesce()
        except self.expected:
            faults += 1
        return faults

    def _rpc_batch(self):
        """One mixed JSON-RPC batch (cheap + expensive lanes) through
        the wire-format dispatch path. -> (ok_count, err_count)."""
        a1 = "0x" + self.addr1.hex()
        reqs = [
            {"jsonrpc": "2.0", "id": 1, "method": "eth_blockNumber",
             "params": []},
            {"jsonrpc": "2.0", "id": 2, "method": "eth_getBalance",
             "params": [a1, "latest"]},
            {"jsonrpc": "2.0", "id": 3, "method": "eth_getBlockByNumber",
             "params": ["latest", False]},
            {"jsonrpc": "2.0", "id": 4, "method": "eth_call",
             "params": [{"from": a1, "to": "0x" + DEST.hex(),
                         "value": "0x0"}, "latest"]},
        ]
        out = json.loads(self.server.handle_raw(json.dumps(reqs).encode()))
        ok = sum(1 for r in out if "result" in r)
        return ok, len(out) - ok

    def act_rpc(self) -> int:
        """RPC traffic. Injected dispatch faults come back as JSON
        error objects (the armor), never exceptions."""
        _, errs = self._rpc_batch()
        return errs

    def act_device(self) -> int:
        """Drive the process-wide device ladder directly: an armed
        dispatch failure reaches its caller, the conductor, with no retry
        and no demotion (ROADMAP Queue 3). Only a caller demotes, so the
        conductor demotes, and the refused re-dispatch raises the typed
        DeviceDegradedError: the drill's one fault."""
        from ..device import DEVICE_FAULTS
        from ..ops.device import DeviceDegradedError, default_ladder
        from . import FailpointError

        ladder = default_ladder()
        try:
            ladder.dispatch(lambda: b"pong", "chaos device drill")
            return 0
        except DeviceDegradedError:
            return 1
        except (FailpointError, *DEVICE_FAULTS) as e:
            ladder.demote(f"chaos device drill: {e!r}")
        try:
            ladder.dispatch(lambda: b"pong", "chaos device drill")
        except DeviceDegradedError:
            return 1
        self._record_violation("device-demote",
                               "a demoted ladder ran a dispatch")
        return 0

    def act_readfault(self) -> int:
        """A direct storage read with ethdb/before_get armed: the
        boundary must answer with typed DBError, not a raw failure."""
        from ..core import rawdb
        from ..ethdb import DBError

        head = self.chain.current_block
        try:
            rawdb.read_header_rlp(self.diskdb, head.number, head.hash())
            return 0
        except DBError:
            return 1

    def act_corrupt(self) -> int:
        """ethdb/corrupt_read flips one seeded bit in the next read;
        verify-on-read must catch it as CorruptDataError — silent
        propagation into consensus is a violation."""
        from ..core import rawdb
        from ..ethdb import CorruptDataError, DBError

        head = self.chain.current_block
        number, h = head.number, head.hash()
        # probe the UNWRAPPED backend: a previous step's injected tail
        # tear may have legitimately left the head's header row off the
        # disk, and a get through the wrapper would consume the armed
        # one-shot without flipping anything. Genesis is always durable.
        if self.diskdb._db.get(rawdb.header_key(number, h)) is None:
            number, h = 0, self.genesis_hash
        try:
            rawdb.read_header_rlp(self.diskdb, number, h)
        except CorruptDataError:
            return 1
        except DBError:
            return 1  # armed %prob can fire on before_get instead
        self._record_violation("corrupt-read",
                      "flipped bit passed verify-on-read unnoticed")
        return 0

    def act_batchfault(self) -> int:
        """Scratch-batch write with before_batch_write armed: typed
        DBError and NOTHING applied."""
        from ..ethdb import DBError, MemoryDB
        from ..ethdb.faultdb import FaultInjectingDB

        scratch = FaultInjectingDB(MemoryDB())
        try:
            scratch.write_batch([(b"k%d" % i, b"v%d" % i)
                                 for i in range(4)])
        except DBError:
            if len(scratch) != 0:
                self._record_violation("batch-atomicity",
                              "bytes applied before the injected "
                              "batch failure")
            return 1
        return 0

    def act_tornbatch(self) -> int:
        """Scratch-batch write with torn_batch armed: exactly the first
        half lands — the non-atomic-backend shape the boot repair and
        the SQLite transaction contract exist for."""
        from ..ethdb import DBError, MemoryDB
        from ..ethdb.faultdb import FaultInjectingDB

        scratch = FaultInjectingDB(MemoryDB())
        try:
            scratch.write_batch([(b"k%d" % i, b"v%d" % i)
                                 for i in range(4)])
        except DBError:
            if len(scratch) != 2:
                self._record_violation("torn-batch",
                              f"expected a 2-entry torn prefix, found "
                              f"{len(scratch)}")
            return 1
        self._record_violation("torn-batch", "armed torn_batch never fired")
        return 0

    def act_degraded(self) -> int:
        """The full degraded-rung drill: persistent write failure while
        the tail lands a block -> chain turns read-only instead of
        crashing; reads keep serving; a write while sick raises the
        typed error; disarm -> probe -> replay -> recovered."""
        from ..core.blockchain import ChainDegradedError

        faults = 0
        chain = self.chain
        try:
            blocks = self._make_blocks(2)
        except self.expected:
            return 1
        chain.insert_block(blocks[0])
        faults += self._quiesce()  # tail retries exhaust -> degraded
        if not chain.degraded:
            self._record_violation("degraded-entry",
                          "persistent put failure never engaged the "
                          "degraded rung")
            return faults
        faults += self._check_degraded_serving()
        try:
            chain.insert_block(blocks[1])
            self._record_violation("degraded-gate",
                          "insert during degraded did not raise")
        except ChainDegradedError:
            faults += 1
        clear_all()
        try:
            chain.insert_block(blocks[1])  # probe + replay + recover
            faults += self._quiesce()
        except self.expected as e:
            self._record_violation("degraded-recovery", f"recovery insert: {e!r}")
        if chain.degraded:
            self._record_violation("degraded-recovery",
                          "rung still engaged after disarm")
        return faults

    def _make_shard_block(self, txs: int = 4):
        """One block with enough txs to clear the shard dispatch gate
        (exec_shards.MIN_SHARD_TXS) — _make_blocks' 1-tx blocks never
        reach the forked workers."""
        from ..core.chain_makers import generate_chain

        chain = self.chain
        nonce = chain.state().get_nonce(self.addr1)

        def gen(i, bg):
            for j in range(txs):
                bg.add_tx(self._tx(nonce + j))

        blocks, _ = generate_chain(
            chain.config, chain.current_block, chain.engine,
            chain.state_database, 1, gap=10, gen=gen)
        return blocks[0]

    def act_shard(self) -> int:
        """A multi-tx block through the forked execution shards. An
        armed shard_crash SIGKILLs a real worker mid-dispatch; the pool
        ladder respawns it and the block falls back to the untouched
        serial loop. The committed root must be identical either way —
        invariant #1 (pure-trie root parity) is exactly the killed-
        shard-never-changes-the-root check, run after every step."""
        faults = 0
        chain = self.chain
        crashes_before = self._counter_delta("exec/shard/crashes")
        try:
            chain.insert_block(self._make_shard_block())
        except self.expected:
            faults += 1
        faults += self._quiesce()
        # a worker killed by the armed failpoint surfaces as a crash
        # counted in the parent, not as an exception out of insert
        faults += (self._counter_delta("exec/shard/crashes")
                   - crashes_before)
        return faults

    ACTIONS = {
        "insert": act_insert,
        "shard": act_shard,
        "spotcheck": act_spotcheck,
        "reorg": act_reorg,
        "rpc": act_rpc,
        "device": act_device,
        "readfault": act_readfault,
        "corrupt": act_corrupt,
        "batchfault": act_batchfault,
        "tornbatch": act_tornbatch,
        "degraded": act_degraded,
    }

    # ---- invariants ------------------------------------------------------

    def _check_invariants(self, step: int) -> None:
        from ..trie.iterator import iterate_leaves
        from ..trie.trie import Trie

        chain = self.chain
        # 1. state-root parity against the pure-python trie oracle
        root = chain.last_accepted.root
        try:
            st = chain.state_database.triedb.open_state_trie(root)
            oracle = Trie()
            for k, v in iterate_leaves(st.trie):
                oracle.update(k, v)
            if oracle.hash() != root:
                self._record_violation(
                    "root-parity",
                    f"pure-trie root {oracle.hash().hex()} != accepted "
                    f"header root {root.hex()}", step)
        except Exception as e:  # noqa: BLE001 - any oracle failure counts
            self._record_violation("root-parity", f"oracle walk failed: {e!r}", step)
        # 2. un-ragged flight records
        keysets = {tuple(sorted(r)) for r in chain.flight_recorder.last()}
        if len(keysets) > 1:
            self._record_violation("flight-ragged",
                          f"{len(keysets)} distinct key sets in the "
                          f"flight ring", step)
        # 3. the acceptor thread survived AND swallowed nothing: every
        # injected fault must be consumed by the conductor's own joins,
        # never by the async acceptor (where a skipped flatten/export
        # would silently poison later accepts)
        if chain.acceptor_error is not None:
            err = chain.acceptor_error.strip().splitlines()[-1]
            chain.acceptor_error = None  # one event, one violation
            self._record_violation("acceptor-error", err, step)
        # 4. watchdog trips are violations
        while self._watchdog_seen < len(self.watchdog.tripped):
            self._record_violation("watchdog",
                          f"step budget blown at "
                          f"{self.watchdog.tripped[self._watchdog_seen]}",
                          step)
            self._watchdog_seen += 1
        # 5. nothing left armed between steps
        leftovers = list_armed()
        if leftovers:
            clear_all()
            self._record_violation("armed-leak",
                          f"{[a['name'] for a in leftovers]} still armed "
                          f"after recovery", step)
        # 6. lock-order witness: no thread acquired canonical locks out
        # of order during the step
        if self.witness.violations:
            for v in self.witness.violations:
                self._record_violation("lock-order", v, step)
            self.witness.violations = []
        # 7. the sampling profiler stayed silent and alive: its tick is
        # fenced — any exception it swallowed counts sampler_errors, and
        # a dead sampler thread means a tick escaped the fence entirely
        if self.profiler is not None:
            errs = self._counter_delta("profile/sampler_errors")
            if errs > 0:
                self._record_violation(
                    "profiler-error",
                    f"{errs} fenced sampler exception(s)", step)
            if not self.profiler.alive():
                self._record_violation(
                    "profiler-dead", "sampler thread exited mid-run", step)

    # ---- kill drill ------------------------------------------------------

    def _run_kill_drill(self, step: int) -> None:
        """SIGKILL a child mid-torn-tail and reboot its database: the
        repair must land on exactly the head the child reported."""
        from ..core import rawdb
        from ..ethdb.sqlitedb import SQLiteDB

        repo = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        tmp = tempfile.mkdtemp(prefix="coreth-chaos-")
        path = os.path.join(tmp, "kill.db")
        errpath = os.path.join(tmp, "child.err")
        with open(errpath, "w") as errf:
            proc = subprocess.Popen(
                [sys.executable, "-c", _KILL_CHILD, path, repo,
                 str(self.device)],
                stdout=subprocess.PIPE, stderr=errf, text=True)
        lines: List[str] = []
        deadline = time.time() + 300
        try:
            while time.time() < deadline:
                line = proc.stdout.readline()
                if not line:
                    break
                lines.append(line.strip())
                if line.strip() == "READY":
                    break
        finally:
            proc.kill()  # SIGKILL: no atexit, no close, no flush
            proc.wait(30)
            proc.stdout.close()
        hashes = {p[0]: p[1] for p in (l.split() for l in lines)
                  if len(p) == 2 and p[0].startswith("B")}
        self.kill_child_lines = lines
        if "READY" not in lines or "B2" not in hashes:
            with open(errpath) as f:
                err = f.read().strip().splitlines()[-3:]
            shutil.rmtree(tmp, ignore_errors=True)
            self._record_violation("kill-drill",
                          f"child never reached READY: {lines[-3:]} "
                          f"{err}", step)
            self.kill_result = {"ok": False, "reason": "child-not-ready"}
            return
        h2 = bytes.fromhex(hashes["B2"])
        h3 = bytes.fromhex(hashes["B3"])
        reopened = None
        diskdb = None
        try:
            diskdb = SQLiteDB(path)
            torn = (rawdb.read_head_block_hash(diskdb) == h3
                    and rawdb.read_body_rlp(diskdb, 3, h3) is None)
            reopened = self._reopen_chain(diskdb)
            repaired_head = reopened.current_block.hash()
            ok = (torn and reopened.current_block.number == 2
                  and repaired_head == h2
                  and rawdb.read_head_block_hash(diskdb) == h2
                  and reopened.state().get_balance(DEST) == 2 * 1000)
            if not ok:
                self._record_violation(
                    "kill-drill",
                    f"reboot repair not bit-exact: torn={torn} "
                    f"head={repaired_head.hex()} expected={h2.hex()}",
                    step)
            self.kill_result = {
                "ok": ok, "torn_on_disk": torn,
                "repaired_number": reopened.current_block.number,
                "repaired_head": repaired_head.hex(),
                "expected_head": h2.hex(),
            }
        except Exception as e:  # noqa: BLE001 - the drill must not abort the run
            self._record_violation("kill-drill", f"reboot failed: {e!r}", step)
            self.kill_result = {"ok": False, "reason": repr(e)}
        finally:
            if reopened is not None:
                reopened.stop()
            if diskdb is not None:
                diskdb.close()
            shutil.rmtree(tmp, ignore_errors=True)

    def _reopen_chain(self, diskdb):
        from .. import params
        from ..consensus.dummy import new_dummy_engine
        from ..core.blockchain import BlockChain, CacheConfig
        from ..core.genesis import Genesis, GenesisAccount
        from ..state.database import Database
        from ..trie.triedb import TrieDatabase

        genesis = Genesis(
            config=params.TEST_CHAIN_CONFIG,
            gas_limit=params.CORTINA_GAS_LIMIT,
            alloc={self.addr1: GenesisAccount(balance=FUND)})
        # db_verify_on_read mounts into a process-wide rawdb flag at
        # chain boot; a plain-default reopen here would silently disarm
        # the conductor's own verify-on-read for the rest of the run.
        return BlockChain(
            diskdb, CacheConfig(commit_interval=4096,
                                db_verify_on_read=True),
            params.TEST_CHAIN_CONFIG, genesis, new_dummy_engine(),
            state_database=Database(TrieDatabase(diskdb)),
            device=self.device)

    # ---- scheduling ------------------------------------------------------

    def _applicable(self):
        resident = self.chain.state_database.mirror is not None
        return [e for e in CATALOGUE
                if resident or not e[0].startswith(("resident/",
                                                    "state/resident/"))]

    def _pick(self, fired: Dict[str, int]):
        """Coverage-pressured choice: failpoints that have not fired yet
        this run go first, but only for a bounded number of attempts
        each — a site the workload cannot reach in this environment must
        not starve the rest of the schedule."""
        cat = self._applicable()
        unfired = [e for e in cat
                   if fired.get(e[0], 0) == 0
                   and self._pick_attempts.get(e[0], 0) < 3]
        pool = unfired or cat
        entry = pool[self.rng.randrange(len(pool))]
        spec = entry[3][self.rng.randrange(len(entry[3]))]
        self._pick_attempts[entry[0]] = (
            self._pick_attempts.get(entry[0], 0) + 1)
        return entry, spec

    def _fired_deltas(self) -> Dict[str, int]:
        from ..metrics import default_registry

        out: Dict[str, int] = {}
        for name, m in default_registry.each():
            if not name.startswith("fault/fired/") or not hasattr(m, "count"):
                continue
            delta = m.count() - self.baseline.get(name, 0)
            if delta > 0:
                out[name[len("fault/fired/"):]] = delta
        return out

    def _counter_delta(self, name: str) -> int:
        from ..metrics import default_registry

        return (default_registry.counter(name).count()
                - self.baseline.get(name, 0))

    # ---- the run ---------------------------------------------------------

    def run(self) -> Dict[str, object]:
        self._boot()
        try:
            kill_step = None
            if self.kill_drill and self.steps >= 5:
                kill_step = self.rng.randrange(self.steps // 2,
                                               self.steps)
            for step in range(self.steps):
                self.watchdog.begin(f"step {step}")
                try:
                    if step == kill_step:
                        self._run_kill_drill(step)
                        self.step_log.append(
                            {"step": step, "action": "kill-drill",
                             "armed": None, "spec": None, "faults": 0})
                        continue
                    fired = self._fired_deltas()
                    (name, _subsystem, action, _specs), spec = \
                        self._pick(fired)
                    set_failpoint(name, spec)
                    faults = self.ACTIONS[action](self)
                    faults += self._recover()
                    # unarmed mix-in traffic so steps overlap subsystems
                    extra = self.rng.choice(
                        ("rpc", "insert", "reorg", "none"))
                    if extra != "none":
                        faults += self.ACTIONS[extra](self)
                        faults += self._quiesce()
                        faults += self._accept_pending()
                    self.step_log.append(
                        {"step": step, "action": action, "armed": name,
                         "spec": spec, "faults": faults})
                    self._check_invariants(step)
                finally:
                    self.watchdog.end()
            fired = self._fired_deltas()
            subsystems = sorted({sub for fp, sub, _a, _s in CATALOGUE
                                 if fired.get(fp, 0) > 0})
            result = {
                "seed": self.seed,
                "steps": self.steps,
                "violations": self.violations,
                "fired": fired,
                "coverage": {"failpoints_fired": len(fired),
                             "subsystems": subsystems},
                "kill_drill": self.kill_result,
                "step_log": self.step_log,
                "final": {
                    "height": self.chain.current_block.number,
                    "accepted": self.chain.last_accepted.number,
                    "root": self.chain.last_accepted.root.hex(),
                    "degraded_entries":
                        self._counter_delta("chain/degraded_entries"),
                    "degraded_recoveries":
                        self._counter_delta("chain/degraded_recoveries"),
                    "db_retries": self._counter_delta("db/retries"),
                    "db_verify_failures":
                        self._counter_delta("db/verify_failures"),
                    "corrupt_injected":
                        self._counter_delta("ethdb/corrupt_injected"),
                    "device_demotions":
                        self._counter_delta("ops/device/demotions"),
                    "mirror_quarantines":
                        self._counter_delta("chain/mirror/quarantines"),
                    "shard_crashes":
                        self._counter_delta("exec/shard/crashes"),
                    "shard_respawns":
                        self._counter_delta("exec/shard/respawns"),
                    "shard_fallbacks":
                        self._counter_delta("exec/shard/fallbacks"),
                    "profiler_errors":
                        self._counter_delta("profile/sampler_errors"),
                },
            }
            return result
        finally:
            self._shutdown()


def run_chaos(seed: int, steps: int, kill_drill: bool = True,
              step_budget: float = STEP_BUDGET,
              device=None) -> Dict[str, object]:
    """Run one conducted chaos session on `device` (None is CUDA);
    returns the deterministic result dict (same seed + steps ->
    byte-identical `json.dumps(..., sort_keys=True)`)."""
    return Conductor(seed, steps, kill_drill=kill_drill,
                     step_budget=step_budget, device=device).run()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m coreth_tpu_torch.fault.chaos",
        description="seeded cross-subsystem chaos conductor")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--json", action="store_true",
                    help="emit the full deterministic result as JSON")
    ap.add_argument("--no-kill-drill", action="store_true",
                    help="skip the SIGKILL-and-reboot subprocess drill")
    ap.add_argument("--step-budget", type=float, default=STEP_BUDGET,
                    help="watchdog seconds per step")
    ap.add_argument("--device", default=None,
                    help="the node's device (default: CUDA; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    result = run_chaos(args.seed, args.steps,
                       kill_drill=not args.no_kill_drill,
                       step_budget=args.step_budget, device=args.device)
    if args.json:
        print(json.dumps(result, sort_keys=True, indent=2))
    else:
        cov = result["coverage"]
        print(f"chaos seed={args.seed} steps={args.steps}: "
              f"{len(result['violations'])} violation(s), "
              f"{cov['failpoints_fired']} failpoint(s) fired across "
              f"{len(cov['subsystems'])} subsystem(s) "
              f"{cov['subsystems']}, "
              f"height={result['final']['height']}")
        for v in result["violations"]:
            print(f"  VIOLATION step={v['step']} {v['what']}: {v['detail']}")
    return 1 if result["violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
