"""The port's BlockChain against the JAX package's on its crash-recovery
and storage-fault paths, on the CPU: the in-process cases of
tests/test_tail_repair.py, tests/test_storage_faults.py,
tests/test_read_view.py and tests/test_populate_missing.py that need no
RPC server, SQLite store or child process (those parts are not ported:
ROADMAP "Still to port", items 3c and 8).

A reference chain and a port chain (device="cpu", the default trie path)
take the same blocks: built once by the reference's generate_chain over a
genesis state of their own (transactions signed with the reference's
signer) and decoded into the port. Both are driven through the same torn
disks, armed failpoints and failing stores, and must agree on the heads,
the canonical index on disk, the balances, the counters each package
keeps in its own registry and the flight-recorder events.

A store fault is the reference's FaultInjectingDB on its side and, on the
port's (whose fault-injecting store waits for item 8), a MemoryDB whose
puts and deletes raise the port's DBError while a budget lasts: the same
fault as the reference's `raise*N` on ethdb/before_put.
"""

import random
import threading
import time

import pytest

from coreth_tpu import fault as jfault
from coreth_tpu import params as jparams
from coreth_tpu.consensus.dummy import new_dummy_engine as j_new_dummy_engine
from coreth_tpu.core import rawdb as jrawdb
from coreth_tpu.core.blockchain import BlockChain as JBlockChain
from coreth_tpu.core.blockchain import CacheConfig as JCacheConfig
from coreth_tpu.core.blockchain import ChainDegradedError as \
    JChainDegradedError
from coreth_tpu.core.blockchain import ChainError as JChainError
from coreth_tpu.core.blockchain import TailStalled as JTailStalled
from coreth_tpu.core.chain_makers import generate_chain as j_generate_chain
from coreth_tpu.core.genesis import Genesis as JGenesis
from coreth_tpu.core.genesis import GenesisAccount as JGenesisAccount
from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.crypto.secp256k1 import priv_to_address
from coreth_tpu.ethdb import CorruptDataError as JCorruptDataError
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu.ethdb.faultdb import FaultInjectingDB
from coreth_tpu.metrics import default_registry as j_registry
from coreth_tpu.metrics import tracectx as jtracectx
from coreth_tpu.state.database import Database as JDatabase
from coreth_tpu.trie.triedb import TrieDatabase as JTrieDatabase
from coreth_tpu_torch import fault, params
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core import rawdb
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig, \
    ChainDegradedError, ChainError, TailStalled
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Block
from coreth_tpu_torch.ethdb import CorruptDataError, DBError, MemoryDB
from coreth_tpu_torch.metrics import default_registry
from coreth_tpu_torch.metrics import tracectx
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.trie.triedb import TrieDatabase

CHAIN_ID = 43112
KEY = b"\x11" * 32
ADDR = priv_to_address(KEY)
DEST = b"\xbb" * 20
FUND = 10**22


class FlakyDB(MemoryDB):
    """The port's MemoryDB whose puts and deletes raise DBError while
    `failing` is above 0, one fewer each time: the reference's
    FaultInjectingDB armed with `raise*N` on ethdb/before_put."""

    def __init__(self):
        super().__init__()
        self.failing = 0

    def _fire(self):
        if self.failing > 0:
            self.failing -= 1
            raise DBError("injected storage fault")

    def put(self, key, value):
        self._fire()
        super().put(key, value)

    def delete(self, key):
        self._fire()
        super().delete(key)


def tx(nonce, value=1000):
    t = JTransaction(type=2, chain_id=CHAIN_ID, nonce=nonce, max_fee=10**12,
                     max_priority_fee=10**9, gas=21000, to=DEST, value=value)
    return JSigner(CHAIN_ID).sign(t, KEY)


def counts(name):
    """(reference, port) counts of one counter, each in its own
    registry."""
    return (j_registry.counter(name).count(),
            default_registry.counter(name).count())


class Pair:
    """A genesis state to build blocks on and the two chains, each over a
    store of its own (a failing one with `flaky`)."""

    def __init__(self, pruning=True, commit_interval=4096, flaky=False,
                 **knobs):
        self.pruning = pruning
        self.commit_interval = commit_interval
        self.knobs = knobs
        jdisk = JMemoryDB()
        self.maker_db = JDatabase(JTrieDatabase(jdisk))
        self.genesis = self._jgenesis().commit(jdisk, self.maker_db)
        self.ref = self.open_ref(FaultInjectingDB(JMemoryDB()) if flaky
                                 else JMemoryDB())
        self.port = self.open_port(FlakyDB() if flaky else MemoryDB())
        assert self.port.genesis_block.hash() == self.genesis.hash()
        assert self.port.mirror is None  # "auto" is off on the CPU
        self._port_blocks = {}

    def _jgenesis(self):
        return JGenesis(config=jparams.TEST_CHAIN_CONFIG,
                        gas_limit=jparams.CORTINA_GAS_LIMIT,
                        alloc={ADDR: JGenesisAccount(balance=FUND)})

    def open_ref(self, disk):
        return JBlockChain(
            disk, JCacheConfig(pruning=self.pruning,
                               commit_interval=self.commit_interval,
                               **self.knobs),
            jparams.TEST_CHAIN_CONFIG, self._jgenesis(),
            j_new_dummy_engine(),
            state_database=JDatabase(JTrieDatabase(disk)))

    def open_port(self, disk):
        return BlockChain(
            disk, CacheConfig(pruning=self.pruning,
                              commit_interval=self.commit_interval,
                              **self.knobs),
            params.TEST_CHAIN_CONFIG,
            Genesis(config=params.TEST_CHAIN_CONFIG,
                    gas_limit=params.CORTINA_GAS_LIMIT,
                    alloc={ADDR: GenesisAccount(balance=FUND)}),
            new_dummy_engine(),
            state_database=Database(TrieDatabase(disk)), device="cpu")

    def reopen(self):
        """Both chains again over their stores, beside the old ones (the
        reference's tests reopen without a stop)."""
        old = (self.ref, self.port)
        self.ref = self.open_ref(self.ref.diskdb)
        self.port = self.open_port(self.port.diskdb)
        return old

    def blocks(self, n, parent=None, value=1000):
        parent = parent or self.genesis
        blocks, _ = j_generate_chain(
            jparams.TEST_CHAIN_CONFIG, parent, j_new_dummy_engine(),
            self.maker_db, n,
            gen=lambda i, bg: bg.add_tx(tx(parent.number + i, value)))
        return blocks

    def port_block(self, block):
        h = block.hash()
        if h not in self._port_blocks:
            self._port_blocks[h] = Block.decode(block.encode())
        return self._port_blocks[h]

    def do(self, op, block):
        getattr(self.ref, op)(block)
        getattr(self.port, op)(self.port_block(block))

    def both(self, op, *args, **kw):
        return (getattr(self.ref, op)(*args, **kw),
                getattr(self.port, op)(*args, **kw))

    def delete(self, key_fn, *args):
        """Delete one rawdb row from both stores (the key built by each
        package's own rawdb)."""
        self.ref.diskdb.delete(getattr(jrawdb, key_fn)(*args))
        self.port.diskdb.delete(getattr(rawdb, key_fn)(*args))

    def check(self):
        ref, port = self.ref, self.port
        assert port.current_block.hash() == ref.current_block.hash()
        assert port.last_accepted.hash() == ref.last_accepted.hash()
        assert port.degraded == ref.degraded
        for n in range(ref.current_block.number + 2):
            assert (rawdb.read_canonical_hash(port.diskdb, n)
                    == jrawdb.read_canonical_hash(ref.diskdb, n)), n
        assert (rawdb.read_head_block_hash(port.diskdb)
                == jrawdb.read_head_block_hash(ref.diskdb))
        assert port.state().get_balance(DEST) == \
            ref.state().get_balance(DEST)

    def stop(self, *extra):
        for chain in (self.ref, self.port) + extra:
            chain.stop()


@pytest.fixture(autouse=True)
def _clear_failpoints():
    yield
    fault.clear_all()
    jfault.clear_all()


# ------------------------------------------------------- torn-tail repair

def _build(p, n):
    blocks = p.blocks(n)
    for b in blocks:
        p.do("insert_block", b)
    p.both("join_tail")
    return blocks


def _check_repaired(p, blocks, before, head_n):
    assert p.port.current_block.number == head_n
    assert p.port.current_block.hash() == blocks[head_n - 1].hash()
    assert rawdb.read_canonical_hash(p.port.diskdb, head_n + 1) is None
    assert counts("chain/tail/torn_repairs") == (before[0] + 1,
                                                 before[1] + 1)
    jev = p.ref.flight_recorder.events(kind="tail/torn_repair")[-1]
    ev = p.port.flight_recorder.events(kind="tail/torn_repair")[-1]
    for k in ("torn_head", "torn_number", "repaired_number"):
        assert ev[k] == jev[k], k
    assert ev["repaired_number"] == head_n
    p.check()


def test_manufactured_torn_head_rewinds_at_boot():
    """The head block's body and receipts rows deleted behind the chain's
    back; the reopen rewinds both chains to the last complete block, and
    the lost block inserts again."""
    p = Pair()
    blocks = _build(p, 3)
    h3 = blocks[-1].hash()
    p.delete("body_key", 3, h3)
    p.delete("receipts_key", 3, h3)
    assert rawdb.read_head_block_hash(p.port.diskdb) == h3
    before = counts("chain/tail/torn_repairs")
    old = p.reopen()
    _check_repaired(p, blocks, before, 2)
    p.do("insert_block", blocks[2])
    p.both("join_tail")
    assert p.port.current_block.hash() == h3
    p.check()
    p.stop(*old)


def test_missing_header_number_row_still_repairs():
    """The torn head's header-number row is gone too: the scan finds the
    tip from the canonical rows."""
    p = Pair()
    blocks = _build(p, 3)
    h3 = blocks[-1].hash()
    for key_fn in ("header_key", "body_key", "receipts_key"):
        p.delete(key_fn, 3, h3)
    p.ref.diskdb.delete(jrawdb.HEADER_NUMBER_PREFIX + h3)
    p.port.diskdb.delete(rawdb.HEADER_NUMBER_PREFIX + h3)
    before = counts("chain/tail/torn_repairs")
    old = p.reopen()
    _check_repaired(p, blocks, before, 2)
    p.stop(*old)


def test_intact_head_is_left_alone():
    p = Pair()
    blocks = _build(p, 3)
    before = counts("chain/tail/torn_repairs")
    old = p.reopen()
    assert counts("chain/tail/torn_repairs") == before
    assert p.port.current_block.hash() == blocks[-1].hash()
    assert not p.port.flight_recorder.events(kind="tail/torn_repair")
    p.check()
    p.stop(*old)


def test_failpoint_torn_body_repairs_on_reopen():
    """`raise*1` on chain/tail/partial_body: the body item fails after
    the header writes while the head item lands, the disk state the boot
    scan is for; join_tail raises it once, and the reopen repairs it."""
    p = Pair()
    blocks = _build(p, 2)
    extra = p.blocks(1, parent=blocks[-1])[0]
    jfault.set_failpoint("chain/tail/partial_body", "raise*1")
    fault.set_failpoint("chain/tail/partial_body", "raise*1")
    p.do("insert_block", extra)
    with pytest.raises(JChainError, match="insert tail failed"):
        p.ref.join_tail()
    with pytest.raises(ChainError, match="insert tail failed"):
        p.port.join_tail()
    h3 = extra.hash()
    assert rawdb.read_head_block_hash(p.port.diskdb) == h3
    assert rawdb.read_body_rlp(p.port.diskdb, 3, h3) is None
    before = counts("chain/tail/torn_repairs")
    old = p.reopen()
    _check_repaired(p, blocks, before, 2)
    p.stop(*old)


# ---------------------------------------------------------- bounded joins

@pytest.mark.parametrize("by_knob", [False, True])
def test_join_tail_deadline_raises_tailstalled(by_knob):
    """A tail parked on chain/tail/before_body: join_tail's deadline (an
    argument, or the tail_join_timeout knob) raises TailStalled with the
    queue's depth; released, the unbounded join completes."""
    p = Pair(**({"tail_join_timeout": 0.3} if by_knob else {}))
    jfault.set_failpoint("chain/tail/before_body", "hang")
    fault.set_failpoint("chain/tail/before_body", "hang")
    p.do("insert_block", p.blocks(1)[0])
    kw = {} if by_knob else {"timeout": 0.3}
    for chain, exc in ((p.ref, JTailStalled), (p.port, TailStalled)):
        with pytest.raises(exc) as ei:
            chain.join_tail(**kw)
        assert ei.value.what == "insert tail"
        assert ei.value.depth >= 1
        assert "unfinished item(s) after" in str(ei.value)
    jfault.clear_all()
    fault.clear_all()
    p.both("join_tail", timeout=0)
    p.check()
    p.stop()


# ------------------------------------------------ retries and degraded rung

def test_transient_put_failure_is_retried_within_budget():
    p = Pair(flaky=True, db_retry_budget=2)
    r0, s0 = counts("db/retries"), counts("db/retry_successes")
    jfault.set_failpoint("ethdb/before_put", "raise*1")
    p.port.diskdb.failing = 1
    p.do("insert_block", p.blocks(1)[0])
    p.both("join_tail")
    for before, name in ((r0, "db/retries"), (s0, "db/retry_successes")):
        assert counts(name) == (before[0] + 1, before[1] + 1), name
    assert not p.port.degraded
    p.check()
    p.stop()


def test_degraded_chain_keeps_serving_then_recovers():
    """Persistent tail write failure demotes both chains to the degraded
    read-only rung: state reads and the read view keep answering, an
    insert raises ChainDegradedError on a failed probe write; disarmed,
    the next insert probes, replays the stashed tail in order and
    re-promotes, and nothing was lost."""
    p = Pair(flaky=True, db_retry_budget=1)
    blocks = p.blocks(3)
    p.do("insert_block", blocks[0])
    p.both("join_tail")
    p.do("accept", blocks[0])
    p.both("drain_acceptor_queue")
    assert not p.port.read_view().degraded
    entries = counts("chain/degraded_entries")
    recoveries = counts("chain/degraded_recoveries")

    jfault.set_failpoint("ethdb/before_put", "raise*64")
    p.port.diskdb.failing = 64
    p.do("insert_block", blocks[1])
    for chain in (p.ref, p.port):
        try:
            chain.join_tail()
        except Exception:  # noqa: BLE001 - the tear may surface here
            pass
        for _ in range(500):  # the flip lands from the tail worker
            if chain.read_view().degraded:
                break
            time.sleep(0.01)
        assert chain.degraded
        view = chain.read_view()
        assert view.degraded and view.accepted.hash() == blocks[0].hash()
        # reads keep serving through the rung
        st = chain.state_at_view(view, view.accepted.root)
        assert st.get_balance(DEST) == 1000
    assert counts("chain/degraded_entries") == (entries[0] + 1,
                                                entries[1] + 1)
    probes = counts("chain/degraded_probe_failures")
    with pytest.raises(JChainDegradedError, match="degraded"):
        p.ref.insert_block(blocks[2])
    with pytest.raises(ChainDegradedError, match="degraded"):
        p.port.insert_block(p.port_block(blocks[2]))
    assert counts("chain/degraded_probe_failures") == (probes[0] + 1,
                                                       probes[1] + 1)
    jevs = [e["event"] for e in p.ref.flight_recorder.events()]
    assert [e["event"] for e in p.port.flight_recorder.events()] == jevs

    jfault.clear_all()
    p.port.diskdb.failing = 0
    p.do("insert_block", blocks[2])
    p.both("join_tail")
    assert not p.port.degraded and not p.port.read_view().degraded
    assert counts("chain/degraded_recoveries") == (recoveries[0] + 1,
                                                   recoveries[1] + 1)
    jev = p.ref.flight_recorder.events(kind="chain/degraded_recovered")[-1]
    ev = p.port.flight_recorder.events(kind="chain/degraded_recovered")[-1]
    assert ev["replayed"] == jev["replayed"]
    assert p.port.current_block.hash() == blocks[2].hash()
    assert p.port.state().get_balance(DEST) == 3 * 1000
    for b in blocks[1:]:
        p.do("accept", b)
    p.both("drain_acceptor_queue")
    p.check()
    p.stop()


# --------------------------------------------------------- verify on read

def test_verify_on_read_catches_what_the_reference_catches():
    """db_verify_on_read mounts rawdb's re-hash (and a default chain
    unmounts it); a flipped header bit, a body that is not the header's
    and receipts that are not the header's raise CorruptDataError in both
    packages, each counted in db/verify_failures."""
    p = Pair(db_verify_on_read=True)
    assert rawdb.verify_on_read and jrawdb.verify_on_read
    blocks = _build(p, 2)
    h1, h2 = blocks[0].hash(), blocks[1].hash()
    before = counts("db/verify_failures")
    sides = ((p.ref, jrawdb, JCorruptDataError, blocks[1]),
             (p.port, rawdb, CorruptDataError, p.port_block(blocks[1])))
    for chain, rdb, exc, block2 in sides:
        db = chain.diskdb
        blob = bytearray(db.get(rdb.header_key(1, h1)))
        blob[0] ^= 0x01
        db.put(rdb.header_key(1, h1), bytes(blob))
        with pytest.raises(exc, match="keccak mismatch"):
            rdb.read_header_rlp(db, 1, h1)
        # block 1's body and an empty receipt list keyed under block 2's
        # hash: their roots are not block 2's header's
        db.put(rdb.body_key(2, h2), db.get(rdb.body_key(1, h1)))
        db.put(rdb.receipts_key(2, h2), b"\xc0")
        chain._blocks.pop(h2)
        chain._receipts.pop(h2)
        with pytest.raises(exc, match="body payload failed"):
            chain.get_block_by_number_and_hash(2, h2)
        chain._blocks[h2] = block2
        with pytest.raises(exc, match="receipts payload failed"):
            chain.get_receipts(h2)
    assert counts("db/verify_failures") == (before[0] + 3, before[1] + 3)
    p.stop()
    p2 = Pair()
    assert not rawdb.verify_on_read and not jrawdb.verify_on_read
    p2.stop()


# --------------------------------------------------------------- read view

def test_read_view_tracks_heads_and_reorgs():
    """Published at boot; a new seq at every insert, accept and
    preference flip, with the heads both chains report."""
    p = Pair(commit_interval=4)
    v0 = p.both("read_view")
    for v in v0:
        assert v.accepted.hash() == v.preferred.hash() == p.genesis.hash()
        assert not v.degraded
    a = p.blocks(1, value=7)[0]
    b = p.blocks(1, value=9)[0]
    p.do("insert_block", a)
    v1 = p.both("read_view")
    p.do("insert_block", b)  # a sibling of the preferred tip
    for old, new in zip(v0, v1):
        assert new.seq > old.seq
        assert new.preferred.hash() == a.hash()
        assert new.accepted.hash() == p.genesis.hash()
    p.do("set_preference", b)
    v2 = p.both("read_view")
    for old, new in zip(v1, v2):
        assert new.seq > old.seq and new.preferred.hash() == b.hash()
    p.do("accept", b)
    p.both("drain_acceptor_queue")
    for old, new in zip(v2, p.both("read_view")):
        assert new.seq > old.seq and new.accepted.hash() == b.hash()
    p.check()
    p.stop()


def test_concurrent_readers_see_only_fully_published_views():
    """Seeded readers on both chains while 24 blocks are inserted and
    accepted: every view is coherent (accepted never ahead of preferred)
    and each reader's views are monotonic in seq and accepted height; the
    state a view pins reads the funded sender."""
    p = Pair(commit_interval=4)
    blocks = p.blocks(24)
    stop = threading.Event()
    errors = []

    def reader(chain, seed):
        rng = random.Random(seed)
        last_seq = last_accepted = 0
        while not stop.is_set():
            try:
                v = chain.read_view()
                if v.seq < last_seq:
                    errors.append(f"seq regressed {last_seq} -> {v.seq}")
                if v.accepted.number < last_accepted:
                    errors.append("accepted regressed")
                if v.accepted.number > v.preferred.number:
                    errors.append("torn head")
                last_seq, last_accepted = v.seq, v.accepted.number
                if rng.random() < 0.3:
                    st = chain.state_at_view(v, v.accepted.root)
                    if st.get_balance(ADDR) <= 0:
                        errors.append("funded account read as empty")
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

    readers = [threading.Thread(target=reader, args=(chain, i))
               for i, chain in enumerate((p.ref, p.port, p.ref, p.port))]
    for t in readers:
        t.start()
    try:
        for b in blocks:
            p.do("insert_block", b)
            p.do("accept", b)
        p.both("drain_acceptor_queue")
    finally:
        stop.set()
        for t in readers:
            t.join()
    assert not errors, errors[:5]
    p.check()
    p.stop()


# ------------------------------------------------- populate_missing_tries

def _drop_root(chain, block):
    chain.diskdb.delete(block.root)
    chain.state_database.triedb._dirties.pop(block.root, None)
    chain.state_database.triedb._cleans.pop(block.root, None)
    assert not chain.has_state(block.root)


def test_populate_missing_tries_heals_like_reference():
    """An archival chain (pruning=False) with root nodes deleted, two of
    them consecutive: both heal the same blocks, forward; the healed
    states read; a second scan heals nothing."""
    p = Pair(pruning=False)
    blocks = p.blocks(12)
    for b in blocks:
        p.do("insert_block", b)
        p.do("accept", b)
    p.both("drain_acceptor_queue")
    holes = [blocks[i] for i in (2, 5, 6, 9)]
    for chain in (p.ref, p.port):
        for b in holes:
            _drop_root(chain, b)
    assert p.both("populate_missing_tries", 1, parallelism=4) == (4, 4)
    for b in holes:
        for chain in (p.ref, p.port):
            assert chain.has_state(b.root)
            assert chain.state_at(b.root).get_nonce(ADDR) == b.number
        assert p.port.diskdb.get(b.root) == p.ref.diskdb.get(b.root)
    assert p.both("populate_missing_tries", 1, parallelism=4) == (0, 0)
    p.check()
    p.stop()


def test_populate_missing_tries_unhealable_gap_raises():
    """The scan starts at a block whose parent state is gone too and out
    of its range: both raise."""
    p = Pair(pruning=False)
    blocks = p.blocks(8)
    for b in blocks:
        p.do("insert_block", b)
        p.do("accept", b)
    p.both("drain_acceptor_queue")
    for chain in (p.ref, p.port):
        _drop_root(chain, blocks[4])
        _drop_root(chain, blocks[5])
    with pytest.raises(JChainError, match="parent state unavailable"):
        p.ref.populate_missing_tries(blocks[5].number, parallelism=4)
    with pytest.raises(ChainError, match="parent state unavailable"):
        p.port.populate_missing_tries(blocks[5].number, parallelism=4)
    p.stop()


# ------------------------------------------------------- insert SLO budget

@pytest.mark.parametrize("budget", [0.0, 1e-9])
def test_insert_slo_budget_captures_slow_inserts(budget):
    """insert_slo_budget above 0: an insert slower than it is captured
    into the trace ring as "slow", with the budget it went over; at the
    default 0 nothing is captured. Both packages alike."""
    assert tracectx.enabled and jtracectx.enabled
    p = Pair(insert_slo_budget=budget)
    b = p.blocks(1)[0]
    p.do("insert_block", b)
    got = []
    for chain, ring in ((p.ref, jtracectx.ring), (p.port, tracectx.ring)):
        tid = chain.flight_recorder.find(b.hash())["trace_id"]
        assert tid
        got.append(ring.get(tid))
    if budget == 0.0:
        assert got == [None, None]
    else:
        jrec, rec = got
        assert rec["outcome"] == jrec["outcome"] == "slow"
        assert rec["meta"] == jrec["meta"]
        assert rec["meta"]["over_slo_budget_s"] == budget
        assert rec["meta"]["number"] == 1 and rec["meta"]["txs"] == 1
    p.stop()
