"""The port's resident chain against the JAX package's, on the CPU: the
cases of tests/test_resident_chain.py (its pruner, VM and miner cases
wait for ROADMAP items 10 and 3c) and the failover corpus of
tests/test_resident_failover.py in the port's rule.

Both chains run resident_account_trie=True: the reference pinned to its
device path (resident_prefer_host=False, its XLA executor on the CPU),
the port on device="cpu" (ResidentExecutor with K1's plain version).
Blocks are built once by the reference's generate_chain over a genesis
state of their own and decoded into the port; both chains take the same
inserts, accepts, rejects, restarts and quarantines, and after each step
agree on the head, the last accepted block, the canonical index, the
mirror's root of every block inserted, and the balances and nonces.

Failover, the port's rule: a commit whose device does not answer within
the watchdog raises DeviceWedgedError from insert_block (counted in
state/resident/device_wedges) and the head stays where it was; nothing
moves to the host until the caller calls take_over_host() (which the
flight recorder notes). The retried insert then lands, and the final
roots and heads equal the reference chain's, which took over by itself.
A wedge in the acceptor's interval export lands in acceptor_error.

Beside them: "auto" is off with device="cpu"; the mesh knob shards the
port's mirror; a device that does not resolve refuses the chain.
"""

import random
import threading

import pytest
import torch

from coreth_tpu import fault as jfault
from coreth_tpu import params as jparams
from coreth_tpu.consensus.dummy import new_dummy_engine as j_new_dummy_engine
from coreth_tpu.core.blockchain import BlockChain as JBlockChain
from coreth_tpu.core.blockchain import CacheConfig as JCacheConfig
from coreth_tpu.core.chain_makers import generate_chain as j_generate_chain
from coreth_tpu.core.genesis import Genesis as JGenesis
from coreth_tpu.core.genesis import GenesisAccount as JGenesisAccount
from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.crypto.secp256k1 import priv_to_address
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu.metrics import default_registry as j_registry
from coreth_tpu.state.database import Database as JDatabase
from coreth_tpu.trie.triedb import TrieDatabase as JTrieDatabase
from coreth_tpu_torch import fault, params
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig, \
    ChainError
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.state_manager import CappedMemoryTrieWriter, \
    ResidentTrieWriter
from coreth_tpu_torch.core.types import Block, create_address
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.metrics import default_registry
from coreth_tpu_torch.native import mpt
from coreth_tpu_torch.device import DeviceWedgedError
from coreth_tpu_torch.ops.device import get_batch_keccak
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.trie import planned
from coreth_tpu_torch.trie.triedb import TrieDatabase

from test_resident_failover import WedgyExecutor as JWedgyExecutor

CHAIN_ID = 43112
KEY1 = b"\x11" * 32
KEY2 = b"\x22" * 32
ADDR1 = priv_to_address(KEY1)
ADDR2 = priv_to_address(KEY2)
FUND = 10**22
BASE_FEE = jparams.APRICOT_PHASE3_INITIAL_BASE_FEE

# the storage-heavy corpus: 24 senders deploying 6-slot contracts
N_SENDERS = 24
KEYS = [i.to_bytes(1, "big") * 32 for i in range(1, N_SENDERS + 1)]
ADDRS = [priv_to_address(k) for k in KEYS]


def _counter(name):
    return default_registry.counter(name).count()


def transfer(nonce, to, key, base_fee, value=1000):
    tx = JTransaction(type=2, chain_id=CHAIN_ID, nonce=nonce,
                      max_fee=base_fee * 2, max_priority_fee=0, gas=21000,
                      to=to, value=value)
    return JSigner(CHAIN_ID).sign(tx, key)


def tx_gen(counts=None):
    counts = {} if counts is None else counts

    def gen(i, bg):
        nonce = counts.get(ADDR1, 0)
        bg.add_tx(transfer(nonce, ADDR2, KEY1, bg.base_fee() or BASE_FEE,
                           value=1000 + i))
        counts[ADDR1] = nonce + 1

    return gen


class _Wedgy:
    """A port ResidentExecutor stand-in: forwards to the real one until a
    wedge flag flips; then the flagged seam (run, or the store readback of
    an export) waits on `release`, which the test sets at its end, and
    gives up without touching the executor: a device that stops
    answering."""

    def __init__(self, real):
        self._real = real
        self.wedge_run = False
        self.wedge_store = False
        self.release = threading.Event()

    def _hang(self):
        # bounded: a test that never releases still ends this thread
        self.release.wait(120)
        raise RuntimeError("the wedged call was abandoned")

    def run(self, export):
        if self.wedge_run:
            self._hang()
        return self._real.run(export)

    def store_parts(self):
        if self.wedge_store:
            self._hang()
        return self._real.store_parts()

    @property
    def last_root(self):
        return self._real.last_root

    @last_root.setter
    def last_root(self, v):
        self._real.last_root = v

    def __getattr__(self, name):
        return getattr(self._real, name)


class Chains:
    """A genesis state to build blocks on (the reference's generate_chain
    over a Database of its own) and the two resident chains."""

    def __init__(self, alloc=None, commit_interval=4096, spot=0,
                 port_marker=None, port_knobs=None):
        self.alloc = alloc or {ADDR1: FUND, ADDR2: FUND}
        self.commit_interval = commit_interval
        self.spot = spot
        self.port_marker = port_marker
        self.port_knobs = port_knobs or {}
        jdisk = JMemoryDB()
        self.maker_db = JDatabase(JTrieDatabase(jdisk))
        self.genesis = self._jgenesis().commit(jdisk, self.maker_db)
        self.ref = self.open_ref()
        self.port = self.open_port()
        assert self.port.genesis_block.hash() == self.genesis.hash()
        assert isinstance(self.port.trie_writer, ResidentTrieWriter)
        assert self.port.mirror is not None
        assert not self.port.mirror.host_mode
        self.inserted = {}  # hash -> block, every block both hold
        self._port_blocks = {}
        self.wedges = []

    def _jgenesis(self):
        return JGenesis(config=jparams.TEST_CHAIN_CONFIG,
                        gas_limit=jparams.CORTINA_GAS_LIMIT,
                        alloc={a: JGenesisAccount(balance=b)
                               for a, b in self.alloc.items()})

    def open_ref(self, disk=None):
        disk = disk if disk is not None else JMemoryDB()
        return JBlockChain(
            disk, JCacheConfig(
                pruning=True, resident_account_trie=True,
                commit_interval=self.commit_interval,
                resident_prefer_host=False,
                resident_spot_check_interval=self.spot),
            jparams.TEST_CHAIN_CONFIG, self._jgenesis(),
            j_new_dummy_engine(),
            state_database=JDatabase(JTrieDatabase(disk)))

    def open_port(self, disk=None):
        disk = disk if disk is not None else MemoryDB()
        return BlockChain(
            disk, CacheConfig(
                pruning=True, resident_account_trie=True,
                commit_interval=self.commit_interval,
                resident_spot_check_interval=self.spot, **self.port_knobs),
            params.TEST_CHAIN_CONFIG,
            Genesis(config=params.TEST_CHAIN_CONFIG,
                    gas_limit=params.CORTINA_GAS_LIMIT,
                    alloc={a: GenesisAccount(balance=b)
                           for a, b in self.alloc.items()}),
            new_dummy_engine(),
            state_database=Database(TrieDatabase(
                disk, batch_keccak=self.port_marker)),
            device="cpu")

    def reopen(self, crash=False):
        """Both chains over their stores again: after stop(), or after a
        crash (no shutdown export: only the acceptor is retired)."""
        for chain in (self.ref, self.port):
            if crash:
                chain._acceptor_queue.put(None)
            else:
                chain.stop()
        self.ref = self.open_ref(self.ref.diskdb)
        self.port = self.open_port(self.port.diskdb)
        self.check()

    def blocks(self, n, gen, parent=None):
        blocks, _ = j_generate_chain(
            jparams.TEST_CHAIN_CONFIG, parent or self.genesis,
            j_new_dummy_engine(), self.maker_db, n, gen=gen)
        return blocks

    def port_block(self, block):
        h = block.hash()
        if h not in self._port_blocks:
            self._port_blocks[h] = Block.decode(block.encode())
        return self._port_blocks[h]

    def do(self, op, block, chains=None, **kw):
        for chain in chains or (self.ref, self.port):
            blk = block if chain is self.ref else self.port_block(block)
            getattr(chain, op)(blk, **kw)
        if op.startswith("insert"):
            self.inserted[block.hash()] = block
        if op == "accept":
            self.drain()

    def drain(self):
        for chain in (self.ref, self.port):
            chain.drain_acceptor_queue()
        assert self.ref.acceptor_error is None, self.ref.acceptor_error
        assert self.port.acceptor_error is None, self.port.acceptor_error

    def check(self, addrs=(ADDR1, ADDR2)):
        ref, port = self.ref, self.port
        assert port.current_block.hash() == ref.current_block.hash()
        assert port.last_accepted.hash() == ref.last_accepted.hash()
        for n in range(ref.current_block.number + 2):
            assert port.get_canonical_hash(n) == ref.get_canonical_hash(n)
        for b in self.inserted.values():
            assert port.mirror.root_of(b.hash()) == \
                ref.mirror.root_of(b.hash()), b.number
        s_ref, s_port = ref.state(), port.state()
        for a in addrs:
            assert s_port.get_balance(a) == s_ref.get_balance(a)
            assert s_port.get_nonce(a) == s_ref.get_nonce(a)
        assert not port.bad_blocks

    def arm(self):
        """Wedgeable executors with a generous watchdog on both mirrors;
        `wedge(seam)` then cuts the budget and blocks the seam."""
        self.jw = JWedgyExecutor(self.ref.mirror.ex)
        self.ref.mirror.ex = self.jw
        self.ref.mirror.device_timeout = 60.0
        self.w = _Wedgy(self.port.mirror.ex)
        self.port.mirror.ex = self.w
        self.port.mirror.device_timeout = 60.0
        self.wedges.append(self.w)

    def wedge(self, seam="run"):
        for m in (self.ref.mirror, self.port.mirror):
            m.device_timeout = 0.5
        setattr(self.jw, "wedge_" + seam, True)
        setattr(self.w, "wedge_" + seam, True)

    def stop(self):
        for w in self.wedges:
            w.release.set()
        self.ref.stop()
        self.port.stop()


@pytest.fixture(autouse=True)
def _clear_port_failpoints():
    """The port's failpoints and its degradation ladder are process-global
    (a chain's take_over_host demotes the ladder): each case ends with
    both cleared."""
    yield
    fault.clear_all()
    from coreth_tpu_torch.ops.device import default_ladder

    default_ladder().reset()


def _linear_chain(c):
    tr = c.port.state_database.open_trie(c.port.last_accepted.root)
    assert getattr(tr, "resident", False)
    blocks = c.blocks(5, tx_gen())
    for b in blocks:
        c.do("insert_block", b)
        c.check()
    for b in blocks:
        c.do("accept", b)
    c.check()
    st = c.port.state()
    assert st.get_balance(ADDR2) == FUND + sum(1000 + i for i in range(5))
    assert st.get_balance(b"\x99" * 20) == 0
    assert not c.port.mirror.host_mode
    assert c.port.flight_recorder.last(1)[0]["host_mode"] is False
    c.stop()


def test_linear_chain_matches_reference():
    """TestResidentLinearChain: the writer and facade are installed, and
    five blocks land with the reference's roots and states; the mirror
    stays on the device."""
    _linear_chain(Chains())


@pytest.mark.parametrize("port_knobs", [
    {"resident_pipeline_depth": 2, "resident_lean_rows": True},
    {"resident_template_residency": True},
], ids=["pipelined-lean", "template"])
def test_linear_chain_with_mirror_options_matches_reference(port_knobs):
    """The port's chain with the mirror's options that CacheConfig hands
    it (pipelined commits on lean rows, template residency) against the
    reference's default chain: the same roots and states."""
    c = Chains(port_knobs=port_knobs)
    m = c.port.mirror
    assert m.pipeline_depth == port_knobs.get("resident_pipeline_depth", 0)
    assert m.lean_rows == port_knobs.get("resident_lean_rows", False)
    assert m.template == port_knobs.get("resident_template_residency",
                                        False)
    _linear_chain(c)


def _siblings(c, parent=None):
    def gen_a(i, bg):
        bg.add_tx(transfer(0, ADDR2, KEY1, bg.base_fee() or BASE_FEE, 111))

    def gen_b(i, bg):
        bg.add_tx(transfer(0, ADDR1, KEY2, bg.base_fee() or BASE_FEE, 222))

    return c.blocks(1, gen_a, parent)[0], c.blocks(1, gen_b, parent)[0]


def test_sibling_verify_and_reject():
    c = Chains()
    a, b = _siblings(c)
    c.do("insert_block", a)
    c.do("insert_block_manual", b, writes=True)
    assert c.port.has_state(a.root) and c.port.has_state(b.root)
    assert c.port.state_at(b.root).get_balance(ADDR1) == FUND + 222
    c.do("accept", a)
    c.do("reject", b)
    assert c.port.mirror.root_of(b.hash()) is None
    c.inserted.pop(b.hash())
    c.check()
    c.stop()


def test_accept_non_canonical():
    c = Chains()
    a, b = _siblings(c)
    c.do("insert_block", a)
    c.do("insert_block_manual", b, writes=True)
    assert c.port.current_block.hash() == a.hash()
    c.do("accept", b)
    c.do("reject", a)
    c.inserted.pop(a.hash())
    assert c.port.current_block.hash() == b.hash()
    c.check()
    c.stop()


def test_interval_export_and_restart():
    """commit_interval 2: exports at the interval and at shutdown; both
    chains reopen over their stores at the tip with equal state, and the
    port's export is a subset of the reference's."""
    c = Chains(commit_interval=2)
    blocks = c.blocks(4, tx_gen())
    for b in blocks:
        c.do("insert_block", b)
        c.do("accept", b)
    c.inserted = {}
    c.reopen()
    assert c.port.last_accepted.hash() == blocks[-1].hash()
    assert c.port.state().get_nonce(ADDR1) == 4
    # the tip's account trie reads straight from the port's disk image
    tdb = TrieDatabase(c.port.diskdb)
    assert tdb.open_state_trie(blocks[-1].root).get(ADDR2)
    c.stop()


def _storage_gen(i, bg):
    bf = bg.base_fee() or BASE_FEE
    for j in range(N_SENDERS):
        code = bytearray()
        for s in range(6):
            v = ((i * N_SENDERS + j) * 31 + s * 7 + 1) % 256 or 1
            code += bytes([0x60, v, 0x60, s, 0x55])
        code += bytes([0x60, 0x00, 0x60, 0x00, 0xF3])
        tx = JTransaction(type=2, chain_id=CHAIN_ID, nonce=i,
                          max_fee=bf * 2, max_priority_fee=0, gas=200_000,
                          to=None, value=0, data=bytes(code))
        bg.add_tx(JSigner(CHAIN_ID).sign(tx, KEYS[j]))


def test_storage_heavy_blocks_in_one_planned_program(monkeypatch):
    """TestResidentStorageContracts and TestResidentStorageBatch: blocks of
    contract deployments on a port chain with the planned marker hash
    each block's dirty storage tries in ONE planned program with no
    account trie (the mirror holds that); roots, slots and receipts equal
    the reference's."""
    runs = {"n": 0, "account": 0}
    orig = planned.PlannedGraphBuilder.run

    def counted(selfb, *a, **kw):
        runs["n"] += 1
        runs["account"] += selfb._account is not None
        return orig(selfb, *a, **kw)

    monkeypatch.setattr(planned.PlannedGraphBuilder, "run", counted)
    c = Chains(alloc={a: FUND for a in ADDRS},
               port_marker=get_batch_keccak("planned", "cpu"))
    blocks = c.blocks(2, _storage_gen)
    for n, b in enumerate(blocks, 1):
        c.do("insert_block", b)
        assert runs["n"] == n and runs["account"] == 0
        c.do("accept", b)
    c.check(ADDRS)
    s_ref, s_port = c.ref.state(), c.port.state()
    for i in range(2):
        for j in range(N_SENDERS):
            ca = create_address(ADDRS[j], i)
            for slot in range(6):
                k = slot.to_bytes(32, "big")
                assert s_port.get_state(ca, k) == s_ref.get_state(ca, k)
    for b in blocks:
        assert [r.encode() for r in c.port.get_receipts(b.hash())] == \
            [r.encode() for r in c.ref.get_receipts(b.hash())]
    c.stop()


def test_unclean_shutdown_reprocesses_tail():
    """A crash mid-interval (no shutdown export): both chains re-execute
    from the last exported root at boot, then extend through the mirror."""
    c = Chains(commit_interval=3)
    counts = {}
    for b in c.blocks(5, tx_gen(counts)):
        c.do("insert_block", b)
        c.do("accept", b)
    tip = c.port.last_accepted
    c.inserted = {}
    c.reopen(crash=True)
    assert c.port.last_accepted.hash() == tip.hash()
    assert c.port.mirror is not None
    more = c.blocks(2, tx_gen(counts), parent=c.ref.last_accepted)
    for b in more:
        c.do("insert_block", b)
        c.do("accept", b)
    c.check()
    assert c.port.state().get_nonce(ADDR1) == 7
    c.stop()


def _fork_rounds(c, rng, rounds, wedge_round=None):
    """TestResidentReorgFuzz: each round two competing children of the
    last accepted block, both inserted, a random winner accepted and the
    loser rejected. With `wedge_round`, the port's device stops answering
    before that round: its insert raises DeviceWedgedError with the head
    unchanged, the caller takes over on the host and retries."""
    nonces = {ADDR1: 0, ADDR2: 0}
    for rnd in range(rounds):
        if rnd == wedge_round:
            c.wedge("run")
        parent = c.ref.last_accepted
        key, sender = ((KEY1, ADDR1) if rng.random() < 0.5
                       else (KEY2, ADDR2))
        to = ADDR2 if sender == ADDR1 else ADDR1
        kids = [c.blocks(1, lambda i, bg, v=v: bg.add_tx(transfer(
            nonces[sender], to, key, bg.base_fee() or BASE_FEE, v)),
            parent)[0] for v in (100 + rnd, 200 + rnd)]
        if rnd == wedge_round:
            c.do("insert_block_manual", kids[0], chains=(c.ref,), writes=True)
            head = c.port.current_block.hash()
            with pytest.raises(DeviceWedgedError):
                c.port.insert_block_manual(c.port_block(kids[0]), True)
            assert c.port.current_block.hash() == head
            assert not c.port.mirror.host_mode
            c.port.take_over_host()
            c.do("insert_block_manual", kids[0], chains=(c.port,),
                 writes=True)
            c.do("insert_block_manual", kids[1], writes=True)
        else:
            for kid in kids:
                c.do("insert_block_manual", kid, writes=True)
        assert c.port.state_at(kids[0].root).get_balance(to) == \
            c.ref.state_at(kids[0].root).get_balance(to)
        win, lose = kids if rng.random() < 0.5 else kids[::-1]
        c.do("accept", win)
        c.do("reject", lose)
        c.inserted.pop(lose.hash())
        nonces[sender] += 1
        c.check()


def test_seeded_fork_fuzz_matches_reference():
    c = Chains()
    _fork_rounds(c, random.Random(1234), 8)
    c.stop()


def test_spot_check_forced_divergence_quarantines():
    """TestSpotCheck: spot checks every insert pass on a clean mirror; a
    forced divergence (the state/resident/spot_check failpoint, once)
    quarantines the mirror in both chains: rebuilt from the last accepted
    state, the block re-inserted, the chain carried on bit-exact."""
    c = Chains(spot=1)
    checks = _counter("state/resident/spot_checks")
    q0, jq0 = _counter("chain/mirror/quarantines"), \
        j_registry.counter("chain/mirror/quarantines").count()
    blocks = c.blocks(4, tx_gen())
    fault.set_failpoint("state/resident/spot_check", "raise*1")
    jfault.set_failpoint("state/resident/spot_check", "raise*1")
    c.do("insert_block", blocks[0])
    assert _counter("chain/mirror/quarantines") == q0 + 1
    assert j_registry.counter("chain/mirror/quarantines").count() == jq0 + 1
    assert c.port.flight_recorder.events(kind="mirror/quarantine")
    c.inserted = {}
    for b in blocks:
        c.do("insert_block", b)
        c.do("accept", b)
    c.check()
    assert _counter("chain/mirror/quarantines") == q0 + 1
    assert _counter("state/resident/spot_checks") == checks + 5
    assert c.port.state().get_nonce(ADDR1) == 4
    c.stop()


@pytest.mark.parametrize("restart", [False, True])
def test_wedge_mid_commit_raises_until_taken_over(restart):
    """The device dies mid-commit. The reference takes over by itself; the
    port's insert raises DeviceWedgedError (one wedge counted, no bad
    block, head unchanged, still not on the host, and again on a retry)
    until the caller calls take_over_host(); then the retried insert and
    the rest land with the reference's roots, and (restart) both chains
    reopen at the tip."""
    c = Chains(commit_interval=2)
    c.arm()
    blocks = c.blocks(6, tx_gen())
    for b in blocks[:3]:
        c.do("insert_block", b)
        c.do("accept", b)
    wedges = _counter("state/resident/device_wedges")
    takeovers = _counter("state/resident/device_takeovers")
    c.wedge("run")
    c.do("insert_block", blocks[3], chains=(c.ref,))
    assert c.ref.mirror.host_mode  # the reference moved by itself
    head = c.port.current_block.hash()
    for _ in range(2):
        with pytest.raises(DeviceWedgedError):
            c.port.insert_block(c.port_block(blocks[3]))
        assert c.port.current_block.hash() == head
        assert not c.port.mirror.host_mode
    assert _counter("state/resident/device_wedges") == wedges + 1
    assert _counter("state/resident/device_takeovers") == takeovers
    assert not c.port.bad_blocks
    c.port.take_over_host()
    assert _counter("state/resident/device_takeovers") == takeovers + 1
    assert c.port.flight_recorder.events(kind="mirror/takeover")
    c.do("insert_block", blocks[3], chains=(c.port,))
    c.do("accept", blocks[3])
    for b in blocks[4:]:
        c.do("insert_block", b)
        c.do("accept", b)
    c.check()
    if restart:
        c.inserted = {}
        c.reopen()
        assert c.port.last_accepted.hash() == blocks[-1].hash()
        assert not c.port.mirror.host_mode  # a fresh mirror, on the device
    c.stop()


def test_wedge_mid_export_lands_in_acceptor_error():
    """The store readback of the interval export hangs on the acceptor
    thread. The reference takes over there; the port records the wedge in
    acceptor_error, finishes the accept's host work, and its next insert
    raises until take_over_host(); then the chain carries on and a
    restart recovers the tip from the host-written image."""
    c = Chains(commit_interval=2)
    c.arm()
    blocks = c.blocks(4, tx_gen())
    c.do("insert_block", blocks[0])
    c.do("accept", blocks[0])
    c.do("insert_block", blocks[1])
    c.wedge("store")
    c.do("accept", blocks[1], chains=(c.ref,))
    c.port.accept(c.port_block(blocks[1]))
    c.port.drain_acceptor_queue()
    assert "DeviceWedgedError" in c.port.acceptor_error or \
        "wedged" in c.port.acceptor_error
    c.port.acceptor_error = None
    c.ref.drain_acceptor_queue()
    assert c.ref.mirror.host_mode and not c.port.mirror.host_mode
    assert c.port.bloom_indexer._filled[2]  # the accept's host work ran
    with pytest.raises(DeviceWedgedError):
        c.port.insert_block(c.port_block(blocks[2]))
    c.port.take_over_host()
    for b in blocks[2:]:
        c.do("insert_block", b)
        c.do("accept", b)
    c.check()
    c.inserted = {}
    c.reopen()
    assert c.port.last_accepted.hash() == blocks[-1].hash()
    c.stop()


def test_fork_fuzz_with_midstream_wedge():
    """The fork fuzz with the port's device dying at a random round: the
    takeover lands mid-competition and every later round still matches
    the reference chain."""
    rng = random.Random(7)
    c = Chains(commit_interval=3)
    c.arm()
    _fork_rounds(c, rng, 5, wedge_round=rng.randrange(1, 4))
    assert c.port.mirror.host_mode and c.ref.mirror.host_mode
    c.stop()


def test_takeover_preserves_reorg_capability():
    """After the takeover a sibling verifies against an older parent
    (rewind and replay on the host); the head does not move."""
    c = Chains(commit_interval=100)
    c.arm()
    counts = {}
    blocks = c.blocks(3, tx_gen(counts))
    c.do("insert_block", blocks[0])
    c.wedge("run")
    c.do("insert_block", blocks[1], chains=(c.ref,))
    with pytest.raises(DeviceWedgedError):
        c.port.insert_block(c.port_block(blocks[1]))
    c.port.take_over_host()
    c.do("insert_block", blocks[1], chains=(c.port,))
    c.do("insert_block", blocks[2])
    sib = c.blocks(1, tx_gen({ADDR1: 1}), parent=blocks[0])[0]
    c.do("insert_block", sib)
    assert c.port.mirror.root_of(sib.hash()) == sib.root
    assert c.port.current_block.hash() == blocks[-1].hash()
    c.check()
    c.stop()


def test_auto_is_off_on_the_cpu():
    """The default CacheConfig ("auto") with device="cpu": no mirror, the
    capped writer, as the reference's "auto" without a TPU."""
    disk = MemoryDB()
    chain = BlockChain(
        disk, CacheConfig(), params.TEST_CHAIN_CONFIG,
        Genesis(config=params.TEST_CHAIN_CONFIG,
                alloc={ADDR1: GenesisAccount(balance=FUND)}),
        new_dummy_engine(), device="cpu")
    assert chain.mirror is None
    assert chain.state_database.mirror is None
    assert isinstance(chain.trie_writer, CappedMemoryTrieWriter)
    assert getattr(chain.state_database.triedb.batch_keccak, "planned")
    chain.stop()


def _genesis():
    return Genesis(config=params.TEST_CHAIN_CONFIG,
                   alloc={ADDR1: GenesisAccount(balance=FUND)})


@pytest.mark.parametrize("knob,value,want", [
    ("device_call_timeout", 1.0, ("call_timeout", 1.0)),
    ("device_max_retries", 3, ("refused", "Queue 3")),
    ("device_probe_interval", 0.0, ("probe_interval", 0.0)),
    ("device_promote_after", 1, ("promote_after", 1)),
])
def test_ladder_knobs_configure_the_ladder(knob, value, want):
    """The knobs of the degradation ladder (item 5) are honoured: the chain
    configures the process ladder from them and listens to it until
    stop(). device_max_retries is refused but at 0: the port retries no
    device dispatch (ROADMAP Queue 3)."""
    from coreth_tpu_torch.ops.device import default_ladder

    lad = default_ladder()
    try:
        if want[0] == "refused":
            with pytest.raises(ValueError, match=want[1]):
                BlockChain(MemoryDB(), CacheConfig(**{knob: value}),
                           params.TEST_CHAIN_CONFIG, _genesis(),
                           new_dummy_engine(), device="cpu")
            return
        chain = BlockChain(MemoryDB(), CacheConfig(**{knob: value}),
                           params.TEST_CHAIN_CONFIG, _genesis(),
                           new_dummy_engine(), device="cpu")
        assert lad.status()[want[0]] == want[1]
        assert chain._on_device_event in lad._listeners
        chain.stop()
        assert chain._on_device_event not in lad._listeners
    finally:
        lad.reset()


@pytest.mark.parametrize("width", [2, 4])
def test_mesh_knob_matches_reference(width):
    """resident_mesh_devices, which raised before the mesh was ported:
    the port's chain shards its mirror `width` ways (virtual positions on
    the chain's CPU device) and lands the reference's unsharded chain's
    roots and states; the flight record says how many shards."""
    c = Chains(port_knobs={"resident_mesh_devices": width})
    assert c.port.mirror.shards == c.port.mirror.ex.shards == width
    for b in c.blocks(3, tx_gen()):
        c.do("insert_block", b)
        c.check()
        c.do("accept", b)
    c.check()
    assert c.port.flight_recorder.last(1)[0]["resident"]["shards"] == width
    c.stop()


@pytest.mark.parametrize("knobs,shadow,interval", [
    ({"state_backend": "bintrie-shadow"}, True, 16),
    ({"state_backend": "bintrie-shadow", "shadow_check_interval": 4},
     True, 4),
    ({"shadow_check_interval": 4}, False, None),
])
def test_shadow_knobs_mount_the_shadow(knobs, shadow, interval):
    """The knobs of the bintrie shadow (item 10's bintrie, which raised
    here before it landed) boot a chain: "bintrie-shadow" mounts a
    ShadowCommitment with the interval asked for, anchored by the genesis
    commit; the interval alone mounts nothing, as in the reference."""
    chain = BlockChain(MemoryDB(), CacheConfig(**knobs),
                       params.TEST_CHAIN_CONFIG, _genesis(),
                       new_dummy_engine(), device="cpu")
    sh = chain.state_database.shadow
    assert (sh is not None) == shadow
    if shadow:
        assert sh.check_interval == interval
        assert sh.root_for(chain.genesis_block.root) is not None
        assert sh.status()["commits"] == 1 and not sh.quarantined
    chain.stop()


@pytest.mark.parametrize("knob,value", [
    ("insert_pipeline_depth", 2),
    ("evm_parallel_workers", 4),
    ("evm_exec_shards", 2),
])
def test_execution_option_knobs_reach_their_modes(knob, value):
    """The three knobs of the execution options (item 3b.3) build a
    resident chain that runs a block in the mode asked for: the pipeline
    ("spec"), the thread-parallel executor or the shards, with the mirror
    holding the header's root."""
    c = Chains(port_knobs={knob: value})

    def gen(i, bg):
        for j, key in enumerate((KEY1, KEY2)):
            bg.add_tx(transfer(i, bytes([0x90 + j]) * 20, key,
                               bg.base_fee() or BASE_FEE))

    blocks = c.blocks(2, gen)
    for b in blocks:
        c.do("insert_block", b)
    if c.port.pipeline is not None:
        c.port.pipeline.drain()
    rec = c.port.flight_recorder.find(blocks[-1].hash())
    want = {"insert_pipeline_depth": ("pipeline-spec", "spec"),
            "evm_parallel_workers": ("parallel", None),
            "evm_exec_shards": ("shards", None)}[knob]
    assert (rec["parallel"]["mode"], rec.get("pipeline", {}).get("mode")) \
        == want
    assert getattr(c.port.cache_config, knob) == value
    c.check()
    c.stop()


def test_device_that_does_not_resolve_refuses_the_chain(monkeypatch):
    """Without CUDA, device=None refuses the chain: the "auto" probe raises
    ChainError, and with resident mode off the device seam raises. A probe
    that times out raises ChainError too; nothing drops to the disk
    path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device resolves here")
    with pytest.raises(ChainError, match="probe"):
        BlockChain(MemoryDB(), CacheConfig(), params.TEST_CHAIN_CONFIG,
                   _genesis(), new_dummy_engine())
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockChain(MemoryDB(), CacheConfig(resident_account_trie=False),
                   params.TEST_CHAIN_CONFIG, _genesis(), new_dummy_engine())

    def hung(fn, timeout, what):
        assert timeout == 10.0
        raise DeviceWedgedError(f"{what} produced nothing within 10s")

    monkeypatch.setattr(mpt, "_run_with_watchdog", hung)
    with pytest.raises(ChainError, match="produced nothing"):
        BlockChain(MemoryDB(), CacheConfig(device_hasher="off"),
                   params.TEST_CHAIN_CONFIG, _genesis(), new_dummy_engine(),
                   device="cpu")
