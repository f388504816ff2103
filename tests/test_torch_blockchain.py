"""The port's BlockChain against the JAX package's on the same blocks, on
the CPU: the chain cases of tests/test_blockchain.py that need no miner or
txpool, and the corpus of tests/test_chain_planned_hasher.py.

The blocks are built once by the reference's generate_chain (transactions
signed once with the reference's signer) and decoded into the port. A
reference chain (its recursive CPU hasher) and a port chain
(device="cpu", its device seam in mode off, batched or planned, the plain
versions of K2 and K1) take the same inserts, accepts, rejects and
preferences. After each step they must agree on the head, the last
accepted block, the canonical index (in memory and on disk) and the head
pointer; block for block on header roots, block hashes and receipts RLP;
on the flight record's keys and phase keys; on the bad-block reasons; and
after accept on the snapshot's account and storage entries. After stop()
the port's store must be a subset of the reference's once the reference
has also flushed its dirty storage tries (cap(0): ROADMAP Queue 3, the
port persists the storage tries the reference leaves dirty), but for the
trie nodes the reference's snapshot generation deleted (Queue 3: nodes
whose hash starts with a snapshot prefix); the reference's iterators'
extra entries of such nodes are left out of the comparison too.
"""

import pytest

from coreth_tpu import params as jparams
from coreth_tpu.consensus.dummy import ConsensusError as JConsensusError
from coreth_tpu.consensus.dummy import new_dummy_engine as j_new_dummy_engine
from coreth_tpu.core.blockchain import BlockChain as JBlockChain
from coreth_tpu.core.blockchain import CacheConfig as JCacheConfig
from coreth_tpu.core.blockchain import ChainError as JChainError
from coreth_tpu.core.chain_makers import generate_chain as j_generate_chain
from coreth_tpu.core.genesis import Genesis as JGenesis
from coreth_tpu.core.genesis import GenesisAccount as JGenesisAccount
from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.crypto.secp256k1 import priv_to_address
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu.state.database import Database as JDatabase
from coreth_tpu.trie.triedb import TrieDatabase as JTrieDatabase
from coreth_tpu_torch import params
from coreth_tpu_torch.consensus.dummy import ConsensusError, new_dummy_engine
from coreth_tpu_torch.core import rawdb
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig, \
    ChainError
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Block, create_address
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch.ops.device import get_batch_keccak
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.trie import hasher, planned
from coreth_tpu_torch.trie.triedb import TrieDatabase

CHAIN_ID = 43112
KEY1 = b"\x11" * 32
KEY2 = b"\x22" * 32
ADDR1 = priv_to_address(KEY1)
ADDR2 = priv_to_address(KEY2)
FUND = 10**22

# the planned-hasher corpus: 60 senders, each deploying a contract that
# writes 6 slots (block 1), then plain transfers (block 2)
N_SENDERS = 60
KEYS = [i.to_bytes(1, "big") * 32 for i in range(1, N_SENDERS + 1)]
ADDRS = [priv_to_address(k) for k in KEYS]
SLOTS = 6
CORPUS_FUND = 10**21

MODES = ("off", "batched", "planned")


def storage_init_code(seed: int) -> bytes:
    code = bytearray()
    for s in range(SLOTS):
        v = (seed * 31 + s * 7 + 1) % 256 or 1
        code += bytes([0x60, v, 0x60, s, 0x55])  # PUSH1 v PUSH1 s SSTORE
    code += bytes([0x60, 0x00, 0x60, 0x00, 0xF3])  # RETURN(0, 0)
    return bytes(code)


def ref_flat(entries):
    """The reference's snapshot iterator output without the trie nodes its
    prefix scan also yields (ROADMAP Queue 3): only 32-byte hash keys."""
    return [(k, v) for k, v in entries if len(k) == 32]


def sign(nonce, key, base_fee, to=None, value=0, gas=21000, data=b""):
    tx = JTransaction(type=2, chain_id=CHAIN_ID, nonce=nonce,
                      max_fee=base_fee * 2, max_priority_fee=0, gas=gas,
                      to=to, value=value, data=data)
    return JSigner(CHAIN_ID).sign(tx, key)


class Pair:
    """A reference chain and a port chain over the same genesis, driven
    in step. `port_blocks` maps a block hash to the port's decoding."""

    def __init__(self, alloc, mode="off"):
        jdisk = JMemoryDB()
        self.ref = JBlockChain(
            jdisk, JCacheConfig(pruning=True), jparams.TEST_CHAIN_CONFIG,
            JGenesis(config=jparams.TEST_CHAIN_CONFIG,
                     gas_limit=jparams.CORTINA_GAS_LIMIT,
                     alloc={a: JGenesisAccount(balance=b)
                            for a, b in alloc.items()}),
            j_new_dummy_engine(), state_database=JDatabase(
                JTrieDatabase(jdisk)))
        disk = MemoryDB()
        self.port = BlockChain(
            disk, CacheConfig(pruning=True), params.TEST_CHAIN_CONFIG,
            Genesis(config=params.TEST_CHAIN_CONFIG,
                    gas_limit=params.CORTINA_GAS_LIMIT,
                    alloc={a: GenesisAccount(balance=b)
                           for a, b in alloc.items()}),
            new_dummy_engine(), state_database=Database(TrieDatabase(
                disk, batch_keccak=get_batch_keccak(mode, "cpu"))),
            device="cpu")
        assert self.port.genesis_block.hash() == self.ref.genesis_block.hash()
        assert self.port.mirror is None  # "auto" is off on the CPU
        self.port_blocks = {}

    def blocks(self, n, gen, parent=None, gap=10):
        """n blocks built by the reference's generate_chain from `parent`
        (default: the reference's current block)."""
        blocks, _ = j_generate_chain(
            self.ref.config, parent or self.ref.current_block,
            self.ref.engine, self.ref.state_database, n, gap=gap, gen=gen)
        return blocks

    def _port(self, block):
        h = block.hash()
        if h not in self.port_blocks:
            self.port_blocks[h] = Block.decode(block.encode())
        return self.port_blocks[h]

    def do(self, op, block, **kw):
        """Call chain.<op>(block) on both; both raise or neither does, with
        one message. Returns the exceptions (None, None) or (ref, port)."""
        errs = []
        for chain, blk in ((self.ref, block), (self.port, self._port(block))):
            try:
                getattr(chain, op)(blk, **kw)
                errs.append(None)
            except Exception as e:  # noqa: BLE001 — compared below
                errs.append(e)
        if errs[0] is None or errs[1] is None:
            assert errs == [None, None], errs
        else:
            assert str(errs[0]) == str(errs[1])
        self.check_heads()
        return errs

    def check_heads(self):
        ref, port = self.ref, self.port
        assert port.current_block.hash() == ref.current_block.hash()
        assert port.last_accepted.hash() == ref.last_accepted.hash()
        top = max(ref.current_block.number, port.current_block.number) + 2
        for n in range(top):
            assert port.get_canonical_hash(n) == ref.get_canonical_hash(n), n
        ref.join_tail()
        port.join_tail()
        for n in range(top):
            assert (rawdb.read_canonical_hash(port.diskdb, n)
                    == ref.diskdb.get(rawdb.canonical_hash_key(n))), n
        assert (rawdb.read_head_block_hash(port.diskdb)
                == ref.diskdb.get(rawdb.HEAD_BLOCK_KEY))
        assert [r for _b, r, _rec in port.bad_blocks] == \
            [r for _b, r, _rec in ref.bad_blocks]

    def check_block(self, block):
        """The block as both chains hold it: header, receipts, flight
        record."""
        h = block.hash()
        pb = self.port.get_block(h)
        assert pb is not None and pb.header.encode() == block.header.encode()
        assert [r.encode() for r in self.port.get_receipts(h)] == \
            [r.encode() for r in self.ref.get_receipts(h)]
        got, want = self.port.flight_recorder.find(h), \
            self.ref.flight_recorder.find(h)
        assert sorted(got) == sorted(want)
        assert sorted(got["phases"]) == sorted(want["phases"])
        assert got["parallel"] == want["parallel"]
        assert sorted(got["counters"]) == sorted(want["counters"])
        assert got["gas_used"] == want["gas_used"] == block.header.gas_used

    def check_snapshot(self, contracts=()):
        """The accepted state's flat entries, accounts and the storage of
        `contracts`, through each chain's snapshot tree."""
        root = self.ref.last_accepted.root
        assert self.port.snaps.disk_layer.root == \
            self.ref.snaps.disk_layer.root == root
        got = list(self.port.snaps.account_iterator(root))
        assert got == ref_flat(self.ref.snaps.account_iterator(root))
        assert got
        for c in contracts:
            ah = keccak256(c)
            got = list(self.port.snaps.storage_iterator(root, ah))
            assert got == ref_flat(self.ref.snaps.storage_iterator(root, ah))
            assert len(got) == SLOTS

    def stop_and_compare_stores(self):
        self.ref.stop()
        self.port.stop()
        self.ref.state_database.triedb.cap(0)
        want = dict(self.ref.diskdb.iterate())
        got = dict(self.port.diskdb.iterate())
        for k, v in got.items():
            if k not in want:
                # a trie node the reference's snapshot generation deleted
                assert len(k) == 32 and k[:1] in (b"a", b"o"), k
                assert keccak256(v) == k
            else:
                assert want[k] == v, k


_CORPUS = []


def _corpus():
    """(alloc, the two blocks) of the planned-hasher corpus, built once."""
    if not _CORPUS:
        alloc = {a: CORPUS_FUND for a in ADDRS}
        pair = Pair(alloc)

        def gen(i, bg):
            bf = bg.base_fee()
            for j, key in enumerate(KEYS):
                if i == 0:
                    bg.add_tx(sign(0, key, bf, gas=800_000,
                                   data=storage_init_code(j)))
                else:
                    bg.add_tx(sign(1, key, bf, value=1000, to=(
                        0x7000 + N_SENDERS + j).to_bytes(20, "big")))

        _CORPUS.append((alloc, pair.blocks(2, gen)))
        pair.ref.stop()
        pair.port.stop()
    return _CORPUS[0]


@pytest.mark.parametrize("mode", MODES)
def test_planned_corpus_matches_reference(mode, monkeypatch):
    """tests/test_chain_planned_hasher.py's corpus: every storage trie and
    the account trie of a block commit through the mode's device seam;
    inserts, accepts and the stores match the reference block for
    block, and every deployed slot reads back."""
    alloc, blocks = _corpus()
    runs = []
    orig = planned.PlannedGraphBuilder.run

    def counted(self, *a, **kw):
        runs.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(planned.PlannedGraphBuilder, "run", counted)
    batches = hasher.keccak_batches
    pair = Pair(alloc, mode)
    contracts = [create_address(a, 0) for a in ADDRS]
    for b in blocks:
        pair.do("insert_block", b)
        pair.check_block(b)
        pair.do("accept", b)
        pair.ref.drain_acceptor_queue()
        pair.port.drain_acceptor_queue()
        assert pair.port.acceptor_error is None
        pair.check_snapshot(contracts)
    assert bool(runs) == (mode == "planned")
    assert (hasher.keccak_batches > batches) == (mode == "batched")
    state = pair.port.state_at(pair.port.current_block.root)
    for j, ca in enumerate(contracts):
        for s in range(SLOTS):
            v = state.get_state(ca, s.to_bytes(32, "big"))
            assert int.from_bytes(v, "big") == ((j * 31 + s * 7 + 1) % 256
                                                or 1)
    pair.stop_and_compare_stores()


def _two_account_pair(mode="off"):
    return Pair({ADDR1: FUND, ADDR2: FUND}, mode)


def _transfers(key=KEY1, to=ADDR2, value=1000, start=0):
    return lambda i, bg: bg.add_tx(sign(start + i, key, bg.base_fee(),
                                        to=to, value=value))


@pytest.mark.parametrize("mode", MODES)
def test_long_chain_then_accept_all(mode):
    """TestInsertAccept: ten blocks inserted, then accepted; receipts
    persisted; the state and the snapshot at the tip agree."""
    pair = _two_account_pair(mode)
    blocks = pair.blocks(10, _transfers())
    for b in blocks:
        pair.do("insert_block", b)
    for b in blocks:
        pair.check_block(b)
        pair.do("accept", b)
    pair.ref.drain_acceptor_queue()
    pair.port.drain_acceptor_queue()
    assert pair.port.last_accepted.number == 10
    receipts = pair.port.get_receipts(blocks[0].hash())
    assert [(r.status, r.cumulative_gas_used) for r in receipts] == \
        [(1, 21000)]
    state = pair.port.state()
    assert state.get_balance(ADDR2) == FUND + 10 * 1000
    assert state.get_nonce(ADDR1) == 10
    pair.check_snapshot()
    pair.stop_and_compare_stores()


def test_bad_blocks_match_reference():
    """A block with a wrong state root and one with a wrong base fee: both
    chains refuse them with one message, the head stays, and the bad-root
    block's reason lands in the bad-block ring (a consensus error in
    header verification too: both are insert failures)."""
    pair = _two_account_pair()
    good = pair.blocks(1, _transfers())[0]
    bad_root = pair.blocks(1, _transfers())[0]
    bad_root.header.root = b"\xde" * 32
    bad_root._hash = None
    ref_err, port_err = pair.do("insert_block", bad_root)
    assert isinstance(ref_err, JChainError)
    assert isinstance(port_err, ChainError)
    assert "invalid merkle root" in str(port_err)
    bad_fee = pair.blocks(1, _transfers())[0]
    bad_fee.header.base_fee += 1
    bad_fee._hash = None
    ref_err, port_err = pair.do("insert_block", bad_fee)
    assert isinstance(ref_err, JConsensusError)
    assert isinstance(port_err, ConsensusError)
    assert len(pair.port.bad_blocks) == 2
    assert pair.port.bad_blocks[0][2]["phases"].keys() == \
        pair.ref.bad_blocks[0][2]["phases"].keys()
    # the good block still lands on the unchanged head
    pair.do("insert_block", good)
    pair.check_block(good)
    pair.stop_and_compare_stores()


def _two_forks(pair):
    fork_a = pair.blocks(2, _transfers())

    def gen_b(i, bg):
        bg.add_tx(sign(0, KEY2, bg.base_fee(), to=ADDR1, value=7))

    fork_b = pair.blocks(1, gen_b, parent=pair.ref.genesis_block, gap=11)
    return fork_a, fork_b


def test_set_preference_rewinds_like_reference():
    """TestPreferenceAndReorg.test_set_preference_rewind."""
    pair = _two_account_pair()
    fork_a, fork_b = _two_forks(pair)
    for b in fork_a + fork_b:
        pair.do("insert_block", b)
    assert pair.port.current_block.hash() == fork_a[1].hash()
    pair.do("set_preference", fork_b[0])
    assert pair.port.get_canonical_hash(1) == fork_b[0].hash()
    assert pair.port.get_canonical_hash(2) is None
    pair.do("set_preference", fork_a[1])
    assert pair.port.get_canonical_hash(2) == fork_a[1].hash()
    pair.stop_and_compare_stores()


def test_accept_non_canonical_like_reference():
    """TestPreferenceAndReorg.test_accept_non_canonical_block: consensus
    accepts the non-preferred fork, then rejects the other."""
    pair = _two_account_pair()
    fork_a, fork_b = _two_forks(pair)
    for b in fork_a + fork_b:
        pair.do("insert_block", b)
    pair.do("accept", fork_b[0])
    pair.ref.drain_acceptor_queue()
    pair.port.drain_acceptor_queue()
    assert pair.port.last_accepted.hash() == fork_b[0].hash()
    assert pair.port.state().get_balance(ADDR1) == FUND + 7
    pair.check_snapshot()
    for b in fork_a:
        pair.do("reject", b)
    pair.stop_and_compare_stores()
