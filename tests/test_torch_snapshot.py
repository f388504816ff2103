"""The port's snapshot tree, bloom-bit index and sender cacher against the
JAX package's, on the CPU.

Snapshot: tests/test_snapshot.py's cases, each built in both packages
from the same StateDB operations: generation from a committed trie, diff
layers and flatten through a chain, sibling drop, a destructed account,
a missing parent, the merged account and storage iterators, unknown
roots, background generation and not-ready reads. Layer reads, iterator
outputs and the flat entries on disk must be equal, and the generated
disk layer must verify against the trie root. The reference's prefix
scans also take trie nodes whose hash starts with a snapshot prefix
(ROADMAP Queue 3): its iterator outputs are compared without them, and a
case pins that the port's generation keeps such nodes.

Bloom index: the same blooms into both indexers (a small section) give
the same 2,048 rows and the same candidates for a filter.

Sender cacher: transactions signed with the reference's signer, decoded
into the port, recovered by the port's cacher in strided shards: the
reference's senders.
"""

import numpy as np
import pytest

from coreth_tpu import params as jparams
from coreth_tpu.consensus.dummy import new_dummy_engine as j_new_dummy_engine
from coreth_tpu.core.bloom_index import BloomIndexer as JBloomIndexer
from coreth_tpu.core.blockchain import BlockChain as JBlockChain
from coreth_tpu.core.blockchain import CacheConfig as JCacheConfig
from coreth_tpu.core.chain_makers import generate_chain as j_generate_chain
from coreth_tpu.core.genesis import Genesis as JGenesis
from coreth_tpu.core.genesis import GenesisAccount as JGenesisAccount
from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.crypto.secp256k1 import priv_to_address
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu.state.database import Database as JDatabase
from coreth_tpu.state.snapshot import Tree as JTree
from coreth_tpu.state.statedb import StateDB as JStateDB
from coreth_tpu.trie.triedb import TrieDatabase as JTrieDatabase
from coreth_tpu_torch import params
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.bloom_index import BloomIndexer, filter_groups
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.sender_cacher import TxSenderCacher
from coreth_tpu_torch.core.types import Block, Signer, Transaction, \
    bloom_add
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.state.snapshot import DiskLayer, SnapshotError, Tree
from coreth_tpu_torch.state.statedb import StateDB
from coreth_tpu_torch.trie.node import EMPTY_ROOT
from coreth_tpu_torch.trie.triedb import TrieDatabase

KEY = b"\x11" * 32
ADDR = priv_to_address(KEY)
DEST = b"\xbb" * 20
FUND = 10**22
CHAIN_ID = 43112


def _sign(nonce, value=1000):
    t = JTransaction(type=2, chain_id=CHAIN_ID, nonce=nonce, max_fee=10**12,
                     max_priority_fee=10**9, gas=21000, to=DEST, value=value)
    return JSigner(CHAIN_ID).sign(t, KEY)


def _ref(entries):
    """A reference iterator's output without the trie nodes its prefix
    scan yields (ROADMAP Queue 3): only 32-byte hash keys."""
    return [(k, v) for k, v in entries if len(k) == 32]


def _flat(diskdb):
    """The snapshot's flat entries and markers on disk."""
    return {k: v for k, v in diskdb.iterate()
            if k[:1] in (b"a", b"o") and len(k) in (33, 65)
            or k in (b"SnapshotRoot", b"SnapshotBlockHash")}


def _trees(ops, **kw):
    """The state `ops(sdb)` makes, committed in both packages, and a Tree
    over it in each: (port tree, reference tree, root)."""
    out = []
    for pkg in ("port", "ref"):
        disk = MemoryDB() if pkg == "port" else JMemoryDB()
        tdb = TrieDatabase(disk) if pkg == "port" else JTrieDatabase(disk)
        sdb = (StateDB(EMPTY_ROOT, Database(tdb)) if pkg == "port"
               else JStateDB(EMPTY_ROOT, JDatabase(tdb)))
        ops(sdb)
        root = sdb.commit()
        tdb.commit(root)
        if pkg == "ref":
            tdb.cap(0)  # the storage tries the reference leaves dirty
        out.append((Tree if pkg == "port" else JTree)(disk, tdb, root, **kw))
        out.append(root)
    port, root, ref, ref_root = out
    assert root == ref_root
    return port, ref, root


class _Chains:
    """A snapshot chain per package over one genesis (snapshot_limit
    256, the default; the port's on device="cpu", device seam off)."""

    def __init__(self):
        jdisk = JMemoryDB()
        self.ref = JBlockChain(
            jdisk, JCacheConfig(snapshot_limit=256),
            jparams.TEST_CHAIN_CONFIG,
            JGenesis(config=jparams.TEST_CHAIN_CONFIG,
                     gas_limit=jparams.CORTINA_GAS_LIMIT,
                     alloc={ADDR: JGenesisAccount(balance=FUND)}),
            j_new_dummy_engine(), state_database=JDatabase(
                JTrieDatabase(jdisk)))
        disk = MemoryDB()
        self.port = BlockChain(
            disk, CacheConfig(snapshot_limit=256, device_hasher="off"),
            params.TEST_CHAIN_CONFIG,
            Genesis(config=params.TEST_CHAIN_CONFIG,
                    gas_limit=params.CORTINA_GAS_LIMIT,
                    alloc={ADDR: GenesisAccount(balance=FUND)}),
            new_dummy_engine(), state_database=Database(TrieDatabase(disk)),
            device="cpu")

    def blocks(self, n, gen, gap=10):
        blocks, _ = j_generate_chain(
            self.ref.config, self.ref.genesis_block, self.ref.engine,
            self.ref.state_database, n, gap=gap, gen=gen)
        return blocks, [Block.decode(b.encode()) for b in blocks]

    def stop(self):
        self.ref.stop()
        self.port.stop()


def test_generation_from_trie_matches_reference():
    chains = _Chains()
    root = chains.port.genesis_block.root
    layer = chains.port.snaps.snapshot(root)
    assert layer is not None
    ah = keccak256(ADDR)
    assert layer.account(ah) == chains.ref.snaps.snapshot(root).account(ah)
    assert layer.account(ah)
    assert chains.port.snaps.verify_root(root)
    assert _flat(chains.port.diskdb) == _flat(chains.ref.diskdb)
    chains.stop()


def test_diff_layers_flatten_and_reads_match_reference():
    """Each insert registers a diff layer keyed by block hash; reads
    through it answer like the trie; accepting all flattens them into the
    disk layer, whose flat entries equal the reference's."""
    chains = _Chains()
    ref_blocks, blocks = chains.blocks(
        3, lambda i, bg: bg.add_tx(_sign(i, 777 + i)))
    for rb, b in zip(ref_blocks, blocks):
        chains.ref.insert_block(rb)
        chains.port.insert_block(b)
        chains.port.join_tail()
        assert chains.port.snaps.get_block_snapshot(b.hash()) is not None
        st = chains.port.state_at(b.root)
        assert st.snap is not None
        assert st.get_balance(DEST) == sum(777 + i for i in range(b.number))
    for rb, b in zip(ref_blocks, blocks):
        chains.ref.accept(rb)
        chains.port.accept(b)
    chains.ref.drain_acceptor_queue()
    chains.port.drain_acceptor_queue()
    assert chains.port.snaps.disk_layer.root == blocks[-1].root
    assert chains.port.snaps.verify_root(blocks[-1].root)
    assert _flat(chains.port.diskdb) == _flat(chains.ref.diskdb)
    chains.stop()


def test_sibling_dropped_on_flatten():
    chains = _Chains()
    _ra, fork_a = chains.blocks(1, lambda i, bg: bg.add_tx(_sign(0, 1)))
    _rb, fork_b = chains.blocks(1, lambda i, bg: bg.add_tx(_sign(0, 2)),
                                gap=30)
    chains.port.insert_block(fork_a[0])
    chains.port.insert_block(fork_b[0])
    chains.port.join_tail()
    snaps = chains.port.snaps
    assert snaps.get_block_snapshot(fork_a[0].hash()) is not None
    assert snaps.get_block_snapshot(fork_b[0].hash()) is not None
    chains.port.accept(fork_b[0])
    chains.port.drain_acceptor_queue()
    assert snaps.get_block_snapshot(fork_a[0].hash()) is None
    assert snaps.disk_layer.root == fork_b[0].root
    chains.stop()


def test_destructed_account_and_missing_parent():
    port, ref, root = _trees(lambda sdb: sdb.add_balance(ADDR, 100))
    ah = keccak256(ADDR)
    assert port.snapshot(root).account(ah) == ref.snapshot(root).account(ah)
    for tree in (port, ref):
        tree.update(b"\x01" * 32, root, {ah}, {}, {})
    assert port.snapshot(b"\x01" * 32).account(ah) == b""  # deleted marker
    assert port.snapshot(b"\x01" * 32).storage(ah, b"\x05" * 32) == b""
    with pytest.raises(SnapshotError):
        Tree(MemoryDB(), TrieDatabase(MemoryDB()), EMPTY_ROOT).update(
            b"\x01" * 32, b"\x77" * 32, set(), {}, {})


def _three_accounts(sdb):
    for i, a in enumerate((b"\x01" * 20, b"\x02" * 20, b"\x03" * 20)):
        sdb.add_balance(a, 100 + i)


def test_account_iterator_merges_layers_like_reference():
    """Disk only, with an inclusive start; then diff1 (overwrite one, add
    one) and diff2 (destruct one): the youngest layer wins, destructed
    accounts vanish, the parent root is unaffected."""
    port, ref, root = _trees(_three_accounts)
    hashes = sorted(keccak256(a) for a in
                    (b"\x01" * 20, b"\x02" * 20, b"\x03" * 20))
    for tree in (port, ref):
        r1, r2 = b"\x01" * 32, b"\x02" * 32
        tree.update(r1, root, set(),
                    {hashes[0]: b"young", b"\x7f" * 32: b"added"}, {})
        tree.update(r2, r1, {hashes[1]}, {}, {})
    for r in (root, b"\x01" * 32, b"\x02" * 32):
        for start in (b"", hashes[1]):
            got = list(port.account_iterator(r, start=start))
            assert got == _ref(ref.account_iterator(r, start=start))
    items = dict(port.account_iterator(b"\x02" * 32))
    assert items[hashes[0]] == b"young" and hashes[1] not in items
    assert [k for k, _ in port.account_iterator(root)] == hashes
    with pytest.raises(SnapshotError):
        list(port.account_iterator(b"\x99" * 32))


def test_storage_iterator_like_reference():
    a = b"\x05" * 20
    slots = {(b"\x02" + b"\x00" * 31): b"\x11",
             (b"\x04" + b"\x00" * 31): b"\x22"}

    def ops(sdb):
        sdb.add_balance(a, 1)
        for k, v in slots.items():
            sdb.set_state(a, k, v.rjust(32, b"\x00"))

    port, ref, root = _trees(ops)
    ah = keccak256(a)
    got = list(port.storage_iterator(root, ah))
    assert got == _ref(ref.storage_iterator(root, ah))
    assert [k for k, _ in got] == sorted(keccak256(k) for k in slots)
    # a destruct in a younger layer truncates everything below it
    for tree in (port, ref):
        tree.update(b"\x03" * 32, root, {ah}, {},
                    {ah: {b"\x09" * 32: b"\x01"}})
    got = list(port.storage_iterator(b"\x03" * 32, ah))
    assert got == _ref(ref.storage_iterator(b"\x03" * 32, ah))
    assert got == [(b"\x09" * 32, b"\x01")]


def test_background_generation_and_not_ready_reads():
    def ops(sdb):
        for i in range(1, 200):
            sdb.add_balance(i.to_bytes(20, "big"), i)

    port, ref, root = _trees(ops, async_generate=True)
    assert port.wait_generation(timeout=60)
    assert ref.wait_generation(timeout=60)
    ah = keccak256((5).to_bytes(20, "big"))
    assert port.disk_layer.account(ah) == ref.disk_layer.account(ah)
    assert port.verify_root(root)
    assert _flat(port.diskdb) == _flat(ref.diskdb)
    layer = DiskLayer(MemoryDB(), b"\x00" * 32, b"\x00" * 32, ready=False)
    with pytest.raises(SnapshotError):
        layer.account(b"\x01" * 32)
    layer.ready = True
    assert layer.account(b"\x01" * 32) is None


def test_trie_nodes_under_snapshot_prefixes_survive():
    """Trie nodes are keyed by their bare hash, so one may start with the
    snapshot's b"a" or b"o": the port's generation, iterators and verify
    leave such keys alone; the reference's generation deletes them
    (ROADMAP Queue 3)."""
    def ops(sdb):
        sdb.add_balance(ADDR, 100)
        sdb.set_state(ADDR, b"\x02" * 32, b"\x03" * 32)

    nodes = {b"a" + b"\x01" * 31: b"node a", b"o" + b"\x02" * 31: b"node o"}
    trees = []
    for pkg in ("port", "ref"):
        disk = MemoryDB() if pkg == "port" else JMemoryDB()
        tdb = TrieDatabase(disk) if pkg == "port" else JTrieDatabase(disk)
        sdb = (StateDB(EMPTY_ROOT, Database(tdb)) if pkg == "port"
               else JStateDB(EMPTY_ROOT, JDatabase(tdb)))
        ops(sdb)
        root = sdb.commit()
        tdb.commit(root)
        if pkg == "ref":
            tdb.cap(0)
        for k, v in nodes.items():
            disk.put(k, v)
        trees.append((Tree if pkg == "port" else JTree)(disk, tdb, root))
    port, ref = trees
    for k, v in nodes.items():
        assert port.diskdb.get(k) == v
        assert ref.diskdb.get(k) is None  # the reference's fault
    ah = keccak256(ADDR)
    assert [k for k, _ in port.account_iterator(root)] == [ah]
    assert len(list(port.storage_iterator(root, ah))) == 1
    assert port.verify_root(root)
    port.update(b"\x05" * 32, root, {ah}, {}, {})
    port.flatten(b"\x05" * 32)
    assert all(port.diskdb.get(k) == v for k, v in nodes.items())


def test_bloom_index_matches_reference():
    rng = np.random.default_rng(5)
    values = [rng.bytes(20) for _ in range(12)]
    section = 16
    port = BloomIndexer(MemoryDB(), section_size=section)
    ref = JBloomIndexer(JMemoryDB(), section_size=section)
    for n in range(2 * section + 3):
        bloom = bytearray(256)
        for v in values[n % 5::5]:
            bloom_add(bloom, v)
        for ix in (port, ref):
            ix.add_block(n, bytes(bloom))
    assert dict(port.diskdb.iterate()) == dict(ref.diskdb.iterate())
    assert port.has_section(1) and not port.has_section(2)
    crit = {"addresses": [values[0], values[3]], "topics": [[values[7]]]}
    groups = filter_groups(crit)
    for s in (0, 1, 2):
        got, want = port.candidates(s, groups), ref.candidates(s, groups)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.tolist() == want.tolist()
    with pytest.raises(ValueError):
        BloomIndexer(MemoryDB(), section_size=12)


def test_sender_cacher_recovers_the_reference_senders():
    """160 transactions of 8 keys in strided shards (4 threads), and 10
    in one shard: every sender the reference's."""
    keys = [bytes([i + 1]) * 32 for i in range(8)]
    signer = JSigner(CHAIN_ID)
    blobs, want = [], []
    for n in range(160):
        t = JTransaction(type=2, chain_id=CHAIN_ID, nonce=n // 8,
                         max_fee=10**12, gas=21000, to=DEST, value=n)
        blobs.append(signer.sign(t, keys[n % 8]).encode())
        want.append(priv_to_address(keys[n % 8]))
    cacher = TxSenderCacher(threads=4)
    txs = [Transaction.decode(b) for b in blobs]
    token = cacher.recover(Signer(CHAIN_ID), txs)
    cacher.wait(token)
    assert [tx._sender for tx in txs] == want
    assert cacher.recover(Signer(CHAIN_ID), []) is None
    txs = [Transaction.decode(b) for b in blobs[:10]]
    cacher.recover(Signer(CHAIN_ID), txs)
    cacher.wait()  # every outstanding batch
    assert [tx._sender for tx in txs] == want[:10]
    cacher.wait()  # nothing outstanding: a no-op
    cacher.shutdown()
