"""The offline pruner and the shutdown tracker of the port
(coreth_tpu_torch/core/pruner.py) against the JAX package's
(coreth_tpu/core/pruner.py), on the CPU.

Twins of tests/test_recovery.py's TestShutdownTracker, TestPruner (the
stale roots and the resumed prune) and test_offline_prune_then_reopen
(on SQLite; the chain is built in process, stopped and reopened, where
the reference's test builds it in a child that dies), and of
tests/test_resident_chain.py's TestResidentPruner (a resident chain with
commit interval 2, its shutdown export, the prune, a reopened resident
chain extending the tip). Blocks are built once by the reference and
decoded into the port; both packages' stores hold the same keys before
each prune, delete the same count and keep the same keys.

The VM-store case, pinned as both packages do it (ROADMAP Queue 3, open
and shared): the sweep deletes every 32-byte key that the state trie and
its storage tries do not reach, and a VM commits its atomic trie's nodes
into the same store under 32-byte keys, so a prune of a VM's store
deletes the atomic trie's committed root. And both count every extension
node over a hashed child as core/pruner/account_leaf_decode_error (also
open and shared).
"""

import importlib
import json

import pytest

from coreth_tpu import params as jparams
from coreth_tpu.consensus.dummy import new_dummy_engine as j_new_dummy_engine
from coreth_tpu.core.blockchain import BlockChain as JBlockChain
from coreth_tpu.core.blockchain import CacheConfig as JCacheConfig
from coreth_tpu.core.chain_makers import generate_chain as j_generate_chain
from coreth_tpu.core.genesis import Genesis as JGenesis
from coreth_tpu.core.genesis import GenesisAccount as JGenesisAccount
from coreth_tpu.core.pruner import PRUNING_IN_PROGRESS_KEY as J_KEY
from coreth_tpu.core.pruner import Pruner as JPruner
from coreth_tpu.core.pruner import ShutdownTracker as JShutdownTracker
from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.crypto.secp256k1 import priv_to_address
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu.ethdb.sqlitedb import SQLiteDB as JSQLiteDB
from coreth_tpu.state.database import Database as JDatabase
from coreth_tpu.state.statedb import StateDB as JStateDB
from coreth_tpu.trie.triedb import TrieDatabase as JTrieDatabase
from coreth_tpu_torch import params
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.pruner import PRUNING_IN_PROGRESS_KEY, \
    UNCLEAN_SHUTDOWN_KEY, Pruner, ShutdownTracker
from coreth_tpu_torch.core.types import Block
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.ethdb.sqlitedb import SQLiteDB
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.state.statedb import StateDB
from coreth_tpu_torch.trie.triedb import TrieDatabase

KEY = b"\x11" * 32
ADDR = priv_to_address(KEY)
DEST = b"\xbb" * 20
FUND = 10**22


def tx(nonce, value=1000):
    t = JTransaction(type=2, chain_id=43112, nonce=nonce, max_fee=10**12,
                     max_priority_fee=10**9, gas=21000, to=DEST, value=value)
    return JSigner(43112).sign(t, KEY)


class Pair:
    """A chain of each package on its own store, one genesis; the
    reference's chain builds the blocks over its own state database (as
    tests/test_recovery.py does) and the port takes them decoded."""

    def __init__(self, jdisk, pdisk, commit_interval):
        self.jdisk, self.pdisk = jdisk, pdisk
        self.commit_interval = commit_interval
        self.ref = self.open_ref()
        self.port = self.open_port()

    def open_ref(self, last=None):
        return JBlockChain(
            self.jdisk, JCacheConfig(commit_interval=self.commit_interval),
            jparams.TEST_CHAIN_CONFIG,
            JGenesis(config=jparams.TEST_CHAIN_CONFIG,
                     gas_limit=jparams.CORTINA_GAS_LIMIT,
                     alloc={ADDR: JGenesisAccount(balance=FUND)}),
            j_new_dummy_engine(),
            state_database=JDatabase(JTrieDatabase(self.jdisk)),
            **({"last_accepted_hash": last} if last else {}))

    def open_port(self, last=None):
        return BlockChain(
            self.pdisk, CacheConfig(commit_interval=self.commit_interval),
            params.TEST_CHAIN_CONFIG,
            Genesis(config=params.TEST_CHAIN_CONFIG,
                    gas_limit=params.CORTINA_GAS_LIMIT,
                    alloc={ADDR: GenesisAccount(balance=FUND)}),
            new_dummy_engine(),
            state_database=Database(TrieDatabase(self.pdisk)),
            device="cpu",
            **({"last_accepted_hash": last} if last else {}))

    def run(self, n):
        ref = self.ref
        blocks, _ = j_generate_chain(
            ref.config, ref.genesis_block, ref.engine, ref.state_database,
            n, gen=lambda i, bg: bg.add_tx(tx(i)))
        for b in blocks:
            ref.insert_block(b)
            ref.accept(b)
            pb = Block.decode(b.encode())
            self.port.insert_block(pb)
            self.port.accept(pb)
        ref.drain_acceptor_queue()
        self.port.drain_acceptor_queue()
        assert self.port.last_accepted.hash() == ref.last_accepted.hash()
        return blocks

    def stop(self):
        self.ref.stop()
        self.port.stop()


def keys(db):
    return sorted(k for k, _ in db.iterate())


def test_shutdown_tracker():
    """Twin of TestShutdownTracker.test_unclean_detection."""
    got = {}
    for name, db, cls in (("ref", JMemoryDB(), JShutdownTracker),
                          ("port", MemoryDB(), ShutdownTracker)):
        seen = [cls(db).mark_start()]      # first boot: clean
        t2 = cls(db)
        seen.append(t2.mark_start())       # no done(): unclean
        t2.done()
        seen.append(cls(db).mark_start())  # clean after done()
        got[name] = (seen, keys(db))
    assert got["port"] == got["ref"] == ([False, True, False],
                                         [UNCLEAN_SHUTDOWN_KEY])


def test_prune_removes_stale_roots():
    """Twin of TestPruner.test_prune_removes_stale_roots: every block's
    root on disk (commit interval 1); the prune keeps the tip and the
    genesis, drops the middle roots, deletes the same nodes in both
    packages, and the tip's state still reads."""
    p = Pair(JMemoryDB(), MemoryDB(), commit_interval=1)
    blocks = p.run(6)
    for b in blocks:
        assert p.pdisk.get(b.root) is not None
    assert keys(p.pdisk) == keys(p.jdisk)
    genesis_root = p.ref.genesis_block.root
    deleted = {
        "ref": JPruner(p.jdisk, p.ref.state_database.triedb).prune(
            blocks[-1].root, genesis_root),
        "port": Pruner(p.pdisk, p.port.state_database.triedb).prune(
            blocks[-1].root, genesis_root)}
    assert deleted["port"] == deleted["ref"] > 0
    assert keys(p.pdisk) == keys(p.jdisk)
    assert p.pdisk.get(blocks[-1].root) is not None
    assert p.pdisk.get(genesis_root) is not None
    assert p.pdisk.get(blocks[2].root) is None
    st = StateDB(blocks[-1].root, Database(TrieDatabase(p.pdisk)))
    jst = JStateDB(blocks[-1].root, JDatabase(JTrieDatabase(p.jdisk)))
    assert st.get_balance(DEST) == jst.get_balance(DEST) == 6 * 1000
    p.stop()


def test_recover_pruning_resumes():
    """Twin of TestPruner.test_recover_pruning_resumes: a progress marker
    left by an interrupted prune is resumed, then cleared."""
    p = Pair(JMemoryDB(), MemoryDB(), commit_interval=1)
    blocks = p.run(3)
    assert PRUNING_IN_PROGRESS_KEY == J_KEY
    out = {}
    for name, disk, chain, cls in (
            ("ref", p.jdisk, p.ref, JPruner),
            ("port", p.pdisk, p.port, Pruner)):
        disk.put(PRUNING_IN_PROGRESS_KEY, blocks[-1].root)
        pruner = cls(disk, chain.state_database.triedb)
        out[name] = (pruner.recover_pruning(chain.genesis_block.root),
                     disk.get(PRUNING_IN_PROGRESS_KEY),
                     pruner.recover_pruning())
    assert out["port"] == out["ref"] == (True, None, False)
    assert keys(p.pdisk) == keys(p.jdisk)
    p.stop()


def test_offline_prune_then_reopen(tmp_path):
    """Twin of TestDiskRecovery.test_offline_prune_then_reopen on SQLite
    stores: five blocks at commit interval 4096 (no root on disk past
    the genesis), the chain stopped and reopened at its tip (the tip
    re-executed), the tip root committed, the prune, and a third open
    that serves the tip's state."""
    p = Pair(JSQLiteDB(str(tmp_path / "ref.db")),
             SQLiteDB(str(tmp_path / "port.db")), commit_interval=4096)
    tip = p.run(5)[-1]
    p.stop()
    p.ref, p.port = p.open_ref(tip.hash()), p.open_port(tip.hash())
    genesis_root = p.ref.genesis_block.root
    for chain in (p.ref, p.port):
        assert chain.last_accepted.hash() == tip.hash()
        chain.state_database.triedb.commit(tip.root)
    p.stop()
    assert keys(p.pdisk) == keys(p.jdisk)
    deleted = (JPruner(p.jdisk, JTrieDatabase(p.jdisk)).prune(
        tip.root, genesis_root),
        Pruner(p.pdisk, TrieDatabase(p.pdisk)).prune(tip.root, genesis_root))
    assert deleted[1] == deleted[0]
    assert keys(p.pdisk) == keys(p.jdisk)
    p.ref, p.port = p.open_ref(tip.hash()), p.open_port(tip.hash())
    assert p.port.state().get_balance(DEST) == \
        p.ref.state().get_balance(DEST) == 5 * 1000
    p.stop()
    p.jdisk.close()
    p.pdisk.close()


def test_offline_prune_then_reopen_resident():
    """Twin of TestResidentPruner: a resident chain of each package at
    commit interval 2 (the reference on its device path), four blocks,
    stop() (the shutdown export), the prune, the tip's state read from
    the pruned store, and a reopened resident chain that boots its
    mirror over it and takes two more blocks."""
    from test_torch_resident_chain import ADDR1, ADDR2, FUND as RFUND, \
        Chains, tx_gen

    c = Chains(commit_interval=2)
    counts = {}
    blocks = c.blocks(4, tx_gen(counts))
    for b in blocks:
        c.do("insert_block", b)
        c.do("accept", b)
    c.check()
    c.ref.stop()
    c.port.stop()
    tip = blocks[-1]
    jdisk, pdisk = c.ref.diskdb, c.port.diskdb
    genesis_root = c.ref.genesis_block.root
    assert keys(pdisk) == keys(jdisk)
    deleted = (JPruner(jdisk, JTrieDatabase(jdisk)).prune(
        tip.root, genesis_root),
        Pruner(pdisk, TrieDatabase(pdisk)).prune(tip.root, genesis_root))
    assert deleted[1] == deleted[0] > 0
    assert keys(pdisk) == keys(jdisk)
    want = RFUND + 1000 + 1001 + 1002 + 1003
    assert StateDB(tip.root, Database(TrieDatabase(pdisk))).get_balance(
        ADDR2) == want
    c.ref, c.port = c.open_ref(jdisk), c.open_port(pdisk)
    assert c.port.last_accepted.hash() == tip.hash()
    assert c.port.mirror is not None and not c.port.mirror.host_mode
    more = c.blocks(2, tx_gen(counts), parent=tip)
    for b in more:
        c.do("insert_block", b)
        c.do("accept", b)
    c.check()
    assert c.port.state().get_nonce(ADDR1) == 6
    c.ref.stop()
    c.port.stop()


def _vm_store_after_import(pkg):
    """A VM of `pkg` at commit interval 1 that accepted one block with an
    ImportTx: its store, its chain and its atomic trie's root."""
    from test_torch_vm import AVAX, C_CHAIN, X_CHAIN, import_tx, make_utxo

    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    sm = m("vm.shared_memory")
    utxo = make_utxo(amount=5 * 10**9)
    mem = sm.Memory()
    mem.new_shared_memory(X_CHAIN).apply({C_CHAIN: sm.Requests(
        put_requests=[sm.Element(key=utxo.utxo_id(), value=utxo.encode(),
                                 traits=[utxo.address])])})
    g = m("core.genesis")
    genesis = g.Genesis(config=m("params").TEST_CHAIN_CONFIG,
                        gas_limit=m("params").CORTINA_GAS_LIMIT,
                        alloc={ADDR: g.GenesisAccount(balance=FUND)})
    vm = m("vm.vm").VM()
    disk = m("ethdb").MemoryDB()
    kw = {"device": "cpu"} if pkg == "coreth_tpu_torch" else {}
    vm.initialize(m("vm.vm").SnowContext(
        chain_id=C_CHAIN, x_chain_id=X_CHAIN, avax_asset_id=AVAX,
        shared_memory=mem), disk, genesis,
        config_bytes=json.dumps({"commit-interval": 1,
                                 "device-hasher": "off"}).encode(), **kw)
    vm.miner.clock = lambda: vm.blockchain.current_block.time + 2
    vm.issue_atomic_tx(import_tx(utxo)[pkg == "coreth_tpu_torch"])
    blk = vm.build_block()
    blk.verify()
    vm.set_preference(blk.id())
    blk.accept()
    vm.blockchain.drain_acceptor_queue()
    atomic_root, height = vm.atomic_trie.root_at()
    assert height == 1
    return vm, disk, atomic_root


def test_prune_of_a_vm_store_deletes_the_atomic_trie():
    """Both packages' pruners, on a VM's store, delete the atomic trie's
    committed root (a 32-byte key neither the state trie nor its storage
    tries reach), and delete the same keys (ROADMAP Queue 3: open,
    shared)."""
    out = {}
    for pkg, cls in (("coreth_tpu", JPruner), ("coreth_tpu_torch", Pruner)):
        vm, disk, atomic_root = _vm_store_after_import(pkg)
        chain = vm.blockchain
        before = keys(disk)
        assert disk.get(atomic_root) is not None
        deleted = cls(disk, chain.state_database.triedb).prune(
            chain.last_accepted.root, chain.genesis_block.root)
        out[pkg] = (atomic_root, deleted, disk.get(atomic_root),
                    sorted(set(before) - set(keys(disk))))
        vm.shutdown()
    assert out["coreth_tpu_torch"] == out["coreth_tpu"]
    atomic_root, deleted, after, gone = out["coreth_tpu_torch"]
    assert after is None and atomic_root in gone and deleted == len(gone)


@pytest.mark.parametrize("blob", [b"\x01\x02", b"\xc2\x80\x80"])
def test_undecodable_marks_count_the_same(blob):
    """A 32-byte-keyed blob under the target root that does not decode as
    an account-trie node: both packages count the same drop and keep the
    same keys."""
    root = b"\x77" * 32
    out = {}
    for name, disk, cls, reg in (
            ("ref", JMemoryDB(), JPruner, "coreth_tpu.metrics"),
            ("port", MemoryDB(), Pruner, "coreth_tpu_torch.metrics")):
        registry = importlib.import_module(reg).default_registry
        names = ("core/pruner/account_node_decode_error",
                 "core/pruner/account_leaf_decode_error")
        before = [registry.counter(n).count() for n in names]
        disk.put(root, blob)
        disk.put(b"\x55" * 32, b"\x80")
        try:
            got = cls(disk, None).prune(root)
        except Exception as e:  # noqa: BLE001 — compared across packages
            got = type(e).__name__
        out[name] = (got, keys(disk), [registry.counter(n).count() - b
                                       for n, b in zip(names, before)])
    assert out["port"] == out["ref"]


def test_extension_nodes_count_as_account_leaf_decode_errors():
    """Both packages' _mark_account_refs take an extension node whose
    child is a hash for a leaf (HashNode is bytes) and count
    core/pruner/account_leaf_decode_error when the hash does not decode
    as RLP (ROADMAP Queue 3: open, shared); the marks and the sweep are
    unchanged by it. A raw trie with shared key prefixes (extension
    nodes over hashed children) and two stale keys: the same deletions
    and the same count in both."""
    name = "core/pruner/account_leaf_decode_error"
    keys_ = ([b"\x12\x34" + bytes([i]) + bytes(29) for i in range(20)]
             + [b"\x56\x78\x9a" + bytes([i]) + bytes(28) for i in range(12)]
             + [bytes([0xc0 + i]) + bytes(31) for i in range(6)])
    out = {}
    for pkg in ("coreth_tpu", "coreth_tpu_torch"):
        m = lambda n: importlib.import_module(f"{pkg}.{n}")  # noqa: E731
        t = m("trie.trie").Trie()
        for i, k in enumerate(keys_):
            t.update(k, m("rlp").encode(bytes([i + 1]) * 40))
        root, ns = t.commit()
        disk = m("ethdb").MemoryDB()
        for node in ns.nodes.values():
            disk.put(node.hash, node.blob)
        disk.put(b"\x99" * 32, b"\x80")
        disk.put(b"\x98" * 32, b"\xc0")
        reg = m("metrics").default_registry
        before = reg.counter(name).count()
        deleted = m("core.pruner").Pruner(disk, None).prune(root)
        out[pkg] = (deleted, keys(disk), reg.counter(name).count() - before)
    assert out["coreth_tpu_torch"] == out["coreth_tpu"]
    deleted, _kept, counted = out["coreth_tpu_torch"]
    assert deleted == 2 and counted > 0
