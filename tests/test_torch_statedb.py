"""The port's StateDB, TrieDatabase and genesis against the JAX package's
on the same seeded inputs, on the CPU, for each batch keccak marker: "off"
(the recursive CPU Hasher), "batched" (BatchedHasher, K2's plain version)
and "planned" (one PlannedCommit per state commit, K1's plain version).

The JAX side runs the same marker: None, a plain host batch keccak (its
BatchedHasher), or PlannedModeKeccak over its XLA BatchedKeccak, as the
JAX package's chain test builds it. Its planned programs run in the JAX
PlannedCommit's per-segment form (fused=False: one compiled step per
segment shape), with the JAX package's own reference Keccak-f
(ops/keccak_ref.keccak_f1600, over numpy lanes) at the executor's seg_impl
seam in place of its XLA scan, whose compiles would take a minute here.
Every root, read, persisted key and genesis byte must be equal; nothing
is compared by tolerance.

(a) seeded streams of every StateDB mutator over ~200 accounts, an
intermediate_root after each transaction and a commit after each block;
(b) the persisted MemoryDB after TrieDatabase.commit; (c) Genesis.commit;
(d) a port StateDB over state the JAX package committed; (e) the planned
dispatch threshold and the TooManySegments fallback; (f) on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coreth_tpu import params as jparams
from coreth_tpu.core import genesis as jgenesis
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu.native import keccak256_batch as j_keccak256_batch
from coreth_tpu.ops import keccak_planned as jkeccak_planned
from coreth_tpu.ops.device import PlannedModeKeccak
from coreth_tpu.ops.keccak_jax import BatchedKeccak as JBatchedKeccak
from coreth_tpu.ops.keccak_ref import keccak_f1600 as j_keccak_f1600
from coreth_tpu.state import statedb as jstatedb
from coreth_tpu.state.database import Database as JDatabase
from coreth_tpu.state.log import Log as JLog
from coreth_tpu.trie import planned as jplanned
from coreth_tpu.trie.node import EMPTY_ROOT as J_EMPTY_ROOT
from coreth_tpu.trie.triedb import TrieDatabase as JTrieDatabase
from coreth_tpu_torch import params
from coreth_tpu_torch.core import genesis
from coreth_tpu_torch.device import hopper_available
from coreth_tpu_torch.ethdb import MemoryDB, memorydb_from_items
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch.ops import keccak_cuda, keccak_planned
from coreth_tpu_torch.ops.device import get_batch_keccak
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.state.log import Log
from coreth_tpu_torch.state.statedb import StateDB
from coreth_tpu_torch.trie import hasher, planned
from coreth_tpu_torch.trie.hasher import BATCH_THRESHOLD
from coreth_tpu_torch.trie.node import EMPTY_ROOT
from coreth_tpu_torch.trie.triedb import TrieDatabase

MODES = ("off", "batched", "planned")
N_ACCOUNTS = 200
_JAX_PLANNED = []


def _host_segment_keccak(words):
    """uint32[P, L, 34] -> uint32[P, 8] on the host: the JAX package's
    reference Keccak-f, each of its 25 lanes a numpy uint64[P]."""
    w = np.asarray(words).astype(np.uint64)
    lanes = w[:, :, 0::2] | (w[:, :, 1::2] << np.uint64(32))
    st = [np.zeros(w.shape[0], np.uint64) for _ in range(25)]
    for b in range(w.shape[1]):
        for i in range(17):
            st[i] = st[i] ^ lanes[:, b, i]
        st = j_keccak_f1600(st)
    out = np.empty((w.shape[0], 8), np.uint32)
    for i in range(4):
        out[:, 2 * i] = (st[i] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        out[:, 2 * i + 1] = (st[i] >> np.uint64(32)).astype(np.uint32)
    return out


def _jax_seg_impl(words):
    return jax.pure_callback(
        _host_segment_keccak,
        jax.ShapeDtypeStruct((words.shape[0], 8), jnp.uint32), words)


@pytest.fixture(autouse=True)
def _jax_planned_commit(monkeypatch):
    """The JAX package's default PlannedCommit for the whole file: the
    per-segment form on the host Keccak-f (module docstring)."""
    if not _JAX_PLANNED:
        _JAX_PLANNED.append(jkeccak_planned.PlannedCommit(
            seg_impl=_jax_seg_impl, fused=False))
    monkeypatch.setattr(jkeccak_planned, "_default_commit", _JAX_PLANNED[0])


def test_host_segment_keccak_is_keccak256():
    """The host Keccak-f the JAX side plugs in gives keccak256 of padded
    messages of one and three blocks."""
    from coreth_tpu.native import keccak256
    from coreth_tpu.ops.keccak_ref import keccak_pad

    for n, blocks in ((5, 1), (300, 3)):
        msgs = [bytes([i]) * n for i in range(1, 4)]
        padded = np.frombuffer(b"".join(keccak_pad(m) for m in msgs),
                               "<u4").reshape(3, blocks, 34)
        got = _host_segment_keccak(padded)
        assert [got[i].astype("<u4").tobytes() for i in range(3)] == \
            [keccak256(m) for m in msgs]


def _port_marker(mode):
    return get_batch_keccak(mode, device="cpu")


def _jax_marker(mode):
    if mode == "off":
        return None
    if mode == "batched":
        return j_keccak256_batch
    return PlannedModeKeccak(JBatchedKeccak().digests)


class Pair:
    """A JAX StateDB and a port StateDB, each over its own MemoryDB and
    TrieDatabase carrying the same mode's marker; every call goes to both
    and must return the same."""

    def __init__(self, mode, root=None, jdisk=None, pdisk=None):
        self.jdisk = jdisk if jdisk is not None else JMemoryDB()
        self.pdisk = pdisk if pdisk is not None else MemoryDB()
        self.jdb = JDatabase(JTrieDatabase(self.jdisk,
                                           batch_keccak=_jax_marker(mode)))
        self.pdb = Database(TrieDatabase(self.pdisk,
                                         batch_keccak=_port_marker(mode)))
        self.j = jstatedb.StateDB(root or J_EMPTY_ROOT, self.jdb)
        self.p = StateDB(root or EMPTY_ROOT, self.pdb)

    def __call__(self, name, *args):
        want = getattr(self.j, name)(*args)
        got = getattr(self.p, name)(*args)
        assert got == want, (name, args, got, want)
        return got

    def add_log(self, addr, topics, data):
        self.j.add_log(JLog(addr, topics, data))
        self.p.add_log(Log(addr, topics, data))

    def logs(self):
        def flat(sdb):
            return sorted((h, l.address, tuple(l.topics), l.data, l.index,
                           l.tx_index) for h, ls in sdb.logs.items()
                          for l in ls)
        assert flat(self.p) == flat(self.j)

    def persist(self, root):
        """TrieDatabase.commit on both; the stores must then be equal. The
        JAX package's commit(root) leaves the storage tries of root's
        accounts dirty (ROADMAP Queue 3), so its cap(0) flushes them: the
        port's commit alone must persist all of it and leave nothing
        dirty."""
        assert self.pdb.triedb.dirty_size == self.jdb.triedb.dirty_size
        _jax_persist(self.jdb.triedb, root)
        self.pdb.triedb.commit(root)
        assert self.pdb.triedb.dirty_size == 0
        assert list(self.pdisk.iterate()) == list(self.jdisk.iterate())


def _jax_persist(triedb, root):
    triedb.commit(root)
    triedb.cap(0)


class Stream:
    """Seeded transactions of StateDB operations over a fixed address set,
    applied to a Pair."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.addrs = [self.rng.bytes(20) for _ in range(N_ACCOUNTS)]
        self.keys = [self.rng.bytes(32) for _ in range(24)]
        self.coins = [self.rng.bytes(32) for _ in range(3)]
        self.tx = 0

    def _int(self, hi):
        return int(self.rng.integers(0, hi))

    def _addr(self):
        return self.addrs[self._int(len(self.addrs))]

    def _value(self):
        if self.rng.random() < 0.3:
            return b"\x00" * 32  # zero-value set_state deletes the slot
        return self.rng.bytes(32)

    def fund(self, s: Pair, n, slots=0):
        """One transaction writing balance, nonce and `slots` storage slots
        to each of the first `n` addresses (code on every tenth)."""
        for i, a in enumerate(self.addrs[:n]):
            s("add_balance", a, 10**18 + self._int(10**9))
            s("set_nonce", a, self._int(100))
            if i % 10 == 0:
                s("set_code", a, self.rng.bytes(self._int(80) + 1))
            for k in self.keys[:slots]:
                s("set_state", a, k, b"\x01" + self.rng.bytes(31))
        return s("intermediate_root", True)

    def op(self, s: Pair, snaps):
        a = self._addr()
        r = self._int(24)
        if r == 0:
            s("add_balance", a, self._int(10**12))
        elif r == 1:
            s("sub_balance", a, self._int(s("get_balance", a) + 1))
        elif r == 2:
            s("set_balance", a, self._int(10**15))
        elif r == 3:
            s("set_nonce", a, s("get_nonce", a) + 1)
        elif r == 4:
            s("set_code", a, self.rng.bytes(self._int(60)))
        elif r in (5, 6, 7):
            s("set_state", a, self.keys[self._int(len(self.keys))],
              self._value())
        elif r == 8:
            k = self.keys[self._int(len(self.keys))]
            s("get_state", a, k)
            s("get_committed_state", a, k)
        elif r == 9:
            s("suicide", a)
        elif r == 10:
            s("create_account", a)
        elif r == 11:
            s("add_balance_multicoin", a, self.coins[self._int(3)],
              self._int(10**6))
        elif r == 12:
            c = self.coins[self._int(3)]
            s("sub_balance_multicoin", a, c,
              self._int(s("get_balance_multicoin", a, c) + 1))
        elif r == 13:
            s("add_refund", self._int(5000))
        elif r == 14:
            s("sub_refund", self._int(s("get_refund") + 1))
        elif r == 15:
            s("set_transient_state", a, self.keys[0], self.rng.bytes(32))
            s("get_transient_state", a, self.keys[0])
        elif r == 16:
            s("add_address_to_access_list", self._addr())
            s("add_slot_to_access_list", a, self.keys[self._int(4)])
            s("slot_in_access_list", a, self.keys[0])
            s("address_in_access_list", a)
        elif r == 17:
            s.add_log(a, [self.rng.bytes(32)], self.rng.bytes(self._int(40)))
        elif r == 18:
            s("add_preimage", self.rng.bytes(32), self.rng.bytes(8))
        elif r == 19:
            s("prepare", params.TEST_CHAIN_CONFIG.rules(1, 1), a,
              self._addr(), self._addr(), [b"\x00" * 19 + b"\x01"],
              [(self._addr(), [self.keys[1]])])
            s("address_in_access_list", a)
        elif r == 20:
            snaps.append(s("snapshot"))
        elif r == 21 and snaps:
            i = self._int(len(snaps))
            s("revert_to_snapshot", snaps[i])
            del snaps[i:]
        else:
            for name in ("exist", "empty", "has_suicided", "get_code",
                         "get_code_hash", "get_code_size", "get_balance"):
                s(name, a)

    def transaction(self, s: Pair, n_ops):
        s.p.set_tx_context(self.rng.bytes(32), self.tx)
        s.j.set_tx_context(s.p.this_tx_hash, self.tx)
        self.tx += 1
        snaps = []
        for _ in range(n_ops):
            self.op(s, snaps)
        s.logs()
        return s("intermediate_root", True)

    def block(self, s: Pair, n_txs=6, n_ops=25, wide=120):
        """`n_txs` transactions, one of them touching `wide` accounts (a
        commit above BATCH_THRESHOLD), then StateDB.commit on both."""
        for t in range(n_txs):
            if t == n_txs // 2:
                for a in self.addrs[:wide]:
                    s("add_balance", a, 1 + self._int(1000))
                # a copy taken mid-transaction hashes to the same root
                assert s.p.copy().intermediate_root(True) == \
                    s.j.copy().intermediate_root(True)
                s("intermediate_root", True)
            else:
                self.transaction(s, n_ops)
        return s("commit", True)


@pytest.mark.parametrize("mode", MODES)
def test_operation_streams_and_persistence(mode):
    """(a) and (b): every intermediate_root, every commit root, every read
    equal; after each block the persisted stores equal key for key, and
    the dirty sizes before the persist."""
    st = Stream(seed=11)
    s = Pair(mode)
    st.fund(s, N_ACCOUNTS, slots=2)
    roots = []
    for _ in range(2):
        root = st.block(s)
        s.persist(root)
        roots.append(root)
    assert len(set(roots)) == 2
    # a fresh StateDB over each store reads the last root the same
    fresh = Pair(mode, roots[-1], s.jdisk, s.pdisk)
    for a in st.addrs:
        for name in ("get_balance", "get_nonce", "get_code", "exist"):
            fresh(name, a)
        for k in st.keys[:6]:
            fresh("get_state", a, k)
        fresh("get_balance_multicoin", a, st.coins[0])


def _alloc(rng, n):
    alloc = {}
    for i in range(n):
        a = rng.bytes(20)
        acct = dict(balance=int(rng.integers(1, 1 << 62)),
                    nonce=int(rng.integers(0, 50)))
        if i % 7 == 0:
            acct["code"] = rng.bytes(int(rng.integers(1, 90)))
            acct["storage"] = {rng.bytes(32): b"\x02" + rng.bytes(31)
                               for _ in range(int(rng.integers(1, 12)))}
        if i % 11 == 0:
            acct["mc_balances"] = {rng.bytes(32): int(rng.integers(1, 10**9))}
        alloc[a] = acct
    return alloc


def _genesis_pair(mode, alloc):
    """Genesis.commit of `alloc` in both packages under TEST_CHAIN_CONFIG:
    (JAX block, port block, Pair whose stores hold the results)."""
    s = Pair(mode)
    jg = jgenesis.Genesis(
        config=jparams.TEST_CHAIN_CONFIG, gas_limit=jparams.CORTINA_GAS_LIMIT,
        alloc={a: jgenesis.GenesisAccount(**v) for a, v in alloc.items()})
    pg = genesis.Genesis(
        config=params.TEST_CHAIN_CONFIG, gas_limit=params.CORTINA_GAS_LIMIT,
        alloc={a: genesis.GenesisAccount(**v) for a, v in alloc.items()})
    jb = jg.commit(s.jdisk, s.jdb)
    s.jdb.triedb.cap(0)  # the storage tries its commit leaves (Queue 3)
    return jb, pg.commit(s.pdisk, s.pdb), s


@pytest.mark.parametrize("mode", MODES)
def test_genesis_commit(mode):
    """(c) the same block hash, header RLP, root and database contents."""
    jb, pb, s = _genesis_pair(mode, _alloc(np.random.default_rng(5), 160))
    assert pb.root == jb.root != EMPTY_ROOT
    assert pb.header.encode() == jb.header.encode()
    assert pb.hash() == jb.hash()
    assert pb.header.base_fee == params.APRICOT_PHASE3_INITIAL_BASE_FEE
    assert list(s.pdisk.iterate()) == list(s.jdisk.iterate())
    assert s.pdb.triedb.dirty_size == s.jdb.triedb.dirty_size == 0


@pytest.mark.parametrize("mode", MODES)
def test_state_committed_by_jax_opens_in_the_port(mode):
    """(d) the JAX package commits a genesis and two blocks; a port StateDB
    over memorydb_from_items(its store) reads every account and slot the
    same and reaches the same next root."""
    rng = np.random.default_rng(9)
    alloc = _alloc(rng, 150)
    s = Pair(mode)
    jg = jgenesis.Genesis(
        config=jparams.TEST_CHAIN_CONFIG,
        alloc={a: jgenesis.GenesisAccount(**v) for a, v in alloc.items()})
    root = jg.commit(s.jdisk, s.jdb).root
    s.jdb.triedb.cap(0)  # the storage tries its commit leaves (Queue 3)
    st = Stream(seed=21)
    st.addrs = list(alloc)
    for _ in range(2):
        sdb = jstatedb.StateDB(root, s.jdb)
        for a in st.addrs[:40]:
            sdb.add_balance(a, 7)
            sdb.set_state(a, st.keys[0], rng.bytes(32))
        root = sdb.commit(True)
        _jax_persist(s.jdb.triedb, root)
    carried = Pair(mode, root, s.jdisk,
                   memorydb_from_items(s.jdisk.iterate()))
    for a, v in alloc.items():
        for name in ("get_balance", "get_nonce", "get_code_hash", "get_code"):
            carried(name, a)
        for k in list(v.get("storage", {})) + st.keys[:1]:
            carried("get_state", a, k)
        for c in v.get("mc_balances", {}):
            carried("get_balance_multicoin", a, c)
    root = st.block(carried, n_txs=3)
    carried.persist(root)


def test_commit_persists_the_storage_tries_of_its_accounts():
    """TrieDatabase.commit(root) persists the storage tries root's accounts
    hold: a fresh TrieDatabase over the store reads every slot. The JAX
    package's commit leaves them dirty, and the same read there raises
    (ROADMAP Queue 3); after its cap(0) the two stores are equal."""
    from coreth_tpu.trie.node import MissingNodeError

    alloc = _alloc(np.random.default_rng(8), 30)
    s = Pair("off")
    jg = jgenesis.Genesis(alloc={a: jgenesis.GenesisAccount(**v)
                                 for a, v in alloc.items()})
    pg = genesis.Genesis(alloc={a: genesis.GenesisAccount(**v)
                                for a, v in alloc.items()})
    root = jg.commit(s.jdisk, s.jdb).root
    assert pg.commit(s.pdisk, s.pdb).root == root
    assert s.pdb.triedb.dirty_size == 0 < s.jdb.triedb.dirty_size
    fresh_p = StateDB(root, Database(TrieDatabase(s.pdisk)))
    fresh_j = jstatedb.StateDB(root, JDatabase(JTrieDatabase(s.jdisk)))
    contract, v = next((a, v) for a, v in alloc.items() if "storage" in v)
    for k, want in v["storage"].items():
        assert fresh_p.get_state(contract, k) == want
    with pytest.raises(MissingNodeError):
        fresh_j.get_state(contract, next(iter(v["storage"])))
    s.jdb.triedb.cap(0)
    assert list(s.pdisk.iterate()) == list(s.jdisk.iterate())


class _Runs:
    """Counts PlannedGraphBuilder.run in both packages."""

    def __init__(self, monkeypatch):
        self.port = self.jax = 0
        for mod, side in ((planned, "port"), (jplanned, "jax")):
            orig = mod.PlannedGraphBuilder.run

            def counted(b, *a, _orig=orig, _side=side, **kw):
                setattr(self, _side, getattr(self, _side) + 1)
                return _orig(b, *a, **kw)
            monkeypatch.setattr(mod.PlannedGraphBuilder, "run", counted)


@pytest.mark.parametrize("accounts,slots,engages", [
    (BATCH_THRESHOLD - 1, 0, False),
    (BATCH_THRESHOLD, 0, True),
    (BATCH_THRESHOLD // 2 - 1, 1, False),
    (BATCH_THRESHOLD // 2, 1, True),
])
def test_planned_dispatch_threshold(monkeypatch, accounts, slots, engages):
    """(e) the planned program runs exactly when the pending accounts plus
    their pending storage writes reach BATCH_THRESHOLD, in both packages."""
    runs = _Runs(monkeypatch)
    st = Stream(seed=3)
    s = Pair("planned")
    st.fund(s, accounts, slots=slots)
    assert runs.port == runs.jax == int(engages)
    s("commit", True)
    assert runs.port == runs.jax == int(engages)


def test_commit_too_many_segments_falls_back_to_batched(monkeypatch):
    """(e) a StateDB commit whose graph overflows the segment table heals
    its holes, and the account trie's own re-plan overflows too: two
    fallbacks to BatchedHasher, and the JAX package's root."""
    monkeypatch.setattr(keccak_planned, "MAX_SEGMENTS", 2)
    monkeypatch.setattr(planned, "planned_fallbacks", 0)
    monkeypatch.setattr(hasher, "keccak_batches", 0)
    st = Stream(seed=4)
    s = Pair("planned")
    s.jdb = JDatabase(JTrieDatabase(s.jdisk))  # the reference's CPU Hasher
    s.j = jstatedb.StateDB(J_EMPTY_ROOT, s.jdb)
    st.fund(s, N_ACCOUNTS, slots=1)
    assert planned.planned_fallbacks == 2
    assert hasher.keccak_batches >= 3
    root = s("commit", True)
    s.persist(root)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("batched", "planned"))
def test_genesis_on_card_equals_cpu(mode):
    """(f) Genesis.commit with the mode's marker on the card: the same
    block and store as on the CPU, and the mode's kernel launched."""
    if not hopper_available():
        pytest.skip("needs a CUDA device with compute capability >= 9.0")
    alloc = {a: genesis.GenesisAccount(**v) for a, v in
             _alloc(np.random.default_rng(6), 3000).items()}
    blocks, stores = [], []
    for marker in (get_batch_keccak(mode), None):
        disk = MemoryDB()
        keccak_cuda.reset_counts()
        blocks.append(genesis.Genesis(
            config=params.TEST_CHAIN_CONFIG, alloc=alloc).commit(
                disk, Database(TrieDatabase(disk, batch_keccak=marker))))
        stores.append(list(disk.iterate()))
        if marker is not None:
            launched = (keccak_cuda.launches if mode == "planned"
                        else keccak_cuda.blocks_launches)
            assert launched > 0
    assert blocks[0].hash() == blocks[1].hash()
    assert stores[0] == stores[1]


def test_what_raised_before_now_runs():
    """The parts of the state layer that raised before their items
    landed run: the resident mirror's mesh rung (a StateDB block commit
    over a 2-shard mirror lands the unsharded mirror's root), the
    snapshot tree (with the chain), the speculative execution modes
    (item 3b.3), and the bintrie shadow and the stateful precompiles
    (item 9: a genesis with an enabled precompile commits its
    activation)."""
    from coreth_tpu_torch.core.types import Block, Header
    from coreth_tpu_torch.precompile import TPU_KECCAK_ADDR, TpuKeccakConfig
    from coreth_tpu_torch.trie.iterator import iterate_leaves
    from coreth_tpu_torch.trie.resident_mirror import ResidentAccountMirror

    diskdb = MemoryDB()
    tdb = TrieDatabase(diskdb)
    gen = genesis.Genesis(config=params.TEST_CHAIN_CONFIG, alloc={
        bytes([i]) * 20: genesis.GenesisAccount(balance=10**18 + i)
        for i in range(1, 40)}).commit(diskdb, Database(tdb))
    leaves = list(iterate_leaves(tdb.open_trie(gen.root)))
    roots = []
    for width in (0, 2):
        db = Database(TrieDatabase(diskdb))
        db.mirror = ResidentAccountMirror(leaves, mesh_devices=width,
                                          device="cpu")
        assert db.mirror.shards == max(1, width)
        sdb = StateDB(gen.root, db)
        for i in range(1, 6):
            sdb.add_balance(bytes([i]) * 20, 7 * i)
        roots.append(sdb.commit(True, block_hash=b"\x07" * 32,
                                parent_block_hash=db.mirror.GENESIS))
    assert roots[0] == roots[1] != gen.root

    cfg = params.avalanche_local_chain_config()
    cfg.precompile_upgrades = (TpuKeccakConfig(timestamp=0),)
    diskdb = MemoryDB()
    blk = genesis.Genesis(config=cfg).commit(
        diskdb, Database(TrieDatabase(diskdb)))
    sdb = StateDB(blk.root, Database(TrieDatabase(diskdb)))
    assert sdb.get_nonce(TPU_KECCAK_ADDR) == 1
    assert sdb.get_code(TPU_KECCAK_ADDR) == b"\x01"
    # transactions landed with item 3b.1: a block with one round-trips;
    # the speculative execution modes landed with item 3b.3
    from coreth_tpu_torch.core.state_processor import StateProcessor
    from coreth_tpu_torch.core.types import Transaction

    tx = Transaction(type=2, chain_id=1, nonce=3, max_fee=7, gas=21000,
                     to=b"\x02" * 20, value=5, v=1, r=2, s=3)
    full = Block(Header(number=4), [tx])
    back = Block.decode(full.encode())
    assert [t.encode() for t in back.transactions] == [tx.encode()]
    assert back.hash() == full.hash()
    proc = StateProcessor(params.TEST_CHAIN_CONFIG, None, None,
                          parallel_workers=2)
    assert proc.parallel_workers == 2
    assert proc.last_parallel == {"mode": "serial"}
    empty = Block(Header(number=3))
    assert Block.decode(empty.encode()).hash() == empty.hash()


def test_rawdb_verify_on_read(monkeypatch):
    """With verify-on-read, code and header blobs are re-hashed as they
    leave the store, and a corrupted one raises CorruptDataError; the
    accessors lay out the JAX package's keys."""
    from coreth_tpu.core import rawdb as jrawdb
    from coreth_tpu_torch.core import rawdb
    from coreth_tpu_torch.core.types import Header
    from coreth_tpu_torch.ethdb import CorruptDataError

    pdisk, jdisk = MemoryDB(), JMemoryDB()
    code = b"\x60\x00\x60\x00"
    h = Header(number=7)
    for mod, disk in ((rawdb, pdisk), (jrawdb, jdisk)):
        mod.write_code(disk, keccak256(code), code)
        mod.write_header_rlp(disk, 7, h.hash(), h.encode())
        mod.write_canonical_hash(disk, h.hash(), 7)
        mod.write_tx_lookup(disk, b"\x05" * 32, 7)
    assert list(pdisk.iterate()) == list(jdisk.iterate())
    monkeypatch.setattr(rawdb, "verify_on_read", True)
    assert rawdb.read_code(pdisk, keccak256(code)) == code
    assert rawdb.read_header_rlp(pdisk, 7, h.hash()) == h.encode()
    assert rawdb.read_header_number(pdisk, h.hash()) == 7
    assert rawdb.read_tx_lookup(pdisk, b"\x05" * 32) == 7
    pdisk.put(rawdb.code_key(keccak256(code)), code + b"\x00")
    with pytest.raises(CorruptDataError):
        rawdb.read_code(pdisk, keccak256(code))


# ---- the resident mirror inside StateDB --------------------------------

class _Blk:
    """What the trie writers read of a block: number, root and hash."""

    def __init__(self, number, root, h):
        self.number, self.root, self._h = number, root, h

    def hash(self):
        return self._h


def test_statedb_on_the_mirror_against_the_reference(monkeypatch):
    """A genesis with storage committed by the JAX package, opened in the
    port with memorydb_from_items; both mirrors booted from one ordered
    iterate_leaves scan of its account trie (the reference chain's
    _boot_mirror); three blocks of balance, nonce, code and slot writes,
    one slot deleted, through StateDB.commit(block_hash, parent_block_hash)
    on each package's mirror (the port's on device="cpu" under the planned
    marker, whose storage program runs in block 1; the JAX side with the
    marker off), each accepted through its ResidentTrieWriter at a commit
    interval of 2. Roots equal block for block; after shutdown the port's
    store holds every node of the reference's, and a fresh port
    TrieDatabase reads every value back."""
    from coreth_tpu.core.state_manager import \
        ResidentTrieWriter as JResidentTrieWriter
    from coreth_tpu.trie.iterator import iterate_leaves as j_iterate_leaves
    from coreth_tpu.trie.resident_mirror import \
        ResidentAccountMirror as JMirror
    from coreth_tpu_torch.core.state_manager import ResidentTrieWriter
    from coreth_tpu_torch.metrics import default_registry
    from coreth_tpu_torch.ops.keccak_planned import PlannedCommit, \
        PlannedMode
    from coreth_tpu_torch.trie.iterator import iterate_leaves
    from coreth_tpu_torch.trie.resident_mirror import ResidentAccountMirror

    rng = np.random.default_rng(31)
    alloc = _alloc(rng, 150)
    jdisk = JMemoryDB()
    jtdb = JTrieDatabase(jdisk)
    gen = jgenesis.Genesis(
        config=jparams.TEST_CHAIN_CONFIG,
        alloc={a: jgenesis.GenesisAccount(**v) for a, v in alloc.items()})
    gblock = gen.commit(jdisk, JDatabase(jtdb))
    jtdb.cap(0)  # the storage tries its commit leaves (ROADMAP Queue 3)
    pdisk = memorydb_from_items(jdisk.iterate())
    items = list(iterate_leaves(TrieDatabase(pdisk).open_trie(gblock.root)))
    assert items == list(j_iterate_leaves(
        JTrieDatabase(jdisk).open_trie(gblock.root)))
    assert len(items) == len(alloc)
    jm = JMirror(items, prefer_host=True)
    pm = ResidentAccountMirror(items, device="cpu", lean_rows=True)
    assert pm.root_of(pm.GENESIS) == jm.root_of(jm.GENESIS) == gblock.root
    jdb = JDatabase(jtdb)
    jdb.mirror = jm
    ptdb = TrieDatabase(pdisk, batch_keccak=PlannedMode(
        PlannedCommit(device="cpu")))
    pdb = Database(ptdb)
    pdb.mirror = pm
    jw = JResidentTrieWriter(jtdb, jm, commit_interval=2)
    pw = ResidentTrieWriter(ptdb, pm, commit_interval=2)
    fallbacks = default_registry.counter("state/resident/fallbacks").count()

    addrs = list(alloc)
    contracts = [a for a, v in alloc.items() if "storage" in v]
    slots = [rng.bytes(32) for _ in range(30)]
    deleted = (contracts[0], next(iter(alloc[contracts[0]]["storage"])))
    root, parent = gblock.root, gblock.hash()
    runs = _Runs(monkeypatch)
    storage_runs = []
    for n in (1, 2, 3):
        j = jstatedb.StateDB(root, jdb)
        p = StateDB(root, pdb)
        assert p.trie.resident and j.trie.resident
        ops = [("add_balance", a, int(rng.integers(1, 10**9)))
               for a in addrs[n::3]]
        ops += [("set_nonce", a, n + 7) for a in addrs[::17]]
        ops += [("set_code", addrs[n], rng.bytes(40))]
        for c in contracts[:4 if n == 1 else 2]:
            ops += [("set_state", c, k, b"\x05" + rng.bytes(31))
                    for k in slots]
        if n == 2:
            ops.append(("set_state",) + deleted + (b"\x00" * 32,))
        for op, *args in ops:
            getattr(j, op)(*args)
            getattr(p, op)(*args)
        before = runs.port
        h = bytes([n]) * 32
        want = j.commit(True, block_hash=h, parent_block_hash=parent)
        root = p.commit(True, block_hash=h, parent_block_hash=parent)
        storage_runs.append(runs.port - before)
        assert root == want, f"block {n}"
        assert p.trie.resident  # reopened on the mirror at the new root
        for w in (jw, pw):
            w.insert_trie(_Blk(n, root, h))
            w.accept_trie(_Blk(n, root, h))
        parent = h
    assert storage_runs == [1, 0, 0]  # block 1's 120 slot writes
    assert pm.spot_check()
    jw.shutdown()
    pw.shutdown()
    assert ptdb.dirty_size == 0
    assert default_registry.counter(
        "state/resident/fallbacks").count() == fallbacks
    jstore, pstore = dict(jdisk.iterate()), dict(pdisk.iterate())
    assert jstore.items() <= pstore.items()
    # a fresh TrieDatabase over the port's store, and the mirror, read
    # every account and slot the same as the reference's store
    fresh = StateDB(root, Database(TrieDatabase(pdisk)))
    assert not getattr(fresh.trie, "resident", False)
    on_mirror = StateDB(root, pdb)
    jfresh = jstatedb.StateDB(root, JDatabase(JTrieDatabase(jdisk)))
    for a in addrs:
        want = (jfresh.get_balance(a), jfresh.get_nonce(a),
                jfresh.get_code(a))
        assert (fresh.get_balance(a), fresh.get_nonce(a),
                fresh.get_code(a)) == want
        assert on_mirror.get_balance(a) == want[0]
    for c in contracts:
        for k in slots + list(alloc[c]["storage"]):
            assert fresh.get_state(c, k) == jfresh.get_state(c, k)
    assert fresh.get_state(*deleted) == b"\x00" * 32


@pytest.mark.parametrize("seed", [61, 62, 63])
def test_triedb_reference_dereference_and_cap_match(seed):
    """ROADMAP Queue 3: the port's TrieDatabase garbage collection and
    partial flush against the reference's. Five blocks of StateDB balance,
    nonce and slot writes (a slot deleted one time in five) on each side,
    `reference` on each root and `dereference` of the root two blocks
    back: after every block the dirty sizes and dirty-node sets are equal.
    Then cap(20000): the stores are equal. Then the head's commit: the
    port's store holds every node of the reference's after its cap(0),
    and fresh reads of every slot are equal."""
    rng = np.random.default_rng(seed)
    s = Pair("off")
    addrs = [rng.bytes(20) for _ in range(60)]
    keys = [rng.bytes(32) for _ in range(8)]
    jroot = proot = EMPTY_ROOT
    roots = []
    for b in range(5):
        j = jstatedb.StateDB(jroot, s.jdb)
        p = StateDB(proot, s.pdb)
        for i, a in enumerate(addrs):
            bal, nonce = int(rng.integers(1, 10**12)), int(rng.integers(99))
            for sdb in (j, p):
                sdb.add_balance(a, bal)
                sdb.set_nonce(a, nonce)
            if i % 3 == 0:
                k = keys[int(rng.integers(len(keys)))]
                v = (b"\x00" * 32 if rng.random() < 0.2
                     else b"\x07" + rng.bytes(31))
                for sdb in (j, p):
                    sdb.set_state(a, k, v)
        jroot, proot = j.commit(True), p.commit(True)
        assert proot == jroot
        roots.append(proot)
        s.jdb.triedb.reference(jroot)
        s.pdb.triedb.reference(proot)
        if b >= 2:
            s.jdb.triedb.dereference(roots[b - 2])
            s.pdb.triedb.dereference(roots[b - 2])
            assert roots[b - 2] not in s.pdb.triedb  # collected
        assert s.pdb.triedb.dirty_size == s.jdb.triedb.dirty_size
        assert set(s.pdb.triedb._dirties) == set(s.jdb.triedb._dirties)
    assert s.pdb.triedb.dirty_size > 20000  # cap has work to do
    s.jdb.triedb.cap(20000)
    s.pdb.triedb.cap(20000)
    assert s.pdb.triedb.dirty_size == s.jdb.triedb.dirty_size <= 20000
    assert dict(s.pdisk.iterate()) == dict(s.jdisk.iterate())
    _jax_persist(s.jdb.triedb, jroot)
    s.pdb.triedb.commit(proot)
    assert dict(s.pdisk.iterate()).items() <= dict(s.jdisk.iterate()).items()
    fresh = Pair("off", proot, s.jdisk, s.pdisk)
    for a in addrs:
        fresh("get_balance", a)
        fresh("get_nonce", a)
        for k in keys:
            fresh("get_state", a, k)


def test_rawdb_lean_rows_and_inspect_database(monkeypatch):
    """The lean node rows and inspect_database lay out and sort keys as
    the JAX package's; verify-on-read counts db/verified_reads and
    db/verify_failures."""
    from coreth_tpu.core import rawdb as jrawdb
    from coreth_tpu_torch.core import rawdb
    from coreth_tpu_torch.core.types import Header
    from coreth_tpu_torch.ethdb import CorruptDataError
    from coreth_tpu_torch.metrics import default_registry

    pdisk, jdisk = MemoryDB(), JMemoryDB()
    h = Header(number=9)
    for mod, disk in ((rawdb, pdisk), (jrawdb, jdisk)):
        for slot in (2, 3, 70000):
            blob = bytes([slot % 251]) * 40
            mod.write_lean_node(disk, slot, keccak256(blob), blob)
        mod.write_code(disk, keccak256(b"\x60"), b"\x60")
        mod.write_header_rlp(disk, 9, h.hash(), h.encode())
        mod.write_head_block_hash(disk, h.hash())
        disk.put(keccak256(b"node"), b"node")
    assert list(pdisk.iterate()) == list(jdisk.iterate())
    assert rawdb.inspect_database(pdisk) == jrawdb.inspect_database(jdisk)
    assert rawdb.lean_nodes_footprint(pdisk) == \
        jrawdb.lean_nodes_footprint(jdisk)
    assert rawdb.read_lean_node(pdisk, 3) == jrawdb.read_lean_node(jdisk, 3)
    assert rawdb.read_lean_node(pdisk, 4) is None
    with pytest.raises(ValueError):
        rawdb.write_lean_node(pdisk, 5, b"\x00", b"x")
    monkeypatch.setattr(rawdb, "verify_on_read", True)
    ok = default_registry.counter("db/verified_reads").count()
    bad = default_registry.counter("db/verify_failures").count()
    assert rawdb.read_lean_node(pdisk, 2)[1] == bytes([2]) * 40
    pdisk.put(rawdb.lean_node_key(2), keccak256(b"x") + b"y")
    with pytest.raises(CorruptDataError):
        rawdb.read_lean_node(pdisk, 2)
    assert default_registry.counter("db/verified_reads").count() == ok + 1
    assert default_registry.counter("db/verify_failures").count() == bad + 1
