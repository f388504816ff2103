"""The port's legacy executors against the JAX package's, on the CPU: the
fused commit (ops/keccak_fused.fused_commit, FusedBatch), the staged
commit (ops/keccak_staged.StagedCommit), CommitPlan.execute_device /
execute_staged, FusedHasher, and a chain in device-hasher "fused".

Both packages plan the same seeded items natively (their exports must be
equal array by array); the reference runs its own executors with its host
Keccak-f at the hash (tests/torch_jax_planned.py: the fused commit's
variable-length segment hash re-traced, the staged commit's seg_impl
seam), the port its plain versions of K1 and K2. Roots and every lane's
digest must be equal: tolerance zero. The fused chain holds its roots to
the reference's fused chain on the same blocks, and a fused commit that
raises or hangs reaches insert_block with the head unchanged (the fused
seam is a ladder dispatch, ROADMAP Queue 3)."""

import random
import threading

import numpy as np
import pytest
import torch

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
from coreth_tpu.native import mpt as jmpt
from coreth_tpu.ops import keccak_fused as jkeccak_fused
from coreth_tpu.ops.device import FusedModeKeccak as JFusedModeKeccak
from coreth_tpu.ops.keccak_jax import BatchedKeccak as JBatchedKeccak
from coreth_tpu.ops.keccak_staged import StagedCommit as JStagedCommit
from coreth_tpu.state.database import Database as JDatabase
from coreth_tpu.trie.hasher import FusedHasher as JFusedHasher
from coreth_tpu.trie.hasher import _keccak_pad as j_keccak_pad
from coreth_tpu.trie.trie import Trie as JTrie
from coreth_tpu.trie.triedb import TrieDatabase as JTrieDatabase
from coreth_tpu_torch import params
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Block
from coreth_tpu_torch.device import DeviceWedgedError, KernelLaunchError
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.native import mpt
from coreth_tpu_torch.ops import keccak_cuda, keccak_fused
from coreth_tpu_torch.ops.device import FusedModeKeccak, default_ladder, \
    get_batch_keccak
from coreth_tpu_torch.ops.keccak_fused import FusedBatch, SegmentSpec, \
    _u8_to_words, _words_to_u8, fused_commit
from coreth_tpu_torch.ops.keccak_staged import StagedCommit
from coreth_tpu_torch.ops.keccak_torch import keccak256_blocks_plain
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.trie.hasher import BATCH_THRESHOLD, FusedHasher
from coreth_tpu_torch.trie.trie import Trie
from coreth_tpu_torch.trie.triedb import TrieDatabase

import torch_jax_planned as jhost


@pytest.fixture
def jfused(monkeypatch):
    """The reference's fused_commit over its host Keccak-f."""
    return jhost.jax_fused_commit(monkeypatch)


def _items(seed, n=300):
    rng = random.Random(seed)
    return sorted({rng.randbytes(32): rng.randbytes(rng.randint(1, 300))
                   for _ in range(n)}.items())


@pytest.fixture(scope="module")
def plans():
    """(reference plan, port plan) of the same items, exports equal."""
    items = _items(7)
    jp, pp = jmpt.plan_from_items(items), mpt.plan_from_items(items)
    for a, b in zip(jp.export()[1:], pp.export()[1:]):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert [tuple(s) for s in jp.export()[0]] == \
        [tuple(s) for s in pp.export()[0]]
    assert jp.root_pos == pp.root_pos
    return jp, pp


def test_byte_word_packing_is_little_endian():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, size=(5, 2 * 136), dtype=np.uint8)
    w = _u8_to_words(torch.from_numpy(a), 2)
    np.testing.assert_array_equal(w.numpy().view(np.uint32),
                                  a.view("<u4").reshape(5, 2, 34))
    np.testing.assert_array_equal(
        _words_to_u8(w[:, 0, :8]).numpy(), a[:, :32])
    want = np.asarray(jkeccak_fused._u8_to_words(a, 2))
    np.testing.assert_array_equal(w.numpy().view(np.uint32), want)


def test_fused_commit_matches_reference(plans, jfused):
    jp, pp = plans
    want_root, want_dig = jp.execute_device(impl=jfused)
    calls = []

    def recording(words, nblocks):
        calls.append(int(words.shape[0]))
        return keccak_cuda.keccak256_blocks(words, nblocks)

    specs, *arrays = pp.export()
    dig = fused_commit(specs, *arrays, device="cpu", impl=recording)
    np.testing.assert_array_equal(dig, np.asarray(want_dig))
    assert dig[pp.root_pos].tobytes() == want_root == pp.execute_cpu()
    assert calls == [s.lanes for s in specs]  # one K2 call a segment
    root, dig2 = pp.execute_device(device="cpu")
    assert root == want_root
    np.testing.assert_array_equal(dig2, dig)


def test_fused_lanes_outside_their_blocks_read_zero(jfused):
    """A lane whose block count is outside [1, L] gets an all-zero digest
    in the reference's masked scan and in K2 (here its plain version)."""
    rng = np.random.default_rng(4)
    specs = (SegmentSpec(2, 16, 0, 0),)
    flat = rng.integers(0, 256, 16 * 2 * 136, dtype=np.uint8)
    nblocks = np.array([0, 1, 2, 3, -1] + [1, 2] * 5 + [0], np.int32)
    empty = np.zeros(0, np.int32)
    want = np.asarray(jfused(specs, flat, nblocks, empty, empty, empty))
    got = fused_commit(specs, flat, nblocks, empty, empty, empty,
                       device="cpu")
    np.testing.assert_array_equal(got, want)
    outside = (nblocks < 1) | (nblocks > 2)
    assert not got[outside].any() and got[~outside].all(axis=1).any()


def test_staged_commit_matches_reference(plans):
    jp, pp = plans
    want_root, want_dig = jp.execute_staged(
        JStagedCommit(seg_impl=jhost.seg_impl))
    launches = []

    def recording(words):
        launches.append(tuple(words.shape))
        return keccak_cuda.segment_keccak(words)

    root, dig = pp.execute_staged(StagedCommit(seg_impl=recording,
                                               device="cpu"))
    assert root == want_root == pp.execute_cpu()
    np.testing.assert_array_equal(dig, np.asarray(want_dig))
    specs = pp.export()[0]
    assert launches == [(s.lanes, s.blocks, 34) for s in specs]
    root2, none = pp.execute_staged(device="cpu", want_digests=False)
    assert (root2, none) == (want_root, None)
    # the export the segments were uploaded from is left as it was
    np.testing.assert_array_equal(pp.export()[1], jp.export()[1])


def test_fused_batch_pads_lanes_and_patches_like_reference(jfused):
    """FusedBatch's own layout (pad lanes with one block, pad patches
    into the scratch lane) through both packages' fused commits."""
    rng = random.Random(9)
    levels = []
    total = 0
    for width in (5, 3, 1):
        padded, nb = zip(*(j_keccak_pad(rng.randbytes(rng.choice((150, 300))))
                           for _ in range(width)))
        # each of the previous level's last three lanes into its own slot
        patches = [(i % width, 4 + 40 * (i // width), g) for i, g in
                   enumerate(range(max(0, total - 3), total))]
        levels.append((list(padded), list(nb), patches))
        total += width

    def run(batch_cls, impl):
        b = batch_cls()
        for padded, nb, patches in levels:
            b.add_level(padded, nb, patches)
        return b.run(impl)

    want = run(jkeccak_fused.FusedBatch, jfused)
    got = run(FusedBatch, lambda *a: fused_commit(*a, device="cpu"))
    assert got == want and len(got) == total


@pytest.mark.parametrize("seed,n", [(0, 150), (1, 400)])
def test_fused_hasher_matches_reference(seed, n, jfused):
    rng = random.Random(seed)
    kv = [(rng.randbytes(32), rng.randbytes(rng.randint(1, 200)))
          for _ in range(n)]
    jt, pt, ct = JTrie(), Trie(), Trie()
    for k, v in kv:
        jt.update(k, v)
        pt.update(k, v)
        ct.update(k, v)
    want = JFusedHasher(jfused).hash_root(jt.root)
    got = FusedHasher(lambda *a: fused_commit(*a, device="cpu")).hash_root(
        pt.root)
    assert bytes(got) == bytes(want) == ct.hash()


def test_trie_hash_takes_the_fused_path_under_the_ladder(monkeypatch):
    """Trie.hash with the fused marker: above BATCH_THRESHOLD one fused
    commit through the ladder's dispatch; with the ladder demoted, the
    BatchedHasher on the host batch keccak. Roots equal either way."""
    marker = get_batch_keccak("fused", device="cpu")
    assert isinstance(marker, FusedModeKeccak) and marker.fused
    seen = []
    real = keccak_fused.fused_commit

    def counting(*a):
        seen.append(len(a[0]))
        return real(*a)

    monkeypatch.setattr(keccak_fused, "fused_commit", counting)
    rng = random.Random(5)
    kv = [(rng.randbytes(32), rng.randbytes(50)) for _ in range(150)]

    def root(bk):
        t = Trie(batch_keccak=bk)
        for k, v in kv:
            t.update(k, v)
        assert t.unhashed >= BATCH_THRESHOLD
        return t.hash()

    want = root(None)
    assert root(marker) == want and len(seen) == 1
    lad = default_ladder()
    try:
        lad.demote("test")
        assert not marker.fused
        assert root(marker) == want and len(seen) == 1
    finally:
        lad.reset()


# ---- a chain in device-hasher "fused" -------------------------------------

N_SENDERS = 120  # every block dirties >= BATCH_THRESHOLD trie nodes
KEYS = [i.to_bytes(1, "big") * 32 for i in range(1, N_SENDERS + 1)]
ADDRS = [priv_to_address(k) for k in KEYS]
FUND = 10**21
CHAIN_ID = 43112


def _jgenesis():
    return JGenesis(config=jparams.TEST_CHAIN_CONFIG,
                    gas_limit=jparams.CORTINA_GAS_LIMIT,
                    alloc={a: JGenesisAccount(balance=FUND) for a in ADDRS})


def _port_chain(marker, **knobs):
    disk = MemoryDB()
    return BlockChain(
        disk, CacheConfig(pruning=True, **knobs), params.TEST_CHAIN_CONFIG,
        Genesis(config=params.TEST_CHAIN_CONFIG,
                gas_limit=params.CORTINA_GAS_LIMIT,
                alloc={a: GenesisAccount(balance=FUND) for a in ADDRS}),
        new_dummy_engine(),
        state_database=Database(TrieDatabase(disk, batch_keccak=marker)),
        device="cpu")


@pytest.fixture(scope="module")
def fused_blocks():
    """A block of 120 transfers built by the reference's chain in
    fused mode (its fused commit on the host Keccak-f), and its roots."""
    mp = pytest.MonkeyPatch()
    try:
        jhost.jax_fused_commit(mp)
        disk = JMemoryDB()
        jchain = JBlockChain(
            disk, JCacheConfig(pruning=True), jparams.TEST_CHAIN_CONFIG,
            _jgenesis(), j_new_dummy_engine(),
            state_database=JDatabase(JTrieDatabase(
                disk, batch_keccak=JFusedModeKeccak(
                    JBatchedKeccak().digests))))
        signer = JSigner(CHAIN_ID)

        def gen(i, bg):
            bf = bg.base_fee() or jparams.APRICOT_PHASE3_INITIAL_BASE_FEE
            for j, key in enumerate(KEYS):
                tx = JTransaction(type=2, chain_id=CHAIN_ID, nonce=i,
                                  max_fee=bf * 2, max_priority_fee=0,
                                  gas=21000, value=1000,
                                  to=(0x9000 + i * N_SENDERS + j).to_bytes(
                                      20, "big"))
                bg.add_tx(signer.sign(tx, key))

        blocks, _ = j_generate_chain(
            jchain.config, jchain.current_block, jchain.engine,
            jchain.state_database, 1, gen=gen)
        roots = [b.root for b in blocks]
        jchain.stop()
    finally:
        mp.undo()
    return [Block.decode(b.encode()) for b in blocks], roots


def test_fused_chain_matches_reference(fused_blocks, monkeypatch):
    """test_chain_device_hasher.py's fused parity on the port: the port's
    chain in device-hasher "fused" takes the reference's fused blocks,
    every root the header's, the fused commit on every large trie."""
    blocks, roots = fused_blocks
    seen = []
    real = keccak_fused.fused_commit
    monkeypatch.setattr(keccak_fused, "fused_commit",
                        lambda *a: seen.append(1) or real(*a))
    chain = _port_chain(get_batch_keccak("fused", device="cpu"))
    try:
        for b, root in zip(blocks, roots):
            chain.insert_block(b)
            chain.accept(b)
            assert chain.current_block.root == root
        chain.drain_acceptor_queue()
        assert chain.current_block.hash() == blocks[-1].hash()
        assert seen  # the large tries went through the fused commit
    finally:
        chain.stop()


@pytest.mark.parametrize("fault", ["launch", "wedge"])
def test_fused_commit_error_reaches_insert_block(fused_blocks, fault,
                                                 monkeypatch):
    """A K2 error in the fused commit, or a fused commit past the
    watchdog, reaches insert_block with the head unchanged and nothing
    demoted; the retried insert lands the reference's root."""
    blocks, roots = fused_blocks
    real = keccak_fused.fused_commit
    release = threading.Event()

    def faulty(*a):
        if not release.is_set():
            if fault == "launch":
                raise KernelLaunchError("K2 launch failed: CUDA error 700")
            # a device that stops answering (for at most 120 s)
            if not release.wait(120):
                raise RuntimeError("the hung fused commit was never "
                                   "released")
        return real(*a)

    monkeypatch.setattr(keccak_fused, "fused_commit", faulty)
    knobs = {"device_call_timeout": 1.0} if fault == "wedge" else {}
    release.set()  # the genesis commits through the fused seam too
    chain = _port_chain(get_batch_keccak("fused", device="cpu"), **knobs)
    release.clear()
    head = chain.current_block.hash()
    try:
        want = KernelLaunchError if fault == "launch" else DeviceWedgedError
        with pytest.raises(want):
            chain.insert_block(blocks[0])
        assert chain.current_block.hash() == head
        assert default_ladder().healthy
        release.set()  # the abandoned call ends before the retry starts
        chain.insert_block(blocks[0])
        assert chain.current_block.root == roots[0]
    finally:
        release.set()
        chain.stop()
        default_ladder().reset()


def test_plain_versions_agree_on_the_fused_layout(plans):
    """K2's plain version on a fused segment equals its per-lane
    host hash; the fused commit on the plain version is the CPU path."""
    _, pp = plans
    specs, flat, nblocks, *_ = pp.export()
    s = next(s for s in specs if s.n_patches == 0)
    width = s.blocks * 136
    off = sum(x.lanes * x.blocks * 136 for x in specs[:specs.index(s)])
    seg = flat[off:off + s.lanes * width].reshape(s.lanes, width)
    words = _u8_to_words(torch.from_numpy(seg.copy()), s.blocks)
    nb = torch.from_numpy(nblocks[s.gstart:s.gstart + s.lanes].copy())
    got = keccak256_blocks_plain(words, nb).numpy().view(np.uint32)
    want = jhost.host_keccak_blocks(words.numpy().view(np.uint32),
                                    nblocks[s.gstart:s.gstart + s.lanes])
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_legacy_executors_on_the_card_equal_the_cpu(plans):
    """The fused commit launches K2 once a segment and the staged commit
    K1 once a segment on the card; digests equal the CPU's."""
    from coreth_tpu_torch.device import hopper_available

    if not hopper_available():
        pytest.skip("needs a CUDA device with compute capability >= 9.0")
    _, pp = plans
    n_seg = len(pp.export()[0])
    keccak_cuda.reset_counts()
    root, dig = pp.execute_device(device="cuda")
    assert keccak_cuda.blocks_launches == n_seg
    want_root, want_dig = pp.execute_device(device="cpu")
    assert root == want_root
    np.testing.assert_array_equal(dig, want_dig)
    root, dig = pp.execute_staged(device="cuda")
    assert keccak_cuda.launches == n_seg
    want_root, want_dig = pp.execute_staged(device="cpu")
    assert root == want_root
    np.testing.assert_array_equal(dig, want_dig)
