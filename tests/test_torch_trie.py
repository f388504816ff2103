"""Port trie, RLP, encoding and account modules against the JAX package's,
on seeded inserts, updates and deletes. Roots are compared exactly."""

import random

import pytest

from coreth_tpu import rlp as jrlp
from coreth_tpu.native import keccak256_batch as j_keccak256_batch
from coreth_tpu.state.account import Account as JAccount
from coreth_tpu.trie import encoding as jenc
from coreth_tpu.trie.hasher import BatchedHasher as JBatchedHasher
from coreth_tpu.trie.hasher import Hasher as JHasher
from coreth_tpu.trie.secure import StateTrie as JStateTrie
from coreth_tpu.trie.trie import Trie as JTrie
from coreth_tpu_torch import rlp
from coreth_tpu_torch.native import keccak256_batch
from coreth_tpu_torch.ops import keccak_planned
from coreth_tpu_torch.ops.device import LadderedKeccak, get_batch_keccak
from coreth_tpu_torch.ops.keccak_planned import PlannedCommit, PlannedMode
from coreth_tpu_torch.ops.keccak_torch import BatchedKeccak
from coreth_tpu_torch.state.account import Account
from coreth_tpu_torch.trie import encoding, hasher, planned
from coreth_tpu_torch.trie.hasher import BATCH_THRESHOLD, BatchedHasher, \
    Hasher, new_hasher
from coreth_tpu_torch.trie.node import EMPTY_ROOT
from coreth_tpu_torch.trie.secure import StateTrie
from coreth_tpu_torch.trie.trie import Trie, trie_from_items


def _ops(seed: int, n: int):
    """Seeded inserts, then updates and deletes of existing keys."""
    rng = random.Random(seed)
    keys = [rng.randbytes(rng.choice((1, 3, 20, 32))) for _ in range(n)]
    ops = [(k, rng.randbytes(rng.randint(1, 70))) for k in keys]
    for k in rng.sample(keys, n // 4):
        ops.append((k, rng.randbytes(rng.randint(1, 40))))
    for k in rng.sample(keys, n // 5):
        ops.append((k, b""))
    return ops


@pytest.mark.parametrize("n,seed", [(1, 0), (12, 1), (90, 2), (300, 3)])
def test_trie_root_matches_jax(n, seed):
    t, jt = Trie(), JTrie()
    for k, v in _ops(seed, n):
        t.update(k, v)
        jt.update(k, v)
    assert t.hash() == jt.hash()
    # and through the explicit recursive hasher on a fresh copy
    t2 = Trie()
    for k, v in _ops(seed, n):
        t2.update(k, v)
    if t2.root is not None:
        assert bytes(Hasher().hash(t2.root, True)[0]) == jt.hash()


def test_trie_get_and_commit_match_jax():
    t, jt = Trie(), JTrie()
    for k, v in _ops(9, 120):
        t.update(k, v)
        jt.update(k, v)
    for k, _ in _ops(9, 120)[:40]:
        assert t.get(k) == jt.get(k)
    root, nodes = t.commit()
    jroot, jnodes = jt.commit()
    assert root == jroot
    assert {p: n.blob for p, n in nodes.nodes.items()} == \
        {p: n.blob for p, n in jnodes.nodes.items()}


def test_state_trie_root_matches_jax():
    st, jst = StateTrie(), JStateTrie()
    for k, v in _ops(4, 200):
        st.update(k, v)
        jst.update(k, v)
    assert st.hash() == jst.hash()
    assert StateTrie().hash() == EMPTY_ROOT


def test_trie_from_items():
    items = [(k, v) for k, v in _ops(6, 50) if v]
    jt = JTrie()
    for k, v in items:
        jt.update(k, v)
    assert trie_from_items(items).hash() == jt.hash()


def _rlp_item(rng: random.Random, depth: int = 0):
    r = rng.random()
    if depth < 3 and r < 0.3:
        return [_rlp_item(rng, depth + 1) for _ in range(rng.randint(0, 5))]
    return rng.randbytes(rng.choice((0, 1, 2, 31, 55, 56, 57, 200, 1100)))


def test_rlp_round_trip_matches_jax():
    rng = random.Random(21)
    for _ in range(200):
        item = _rlp_item(rng)
        enc = rlp.encode(item)
        assert enc == jrlp.encode(item)
        assert rlp.decode(enc) == jrlp.decode(enc) == item
    for v in (0, 1, 127, 128, 255, 256, 2**64, 10**24):
        assert rlp.encode_uint(v) == jrlp.encode_uint(v)
        assert rlp.encode(v) == jrlp.encode(v)


def test_encoding_round_trip_matches_jax():
    rng = random.Random(22)
    for n in (0, 1, 2, 7, 20, 32):
        key = rng.randbytes(n)
        h = encoding.key_to_hex(key)
        assert h == jenc.key_to_hex(key)
        assert encoding.hex_to_keybytes(h) == key
        for cut in (h, h[:-1], h[1:]):  # with/without terminator, odd length
            c = encoding.hex_to_compact(cut)
            assert c == jenc.hex_to_compact(cut)
            assert encoding.compact_to_hex(c) == jenc.compact_to_hex(c) == cut


@pytest.mark.parametrize("nonce,balance,multi", [
    (0, 0, False), (1, 10**18, False), (2**40, 10**24 - 1, True),
    (127, 128, False), (2**64 - 1, 2**200, False),
])
def test_account_root_hole_offsets(nonce, balance, multi):
    code_hash = bytes(range(32))
    a = Account(nonce=nonce, balance=balance, code_hash=code_hash,
                is_multi_coin=multi)
    ja = JAccount(nonce=nonce, balance=balance, code_hash=code_hash,
                  is_multi_coin=multi)
    enc, off = a.encode_with_root_hole()
    assert (enc, off) == ja.encode_with_root_hole()
    assert enc[off:off + 32] == b"\x00" * 32
    root = bytes(range(100, 132))
    a.root = ja.root = root
    assert a.encode() == ja.encode()
    assert enc[:off] + root + enc[off + 32:] == a.encode()
    assert Account.decode(a.encode()) == a


def test_trie_hash_takes_planned_path_above_threshold():
    rng = random.Random(31)
    items = [(rng.randbytes(32), rng.randbytes(50))
             for _ in range(BATCH_THRESHOLD + 20)]
    jt = JTrie()
    for k, v in items:
        jt.update(k, v)
    commit = PlannedCommit(device="cpu")
    t = trie_from_items(items, batch_keccak=PlannedMode(commit))
    assert t.hash() == jt.hash()
    assert commit.last_dispatches == 1  # the planned executor ran
    assert t.unhashed == 0
    # the hashes it assigned are the CPU hasher's
    assert bytes(JHasher().hash(jt.root, True)[0]) == \
        bytes(Hasher().hash(t.root, True)[0])


def test_trie_hash_below_threshold_stays_on_cpu():
    commit = PlannedCommit(device="cpu")
    t = trie_from_items([(bytes([i]) * 32, b"v" * 40) for i in range(10)],
                        batch_keccak=PlannedMode(commit))
    jt = JTrie()
    for i in range(10):
        jt.update(bytes([i]) * 32, b"v" * 40)
    assert t.hash() == jt.hash()
    assert commit.last_dispatches == 0


def test_too_many_segments_falls_back_and_counts(monkeypatch):
    """The planned path's fallback runs BatchedHasher on the marker (a plain
    batch keccak on the commit's device), as the reference does."""
    monkeypatch.setattr(keccak_planned, "MAX_SEGMENTS", 1)
    monkeypatch.setattr(planned, "planned_fallbacks", 0)
    monkeypatch.setattr(hasher, "keccak_batches", 0)
    monkeypatch.setattr(hasher, "keccak_batch_msgs", 0)
    rng = random.Random(32)
    items = [(rng.randbytes(32), rng.randbytes(rng.randint(1, 300)))
             for _ in range(BATCH_THRESHOLD + 10)]
    jt = JTrie()
    for k, v in items:
        jt.update(k, v)
    commit = PlannedCommit(device="cpu")
    t = trie_from_items(items, batch_keccak=PlannedMode(commit))
    assert t.hash() == jt.hash()
    assert planned.planned_fallbacks == 1
    assert commit.last_dispatches == 0
    assert hasher.keccak_batches > 0
    assert hasher.keccak_batch_msgs >= BATCH_THRESHOLD


class _Recorder:
    """A batch keccak that keeps every message list it is handed."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, msgs):
        self.calls.append(list(msgs))
        return self.fn(msgs)


@pytest.mark.parametrize("n,seed,device_batch", [
    (150, 40, False), (600, 41, False), (300, 42, True)])
def test_batched_hasher_matches_jax_level_by_level(n, seed, device_batch):
    """Seeded inserts, updates and deletes; both BatchedHashers must hand
    their batch keccak the identical message list at every level, and give
    the CPU Hasher's root. device_batch hashes the port's levels with
    BatchedKeccak on the CPU (K2's plain version) instead of the native
    keccak."""
    ops = _ops(seed, n)
    t, jt, ref = Trie(), JTrie(), Trie()
    for k, v in ops:
        t.update(k, v)
        jt.update(k, v)
        ref.update(k, v)
    fn = BatchedKeccak(device="cpu").digests if device_batch \
        else keccak256_batch
    rec, jrec = _Recorder(fn), _Recorder(j_keccak256_batch)
    got = bytes(BatchedHasher(rec).hash_root(t.root))
    want = bytes(JBatchedHasher(jrec).hash_root(jt.root))
    assert rec.calls == jrec.calls
    assert len(rec.calls) >= 3
    assert got == want == bytes(Hasher().hash(ref.root, True)[0])
    # every hashed node carries the CPU Hasher's digest
    assert t.root.flags.hash == ref.root.flags.hash
    # an update on top of the batched-hashed trie re-hashes only the path
    k, _ = ops[0]
    t.update(k, b"\x42" * 40)
    jt.update(k, b"\x42" * 40)
    rec.calls.clear()
    jrec.calls.clear()
    assert bytes(BatchedHasher(rec).hash_root(t.root)) == \
        bytes(JBatchedHasher(jrec).hash_root(jt.root))
    assert rec.calls == jrec.calls


def test_batched_hasher_embeds_small_nodes_but_hashes_the_root():
    # tiny values keep every leaf's RLP under 32 bytes: embedded in parents
    items = [(bytes([i, j]), bytes([j])) for i in range(4) for j in range(3)]
    t, jt = trie_from_items(items), JTrie()
    for k, v in items:
        jt.update(k, v)
    rec, jrec = _Recorder(keccak256_batch), _Recorder(j_keccak256_batch)
    assert bytes(BatchedHasher(rec).hash_root(t.root)) == \
        bytes(JBatchedHasher(jrec).hash_root(jt.root)) == jt.hash()
    assert rec.calls == jrec.calls
    assert len(rec.calls[-1]) == 1  # the root, hashed though it is small
    one = trie_from_items([(b"k", b"v")])  # a lone 5-byte root: still hashed
    assert bytes(BatchedHasher(keccak256_batch).hash_root(one.root)) == \
        bytes(Hasher().hash(trie_from_items([(b"k", b"v")]).root, True)[0])


def test_trie_hash_takes_batched_path_above_threshold(monkeypatch):
    monkeypatch.setattr(hasher, "keccak_batches", 0)
    rng = random.Random(33)
    items = [(rng.randbytes(32), rng.randbytes(60))
             for _ in range(BATCH_THRESHOLD + 5)]
    jt = JTrie(batch_keccak=j_keccak256_batch)
    for k, v in items:
        jt.update(k, v)
    mode = get_batch_keccak("batched", device="cpu")
    assert isinstance(mode, LadderedKeccak)
    launches = mode.batched.launches
    t = trie_from_items(items, batch_keccak=mode)
    assert t.hash() == jt.hash()
    assert hasher.keccak_batches >= 3 and mode.batched.launches > launches
    assert t.unhashed == 0
    # below the threshold the same seam stays on the CPU Hasher
    small = trie_from_items(items[:10], batch_keccak=mode)
    before = hasher.keccak_batches
    assert small.hash() == trie_from_items(items[:10]).hash()
    assert hasher.keccak_batches == before


def test_new_hasher_picks_by_dirty_estimate():
    assert isinstance(new_hasher(BATCH_THRESHOLD, keccak256_batch),
                      BatchedHasher)
    assert isinstance(new_hasher(BATCH_THRESHOLD - 1, keccak256_batch), Hasher)
    assert isinstance(new_hasher(10**6, None), Hasher)


def test_get_batch_keccak_modes():
    assert get_batch_keccak("off") is None
    assert get_batch_keccak("planned", device="cpu").planned
    assert get_batch_keccak("auto", device="cpu").planned
    with pytest.raises(NotImplementedError, match="item 7"):
        get_batch_keccak("fused", device="cpu")
    with pytest.raises(ValueError):
        get_batch_keccak("turbo", device="cpu")
    msgs = [b"", b"abc", bytes(300)]
    want = keccak256_batch(msgs)
    assert get_batch_keccak("batched", device="cpu")(msgs) == want
    assert get_batch_keccak("planned", device="cpu")(msgs) == want
