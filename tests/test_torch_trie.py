"""Port trie, RLP, encoding and account modules against the JAX package's,
on seeded inserts, updates and deletes. Roots are compared exactly."""

import random

import pytest

from coreth_tpu import rlp as jrlp
from coreth_tpu.state.account import Account as JAccount
from coreth_tpu.trie import encoding as jenc
from coreth_tpu.trie.hasher import Hasher as JHasher
from coreth_tpu.trie.secure import StateTrie as JStateTrie
from coreth_tpu.trie.trie import Trie as JTrie
from coreth_tpu_torch import rlp
from coreth_tpu_torch.ops import keccak_planned
from coreth_tpu_torch.ops.keccak_planned import PlannedCommit, PlannedMode
from coreth_tpu_torch.state.account import Account
from coreth_tpu_torch.trie import encoding, planned
from coreth_tpu_torch.trie.hasher import BATCH_THRESHOLD, Hasher
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
    monkeypatch.setattr(keccak_planned, "MAX_SEGMENTS", 1)
    monkeypatch.setattr(planned, "planned_fallbacks", 0)
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
