"""The benchmark's plain reference against published vectors, and its
batched trie against the textbook one."""

import random

import numpy as np
import pytest
import torch

from portbench.lib import accounts
from portbench.reference import mpt, rlp, simple_trie
from portbench.reference.keccak import keccak256_bytes, keccak256_list

KNOWN = {
    b"": "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470",
    b"\x80": "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421",
    b"abc": "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45",
}


@pytest.mark.parametrize("msg", sorted(KNOWN))
def test_keccak_known_vectors(msg):
    assert keccak256_bytes(msg).hex() == KNOWN[msg]


def test_keccak_lengths_across_the_rate():
    """Messages of 0 to 3 blocks in one batch equal the same messages one
    at a time (the batch sorts lanes by block count)."""
    rng = random.Random(5)
    msgs = [bytes(rng.randrange(256) for _ in range(n))
            for n in (0, 1, 135, 136, 137, 271, 272, 300, 7)]
    assert keccak256_list(msgs) == [keccak256_bytes(m) for m in msgs]


def test_trie_published_vectors():
    assert simple_trie.root([]).hex() == KNOWN[b"\x80"]
    items = [(b"doe", b"reindeer"), (b"dog", b"puppy"),
             (b"dogglesworth", b"cat")]
    assert simple_trie.root(items).hex() == (
        "8aad789dff2f538bca5d8ea56e8abe10f4c7ba3a5dea95fea4cd6e7c3a1168d3")


@pytest.mark.parametrize("n", [1, 2, 17, 600])
def test_batched_trie_equals_textbook(n):
    rng = random.Random(n)
    items = [(bytes(rng.randrange(256) for _ in range(32)),
              bytes(rng.randrange(256) for _ in range(rng.randrange(40, 110))))
             for _ in range(n)]
    assert mpt.root_of_items(items) == simple_trie.root(items)


def _rows(values):
    w = max(len(v) for v in values)
    out = torch.zeros((len(values), w), dtype=torch.uint8)
    for i, v in enumerate(values):
        out[i, :len(v)] = torch.tensor(list(v), dtype=torch.uint8)
    return out, torch.tensor([len(v) for v in values], dtype=torch.int64)


def test_versions_and_forest():
    """Roots after update sets, and several tries at once, equal the
    textbook trie of each state."""
    rng = random.Random(9)
    n = 400
    keys = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(n)]
    cur = [bytes(rng.randrange(256) for _ in range(70)) for _ in range(n)]
    vals, lens = _rows(cur)
    base = list(cur)
    kt = torch.tensor([list(k) for k in keys], dtype=torch.uint8)
    want = [simple_trie.root(list(zip(keys, cur)))]
    ups = []
    for _ in range(4):
        idx = rng.sample(range(n), 30)
        new = [bytes(rng.randrange(256) for _ in range(rng.randrange(40, 90)))
               for _ in idx]
        for i, v in zip(idx, new):
            cur[i] = v
        r, ln = _rows(new)
        ups.append((torch.tensor(idx), r, ln))
        want.append(simple_trie.root(list(zip(keys, cur))))
    got = mpt.roots(mpt.Structure(kt), vals, lens, ups)
    assert [bytes(got[k, 0].tolist()) for k in range(5)] == want
    group = torch.tensor([i % 3 for i in range(n)])
    got = mpt.roots(mpt.Structure(kt, group), vals, lens)
    assert [bytes(got[0, g].tolist()) for g in range(3)] == [
        simple_trie.root([(keys[i], base[i]) for i in range(n) if i % 3 == g])
        for g in range(3)]


def test_account_rlp_matches_plain_rlp():
    rng = np.random.default_rng(3)
    n = 300
    nonce = rng.integers(0, 1 << 16, n).astype(np.uint64)
    nonce[:4] = [0, 1, 127, 128]
    hi = rng.integers(0, 1 << 16, n).astype(np.uint64)
    hi[:6] = 0
    lo = rng.integers(0, 1 << 63, n).astype(np.uint64)
    lo[:4] = [0, 1, 127, 128]
    root = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    code = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    rows, lens = accounts.encode(nonce, hi, lo, root, code)
    got = accounts.byte_list(rows, lens)
    for i in range(n):
        assert got[i] == rlp.encode([
            int(nonce[i]), (int(hi[i]) << 64) | int(lo[i]),
            root[i].tobytes(), code[i].tobytes(), b""])


def test_rlp_round_trip():
    item = [b"", b"\x01", b"\x80", b"x" * 60, [b"a", [b"b" * 100]], b"y" * 300]
    assert rlp.decode(rlp.encode(item)) == item
    assert rlp.encode(0) == b"\x80" and rlp.encode(1024) == b"\x82\x04\x00"
