"""The port's Merkle proofs (coreth_tpu_torch/trie/proof.py, proof_range.py)
and the commitment seam's MPT proof surface (state/commitment.MPTBackend)
against the JAX package's, on the CPU.

prove() gives the same blobs on the same tries; verify_proof() the same
values and the same missing- and corrupt-node errors and counters;
verify_range_proof() accepts and rejects the same ranges (whole-trie,
edge proofs, gaps, an empty range, a single element, bad inputs). The
port's MPTBackend.prove / verify round-trip over a TrieDatabase root and
over a resident root (exported to disk first), where the reference's
prove raises AttributeError on the StateTrie it is handed (ROADMAP
Queue 3). Everything is compared exactly."""

import random

import pytest

from coreth_tpu.metrics import default_registry as j_registry
from coreth_tpu.state.commitment import MPTBackend as JMPTBackend
from coreth_tpu.trie import proof as jproof
from coreth_tpu.trie import proof_range as jproof_range
from coreth_tpu.trie.trie import Trie as JTrie
from coreth_tpu.trie.triedb import TrieDatabase as JTrieDatabase
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu_torch import trie as ptrie
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.metrics import default_registry
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch.state.commitment import (BACKEND_BINTRIE_SHADOW,
                                               MPTBackend, make_backend)
from coreth_tpu_torch.trie import proof_range
from coreth_tpu_torch.trie.trie import Trie
from coreth_tpu_torch.trie.triedb import TrieDatabase


def _items(seed, n, klen=None):
    rng = random.Random(seed)
    return {rng.randbytes(klen or rng.randint(1, 12)):
            rng.randbytes(rng.randint(1, 60)) for _ in range(n)}


def _pair(items):
    jt, pt = JTrie(), Trie()
    for k, v in items.items():
        jt.update(k, v)
        pt.update(k, v)
    assert pt.hash() == jt.hash()
    return jt, pt


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("err", type(e).__name__, str(e))


@pytest.mark.parametrize("seed,n,klen", [(1, 100, 8), (2, 300, None),
                                         (3, 40, 32)])
def test_prove_and_verify_match_reference(seed, n, klen):
    items = _items(seed, n, klen)
    jt, pt = _pair(items)
    root = pt.hash()
    rng = random.Random(seed)
    probes = list(items)[:25] + [rng.randbytes(8) for _ in range(10)]
    for k in probes:
        blobs = ptrie.prove(pt, k)
        assert blobs == jproof.prove(jt, k)
        db = {keccak256(b): b for b in blobs}
        assert ptrie.verify_proof(root, k, db) == \
            jproof.verify_proof(root, k, db) == items.get(k)


def test_missing_and_corrupt_nodes_match_reference():
    items = {b"k-%03d" % i: b"v%d" % i for i in range(60)}
    jt, pt = _pair(items)
    root = pt.hash()
    k = b"k-017"
    db = {keccak256(b): b for b in ptrie.prove(pt, k)}
    victim = [h for h in db if h != root][0]
    cases = {
        "missing": {h: b for h, b in db.items() if h != victim},
        "corrupt": dict(db) | {victim: db[victim][:-1] + bytes(
            [db[victim][-1] ^ 1])},
        "undecodable": dict(db) | {victim: b"\xff\xfe\xfd"},
        "missing-root": {h: b for h, b in db.items() if h != root},
    }
    names = ("trie/proof/missing_node", "trie/proof/corrupt_node")
    for name, proof in cases.items():
        before = ([j_registry.counter(n).count() for n in names],
                  [default_registry.counter(n).count() for n in names])
        want = _outcome(jproof.verify_proof, root, k, proof)
        got = _outcome(ptrie.verify_proof, root, k, proof)
        assert got == want and got[0] == "err", name
        moved = ([j_registry.counter(n).count() for n in names],
                 [default_registry.counter(n).count() for n in names])
        assert [a - b for a, b in zip(moved[1], before[1])] == \
            [a - b for a, b in zip(moved[0], before[0])]
    # undecodable blob keyed by its own hash at the root
    junk = b"\xc3\x01\x02"
    want = _outcome(jproof.verify_proof, keccak256(junk), k,
                    {keccak256(junk): junk})
    assert _outcome(ptrie.verify_proof, keccak256(junk), k,
                    {keccak256(junk): junk}) == want


def _edge_proof(pt, *keys):
    proof = {}
    for k in keys:
        for blob in ptrie.prove(pt, k):
            proof[keccak256(blob)] = blob
    return proof


def _range_cases(items, pt):
    keys = sorted(items)
    vals = [items[k] for k in keys]
    lo, hi = 5, 25
    rk, rv = keys[lo:hi], vals[lo:hi]
    edge = _edge_proof(pt, rk[0], rk[-1])
    gap_k = rk[:7] + rk[8:]
    gap_v = rv[:7] + rv[8:]
    past = b"\xff" * 32
    return {
        "whole-trie": (keys[0], keys[-1], keys, vals, None),
        "whole-trie-gap": (keys[0], keys[-1], keys[:3] + keys[4:],
                           vals[:3] + vals[4:], None),
        "edge": (rk[0], rk[-1], rk, rv, edge),
        "edge-last": (keys[-20], keys[-1], keys[-20:], vals[-20:],
                      _edge_proof(pt, keys[-20], keys[-1])),
        "edge-gap": (rk[0], rk[-1], gap_k, gap_v, edge),
        "edge-wrong-value": (rk[0], rk[-1], rk, rv[:3] + [b"x"] + rv[4:],
                             edge),
        "edge-extra-key": (rk[0], rk[-1], sorted(rk + [rk[3] + b"\x00"]),
                           [items.get(k, b"y") for k in
                            sorted(rk + [rk[3] + b"\x00"])], edge),
        "empty-range": (past, past, [], [], _edge_proof(pt, past)),
        "empty-range-not-empty": (keys[10], keys[10], [], [],
                                  _edge_proof(pt, keys[10])),
        "single": (rk[2], rk[2], [rk[2]], [rv[2]], _edge_proof(pt, rk[2])),
        "single-wrong": (rk[2], rk[2], [rk[2]], [b"z"],
                         _edge_proof(pt, rk[2])),
        "not-monotonic": (rk[0], rk[-1], rk[::-1], rv[::-1], edge),
        "deletion": (rk[0], rk[-1], rk, rv[:-1] + [b""], edge),
        "lengths": (rk[0], rk[-1], rk, rv[:-1], edge),
        "bad-edges": (rk[-1], rk[0], rk, rv, edge),
        "missing-edge-node": (rk[0], rk[-1], rk, rv, {
            h: b for h, b in edge.items() if h != pt.hash()}),
    }


@pytest.mark.parametrize("seed", [4, 5])
def test_range_proofs_match_reference(seed):
    items = _items(seed, 80, 32)
    _jt, pt = _pair(items)
    root = pt.hash()
    cases = _range_cases(items, pt)
    accepted = []
    for name, (first, last, keys, vals, proof) in cases.items():
        want = _outcome(jproof_range.verify_range_proof, root, first, last,
                        keys, vals, proof)
        got = _outcome(proof_range.verify_range_proof, root, first, last,
                       keys, vals, proof)
        assert got == want, name
        if got[0] == "ok":
            accepted.append(name)
    assert {"whole-trie", "edge", "edge-last", "empty-range",
            "single"} <= set(accepted)
    assert not {"whole-trie-gap", "edge-gap", "edge-wrong-value",
                "deletion", "not-monotonic"} & set(accepted)
    # the helpers on the same partial tries
    k = sorted(items)[10]
    edge = _edge_proof(pt, k)
    proot, val = proof_range.proof_to_path(root, None, k, edge, False)
    jroot, jval = jproof_range.proof_to_path(root, None, k, edge, False)
    assert val == jval == items[k]
    assert proof_range.has_right_element(proot, k) == \
        jproof_range.has_right_element(jroot, k) is True


def test_mpt_backend_prove_verify_round_trip_where_reference_raises():
    """Proof keys are trie keys (keccak256 of the address). The port's
    MPTBackend proves over the StateTrie's inner Trie and verifies from
    the blob list; the reference's prove raises AttributeError on the
    StateTrie, and its verify takes the list for a dict (ROADMAP Queue 3)."""
    from coreth_tpu.trie.secure import StateTrie as JStateTrie
    from coreth_tpu_torch.trie.node import EMPTY_ROOT

    rng = random.Random(7)
    disk = MemoryDB()
    tdb = TrieDatabase(disk)
    st = tdb.open_state_trie(EMPTY_ROOT)
    jst = JStateTrie()
    addrs = [rng.randbytes(20) for _ in range(150)]
    vals = {}
    for a in addrs:
        vals[a] = rng.randbytes(50)
        st.update(a, vals[a])
        jst.update(a, vals[a])
    root, nodes = st.commit()
    assert root == jst.hash()
    tdb.update(root, EMPTY_ROOT, _merged(nodes))
    tdb.commit(root)
    be = make_backend(BACKEND_BINTRIE_SHADOW, TrieDatabase(disk))
    assert isinstance(be, MPTBackend)
    for a in addrs[:30] + [rng.randbytes(20) for _ in range(10)]:
        key = keccak256(a)
        proof = be.prove(root, key)
        assert proof == jproof.prove(jst.trie, key)
        assert be.verify(root, key, proof) == (a in vals, vals.get(a))
    with pytest.raises(AttributeError):
        JMPTBackend(JTrieDatabase(JMemoryDB())).prove(jst.hash(),
                                                       keccak256(addrs[0]))
    proof = be.prove(root, keccak256(addrs[0]))
    with pytest.raises(AttributeError):
        JMPTBackend(None).verify(root, keccak256(addrs[0]), proof)
    bad = [proof[0][:-1] + bytes([proof[0][-1] ^ 1])] + proof[1:]
    with pytest.raises(ValueError):
        be.verify(root, keccak256(addrs[0]), bad)


def _merged(nodes):
    from coreth_tpu_torch.trie.trienode import MergedNodeSet

    m = MergedNodeSet()
    m.merge(nodes)
    return m


def test_mpt_backend_proves_a_resident_root():
    """On a resident chain the head's root lives in the mirror (a
    MirrorStateTrie, no Python nodes): prove exports the mirror's changed
    nodes at that root to disk first and proves over the disk image."""
    from coreth_tpu.crypto.secp256k1 import priv_to_address
    from coreth_tpu.core.chain_makers import generate_chain
    from coreth_tpu.core.genesis import Genesis as JGenesis
    from coreth_tpu.core.genesis import GenesisAccount as JGenesisAccount
    from coreth_tpu.core.types import Signer, Transaction as JTransaction
    from coreth_tpu.consensus.dummy import new_dummy_engine as j_engine
    from coreth_tpu.state.database import Database as JDatabase
    from coreth_tpu import params as jparams
    from coreth_tpu_torch import params
    from coreth_tpu_torch.consensus.dummy import new_dummy_engine
    from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
    from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
    from coreth_tpu_torch.core.types import Block
    from coreth_tpu_torch.state.account import Account

    key = b"\x21" * 32
    addr = priv_to_address(key)
    alloc = {addr: 10**21}
    jdisk = JMemoryDB()
    maker = JDatabase(JTrieDatabase(jdisk))
    g = JGenesis(config=jparams.TEST_CHAIN_CONFIG,
                 gas_limit=jparams.CORTINA_GAS_LIMIT,
                 alloc={a: JGenesisAccount(balance=b)
                        for a, b in alloc.items()}).commit(jdisk, maker)

    def gen(i, bg):
        tx = JTransaction(type=2, chain_id=43112, nonce=i,
                          max_fee=(bg.base_fee() or 225 * 10**9) * 2,
                          max_priority_fee=0, gas=21000,
                          to=bytes([0x50 + i]) * 20, value=7)
        bg.add_tx(Signer(43112).sign(tx, key))

    blocks, _ = generate_chain(jparams.TEST_CHAIN_CONFIG, g, j_engine(),
                               maker, 2, gap=10, gen=gen)
    disk = MemoryDB()
    chain = BlockChain(
        disk, CacheConfig(pruning=True, resident_account_trie=True),
        params.TEST_CHAIN_CONFIG,
        Genesis(config=params.TEST_CHAIN_CONFIG,
                gas_limit=params.CORTINA_GAS_LIMIT,
                alloc={a: GenesisAccount(balance=b)
                       for a, b in alloc.items()}),
        new_dummy_engine(), device="cpu")
    for b in blocks:
        chain.insert_block(Block.decode(b.encode()))
    head = chain.current_block.root
    be = chain.state_database.backend
    assert getattr(be.open(head), "resident", False)
    assert TrieDatabase(disk).node(b"", head) is None  # not on disk yet
    for a in (addr, bytes([0x51]) * 20, b"\x99" * 20):
        proof = be.prove(head, keccak256(a))
        present, value = be.verify(head, keccak256(a), proof)
        assert present == (a != b"\x99" * 20)
        want = chain.state_at(head)
        if present:
            acct = Account.decode(value)
            assert (acct.nonce, acct.balance) == (want.get_nonce(a),
                                                  want.get_balance(a))
    chain.stop()
