"""The port's binary Merkle tree (coreth_tpu_torch/bintrie) against the
JAX package's (coreth_tpu/bintrie) on the same seeded inputs, on the CPU.

Tree updates, deletes and the canonical collapse give the same roots, the
same node store and the same items(); the planned commit on device="cpu"
(kernel K1's plain version) gives the same root and the same per-node
digests as the reference's planned commit (its executor on the host
Keccak-f: tests/torch_jax_planned.py) and as the host commit, also for a
key set deeper than MAX_SEGMENTS levels, which chunks; witnesses are
byte-equal and fail the same way when tampered with. Everything is
compared exactly."""

import random

import pytest

from coreth_tpu.bintrie import tree as jtree
from coreth_tpu.bintrie import witness as jwitness
from coreth_tpu.bintrie.planned import commit_planned as j_commit_planned
from coreth_tpu_torch import fault
from coreth_tpu_torch.bintrie import tree, witness
from coreth_tpu_torch.bintrie.backend import BinTrieBackend
from coreth_tpu_torch.bintrie.planned import commit_planned
from coreth_tpu_torch.ops import device as pdevice
from coreth_tpu_torch.ops.keccak_planned import MAX_SEGMENTS, PlannedCommit
from torch_jax_planned import jax_planned_commit


@pytest.fixture(autouse=True)
def _port_isolation():
    yield
    fault.clear_all()
    pdevice.default_ladder().reset()


def _keys(rng, n, prefix=b""):
    return [prefix + rng.randbytes(32 - len(prefix)) for _ in range(n)]


def _pair():
    return (jtree.BinaryTrie(jtree.NodeStore()),
            tree.BinaryTrie(tree.NodeStore()))


def _same(jt, pt):
    assert pt.commit() == jt.commit()
    assert pt.store.nodes == jt.store.nodes
    assert pt.store.values == jt.store.values
    assert list(pt.items()) == list(jt.items())


@pytest.mark.parametrize("seed,n", [(1, 50), (2, 600), (3, 2000)])
def test_updates_deletes_and_collapse_match_reference(seed, n):
    rng = random.Random(seed)
    keys = _keys(rng, n)
    jt, pt = _pair()
    model = {}
    for k in keys:
        v = rng.randbytes(rng.randint(1, 40))
        jt.update(k, v)
        pt.update(k, v)
        model[k] = v
    _same(jt, pt)
    assert pt.commit() == tree.reference_root(model) == \
        jtree.reference_root(model)
    # rewrites, deletes (canonical collapse), empty values as deletes and
    # absent deletes, committed in rounds on a reopened trie
    root = pt.commit()
    jt2, pt2 = (jtree.BinaryTrie(jt.store, root),
                tree.BinaryTrie(pt.store, root))
    for i in range(n):
        k = rng.choice(keys)
        op = rng.random()
        if op < 0.4:
            v = rng.randbytes(8)
            jt2.update(k, v)
            pt2.update(k, v)
            model[k] = v
        elif op < 0.8:
            assert pt2.delete(k) == jt2.delete(k)
            model.pop(k, None)
        elif op < 0.9:
            jt2.update(k, b"")
            pt2.update(k, b"")
            model.pop(k, None)
        else:
            absent = rng.randbytes(32)
            assert pt2.delete(absent) is jt2.delete(absent) is False
        if i % (n // 4 or 1) == 0:
            _same(jt2, pt2)
    _same(jt2, pt2)
    assert pt2.commit() == tree.reference_root(model)
    for k in keys[:50]:
        assert pt2.get(k) == jt2.get(k) == model.get(k)
        assert pt2.get_value_hash(k) == jt2.get_value_hash(k)
    for k in list(model):
        jt2.delete(k)
        pt2.delete(k)
    assert pt2.commit() == jt2.commit() == tree.EMPTY


def test_dirty_levels_match_reference():
    rng = random.Random(4)
    jt, pt = _pair()
    for k in _keys(rng, 300):
        v = rng.randbytes(4)
        jt.update(k, v)
        pt.update(k, v)
    jl, pl = jt.dirty_levels(), pt.dirty_levels()
    assert [len(x) for x in pl] == [len(x) for x in jl]
    assert len(pl) > 10


def _planned_trio(keys_values):
    """(reference planned, port planned, port host) tries over the same
    content, each on its own store."""
    tries = (jtree.BinaryTrie(jtree.NodeStore()),
             tree.BinaryTrie(tree.NodeStore()),
             tree.BinaryTrie(tree.NodeStore()))
    for k, v in keys_values:
        for t in tries:
            t.update(k, v)
    return tries


@pytest.mark.parametrize("seed,n,prefix", [
    (5, 400, b""),
    # 70 shared key bits: more than MAX_SEGMENTS depth levels, two runs
    (6, 40, b"\xa5" * 8 + b"\x3c"),
])
def test_commit_planned_matches_reference_and_host(seed, n, prefix):
    rng = random.Random(seed)
    kv = [(k, rng.randbytes(rng.randint(1, 33))) for k in
          _keys(rng, n, prefix)]
    jt, pt, ht = _planned_trio(kv)
    levels = len(pt.dirty_levels())
    if prefix:
        assert levels > MAX_SEGMENTS
    runs = []
    pc = PlannedCommit(device="cpu")
    orig = pc.run
    pc.run = lambda *a, **kw: runs.append(1) or orig(*a, **kw)
    root = commit_planned(pt, executor=pc)
    assert len(runs) == -(-levels // MAX_SEGMENTS)
    assert root == j_commit_planned(jt, executor=jax_planned_commit()) \
        == ht.commit() == tree.reference_root(dict(kv))
    # per-node digests: the same hash -> preimage stores
    assert pt.store.nodes == jt.store.nodes == ht.store.nodes
    assert commit_planned(pt, executor=pc) == root  # clean: no run
    assert len(runs) == -(-levels // MAX_SEGMENTS)
    # an incremental recommit over the committed store
    t2 = tree.BinaryTrie(pt.store, root)
    j2 = jtree.BinaryTrie(jt.store, root)
    model = dict(kv)
    for k, _v in kv[: n // 3]:
        t2.delete(k)
        j2.delete(k)
        model.pop(k)
    for k in _keys(rng, n // 3, prefix):
        t2.update(k, b"\x07")
        j2.update(k, b"\x07")
        model[k] = b"\x07"
    r2 = commit_planned(t2, executor=pc)
    assert r2 == j_commit_planned(j2, executor=jax_planned_commit()) == \
        tree.reference_root(model)
    assert pt.store.nodes == jt.store.nodes


def test_commit_planned_empty_and_store_roots():
    pt = tree.BinaryTrie(tree.NodeStore())
    assert commit_planned(pt, device="cpu") == tree.EMPTY
    pt.update(b"\x01" * 32, b"x")
    r = commit_planned(pt, device="cpu")
    assert r == tree.leaf_hash(b"\x01" * 32, tree.keccak256(b"x"))
    assert commit_planned(tree.BinaryTrie(pt.store, r), device="cpu") == r


class _Boom(Exception):
    pass


def test_commit_planned_device_error_propagates_with_digests_untouched():
    """An error of the planned run (here the dispatch failpoint, as a
    device fault would) reaches the caller, counted by the ladder, with no
    digest written; no host re-hash. Then a demoted ladder hashes the same
    overlay on the host with the same root."""
    from coreth_tpu_torch.metrics import default_registry

    rng = random.Random(7)
    kv = [(k, rng.randbytes(5)) for k in _keys(rng, 200)]
    _jt, pt, ht = _planned_trio(kv)
    want = ht.commit()
    errs = default_registry.counter("ops/device/dispatch_errors").count()
    fault.set_failpoint("ops/device/dispatch", "raise*1")
    with pytest.raises(fault.FailpointError):
        commit_planned(pt, device="cpu")
    assert default_registry.counter(
        "ops/device/dispatch_errors").count() == errs + 1
    assert all(n.hash is None for lvl in pt.dirty_levels() for n in lvl)
    assert len(pt.store) == 0
    lad = pdevice.default_ladder()
    lad.configure(probe_interval=0)
    lad.demote("test")
    pc = PlannedCommit(device="cpu")
    pc.run = lambda *a, **kw: (_ for _ in ()).throw(_Boom())
    assert commit_planned(pt, executor=pc) == want
    assert pt.store.nodes == ht.store.nodes


@pytest.mark.parametrize("seed", [8, 9])
def test_witnesses_match_reference(seed):
    rng = random.Random(seed)
    jt, pt = _pair()
    keys = _keys(rng, 300)
    for k in keys:
        v = rng.randbytes(rng.randint(1, 60))
        jt.update(k, v)
        pt.update(k, v)
    root = pt.commit()
    assert jt.commit() == root
    probes = keys[:40] + _keys(rng, 40)
    for k in probes:
        pw = witness.prove(pt.store, root, k)
        assert pw == jwitness.prove(jt.store, root, k)
        assert witness.verify_witness(root, k, pw) == \
            jwitness.verify_witness(root, k, pw)
    # tampering: every variant fails in both with the same message
    k = keys[0]
    w = witness.prove(pt.store, root, k)
    bad = [w[:-1], w + b"\x00", bytes([2]) + w[1:],
           w[:40] + bytes([w[40] ^ 1]) + w[41:],
           w[:-5] + bytes([w[-5] ^ 0x80]) + w[-4:], w[:33] + b"\xff\xff"
           + w[35:], w[:35] + b"\x07" + w[36:]]
    for b in bad:
        with pytest.raises(jwitness.WitnessError) as je:
            jwitness.verify_witness(root, k, b)
        with pytest.raises(witness.WitnessError) as pe:
            witness.verify_witness(root, k, b)
        assert str(pe.value) == str(je.value)
    with pytest.raises(witness.WitnessError):
        witness.verify_witness(root, keys[1], w)
    # absorbing witnesses builds the same partial stores
    jstore, pstore = jtree.NodeStore(), tree.NodeStore()
    for k in probes[:20]:
        jwitness.absorb_witness(jstore, root,
                                jwitness.prove(jt.store, root, k))
        witness.absorb_witness(pstore, root, witness.prove(pt.store, root, k))
    assert pstore.nodes == jstore.nodes and pstore.values == jstore.values
    # the backend's one-blob proof surface
    be = BinTrieBackend(pt.store)
    proof = be.prove(root, k)
    assert be.verify(root, k, proof) == witness.verify_witness(root, k,
                                                               proof[0])
    with pytest.raises(witness.WitnessError):
        be.verify(root, k, proof * 2)
